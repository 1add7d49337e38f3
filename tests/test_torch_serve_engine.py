"""The online serving engine of the PyTorch port
(``ddw_tpu_torch.serve.engine.ServingEngine``) on the CPU, against
``ddw_tpu``'s engine and sequential ``generate``: greedy tokens of the
paged and slot lanes under staggered admissions from several threads (with
prefix reuse, copy-on-write, preemption and the batch lane) equal to both;
the structured refusals (``Overloaded``, deadline shedding, ``cancel``,
stop with pending futures); failure containment through an injected
raising pool op (degraded, then failed with every future resolved, then
restart); seeded sampling repeatable inside the port; int8 LM and image
packages through the engine; the image lane on the depthwise kernel's path
(``dw_impl="pallas"``, its plain version here); what stays unported
(tensor parallelism, the disaggregation roles, serve faults) refused naming
``ROADMAP.md``. Every future is waited on with a timeout and
every engine stopped."""

import concurrent.futures
import functools
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.serve import EngineCfg as JaxEngineCfg
from ddw_tpu.serve import ServingEngine as JaxServingEngine
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.models.convert import to_flax_variables
from ddw_tpu_torch.models.layers import init_weights
from ddw_tpu_torch.models.registry import build_model
from ddw_tpu_torch.serve import (DEGRADED, FAILED, DeadlineExceeded,
                                 EngineCfg, Overloaded, ReplicaFailed,
                                 ServingEngine)
from ddw_tpu_torch.serving.lm_package import LMPackagedModel
from ddw_tpu_torch.serving.package import (PackagedModel,
                                           save_packaged_model)
from ddw_tpu_torch.utils.config import ModelCfg

VOCAB = 64
CFG = dict(vocab_size=VOCAB, max_len=96, hidden=32, depth=2, num_heads=2,
           mlp_dim=64, dropout=0.0, dtype="float32")
WAIT = 120          # seconds any one future may take


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread is fastest, and the test workers
    share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _save(out_dir, quantize=None, seed=0):
    cfg = JaxLMCfg(**CFG)
    params = jax_build_lm(cfg).init({"params": jax.random.PRNGKey(seed)},
                                    np.zeros((1, 8), np.int32))["params"]
    return jax_lm_package.save_lm_package(str(out_dir), cfg, params,
                                          quantize=quantize)


@pytest.fixture(scope="module")
def pkg_dir(tmp_path_factory):
    return _save(tmp_path_factory.mktemp("serve_pkg") / "pkg")


@pytest.fixture(scope="module")
def pm(pkg_dir):
    return LMPackagedModel(pkg_dir, device="cpu")


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=(n,)).astype(np.int32)
            for n in lengths]


def _mix(seed=0):
    """Prompts of 3-40 tokens, four of them sharing a 24-token prefix."""
    out = _prompts([3, 17, 9, 30, 5, 12, 40, 7], seed)
    shared = _prompts([24], seed + 50)[0]
    out += [np.concatenate([shared, p]) for p in _prompts([1, 4, 9, 16],
                                                          seed + 51)]
    return out


@functools.cache
def _refs(pkg_dir, seed, steps):
    jpm = jax_lm_package.LMPackagedModel(pkg_dir)
    return [jpm.generate(p[None, :], steps)[0] for p in _mix(seed)]


def _staggered(eng, prompts, steps, **kw):
    """Submit from three threads with staggered arrivals; results in
    prompt order."""
    futs = [None] * len(prompts)

    def client(idx):
        for i in idx:
            futs[i] = eng.submit_generate(prompts[i], steps, **kw)
            time.sleep(0.004 * (i % 3))

    threads = [threading.Thread(target=client, args=(range(t, len(prompts),
                                                           3),))
               for t in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    return [f.result(timeout=WAIT) for f in futs]


def test_jax_engine_equals_jax_generate_on_the_mix(pkg_dir):
    """The reference side of the parity pins below: ddw_tpu's own engine
    on this mix gives ddw_tpu's sequential tokens."""
    jpm = jax_lm_package.LMPackagedModel(pkg_dir)
    prompts = _mix()
    with JaxServingEngine(lm=jpm, cfg=JaxEngineCfg(
            n_slots=4, steps_per_tick=4, kv_block_size=8)) as eng:
        futs = [eng.submit_generate(p, 12) for p in prompts]
        out = [f.result(timeout=WAIT).tokens for f in futs]
    for got, ref in zip(out, _refs(pkg_dir, 0, 12)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("arm", [
    dict(),
    dict(block_overcommit=3.0, kv_cache_blocks=14),
    dict(paged=False),
    dict(decode_buckets=False, max_resident=3),
])
def test_engine_tokens_equal_sequential_and_jax(pm, pkg_dir, arm):
    """Paged (the default), paged under preemption, the slot lane and
    unbucketed decode: every stream's greedy tokens equal the port's
    sequential ``generate`` and ddw_tpu's (engine and sequential)."""
    prompts = _mix()
    cfg = EngineCfg(n_slots=4, steps_per_tick=4, kv_block_size=8, **arm)
    with ServingEngine(lm=pm, cfg=cfg) as eng:
        eng.warmup(sorted({len(p) for p in prompts}))
        out = _staggered(eng, prompts, 12)
        # a repeat of a 30-token prompt: its cached tail block is cloned
        out.append(eng.submit_generate(prompts[3], 12).result(timeout=WAIT))
        snap = eng.snapshot()
    refs = _refs(pkg_dir, 0, 12)
    refs.append(refs[3])
    for i, (res, p, ref) in enumerate(zip(out, prompts + [prompts[3]],
                                          refs)):
        np.testing.assert_array_equal(res.tokens, ref, err_msg=str(i))
        np.testing.assert_array_equal(pm.generate(p[None, :], 12)[0], ref)
        assert res.ttft_ms <= res.total_ms
    assert snap["serve.completed"] == len(prompts) + 1
    if cfg.paged:
        assert snap["serve.prefix_hit_tokens"] > 0
        assert snap["serve.blocks_used"] == 0.0
        if not cfg.kv_cache_blocks:      # a small pool may reclaim the tail
            assert snap["serve.cow_copies"] >= 1
    if arm.get("block_overcommit"):
        assert snap["serve.preemptions"] > 0
    if arm.get("max_resident") == 3:
        assert snap["serve.decode_rows_skipped"] == 0


def test_batch_lane_and_streaming(pm, pkg_dir):
    """Batch-lane items give the interactive tokens; on_token streams every
    token once, in order."""
    prompts = _mix()
    streamed = {i: [] for i in range(4)}
    with ServingEngine(lm=pm, cfg=EngineCfg(
            n_slots=2, steps_per_tick=3, kv_block_size=8,
            interactive_reserve_blocks=4)) as eng:
        bfuts = [eng.submit_batch_item(p, 12) for p in prompts[4:]]
        ifuts = [eng.submit_generate(
            p, 12, on_token=lambda j, t, i=i: streamed[i].append((j, t)))
            for i, p in enumerate(prompts[:4])]
        out = [f.result(timeout=WAIT) for f in ifuts + bfuts]
        snap = eng.snapshot()
    refs = _refs(pkg_dir, 0, 12)
    for res, ref in zip(out, refs[:4] + refs[4:]):
        np.testing.assert_array_equal(res.tokens, ref)
    for i in range(4):
        assert streamed[i] == list(enumerate(int(t) for t in refs[i]))
    assert snap["serve.batch_items"] == len(prompts) - 4


def test_seeded_sampling_is_repeatable_inside_the_port(pm):
    """Sampled streams (one generator per request, per-step keys) repeat
    token for token across runs, lanes and preemption; greedy neighbours
    are untouched."""
    prompts = _mix()[:6]

    def run(**arm):
        with ServingEngine(lm=pm, cfg=EngineCfg(
                n_slots=3, steps_per_tick=2, kv_block_size=8,
                **arm)) as eng:
            futs = [eng.submit_generate(
                p, 10, temperature=0.0 if i % 2 else 0.8,
                rng=torch.Generator().manual_seed(i)) for i, p in
                enumerate(prompts)]
            return [f.result(timeout=WAIT).tokens for f in futs]

    base = run()
    for arm in (dict(), dict(paged=False),
                dict(block_overcommit=3.0, kv_cache_blocks=10)):
        for got, ref in zip(run(**arm), base):
            np.testing.assert_array_equal(got, ref)
    for i in range(1, 6, 2):
        np.testing.assert_array_equal(base[i],
                                      pm.generate(prompts[i][None], 10)[0])
    with ServingEngine(lm=pm) as eng:
        with pytest.raises(ValueError, match="requires rng"):
            eng.submit_generate(prompts[0], 4, temperature=1.0)


def test_overloaded_deadline_cancel_and_stop(pm):
    p1, p2, p3 = _prompts([5, 6, 7], seed=2)
    eng = ServingEngine(lm=pm, cfg=EngineCfg(n_slots=1, queue_depth=2))
    try:
        f1 = eng.submit_generate(p1, 4)
        f2 = eng.submit_generate(p2, 4, timeout_s=0.001)
        with pytest.raises(Overloaded) as e:
            eng.submit_generate(p3, 4)
        assert e.value.to_dict()["capacity"] == 2
        time.sleep(0.01)
        eng.start()
        assert len(f1.result(timeout=WAIT).tokens) == 4
        with pytest.raises(DeadlineExceeded):
            f2.result(timeout=WAIT)
        snap = eng.snapshot()
        assert snap["serve.shed_overloaded"] == 1.0
        assert snap["serve.shed_deadline"] == 1.0
    finally:
        eng.stop()
    eng = ServingEngine(lm=pm, cfg=EngineCfg(n_slots=1))   # never started
    try:
        fa = eng.submit_generate(p1, 4)
        fb = eng.submit_generate(p2, 4)
        assert fb.cancel()
        eng.start()
        assert len(fa.result(timeout=WAIT).tokens) == 4
        with pytest.raises(concurrent.futures.CancelledError):
            fb.result(timeout=10)
        assert eng.snapshot()["serve.cancelled"] == 1.0
    finally:
        eng.stop()
    eng = ServingEngine(lm=pm, cfg=EngineCfg(n_slots=1))   # never started
    fut = eng.submit_generate(p1, 4)
    eng.stop()
    with pytest.raises(RuntimeError, match="engine stopped"):
        fut.result(timeout=10)
    assert eng.state == "stopped"


def test_failure_containment_and_restart(pm, pkg_dir):
    """A raising pool op fails the streams it touched with ReplicaFailed
    and leaves the engine degraded; the error budget turns it failed with
    every future resolved and submissions refused; restart serves again."""
    prompts = _mix()[:3]
    refs = _refs(pkg_dir, 0, 12)[:3]
    eng = ServingEngine(lm=pm, cfg=EngineCfg(
        n_slots=2, steps_per_tick=2, kv_block_size=8,
        max_consecutive_errors=2))
    try:
        real = eng.pool.decode
        boom = {"n": 1}

        def flaky(*a, **kw):
            if boom["n"]:
                boom["n"] -= 1
                raise RuntimeError("injected decode failure")
            return real(*a, **kw)

        eng.pool.decode = flaky
        eng.start()
        f = eng.submit_generate(prompts[0], 12)
        with pytest.raises(ReplicaFailed) as e:
            f.result(timeout=WAIT)
        assert e.value.to_dict()["phase"] == "in_slot"
        assert eng.state == DEGRADED
        ok = eng.submit_generate(prompts[1], 12).result(timeout=WAIT)
        np.testing.assert_array_equal(ok.tokens, refs[1])
        assert eng.state == "alive"
        assert eng.snapshot()["serve.loop_errors"] == 1.0
        real_prefill = eng.pool.prefill

        def dead(*a, **kw):
            raise RuntimeError("dead card")

        eng.pool.prefill = eng.pool.decode = dead
        for p in prompts[:2]:               # two errors in a row: terminal
            with pytest.raises(ReplicaFailed):
                eng.submit_generate(p, 12).result(timeout=WAIT)
        deadline = time.monotonic() + WAIT
        while eng.state != FAILED and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.state == FAILED and eng.health()["state"] == FAILED
        assert eng.failure.to_dict()["kind"] == "errors"
        with pytest.raises(ReplicaFailed):
            eng.submit_generate(prompts[0], 4)
        eng.pool.decode, eng.pool.prefill = real, real_prefill
        eng.restart()
        assert eng.generation == 1 and eng.state == "alive"
        got = eng.submit_generate(prompts[2], 12).result(timeout=WAIT)
        np.testing.assert_array_equal(got.tokens, refs[2])
        assert eng.snapshot()["serve.blocks_used"] == 0.0
        assert eng.recycle(drain_timeout_s=WAIT)
        assert eng.generation == 2
        clone = eng.clone_fresh()
        assert clone.generation == 3 and clone.pool is not eng.pool
    finally:
        eng.stop()


def test_checkpoint_swap_at_restart(pm, pkg_dir, tmp_path):
    other = _save(tmp_path / "other", seed=5)
    p = _mix()[1]
    eng = ServingEngine(lm=pm, cfg=EngineCfg(n_slots=2))
    try:
        eng.start()
        before = eng.generate(p, 8).tokens
        eng.set_checkpoint(other)
        eng.force_fail("stalled", "test")
        eng.restart()
        after = eng.generate(p, 8).tokens
    finally:
        eng.stop()
    np.testing.assert_array_equal(before, _refs(pkg_dir, 0, 8)[1])
    np.testing.assert_array_equal(
        after, LMPackagedModel(other, device="cpu").generate(p[None], 8)[0])
    assert eng.model_dir == other


def test_int8_lm_package_through_engine_matches_direct(tmp_path):
    d = _save(tmp_path / "i8", quantize="int8")
    pm8 = LMPackagedModel(d, device="cpu")
    prompts = _prompts([6, 11, 4, 15], seed=9)
    direct = [pm8.generate(p[None, :], 8)[0] for p in prompts]
    jdirect = [jax_lm_package.LMPackagedModel(d).generate(p[None, :], 8)[0]
               for p in prompts[:2]]
    with ServingEngine(lm=pm8, cfg=EngineCfg(n_slots=2,
                                             steps_per_tick=3)) as eng:
        out = [f.result(timeout=WAIT) for f in
               [eng.submit_generate(p, 8) for p in prompts]]
    for r, ref in zip(out, direct):
        np.testing.assert_array_equal(r.tokens, ref)
    for ref, jref in zip(direct, jdirect):
        np.testing.assert_array_equal(ref, jref)


@pytest.mark.parametrize("name,quantize", [("small_cnn", "int8"),
                                           ("mobilenet_v2", None)])
def test_image_lane_matches_predict_logits(tmp_path, name, quantize):
    """The image lane is the package's own forward: an int8 SmallCNN, and a
    MobileNetV2 with dw_impl='pallas' (the depthwise kernel's path; its
    plain version on CPU tensors) in padded power-of-two batches."""
    mcfg = ModelCfg(name=name, num_classes=5, dropout=0.0, dtype="float32",
                    width_mult=0.35, dw_impl="pallas", freeze_base=False)
    model = build_model(mcfg, (32, 32))
    init_weights(model, torch.Generator().manual_seed(0))
    v = to_flax_variables(model)
    d = save_packaged_model(str(tmp_path / name), mcfg,
                            [f"c{i}" for i in range(5)], v["params"],
                            v.get("batch_stats"), 32, 32, quantize=quantize)
    pkg = PackagedModel(d, device="cpu")
    imgs = np.random.RandomState(0).rand(11, 32, 32, 3).astype(
        np.float32) * 2 - 1
    ref = pkg.predict_logits(imgs)
    with ServingEngine(image=pkg, cfg=EngineCfg(max_batch=4,
                                                max_wait_ms=1.0)) as eng:
        eng.warmup()
        out = eng.predict(list(imgs), timeout_s=WAIT)
        batch = eng.submit_batch_predict(imgs[0]).result(timeout=WAIT)
        snap = eng.snapshot()
    got = np.stack([r.logits for r in out])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert [r.label for r in out] == pkg.predict(imgs)
    np.testing.assert_allclose(batch.logits, ref[0], rtol=1e-5, atol=1e-5)
    assert snap["serve.image_batches"] >= 3.0
    with pytest.raises(ValueError, match="without an LM"):
        eng.submit_generate(np.zeros(3, np.int32), 4)


def test_unported_features_are_refused_naming_the_roadmap(pm, monkeypatch):
    """What stays refused after the speculative tick, adapters, tenants,
    tracing, telemetry, the monitor and bulk jobs landed (their cases moved
    to test_torch_serve_spec.py, test_torch_serve_adapters.py,
    test_torch_serve_tenancy_lanes.py and test_torch_obs.py): tensor
    parallelism, a mesh, the disaggregation roles and DDW_FAULT serve
    faults."""
    for kw in (dict(cfg=EngineCfg(tp=2)), dict(mesh=object()),
               dict(cfg=EngineCfg(role="prefill")),
               dict(cfg=EngineCfg(role="decode"))):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ServingEngine(lm=pm, **kw)
    monkeypatch.setenv("DDW_FAULT", "serve:crash")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServingEngine(lm=pm)
    monkeypatch.delenv("DDW_FAULT")
    with ServingEngine(lm=pm) as eng:
        with pytest.raises(ValueError, match="exceeds max_len"):
            eng.submit_generate(np.ones(90, np.int32), 10)
        with pytest.raises(ValueError, match="token ids outside"):
            eng.submit_generate(np.full(3, VOCAB, np.int32), 2)
    with pytest.raises(ValueError, match="role"):
        EngineCfg(role="x")
    with pytest.raises(ValueError, match="paged pool"):
        EngineCfg(tp=2, paged=False)
    with pytest.raises(ValueError, match="lm and/or image"):
        ServingEngine()
