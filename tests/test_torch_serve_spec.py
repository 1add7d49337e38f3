"""The speculative tick of the PyTorch port's serving engine
(``ServingEngine(cfg=EngineCfg(spec_k=...), draft=...)``, over
``BlockPool.spec_draft`` / ``spec_verify`` / ``commit_spec``) on the CPU in
f32, mirroring ``tests/test_spec_engine.py``: greedy spec-on tokens equal
spec-off, the port's sequential ``generate`` and ``ddw_tpu``'s spec-on
engine (a different-weights draft, so every tick rejects and rolls back);
seeded spec-on equals seeded spec-off inside the port; a self-draft accepts
exactly 1; a preempted spec stream resumes token for token, streaming each
token once; prefix-hit and copy-on-write counters are equal across spec
modes; a restart generation and a staged draft swap serve clean; config
validation raises the error types ``ddw_tpu``'s does. Both pools are checked
for leaks after every drill."""

import functools
import tempfile

import jax
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.serve import EngineCfg as JaxEngineCfg
from ddw_tpu.serve import ServingEngine as JaxServingEngine
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.serve import BlockPool, EngineCfg, ServingEngine
from ddw_tpu_torch.serving.lm_package import LMPackagedModel

VOCAB = 64
WAIT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _save(out_dir, seed=0, **cfg_kw):
    kw = dict(vocab_size=VOCAB, max_len=96, hidden=32, depth=2, num_heads=2,
              mlp_dim=64, dropout=0.0, dtype="float32")
    kw.update(cfg_kw)
    cfg = JaxLMCfg(**kw)
    params = jax_build_lm(cfg).init({"params": jax.random.PRNGKey(seed)},
                                    np.zeros((1, 8), np.int32))["params"]
    return jax_lm_package.save_lm_package(str(out_dir), cfg, params,
                                          quantize=None)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spec")
    # a different seed gives different weights: proposals genuinely diverge
    # from the target's picks, so every tick exercises rollback
    return _save(root / "target", seed=0), _save(root / "draft", seed=7)


@pytest.fixture(scope="module")
def pm(dirs):
    return LMPackagedModel(dirs[0], device="cpu")


@pytest.fixture(scope="module")
def dm(dirs):
    return LMPackagedModel(dirs[1], device="cpu")


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=(n,)).astype(np.int32)
            for n in lengths]


# 1- and 2-token prompts are the draft-lag edge cases; the steps clip the
# final tick short
PROMPTS = _prompts([5, 17, 1, 2], seed=2)
STEPS = [6, 9, 5, 7]


def _cfg(**kw):
    return dict(dict(n_slots=3, steps_per_tick=2, spec_k=3,
                     decode_buckets=False, default_timeout_s=600.0), **kw)


@functools.cache
def _jax_spec_tokens(dirs):
    """ddw_tpu's spec-on engine over the same packages (built once)."""
    jpm = jax_lm_package.load_lm_package(dirs[0])
    jdm = jax_lm_package.load_lm_package(dirs[1])
    with JaxServingEngine(lm=jpm, cfg=JaxEngineCfg(**_cfg()),
                          draft=jdm) as eng:
        futs = [eng.submit_generate(p, n) for p, n in zip(PROMPTS, STEPS)]
        return [f.result(timeout=WAIT).tokens for f in futs]


def _pool_clean(pool: BlockPool) -> None:
    """Rejected-speculation rollback leaves no block behind."""
    g = pool.gauges()
    assert g["resident_streams"] == 0
    assert g["blocks_used"] == 0, g
    assert g["blocks_free"] + g["blocks_cached"] == g["blocks_total"], g
    assert int(pool._ref.sum()) == 0
    assert pool._committed == 0
    assert pool.free_slots == pool.max_resident


def test_greedy_spec_on_equals_spec_off_and_jax(pm, dm, dirs):
    """A low-agreement draft changes latency only, never content: the
    port's spec-on tokens equal its sequential generate, its spec-off
    engine and ddw_tpu's spec-on engine."""
    refs = [pm.generate(p[None, :], n)[0] for p, n in zip(PROMPTS, STEPS)]
    with ServingEngine(lm=pm, cfg=EngineCfg(**_cfg()), draft=dm) as eng:
        futs = [eng.submit_generate(p, n) for p, n in zip(PROMPTS, STEPS)]
        spec = [f.result(timeout=WAIT).tokens for f in futs]
        snap = eng.snapshot()
        _pool_clean(eng.pool)
        _pool_clean(eng._draft_pool)
    with ServingEngine(lm=pm, cfg=EngineCfg(**_cfg(spec_k=0))) as eng:
        futs = [eng.submit_generate(p, n) for p, n in zip(PROMPTS, STEPS)]
        off = [f.result(timeout=WAIT).tokens for f in futs]
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(spec[i], ref)
        np.testing.assert_array_equal(off[i], ref)
        np.testing.assert_array_equal(spec[i], _jax_spec_tokens(dirs)[i])
    assert snap["serve.spec_proposed"] > 0
    assert snap["serve.spec_rejected"] > 0          # rollback really ran
    assert (snap["serve.spec_accepted"] + snap["serve.spec_rejected"]
            == snap["serve.spec_proposed"])


def test_seeded_spec_on_equals_spec_off(pm, dm):
    """Draft proposal j and verify position j both use step emitted+j's
    seed, so seeded spec-on reproduces seeded spec-off (and the package's
    step-by-step sampling is not the reference: inside the port the engine
    is)."""
    prompts, steps = PROMPTS[:2], STEPS[:2]

    def run(**kw):
        with ServingEngine(lm=pm, cfg=EngineCfg(**_cfg(**kw)),
                           draft=dm if kw.get("spec_k", 3) else None) as eng:
            futs = [eng.submit_generate(
                p, n, temperature=0.9,
                rng=torch.Generator().manual_seed(100 + i))
                for i, (p, n) in enumerate(zip(prompts, steps))]
            out = [f.result(timeout=WAIT).tokens for f in futs]
            if eng._draft_pool is not None:
                _pool_clean(eng._draft_pool)
            return out

    on, off = run(), run(spec_k=0)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def test_self_draft_acceptance_is_exactly_one(pm):
    """Draft == target: proposals always match the verifier's picks, so
    acceptance is exactly 1.0 (clipped proposals at a request's horizon are
    not rejections) and each spec tick advances more than one token."""
    refs = [pm.generate(p[None, :], n)[0]
            for p, n in zip(PROMPTS[:2], STEPS[:2])]
    with ServingEngine(lm=pm, cfg=EngineCfg(**_cfg()), draft=pm) as eng:
        futs = [eng.submit_generate(p, n)
                for p, n in zip(PROMPTS[:2], STEPS[:2])]
        for f, ref in zip(futs, refs):
            np.testing.assert_array_equal(f.result(timeout=WAIT).tokens, ref)
        snap = eng.snapshot()
    assert snap["serve.spec_acceptance_rate"] == 1.0
    assert snap["serve.spec_rejected"] == 0
    assert snap["serve.spec_tokens_per_tick"] > 1.0


def test_spec_preempt_resume_identical_exactly_once(pm, dm):
    """Out of blocks mid-speculation: the youngest stream leaves BOTH
    pools, re-queues at the head with only accepted tokens folded into its
    recompute prompt, and resumes token for token; streamed tokens are never
    duplicated and nothing leaks."""
    prompts = _prompts([30, 31, 33, 34], seed=17)
    steps = 36
    refs = [pm.generate(p[None, :], steps)[0] for p in prompts]
    streamed = {i: [] for i in range(len(prompts))}
    cfg = EngineCfg(n_slots=2, steps_per_tick=4, kv_cache_blocks=12,
                    max_resident=4, block_overcommit=3.0, spec_k=3,
                    decode_buckets=False, default_timeout_s=600.0)
    with ServingEngine(lm=pm, cfg=cfg, draft=dm) as eng:
        futs = [eng.submit_generate(
            p, steps, on_token=lambda i, t, j=j: streamed[j].append((i, t)))
            for j, p in enumerate(prompts)]
        out = [f.result(timeout=WAIT) for f in futs]
        snap = eng.snapshot()
        _pool_clean(eng.pool)
        _pool_clean(eng._draft_pool)
    assert snap["serve.preemptions"] > 0, "overcommit never ran out"
    for j, (r, ref) in enumerate(zip(out, refs)):
        np.testing.assert_array_equal(r.tokens, ref)
        assert [i for i, _ in streamed[j]] == list(range(steps)), j
        assert [t for _, t in streamed[j]] == list(r.tokens), j


def test_prefix_hit_and_cow_counters_equal_across_spec_modes(pm, dm):
    """Speculation never perturbs what the prefix cache sees: the same
    workload gives the same hit / copy-on-write counters spec on and
    off."""
    (pa,) = _prompts([24], seed=1)
    pb = pa.copy()
    pb[20] = (pb[20] + 1) % VOCAB          # diverges inside the tail block
    counters = {}
    for mode, k in (("off", 0), ("on", 3)):
        with ServingEngine(lm=pm, cfg=EngineCfg(**_cfg(spec_k=k)),
                           draft=dm if k else None) as eng:
            eng.generate(pa, 5)                  # seeds the prefix cache
            f1 = eng.submit_generate(pa, 5)      # exact repeat: tail CoW
            f2 = eng.submit_generate(pb, 5)      # shared full-block prefix
            f1.result(timeout=WAIT), f2.result(timeout=WAIT)
            snap = eng.snapshot()
        counters[mode] = {kk: snap[f"serve.{kk}"] for kk in
                          ("prefix_hit_blocks", "prefix_miss_blocks",
                           "prefix_hit_tokens", "cow_copies")}
    assert counters["on"] == counters["off"], counters
    assert counters["on"]["prefix_hit_blocks"] > 0
    assert counters["on"]["cow_copies"] > 0


def test_spec_restart_and_draft_swap_serve_clean(pm, dm, dirs):
    """restart() resets BOTH pools and the next generation serves the
    sequential tokens; ``set_checkpoint(draft_dir=)`` swaps the draft at
    the next restart (here to the target itself: acceptance becomes 1)."""
    prompts = _prompts([9, 13], seed=23)
    eng = ServingEngine(lm=pm, cfg=EngineCfg(**_cfg()), draft=dm)
    with eng:
        eng.generate(prompts[0], 6)
    eng.restart()
    try:
        got = eng.generate(prompts[1], 6)
        np.testing.assert_array_equal(got.tokens,
                                      pm.generate(prompts[1][None, :], 6)[0])
        _pool_clean(eng.pool)
        _pool_clean(eng._draft_pool)
    finally:
        eng.stop()
    rejected = eng.snapshot()["serve.spec_rejected"]    # cumulative
    eng.set_checkpoint(dirs[0], draft_dir=dirs[0])
    eng.restart()
    try:
        got = eng.generate(prompts[1], 6)
        np.testing.assert_array_equal(got.tokens,
                                      pm.generate(prompts[1][None, :], 6)[0])
        assert eng.draft_dir == dirs[0] and eng.model_dir == dirs[0]
        assert eng.snapshot()["serve.spec_rejected"] == rejected
    finally:
        eng.stop()


def test_spec_config_validation_raises_jax_error_types(pm, dm, dirs):
    """Each misconfiguration raises the ValueError ddw_tpu's engine raises,
    at construction (or at submission, for the draft's max_len)."""
    jpm = jax_lm_package.load_lm_package(dirs[0])
    jdm = jax_lm_package.load_lm_package(dirs[1])
    cases = [(dict(cfg=dict(spec_k=-1), draft=True), "spec_k"),
             (dict(cfg=dict(spec_k=2), draft=False), "draft"),
             (dict(cfg=dict(spec_k=2, paged=False), draft=True), "paged")]
    for case, match in cases:
        for engine_cls, cfg_cls, lm, draft in (
                (ServingEngine, EngineCfg, pm, dm),
                (JaxServingEngine, JaxEngineCfg, jpm, jdm)):
            with pytest.raises(ValueError, match=match):
                engine_cls(lm=lm, cfg=cfg_cls(**case["cfg"]),
                           draft=draft if case["draft"] else None)
    with tempfile.TemporaryDirectory() as tmp:
        other = LMPackagedModel(_save(tmp + "/v", vocab_size=32),
                                device="cpu")
        with pytest.raises(ValueError, match="vocab"):
            ServingEngine(lm=pm, cfg=EngineCfg(spec_k=2), draft=other)
        short = LMPackagedModel(_save(tmp + "/s", max_len=32), device="cpu")
        eng = ServingEngine(lm=pm, cfg=EngineCfg(spec_k=4), draft=short)
        (p,) = _prompts([24], seed=3)
        with pytest.raises(ValueError, match="max_len"):
            eng.submit_generate(p, 8)           # 24 + 8 + 4 > 32
        eng.stop()
