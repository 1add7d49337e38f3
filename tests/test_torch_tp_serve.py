"""Tensor-parallel serving in the PyTorch port on the CPU (the parity
target is ``tests/test_tp_serve.py``).

A port ``tp``-wide replica is ``tp`` rank processes: the engine's process is
rank 0 and schedules, followers run every paged program on their shards
(``ddw_tpu_torch/serve/tp.py``). The pins:

- **the group repair**: a gloo group built outside the default one (no
  ``init_process_group`` at all) is answered for by the port's collectives
  as the world it is, never as a world of one;
- **structured config errors**, each ``ddw_tpu``'s message beside the
  port's, all raised at construction, before any follower starts;
- **spec resolution**: ``LM_TP_RULES``, the GQA fallback's warning, and a
  decode cache whose K/V pool leaves, and only those, shard on the heads
  axis;
- **identity**: a ``tp=2`` engine (this process rank 0, one follower
  process) serves the greedy tokens of the port's ``tp=1`` engine and of a
  ``ddw_tpu`` ``tp=2`` engine, and the seeded tokens of the port's
  ``tp=1`` engine; its f32 logits stay within 1e-5 of the largest; the
  ``serve.tp_*`` telemetry flows; the pool drains to zero; ``close()``
  ends the follower;
- an explicit two-rank mesh (``mesh=``) adopts its degree on rank 0 while
  rank 1 follows, also under the GQA fallback;
- ``slow``: out-of-blocks preemption, a rejecting spec tick with a warm
  restart, the ``ProcessReplica(tp=2)`` fleet through a SIGKILL, and the
  KV wire between pools of any ``tp`` and across the two packages.

Tiny packages (vocab 64, hidden 32, depth 2, 4 heads, mlp 64, f32) are
saved with ``ddw_tpu``'s ``save_lm_package`` and loaded by both packages,
so the weights are the same. Every future is waited on with a timeout.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JaxMesh

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.parallel.sharding import \
    decode_cache_shardings as jax_decode_cache_shardings
from ddw_tpu.parallel.sharding import lm_tp_rules_for as jax_rules_for
from ddw_tpu.serve import EngineCfg as JaxEngineCfg
from ddw_tpu.serve import ServingEngine as JaxServingEngine
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.models.lm import init_paged_cache
from ddw_tpu_torch.parallel.sharding import (LM_TP_RULES,
                                             LM_TP_RULES_REPLICATED_KV, P,
                                             check_spec_divisibility,
                                             decode_cache_shardings,
                                             lm_tp_rules_for)
from ddw_tpu_torch.runtime.mesh import MODEL_AXIS, Mesh
from ddw_tpu_torch.serve import EngineCfg, ReplicaFailed, ServingEngine
from ddw_tpu_torch.serve import tp as tp_mod
from ddw_tpu_torch.serve.blocks import BlockPool
from ddw_tpu_torch.serving.lm_package import LMPackagedModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 64
WAIT = 300
CFG = dict(vocab_size=VOCAB, max_len=96, hidden=32, depth=2, num_heads=4,
           mlp_dim=64, dropout=0.0, dtype="float32")


def _save_pkg(out_dir, seed=0, **kw) -> str:
    cfg = JaxLMCfg(**dict(CFG, **kw))
    params = jax_build_lm(cfg).init({"params": jax.random.PRNGKey(seed)},
                                    np.zeros((1, 8), np.int32))["params"]
    return jax_lm_package.save_lm_package(str(out_dir), cfg, params,
                                          quantize=None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pkg_dir(tmp_path_factory):
    return _save_pkg(tmp_path_factory.mktemp("tp_target") / "pkg", seed=0)


@pytest.fixture(scope="module")
def pm(pkg_dir):
    return LMPackagedModel(pkg_dir, device="cpu")


@pytest.fixture(scope="module")
def jpm(pkg_dir):
    return jax_lm_package.load_lm_package(pkg_dir)


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=(n,)).astype(np.int32)
            for n in lengths]


def _cfg(**kw):
    return EngineCfg(**dict(dict(n_slots=2, steps_per_tick=2,
                                 decode_buckets=False,
                                 default_timeout_s=600.0), **kw))


def _pool_clean(pool: BlockPool) -> None:
    """The leak pin: the sharding changes the layout only — host
    accounting drains to zero exactly as at tp=1."""
    g = pool.gauges()
    assert g["resident_streams"] == 0
    assert g["blocks_used"] == 0, g
    assert g["blocks_free"] + g["blocks_cached"] == g["blocks_total"], g
    assert int(pool._ref.sum()) == 0
    assert pool._committed == 0
    assert pool.free_slots == pool.max_resident


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def _fake_mesh(n, axes=(MODEL_AXIS,)):
    """A mesh's shape without its groups: what construction-time checks
    read before any collective."""
    return Mesh(tuple(axes), np.arange(n), {}, rank=0)


# -- step 0: a group that is not the default one --------------------------

def _run_ranks(code: str, n: int, **env) -> list[dict]:
    """Run ``code`` in ``n`` fresh interpreters that import torch and the
    port only (rank ``r`` finds ``RANK``, ``WORLD`` and ``PORT``, the port
    of a ``TCPStore`` this process holds, in its environment, with
    ``env``); each prints one JSON line last. Their lines, in rank
    order."""
    store = dist.TCPStore("127.0.0.1", 0, n, True, wait_for_workers=False)
    port = store.port
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=REPO, RANK=str(r), WORLD=str(n),
                 PORT=str(port), **env)) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


_PRIVATE_GROUP_RANK = """
import datetime, gc, json, os
import torch, torch.distributed as dist
from ddw_tpu_torch.parallel import comm
from ddw_tpu_torch.runtime.collectives import (all_gather_axis,
    all_reduce_mean, all_reduce_sum, broadcast_from)
from ddw_tpu_torch.runtime.mesh import MODEL_AXIS, Mesh

rank = int(os.environ["RANK"])
timeout = datetime.timedelta(seconds=60)
store = dist.TCPStore("127.0.0.1", int(os.environ["PORT"]), 2, False,
                      timeout=timeout)
pg = dist.ProcessGroupGloo(store, rank, 2, timeout)
x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
mesh = Mesh.over_group(pg, MODEL_AXIS)
summed = all_reduce_sum({"a": x, "b": [x + 1]}, pg)
res = {"initialized": dist.is_initialized(),
       "sum": summed["a"], "sum_b": summed["b"][0],
       "mesh_sum": all_reduce_sum(x, (mesh, MODEL_AXIS)),
       "mean": all_reduce_mean(x, pg),
       "bcast": broadcast_from(x, pg, root=1),
       "gather": all_gather_axis(x, pg, tiled=True, axis=1),
       "stack": all_gather_axis(x, pg),
       "reduce": comm.reduce_from_group(x, pg),
       "gather_grp": comm.gather_from_group(x, pg, 0),
       "axis_index": mesh.axis_index(MODEL_AXIS),
       "shape": mesh.shape}
# gloo's own teardown at exit aborts a rank now and then (terminate called
# without an active exception), in a process that holds nothing but a
# ProcessGroupGloo and its collectives too: end the collectives together,
# then close the group and free it and its store while the interpreter is
# whole
pg.barrier().wait()
pg.shutdown()
del pg, mesh, store
gc.collect()
print(json.dumps({k: v.tolist() if isinstance(v, torch.Tensor) else v
                  for k, v in res.items()}))
"""


def test_private_group_collectives_see_the_whole_group():
    """The repair: two gloo ranks over a private group with no default
    group get the full sums and gathers from the port's collectives and
    ``parallel.comm``, and a mesh over that group reads the rank in it."""
    got = _run_ranks(_PRIVATE_GROUP_RANK, 2)
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) * (r + 1)
         for r in range(2)]
    for r, res in enumerate(got):
        assert not res["initialized"]
        for key, want in (("sum", x[0] + x[1]), ("sum_b", x[0] + x[1] + 2),
                          ("mesh_sum", x[0] + x[1]),
                          ("mean", (x[0] + x[1]) / 2), ("bcast", x[1]),
                          ("gather", np.concatenate(x, 1)),
                          ("stack", np.stack(x)), ("reduce", x[0] + x[1]),
                          ("gather_grp", np.concatenate(x, 0))):
            np.testing.assert_allclose(res[key], want, err_msg=key)
        assert res["axis_index"] == r
        assert res["shape"] == {MODEL_AXIS: 2}


# -- structured config errors ---------------------------------------------

def test_tp_validation_messages(pm, jpm, tmp_path):
    """Each of ddw_tpu's construction-time refusals with its port
    counterpart, and what the port adds: a draft whose heads the degree
    cannot split is refused, and nothing spawns a follower on the way.
    (Adapter pools under TP, refused here before, serve: their parity
    cases are in test_torch_tp_lora.py.)"""
    jmesh = lambda n, ax=(MODEL_AXIS,): JaxMesh(  # noqa: E731
        np.asarray(jax.devices()[:n]), ax)
    for cfg_cls in (JaxEngineCfg, EngineCfg):
        with pytest.raises(ValueError, match="tp must be >= 1"):
            cfg_cls(tp=0)
        with pytest.raises(ValueError, match="requires the paged pool"):
            cfg_cls(tp=2, paged=False)
    for eng_cls, cfg_cls, lm, mesh in (
            (JaxServingEngine, JaxEngineCfg, jpm, jmesh),
            (ServingEngine, EngineCfg, pm, _fake_mesh)):
        with pytest.raises(ValueError, match="does not divide the target "
                                             "model's num_heads"):
            eng_cls(lm=lm, cfg=cfg_cls(tp=3))
        with pytest.raises(ValueError,
                           match="exceeds the local device count"):
            eng_cls(lm=lm, cfg=cfg_cls(tp=1024))
        with pytest.raises(ValueError, match="conflicts with the mesh"):
            eng_cls(lm=lm, cfg=cfg_cls(tp=2), mesh=mesh(4))
        with pytest.raises(ValueError, match="must carry a"):
            eng_cls(lm=lm, cfg=cfg_cls(tp=2), mesh=mesh(2, ("data",)))
    draft = LMPackagedModel(_save_pkg(tmp_path / "draft", num_heads=1),
                            device="cpu")
    with pytest.raises(ValueError, match="does not divide the draft "
                                         "model's num_heads 1"):
        ServingEngine(lm=pm, cfg=EngineCfg(tp=2, spec_k=2), draft=draft)
    with pytest.raises(ValueError, match="must carry a"):
        BlockPool(pm.model, 4, 16, 2, mesh=_fake_mesh(2, ("data",)))


def test_a_follower_that_fails_to_start_fails_the_construction(
        pm, monkeypatch, tmp_path):
    """No fallback: an engine whose follower dies at startup raises at
    construction, naming the follower's log; nothing is left running."""
    monkeypatch.setattr(tp_mod.sys, "executable", "/bin/false")
    with pytest.raises(RuntimeError, match="follower rank 1 exited with "
                                           "code 1 during startup") as e:
        tp_mod.TPGroup(2, "cpu", log_dir=str(tmp_path))
    assert str(tmp_path / "follower1.log") in str(e.value)


def test_a_cleanly_closed_group_removes_its_own_logs():
    """The follower logs of a group that made its own directory go with
    it once every follower exited cleanly."""
    group = tp_mod.TPGroup(2, "cpu")
    log_dir = group.log_dir
    assert os.path.isfile(os.path.join(log_dir, "follower1.log"))
    group.close()
    assert group.procs[1].returncode == 0
    assert not os.path.exists(log_dir)


def test_degenerate_mesh_keeps_the_tp1_path(pm):
    """A model axis of one rank is the tp=1 path (ddw_tpu's degenerate
    slice): no follower, the single-device pool, and a pool given that
    mesh shards nothing."""
    eng = ServingEngine(lm=pm, cfg=_cfg(), mesh=_fake_mesh(1))
    assert eng.mesh is None and eng.tp_degree == 1
    assert eng.pool.tp_degree == 1 and eng.follower_pids == []
    clone = eng.clone_fresh()
    assert clone.tp_degree == 1
    pool = BlockPool(pm.model, 4, 16, 2, mesh=_fake_mesh(1))
    assert pool.tp_degree == 1
    assert pool.cache["backbone_block0"]["attn"]["kv_block_key"].shape[2] == 4


# -- spec resolution ------------------------------------------------------

def test_lm_tp_rules_resolution_and_gqa_fallback():
    """The port's rules are ddw_tpu's, spec for spec, and the GQA
    fallback warns alike."""
    rules, kv_sharded = lm_tp_rules_for(4, 0, 2)
    jrules, jkv = jax_rules_for(4, 0, 2)
    assert kv_sharded and jkv and rules is LM_TP_RULES
    for path, nd in (("layers_0/attn/key/kernel", 3),
                     ("layers_0/attn/query/bias", 2),
                     ("layers_0/attn/out/kernel", 3),
                     ("layers_0/fc1/kernel", 2), ("layers_0/fc2/kernel", 2),
                     ("tok_embed/embedding", 2), ("head/kernel", 2),
                     ("head/bias", 1), ("layers_0/LayerNorm_0/scale", 1)):
        assert rules.spec_for(path, nd) == tuple(jrules.spec_for(path, nd))
    for pkg_fn in (lm_tp_rules_for, jax_rules_for):
        with pytest.warns(RuntimeWarning, match="num_kv_heads 3 not "
                                                "divisible"):
            rules, kv_sharded = pkg_fn(6, 3, 2)
        assert not kv_sharded
        assert tuple(rules.spec_for("layers_0/attn/key/kernel", 3)) == ()
        assert tuple(rules.spec_for("layers_0/attn/value/bias", 2)) == ()
        assert (tuple(rules.spec_for("layers_0/attn/query/kernel", 3))
                == (None, MODEL_AXIS, None))
        with pytest.raises(ValueError, match="does not divide num_heads 5"):
            pkg_fn(5, 0, 2)
    with pytest.warns(RuntimeWarning):
        assert lm_tp_rules_for(6, 3, 2)[0] is LM_TP_RULES_REPLICATED_KV


def test_decode_cache_shardings_shard_exactly_the_kv_pool(pm, jpm):
    """The port's paged cache takes ddw_tpu's decode-cache specs leaf for
    leaf, and a pool built over a two-rank model axis holds half the K/V
    heads a rank (all of them under the GQA fallback)."""
    from ddw_tpu.models.lm import init_cache as jax_init_cache

    cache = init_paged_cache(pm.model, 9, 8)
    mesh = _fake_mesh(2)
    sh = decode_cache_shardings(cache, mesh, kv_sharded=True)
    jmodel = jpm.model.clone(decode=True, slot_decode=False,
                             paged_decode=True, kv_cache_blocks=9,
                             kv_block_size=8, seq_axis=None, dropout=0.0)
    jmesh = JaxMesh(np.asarray(jax.devices()[:2]), (MODEL_AXIS,))
    jsh = jax_decode_cache_shardings(jax_init_cache(jmodel, 1), jmesh,
                                     kv_sharded=True)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): s
             for path, s in jax.tree_util.tree_leaves_with_path(jsh)}
    kv_keys = [k for k in sh if "kv_block_" in k]
    assert len(kv_keys) == 2 * CFG["depth"]
    for k, spec in sh.items():
        want = P(None, None, MODEL_AXIS, None) if "kv_block_" in k else P()
        assert spec == want, (k, spec)
        if "kv_block_" in k:
            assert tuple(jflat[k].spec) == tuple(spec), k
    for spec in decode_cache_shardings(cache, mesh, False).values():
        assert spec == P()
    with pytest.raises(ValueError, match="not divisible"):
        check_spec_divisibility("kv_block_key", (9, 8, 3, 8),
                                P(None, None, MODEL_AXIS, None), mesh)
    local = init_paged_cache(pm.model, 9, 8, mesh=mesh)
    assert local["backbone_block1"]["attn"]["kv_block_value"].shape == \
        (9, 8, 2, 8)
    full = init_paged_cache(pm.model, 9, 8, mesh=mesh, kv_sharded=False)
    assert full["backbone_block1"]["attn"]["kv_block_value"].shape == \
        (9, 8, 4, 8)


# -- identity: tp=2 equals tp=1 --------------------------------------------

def _serve_one_by_one(eng, prompts, steps, **kw):
    """Each request alone, so two engines run the same dispatches."""
    return [eng.submit_generate(p, n, **kw).result(timeout=WAIT).tokens
            for p, n in zip(prompts, steps)]


def test_tp2_engine_serves_tp1_tokens_with_telemetry(pm, jpm):
    """THE acceptance pin. A port tp=2 engine (this process is rank 0, one
    follower process) serves the greedy tokens of the port's tp=1 engine,
    of a ddw_tpu tp=2 engine and of sequential generate, and the seeded
    tokens of the port's tp=1 engine at the same seeds. Its f32 logits,
    recorded at every pick, are within 1e-5 of the largest logit of tp=1's
    and every live row's top-2 margin clears that. The dispatch meter,
    the degree gauge and the telemetry feed carry the tp keys; the pool
    drains to zero; close() ends the follower."""
    greedy = _prompts([5, 12, 3, 17], seed=2)
    gsteps = [8, 6, 9, 7]
    seeded = _prompts([6, 11, 4], seed=5)
    refs = [pm.generate(p[None, :], n)[0] for p, n in zip(greedy, gsteps)]
    with JaxServingEngine(lm=jpm, cfg=JaxEngineCfg(
            n_slots=2, steps_per_tick=2, tp=2, decode_buckets=False,
            default_timeout_s=600.0)) as jeng:
        jax_tokens = [f.result(timeout=WAIT).tokens for f in [
            jeng.submit_generate(p, n) for p, n in zip(greedy, gsteps)]]
    out, logits = {}, {}
    for tp in (1, 2):
        eng = ServingEngine(lm=pm, cfg=_cfg(tp=tp, telemetry=True,
                                            telemetry_interval_s=0.05))
        try:
            assert eng.tp_degree == tp and eng.pool.tp_degree == tp
            assert len(eng.follower_pids) == tp - 1
            eng.pool.record_logits = logits[tp] = []
            eng.start()
            out[tp, "greedy"] = _serve_one_by_one(eng, greedy, gsteps)
            eng.pool.record_logits = None
            out[tp, "seeded"] = [
                eng.submit_generate(
                    p, 8, temperature=0.9,
                    rng=torch.Generator().manual_seed(100 + i)
                ).result(timeout=WAIT).tokens
                for i, p in enumerate(seeded)]
            time.sleep(0.2)             # a telemetry sample after the last
            snap = eng.snapshot()
            feed = eng.telemetry_events()
            _pool_clean(eng.pool)
            pids = eng.follower_pids
            if tp == 2:
                log_dir = eng._tp_group.log_dir
                # a follower that dies fails the next dispatch: the
                # replica goes failed and the future resolves, no hang
                os.kill(pids[0], signal.SIGKILL)
                fut = eng.submit_generate(greedy[0], 4)
                with pytest.raises(ReplicaFailed):
                    fut.result(timeout=60)
                assert eng.state == "failed"
        finally:
            eng.close()
        if tp == 2:
            assert snap["serve.tp_dispatches"] > 0
            assert snap["serve.tp_dispatch_us"] > 0
            assert snap["serve.tp_dispatch_cost_us"] > 0
            assert snap["serve.tp_degree"] == 2.0
            sampled = {s["name"]: s["value"] for s in feed["samples"]}
            assert sampled.get("serve.tp_dispatches", 0) > 0, sampled
            assert sampled.get("serve.tp_degree") == 2.0, sampled
            deadline = time.monotonic() + 10
            while any(_alive(p) for p in pids) and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            assert not any(_alive(p) for p in pids), pids
            # the killed follower's log outlives the group, for its error
            assert os.path.isfile(os.path.join(log_dir, "follower1.log"))
            shutil.rmtree(log_dir)
        else:
            assert snap["serve.tp_dispatches"] == 0
    for i, ref in enumerate(refs):
        assert np.array_equal(out[1, "greedy"][i], ref), i
        assert np.array_equal(out[2, "greedy"][i], ref), i
        assert np.array_equal(jax_tokens[i], ref), i
    for i in range(len(seeded)):
        assert np.array_equal(out[1, "seeded"][i], out[2, "seeded"][i]), i
    assert len(logits[1]) == len(logits[2]) > 0
    for a, b in zip(logits[1], logits[2]):
        tol = 1e-5 * float(np.abs(a).max())
        assert float(np.abs(a - b).max()) <= tol
        top2 = np.sort(a[0])[-2:]          # row 0: the live row
        assert top2[1] - top2[0] > tol


_EXPLICIT_MESH_RANK = """
import json, os, warnings
import numpy as np, torch, torch.distributed as dist
from ddw_tpu_torch.runtime.mesh import MODEL_AXIS, make_mesh
from ddw_tpu_torch.serve import EngineCfg, ServingEngine
from ddw_tpu_torch.serving.lm_package import LMPackagedModel

torch.set_num_threads(1)
dist.init_process_group(
    "gloo", store=dist.TCPStore("127.0.0.1", int(os.environ["PORT"]), 2,
                                False),
    rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD"]))
mesh = make_mesh([(MODEL_AXIS, 2)])
rank = mesh.axis_index(MODEL_AXIS)
rng = np.random.RandomState(4)
prompts = [rng.randint(0, 64, size=(n,)).astype(np.int32) for n in (5, 9)]
steps = [6, 5]
cfg = EngineCfg(n_slots=2, steps_per_tick=2, decode_buckets=False)
out = {}
for name in ("mha", "gqa"):
    pkg = LMPackagedModel(os.environ[name.upper()], device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        eng = ServingEngine(lm=pkg, cfg=cfg, mesh=mesh)
    if rank:
        eng.start()
        eng.close()               # returns once rank 0 closed the replica
        out[name] = eng.tp_degree
        continue
    with eng:
        got = [f.result(timeout=300).tokens for f in [
            eng.submit_generate(p, n) for p, n in zip(prompts, steps)]]
    clone = eng.clone_fresh().start()
    got.append(clone.submit_generate(prompts[0], steps[0]).result(
        timeout=300).tokens)
    refs = [pkg.generate(p[None], n)[0] for p, n in zip(prompts, steps)]
    out[name] = {"degree": [eng.tp_degree, eng.pool.tp_degree,
                            clone.tp_degree],
                 "kv_heads": eng.pool._leaves()[0].shape[2],
                 "equal": [bool(np.array_equal(a, b))
                           for a, b in zip(got, refs + refs[:1])]}
    eng.stop()
    clone.close()
print(json.dumps(out))
"""


def test_explicit_mesh_adopts_its_degree_and_follows(pkg_dir, tmp_path):
    """ServingEngine(mesh=...) with cfg.tp left at 1 adopts the mesh's
    model axis; the other rank's engine follows; sequential generate's
    tokens come out, and the clone keeps the degree. The same under the
    GQA fallback (6 heads over 3 K/V heads at tp 2: K/V replicated, each
    rank's query heads mapped to their global K/V heads)."""
    gqa = _save_pkg(tmp_path / "gqa", hidden=48, num_heads=6,
                    num_kv_heads=3)
    r0, r1 = _run_ranks(_EXPLICIT_MESH_RANK, 2, MHA=pkg_dir, GQA=gqa)
    assert r1 == {"mha": 2, "gqa": 2}
    assert r0["mha"]["degree"] == [2, 2, 2]
    assert r0["mha"]["kv_heads"] == 2          # 4 K/V heads, sharded
    assert r0["gqa"]["kv_heads"] == 3          # replicated
    for name in ("mha", "gqa"):
        assert all(r0[name]["equal"]), (name, r0[name])


# -- tier-2 drills (test_tp_serve.py's slow drills) -------------------------

@pytest.fixture(scope="module")
def dm_dir(tmp_path_factory):
    # different weights: drafts diverge, so the sharded spec tick rejects
    return _save_pkg(tmp_path_factory.mktemp("tp_draft") / "pkg", seed=7)


@pytest.fixture(scope="module")
def dm(dm_dir):
    return LMPackagedModel(dm_dir, device="cpu")


@pytest.mark.slow
def test_tp2_identity_through_out_of_blocks_preemption(pm):
    """block_overcommit starves the tp=2 pool mid-decode: preemption by
    recompute resumes with sequential generate's tokens, streams see every
    token once, and the sharded pool drains to zero."""
    prompts = _prompts([30, 31, 33, 34], seed=17)
    steps = 40
    refs = [pm.generate(p[None, :], steps)[0] for p in prompts]
    streamed: dict[int, list] = {i: [] for i in range(len(prompts))}
    eng = ServingEngine(lm=pm, cfg=_cfg(
        steps_per_tick=4, kv_cache_blocks=12, max_resident=4,
        block_overcommit=3.0, tp=2))
    try:
        with eng:
            futs = [eng.submit_generate(
                p, steps,
                on_token=lambda i, t, j=j: streamed[j].append((i, t)))
                for j, p in enumerate(prompts)]
            out = [f.result(timeout=600) for f in futs]
            snap = eng.snapshot()
            _pool_clean(eng.pool)
    finally:
        eng.close()
    assert snap["serve.preemptions"] > 0, "overcommit never ran out"
    assert snap["serve.tp_dispatches"] > 0
    for j, (r, ref) in enumerate(zip(out, refs)):
        assert np.array_equal(r.tokens, ref), j
        assert [i for i, _ in streamed[j]] == list(range(steps)), j


@pytest.mark.slow
def test_tp2_identity_through_spec_tick_and_warm_restart(pm, dm, dm_dir):
    """Speculation across the ranks: a different-weights draft forces
    rejections and rollback each tick; the emitted tokens are sequential
    generate's, both sharded pools drain, and restart() re-zeroes the
    shards on every rank and serves the same tokens again. A staged
    checkpoint reaches the followers at the next restart; a killed
    follower fails the replica, and restart() starts a new one."""
    prompts = _prompts([5, 17, 2], seed=3)
    steps = [6, 9, 7]
    refs = [pm.generate(p[None, :], n)[0] for p, n in zip(prompts, steps)]
    eng = ServingEngine(lm=pm, cfg=_cfg(spec_k=3, tp=2), draft=dm)
    try:
        assert eng._draft_pool.tp_degree == 2
        with eng:
            futs = [eng.submit_generate(p, n)
                    for p, n in zip(prompts, steps)]
            for i, f in enumerate(futs):
                assert np.array_equal(f.result(timeout=600).tokens,
                                      refs[i]), i
            snap = eng.snapshot()
            assert snap["serve.spec_proposed"] > 0
            assert snap["serve.spec_rejected"] > 0, "self-agreeing draft?"
            _pool_clean(eng.pool)
            _pool_clean(eng._draft_pool)
        pids = eng.follower_pids
        eng.restart()
        assert eng.tp_degree == 2 and eng.follower_pids == pids
        f = eng.submit_generate(prompts[0], steps[0])
        assert np.array_equal(f.result(timeout=600).tokens, refs[0])
        _pool_clean(eng.pool)
        _pool_clean(eng._draft_pool)
        # a weight swap at restart sends the followers new shards
        eng.stop()
        eng.set_checkpoint(dm_dir)
        eng.restart()
        assert eng.follower_pids == pids
        f = eng.submit_generate(prompts[1], steps[1])
        assert np.array_equal(f.result(timeout=600).tokens,
                              dm.generate(prompts[1][None], steps[1])[0])
        # a dead follower fails the replica; restart() starts a new one
        os.kill(pids[0], signal.SIGKILL)
        with pytest.raises(ReplicaFailed):
            eng.submit_generate(prompts[0], steps[0]).result(timeout=60)
        eng.restart()
        assert len(eng.follower_pids) == 1 and eng.follower_pids != pids
        f = eng.submit_generate(prompts[1], steps[1])
        assert np.array_equal(f.result(timeout=600).tokens,
                              dm.generate(prompts[1][None], steps[1])[0])
    finally:
        eng.close()


def _followers_of(pid: int) -> list[int]:
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().split(")")[-1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == pid and b"ddw_tpu_torch.serve.tp" in cmd:
            out.append(int(d))
    return out


@pytest.mark.slow
def test_tp_fleet_replica_death_supervisor_restarts_warm(tmp_path):
    """Two ProcessReplica(tp=2) children behind a Gateway serve sequential
    generate's tokens; SIGKILL child 0: its follower dies with it, the
    supervisor respawns the child with the same degree (and a new
    follower), the same tokens come out, and after the drain no follower
    of any child is left."""
    from ddw_tpu_torch.deploy import ProcessReplica
    from ddw_tpu_torch.gateway import Gateway, GatewayClient

    model_dir = _save_pkg(tmp_path / "pkg", seed=0, max_len=64)
    pkg = LMPackagedModel(model_dir, device="cpu")
    ref = [int(t) for t in pkg.generate(np.array([[1, 2, 3]]), 4)[0]]
    reps = [ProcessReplica(model_dir, replica_id=i,
                           engine_cfg={"n_slots": 2, "steps_per_tick": 2,
                                       "queue_depth": 16},
                           tp=2, warmup_lens=(4,), spawn_timeout_s=150.0,
                           device="cpu")
            for i in range(2)]
    assert all(r.tp == 2 for r in reps)
    gw = Gateway(reps, supervisor_kw={"poll_interval_s": 0.1,
                                      "backoff_base_s": 0.1,
                                      "backoff_max_s": 0.5, "jitter": 0.0})
    gw.start(warmup_prompt_lens=(4,))
    cli = GatewayClient("127.0.0.1", gw.port, timeout_s=90.0, max_retries=8)
    seen: set[int] = set()
    try:
        for _ in range(4):
            assert cli.generate([1, 2, 3], 4)["tokens"] == ref
        for r in gw.replica_set.replicas:
            fol = _followers_of(r._proc.pid)
            assert len(fol) == 1, fol
            seen.update(fol)
        victim = gw.replica_set.replicas[0]
        old = _followers_of(victim._proc.pid)
        base = gw.replica_set.restarts[0]
        victim._proc.kill()
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline:
            h0 = gw.replica_set.fleet_health()[0]
            if (gw.replica_set.restarts[0] > base and h0["state"] == "alive"
                    and h0["circuit"] == "closed"):
                break
            time.sleep(0.2)
        else:
            pytest.fail(f"TP replica 0 not restarted: "
                        f"{gw.replica_set.fleet_health()[0]}")
        assert (0, "killed", "restarted") in [
            (a.replica, a.kind, a.action) for a in gw.supervisor.attempts]
        assert not any(_alive(p) for p in old), old
        assert gw.replica_set.replicas[0].tp == 2
        seen.update(_followers_of(gw.replica_set.replicas[0]._proc.pid))
        assert cli.generate([1, 2, 3], 4)["tokens"] == ref
    finally:
        gw.drain(grace_s=10.0)
    deadline = time.monotonic() + 15.0
    while any(_alive(p) for p in seen) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert seen and not any(_alive(p) for p in seen), seen


@pytest.mark.slow
def test_kv_wire_between_any_tp_and_across_packages(pm, jpm):
    """Payloads are full-shape and ``tp`` on the wire is advisory: a
    tp=2 export round-trips through a tp=2 import bit for bit, lands in a
    tp=1 pool, and a tp=1 wire lands in a tp=2 pool; a ddw_tpu tp=2
    pool's wire lands in a port tp=2 pool and comes back out unchanged
    (test_kv_migration.py:213 across the packages)."""
    from ddw_tpu.serve.blocks import BlockPool as JaxBlockPool

    bs = 8
    (p,) = _prompts([2 * bs], seed=9)
    cfg = dict(kv_block_size=bs, kv_cache_blocks=8)
    engines = {name: ServingEngine(lm=pm, cfg=_cfg(tp=tp, **cfg))
               for name, tp in (("a2", 2), ("b2", 2), ("c1", 1), ("d2", 2))}
    try:
        a2 = engines["a2"].start()
        a2.submit_generate(p, 1).result(timeout=WAIT)
        wire = a2.kv_export(p)
        assert wire["tp"] == 2
        assert [s for s, _ in wire["leaves"]] == [[bs, 4, 8]] * 4
        b2, c1 = engines["b2"], engines["c1"]
        assert b2.kv_import(wire)["imported"] == 2
        assert b2.kv_export(p) == wire
        assert c1.kv_import(wire)["imported"] == 2
        w1 = c1.kv_export(p)
        assert w1.pop("tp") == 1 and dict(wire, tp=None) == dict(w1, tp=None)
        w1["tp"] = 1
        d2 = engines["d2"]
        assert d2.kv_import(w1)["imported"] == 2
        assert dict(d2.kv_export(p), tp=1) == w1
        # a ddw_tpu tp=2 pool's wire, into a fresh port tp=2 pool
        jmesh = JaxMesh(np.asarray(jax.devices()[:2]), (MODEL_AXIS,))
        jpool = JaxBlockPool(jpm.model, jpm.params, n_blocks=8,
                             block_size=bs, max_resident=2, steps_per_tick=1,
                             decode_buckets=False, mesh=jmesh)
        row, _ = jpool.admit(p, 2)
        jpool.prefill([row], p[None], np.asarray([p.size], np.int32),
                      np.zeros((1,), np.float32),
                      np.zeros((1, 2), np.uint32))
        jpool.register(row, p)
        jpool.note_prefilled(row)
        jpool.release(row)
        jwire = jpool.export_blocks(p)
        assert jwire["tp"] == 2
        d2.restart()
        assert d2.kv_import(jwire)["imported"] == 2
        assert d2.kv_export(p) == jwire
    finally:
        for eng in engines.values():
            eng.close()
