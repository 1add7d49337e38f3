"""LoRA under tensor parallelism in the port's serving engine on the CPU, in
f32, against ``ddw_tpu``'s tp=2 engines and the port's tp=1 engines.

- **a LoRA-built package** (all six targets, a seeded nonzero ``lora_b``)
  at ``tp=2`` serves the greedy tokens of ``ddw_tpu``'s tp=2 engine, of the
  port's tp=1 engine and of sequential ``generate``; every logit it picked
  from is within 1e-5 (of the largest) of tp=1's;
- **an adapter pool at tp=2** serves one heterogeneous batch (two adapters
  over all six targets and two base rows): the tokens of ``ddw_tpu``'s
  tp=2 adapter engine, of the port's tp=1 adapter engine and of
  ``generate`` over each adapter's merged params; its base rows' logits
  are bit-equal to an adapter-free tp=2 engine's; a third adapter that
  evicts one serves its own reference (the slot write reached the
  follower); the adapter engine's warmup makes exactly the adapter-free
  engine's group all-reduces (the row-parallel delta rides the existing
  sum);
- **the GQA fallback** (one K/V head at tp=2: K/V layers replicated, their
  deltas whole) serves tp=1's adapted tokens;
- ``slow``: a follower killed under an adapter engine fails the replica,
  and the restart's new follower receives the resident adapters with its
  weights; a ``ProcessReplica(tp=2)`` with an adapter pool behind a
  ``Gateway``, its adapters loaded and unloaded through ``/admin/adapters``;
  the speculative tick (an adapter-free draft) with adapter rows at tp=2
  equal to the spec-off tokens.

The engines at tp=2 share one follower process (a ``TPGroup`` whose mesh
they take), one engine running at a time. Packages are saved with
``ddw_tpu``'s ``save_lm_package``; adapters are ``ddw_tpu``-trained-shaped
trees with a seeded nonzero ``lora_b``. Every future is waited on with a
timeout.
"""

import functools
import os
import signal
import warnings
import zlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ddw_tpu.models.lora import merge_base_params
from ddw_tpu.serve import EngineCfg as JaxEngineCfg
from ddw_tpu.serve import ServingEngine as JaxServingEngine
from ddw_tpu.serve import adapters as jax_adapters
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.models.convert import (init_lm_weights,
                                          load_flax_variables,
                                          to_flax_variables)
from ddw_tpu_torch.models.lm import build_lm, generate
from ddw_tpu_torch.serve import EngineCfg, ReplicaFailed, ServingEngine
from ddw_tpu_torch.serve import tp as tp_mod
from ddw_tpu_torch.serving.lm_package import LMPackagedModel
from ddw_tpu_torch.utils.config import LMCfg

VOCAB = 64
WAIT = 300
TARGETS = ("query", "key", "value", "out", "fc1", "fc2")
BASE = dict(vocab_size=VOCAB, max_len=96, hidden=32, depth=2, num_heads=4,
            mlp_dim=64, dropout=0.0, dtype="float32")
LORA = dict(lora_rank=2, lora_alpha=4.0, lora_targets=TARGETS)
PROMPTS = [np.random.RandomState(3).randint(0, VOCAB, n).astype(np.int32)
           for n in (9, 14, 17, 11)]
STEPS = 8
HET = [None, "fin", "legal", None]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rand_b(node, seed, path=()):
    """A seeded nonzero lora_b per path (at init it is zero, and the adapted
    function the base's)."""
    if isinstance(node, dict):
        return {k: _rand_b(v, seed, path + (k,)) for k, v in node.items()}
    if path and path[-1] == "lora_b":
        rng = np.random.RandomState(
            (seed * 7919 + zlib.crc32("/".join(path).encode())) % 2**31)
        return (2.0 * rng.randn(*node.shape)).astype(np.float32)
    return np.asarray(node)


def _init(seed, **kw):
    """Seeded flax-layout weights drawn through the port (a flax init here
    takes seconds a model)."""
    return to_flax_variables(init_lm_weights(
        build_lm(LMCfg(**dict(BASE, **kw))),
        torch.Generator().manual_seed(seed)))["params"]


def _save(out_dir, seed=0, **kw):
    cfg = JaxLMCfg(**dict(BASE, **kw))
    params = _init(seed, **kw)
    if cfg.lora_rank:
        params = _rand_b(params, 5)
    return jax_lm_package.save_lm_package(str(out_dir), cfg, params,
                                          quantize=None)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_lora")
    return {"base": _save(root / "base"),
            "gqa": _save(root / "gqa", num_kv_heads=1),
            "lora": _save(root / "lora", **LORA)}


@pytest.fixture(scope="module")
def group():
    """One follower process for every tp=2 engine of the module."""
    g = tp_mod.TPGroup(2, "cpu")
    yield g
    g.close()


@functools.cache
def _adapters(pkg_dir):
    """{name: (merged flax params, adapter tree)}: three adapters over all
    six targets of the package's backbone (rank 2, alpha 4)."""
    jpm = jax_lm_package.load_lm_package(pkg_dir)
    kv = jpm.lm_cfg.num_kv_heads
    out = {}
    for name, seed in (("fin", 1), ("legal", 2), ("med", 3)):
        params = _rand_b(merge_base_params(
            _init(seed, num_kv_heads=kv, **LORA), jpm.params), seed)
        out[name] = (params, jax_adapters.extract_adapter(params))
    return out


@functools.cache
def _merged(pkg_dir, name):
    jpm = jax_lm_package.load_lm_package(pkg_dir)
    cfg = LMCfg(**dict(BASE, num_kv_heads=jpm.lm_cfg.num_kv_heads, **LORA))
    return load_flax_variables(
        build_lm(cfg), {"params": _adapters(pkg_dir)[name][0]}).eval()


def _ref(pkg_dir, name, p, pm):
    model = pm.model if name is None else _merged(pkg_dir, name)
    return generate(model, torch.from_numpy(p[None]).long(), STEPS)[0].numpy()


def _cfg(cls=EngineCfg, **kw):
    return cls(**dict(dict(n_slots=2, max_resident=4, steps_per_tick=2,
                           decode_buckets=False, default_timeout_s=600.0),
                      **kw))


def _run(eng, names, prompts=PROMPTS, load=("fin", "legal"), pkg_dir=None,
         record=None):
    """Load ``load`` (from ``pkg_dir``'s adapters), submit every request
    before the loop starts (so two engines schedule alike), and return the
    tokens."""
    for name in load:
        eng.load_adapter(name, adapter=_adapters(pkg_dir)[name][1],
                         alpha=4.0, rank=2)
    if record is not None:
        eng.pool.record_logits = record
    futs = [eng.submit_generate(p, STEPS, adapter_id=a)
            for p, a in zip(prompts, names)]
    eng.start()
    try:
        return [f.result(timeout=WAIT).tokens for f in futs]
    finally:
        eng.pool.record_logits = None


def _pool_clean(eng):
    pool = eng.pool
    g = pool.gauges()
    assert g["resident_streams"] == 0 and g["blocks_used"] == 0, g
    assert int(pool._ref.sum()) == 0 and pool._committed == 0
    if eng.adapters is not None:
        assert eng.adapters.gauges()["serve.adapter.pins_inflight"] == 0


# -- a LoRA-built package ----------------------------------------------------

def test_lora_built_package_at_tp2_equals_jax_tp1_and_generate(dirs, group):
    """The LoRA leaves stay whole on both ranks and each layer computes
    with its block of them: tp=2's greedy tokens are ddw_tpu's tp=2
    engine's, tp=1's and generate's, and its logits within 1e-5 of tp=1's
    at every pick."""
    pm = LMPackagedModel(dirs["lora"], device="cpu")
    refs = [_ref(None, None, p, pm) for p in PROMPTS]
    jpm = jax_lm_package.load_lm_package(dirs["lora"])
    with JaxServingEngine(lm=jpm, cfg=_cfg(JaxEngineCfg, tp=2)) as jeng:
        jax_tokens = [f.result(timeout=WAIT).tokens for f in [
            jeng.submit_generate(p, STEPS) for p in PROMPTS]]
    out, logits = {}, {1: [], 2: []}
    for tp in (1, 2):
        eng = ServingEngine(lm=pm, cfg=_cfg(),
                            mesh=group.mesh if tp == 2 else None)
        assert eng.tp_degree == tp
        if tp == 2:
            q = eng.pool.model.backbone_block0.attn.query
            assert tuple(q.lora_b.shape) == (2, 4, 8)   # whole
            assert q.tp_split == (1, 0, 2)
        try:
            out[tp] = _run(eng, [None] * 4, load=(), record=logits[tp])
            _pool_clean(eng)
        finally:
            eng.stop()
    for i, ref in enumerate(refs):
        for got in (out[1][i], out[2][i], jax_tokens[i]):
            np.testing.assert_array_equal(got, ref)
    assert len(logits[1]) == len(logits[2]) > 0
    for a, b in zip(logits[1], logits[2]):
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= 1e-5 * float(np.abs(a).max())


# -- adapter pools at tp=2 ---------------------------------------------------

@functools.cache
def _jax_het_tokens(pkg_dir):
    jpm = jax_lm_package.load_lm_package(pkg_dir)
    cfg = _cfg(JaxEngineCfg, tp=2, adapter_slots=2, adapter_rank=4)
    with JaxServingEngine(lm=jpm, cfg=cfg) as eng:
        for name in ("fin", "legal"):
            eng.load_adapter(name, adapter=_adapters(pkg_dir)[name][1],
                             alpha=4.0, rank=2)
        futs = [eng.submit_generate(p, STEPS, adapter_id=a)
                for p, a in zip(PROMPTS, HET)]
        return [f.result(timeout=WAIT).tokens for f in futs]


def _count_all_reduces(fn) -> int:
    """The group all-reduces ``fn`` makes in this process (rank 0)."""
    calls = []
    real = dist.all_reduce
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dist, "all_reduce",
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        fn()
    return len(calls)


def test_adapter_pool_at_tp2_equals_jax_tp1_and_merged_generate(dirs, group):
    """One heterogeneous batch (fin, legal, two base rows; all six targets)
    at tp=2: each row's greedy tokens equal ddw_tpu's tp=2 adapter
    engine's, the port's tp=1 adapter engine's and generate over the
    merged params (the base package for base rows). Each rank's stacks
    hold its block (query's B on half the heads, out's A on half). Base
    rows' logits are bit-equal to an adapter-free tp=2 engine's at every
    decode step. The adapter engine's warmup makes exactly as many group
    all-reduces as the adapter-free engine's. A third adapter evicts the
    least recently used one and serves its own merged reference."""
    pkg = dirs["base"]
    pm = LMPackagedModel(pkg, device="cpu")
    refs = [_ref(pkg, a, p, pm) for p, a in zip(PROMPTS, HET)]
    ad_cfg = _cfg(adapter_slots=2, adapter_rank=4)
    eng1 = ServingEngine(lm=pm, cfg=ad_cfg)
    try:
        tp1 = _run(eng1, HET, pkg_dir=pkg)
    finally:
        eng1.stop()
    rec = {"adapters": [], "plain": []}
    reduces = {}
    plain = ServingEngine(lm=pm, cfg=_cfg(), mesh=group.mesh)
    try:
        reduces["plain"] = _count_all_reduces(lambda: plain.warmup([16]))
        _run(plain, [None] * 4, load=(), record=rec["plain"])
    finally:
        plain.stop()
    eng = ServingEngine(lm=pm, cfg=ad_cfg, mesh=group.mesh)
    try:
        stacks = eng.adapters.stacks()["backbone_block0"]
        assert tuple(stacks["query"][1].shape) == (3, 4, 2, 8)
        assert tuple(stacks["out"][0].shape) == (3, 2, 8, 4)
        assert tuple(stacks["fc2"][1].shape) == (3, 4, 32)
        reduces["adapters"] = _count_all_reduces(lambda: eng.warmup([16]))
        tp2 = _run(eng, HET, pkg_dir=pkg, record=rec["adapters"])
        _pool_clean(eng)
        eng.stop()
        # a third adapter evicts the LRU one: one slot write, which must
        # reach the follower for med's rows to come out right
        before = eng.pool.stats["tp_dispatches"]
        eng.load_adapter("med", adapter=_adapters(pkg)["med"][1],
                         alpha=4.0, rank=2)
        assert eng.pool.stats["tp_dispatches"] == before + 1
        assert eng.adapters.loaded() == ("legal", "med")
        eng.start()
        med = [eng.submit_generate(p, STEPS, adapter_id="med")
               for p in PROMPTS[:2]]
        med = [f.result(timeout=WAIT).tokens for f in med]
        eng.stop()
        before = eng.pool.stats["tp_dispatches"]
        eng.unload_adapter("med")
        assert eng.pool.stats["tp_dispatches"] == before + 1
        _pool_clean(eng)
    finally:
        eng.stop()
    jax_tokens = _jax_het_tokens(pkg)
    for i, ref in enumerate(refs):
        for got in (tp2[i], tp1[i], jax_tokens[i]):
            np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(refs[1], _ref(pkg, "legal", PROMPTS[1], pm))
    for p, got in zip(PROMPTS[:2], med):
        np.testing.assert_array_equal(got, _ref(pkg, "med", p, pm))
    assert reduces["adapters"] == reduces["plain"] > 0, reduces
    # rows 0 and 3 are the base rows (four requests admitted at once take
    # rows 0-3); the decode ticks hold all four rows
    decode = [(a, b) for a, b in zip(rec["adapters"], rec["plain"])
              if a.shape[0] == 4]
    assert len(rec["adapters"]) == len(rec["plain"]) and decode
    for a, b in decode:
        assert np.array_equal(a[[0, 3]], b[[0, 3]])
        assert not np.array_equal(a[1], b[1])


def test_gqa_fallback_adapters_at_tp2_equal_tp1(dirs, group):
    """One K/V head at tp=2: K/V replicate and their adapter deltas stay
    whole (the stacks too), query's and the MLP's split; adapted and base
    tokens equal tp=1's and generate's."""
    pkg = dirs["gqa"]
    pm = LMPackagedModel(pkg, device="cpu")
    refs = [_ref(pkg, a, p, pm) for p, a in zip(PROMPTS, HET)]
    out = {}
    for tp in (1, 2):
        with warnings.catch_warnings():     # the fallback's warning
            warnings.simplefilter("ignore", RuntimeWarning)
            eng = ServingEngine(lm=pm, cfg=_cfg(adapter_slots=2,
                                                adapter_rank=2),
                                mesh=group.mesh if tp == 2 else None)
        try:
            if tp == 2:
                st = eng.adapters.stacks()["backbone_block1"]
                assert tuple(st["key"][1].shape) == (3, 2, 1, 8)
                assert tuple(st["query"][1].shape) == (3, 2, 2, 8)
            out[tp] = _run(eng, HET, pkg_dir=pkg)
            _pool_clean(eng)
        finally:
            eng.stop()
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(out[1][i], ref)
        np.testing.assert_array_equal(out[2][i], ref)


# -- tier-2 drills ------------------------------------------------------------

@pytest.mark.slow
def test_adapters_stay_resident_through_a_new_follower(dirs):
    """A follower killed under an adapter engine fails the replica; the
    restart starts a new follower, which receives its blocks of every
    resident adapter with its weights: adapted tokens come out as
    before."""
    pkg = dirs["base"]
    pm = LMPackagedModel(pkg, device="cpu")
    eng = ServingEngine(lm=pm, cfg=_cfg(tp=2, adapter_slots=2,
                                        adapter_rank=2))
    try:
        before = _run(eng, HET[:3], PROMPTS[:3], pkg_dir=pkg)
        pids = eng.follower_pids
        os.kill(pids[0], signal.SIGKILL)
        with pytest.raises(ReplicaFailed):
            eng.submit_generate(PROMPTS[0], 4).result(timeout=60)
        eng.restart()
        assert eng.follower_pids != pids
        assert eng.adapters.loaded() == ("fin", "legal")
        futs = [eng.submit_generate(p, STEPS, adapter_id=a)
                for p, a in zip(PROMPTS[:3], HET[:3])]
        after = [f.result(timeout=WAIT).tokens for f in futs]
        _pool_clean(eng)
    finally:
        eng.close()
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_process_replica_tp2_adapters_behind_the_gateway(dirs, tmp_path):
    """A ProcessReplica(tp=2) child with an adapter pool behind a Gateway:
    an adapter loaded through /admin/adapters serves its merged reference
    over HTTP beside base requests, the registry lists it, and it unloads
    clean."""
    from ddw_tpu_torch.deploy import ProcessReplica
    from ddw_tpu_torch.gateway import Gateway, GatewayClient
    from ddw_tpu_torch.serve.adapters import save_adapter

    pkg = dirs["base"]
    pm = LMPackagedModel(pkg, device="cpu")
    apath = str(tmp_path / "fin.npz")
    save_adapter(apath, _adapters(pkg)["fin"][1], rank=2, alpha=4.0)
    rep = ProcessReplica(pkg, replica_id=0, tp=2, device="cpu",
                         engine_cfg={"n_slots": 2, "steps_per_tick": 2,
                                     "adapter_slots": 2, "adapter_rank": 2},
                         warmup_lens=(16,), spawn_timeout_s=150.0)
    gw = Gateway([rep])
    gw.start(warmup_prompt_lens=(16,))
    cli = GatewayClient("127.0.0.1", gw.port, timeout_s=90.0)
    try:
        assert cli.adapters(op="load", adapter_id="fin", path=apath)
        assert "fin" in cli.adapters(op="list")["replicas"]["0"]["adapters"]
        for p in PROMPTS[:2]:
            got = cli.generate(p.tolist(), STEPS, adapter_id="fin")["tokens"]
            assert got == _ref(pkg, "fin", p, pm).tolist()
            base = cli.generate(p.tolist(), STEPS)["tokens"]
            assert base == _ref(pkg, None, p, pm).tolist()
        cli.adapters(op="unload", adapter_id="fin")
        assert cli.adapters(op="list")["registry"] == {}
    finally:
        gw.drain(grace_s=10.0)


@pytest.mark.slow
def test_spec_tick_with_adapter_rows_at_tp2_equals_spec_off(dirs, group,
                                                           tmp_path):
    """The speculative tick at tp=2 with adapter rows in the verify pass
    (the draft's pool has no adapters, as at tp=1): every row's tokens
    equal the spec-off tokens, which equal the merged references."""
    pkg = dirs["base"]
    pm = LMPackagedModel(pkg, device="cpu")
    dm = LMPackagedModel(_save(tmp_path / "draft", seed=7), device="cpu")
    refs = [_ref(pkg, a, p, pm) for p, a in zip(PROMPTS, HET)]
    out = {}
    for k in (0, 3):
        eng = ServingEngine(lm=pm, cfg=_cfg(adapter_slots=2, adapter_rank=2,
                                            spec_k=k),
                            draft=dm if k else None, mesh=group.mesh)
        try:
            out[k] = _run(eng, HET, pkg_dir=pkg)
            if k:
                assert eng._draft_pool.tp_degree == 2
                assert eng._draft_pool._adapters is None
                assert eng.snapshot()["serve.spec_proposed"] > 0
            _pool_clean(eng)
        finally:
            eng.stop()
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(out[3][i], out[0][i])
        np.testing.assert_array_equal(out[3][i], ref)
