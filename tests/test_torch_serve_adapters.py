"""Heterogeneous LoRA adapters in the PyTorch port's serving engine
(``ddw_tpu_torch.models.lora.row_lora_delta``, ``ddw_tpu_torch.serve.
adapters``, ``ServingEngine(adapter_slots=...)``) on the CPU in f32,
mirroring ``tests/test_adapters.py`` and ``tests/test_lora.py``:
``row_lora_delta`` against ``ddw_tpu``'s; the pool's pins, LRU eviction and
refusals; ``adapter_digest`` equal to ``ddw_tpu``'s and ``.npz`` files that
cross both ways; a heterogeneous batch (two adapters and base rows) whose
greedy tokens equal ``ddw_tpu``'s engine and the port's merged-LoRA
sequential ``generate``; base rows equal to an adapter-free engine; salted
prefixes that never cross-hit; load/evict cycles that leak nothing; and
identity with adapter rows in flight through preemption and the
speculative tick. The adapters are ``ddw_tpu``-trained-shaped trees with a
seeded nonzero ``lora_b``."""

import dataclasses
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.models.lora import merge_base_params
from ddw_tpu.models.lora import row_lora_delta as jax_row_lora_delta
from ddw_tpu.serve import EngineCfg as JaxEngineCfg
from ddw_tpu.serve import ServingEngine as JaxServingEngine
from ddw_tpu.serve import adapters as jax_adapters
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.models.convert import load_flax_variables
from ddw_tpu_torch.models.lm import build_lm, generate
from ddw_tpu_torch.models.lora import row_lora_delta
from ddw_tpu_torch.serve import BlockPool, EngineCfg, ServingEngine
from ddw_tpu_torch.serve.adapters import (AdapterDigestMismatch,
                                          AdapterError, AdapterPool,
                                          AdapterPoolFull, UnknownAdapter,
                                          adapter_digest, extract_adapter,
                                          load_adapter, save_adapter)
from ddw_tpu_torch.serving.lm_package import LMPackagedModel
from ddw_tpu_torch.utils.config import LMCfg

VOCAB = 64
TARGETS = ("query", "value", "fc1")
BASE = dict(vocab_size=VOCAB, max_len=96, hidden=32, depth=2, num_heads=2,
            mlp_dim=64, dropout=0.0, dtype="float32")
WAIT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _save(out_dir, seed=0):
    cfg = JaxLMCfg(**BASE)
    params = jax_build_lm(cfg).init({"params": jax.random.PRNGKey(seed)},
                                    np.zeros((1, 8), np.int32))["params"]
    return jax_lm_package.save_lm_package(str(out_dir), cfg, params,
                                          quantize=None)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("adapters")
    return _save(root / "target", 0), _save(root / "draft", 7)


@pytest.fixture(scope="module")
def pm(dirs):
    return LMPackagedModel(dirs[0], device="cpu")


def _rand_b(node, seed, path=()):
    """A seeded nonzero lora_b per path: at init lora_b is zero and the
    adapted function equals the base, which would make identity vacuous."""
    if isinstance(node, dict):
        return {k: _rand_b(v, seed, path + (k,)) for k, v in node.items()}
    if path and path[-1] == "lora_b":
        rng = np.random.RandomState(
            (seed * 7919 + zlib.crc32("/".join(path).encode())) % 2**31)
        return (2.0 * rng.randn(*node.shape)).astype(np.float32)
    return np.asarray(node)


@functools.cache
def _lora(pkg_dir):
    """{name: (merged flax params, adapter tree)} — two adapters with
    different weights over the package's backbone (rank 2, alpha 4)."""
    jpm = jax_lm_package.load_lm_package(pkg_dir)
    lcfg = dataclasses.replace(jpm.lm_cfg, lora_rank=2, lora_alpha=4.0,
                               lora_targets=TARGETS)
    lmodel = jax_build_lm(lcfg)
    out = {}
    for name, seed in (("fin", 1), ("legal", 2)):
        lparams = lmodel.init({"params": jax.random.PRNGKey(seed)},
                              np.zeros((1, 8), np.int32))["params"]
        lparams = _rand_b(merge_base_params(lparams, jpm.params), seed)
        out[name] = (lparams, jax_adapters.extract_adapter(lparams))
    return out


@pytest.fixture(scope="module")
def ads(dirs):
    return _lora(dirs[0])


@functools.cache
def _merged_model(pkg_dir, name):
    """The port's LoRA LM over ``name``'s merged params: the sequential
    reference an adapter row must reproduce."""
    lparams = _lora(pkg_dir)[name][0]
    cfg = LMCfg(**dict(BASE, lora_rank=2, lora_alpha=4.0,
                       lora_targets=TARGETS))
    return load_flax_variables(build_lm(cfg), {"params": lparams}).eval()


def _ref(pkg_dir, name, p, n):
    return generate(_merged_model(pkg_dir, name),
                    torch.from_numpy(p[None, :]).long(), n)[0].numpy()


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=(n,)).astype(np.int32)
            for n in lengths]


def _pool_clean(pool: BlockPool) -> None:
    g = pool.gauges()
    assert g["resident_streams"] == 0
    assert g["blocks_used"] == 0, g
    assert g["blocks_free"] + g["blocks_cached"] == g["blocks_total"], g
    assert int(pool._ref.sum()) == 0
    assert pool._committed == 0
    assert pool.free_slots == pool.max_resident


def _engine(pm, ads, draft=None, **kw):
    cfg = EngineCfg(**dict(dict(n_slots=4, steps_per_tick=2,
                                default_timeout_s=600.0, adapter_slots=2,
                                adapter_rank=4), **kw))
    eng = ServingEngine(lm=pm, cfg=cfg, draft=draft)
    for name, (_, ad) in ads.items():
        eng.load_adapter(name, adapter=ad, alpha=4.0, rank=2)
    return eng


# -- the per-row delta -------------------------------------------------------

@pytest.mark.parametrize("cn", [1, 2])
def test_row_lora_delta_matches_jax(cn):
    """Each row's delta from its own (A, B): f32 within 1e-5 of
    ddw_tpu's (both contract in f32; only the summation order differs); a
    zero B row gives exactly +0.0."""
    rng = np.random.RandomState(cn)
    ins = (6,) if cn == 1 else (2, 3)
    x = rng.randn(3, 5, *ins).astype(np.float32)
    a = rng.randn(3, *ins, 4).astype(np.float32)
    b = rng.randn(3, 4, 7).astype(np.float32)
    b[1] = 0.0
    want = np.asarray(jax_row_lora_delta(jnp.asarray(x), jnp.asarray(a),
                                         jnp.asarray(b), cn))
    got = row_lora_delta(torch.from_numpy(x), torch.from_numpy(a),
                         torch.from_numpy(b), cn).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.array_equal(got[1], np.zeros_like(got[1]))


# -- AdapterPool unit surface ------------------------------------------------

def test_pool_pin_refcounts_lru_eviction_and_refusals(pm, ads):
    """Slots evict LRU among UNPINNED adapters only; a fully pinned pool
    refuses new loads; unload refuses while pinned; pin/unpin keep exact
    refcounts (underflow is an error, unknown ids are UnknownAdapter)."""
    fin, legal = ads["fin"][1], ads["legal"][1]
    pool = AdapterPool(pm.model, slots=2, rank=2, targets=TARGETS)
    assert pool.load("fin", fin, alpha=4.0) == 1
    assert pool.load("legal", legal, alpha=4.0) == 2
    assert pool.load("fin", fin, alpha=4.0) == 1     # idempotent re-land
    assert pool.loads == 2
    assert pool.lru_order() == ("legal", "fin")
    assert pool.pin("legal") == 2                     # pin refreshes LRU
    assert pool.lru_order() == ("fin", "legal")
    pool.pin("fin")
    with pytest.raises(AdapterPoolFull):
        pool.load("third", fin, alpha=4.0)            # every slot pinned
    with pytest.raises(AdapterError, match="pins"):
        pool.unload("fin")                            # in-flight: refused
    pool.unpin("fin")
    assert pool.load("third", fin, alpha=4.0) == 1    # evicts fin (LRU)
    assert pool.evictions == 1
    assert pool.loaded() == ("legal", "third")
    with pytest.raises(UnknownAdapter) as ei:
        pool.pin("fin")
    assert ei.value.adapter_id == "fin"
    assert set(ei.value.loaded) == {"legal", "third"}
    pool.unpin("legal")
    pool.unpin("fin")                                 # post-evict unpin: noop
    with pytest.raises(AdapterError, match="underflow"):
        pool.unpin("legal")
    g = pool.gauges()
    assert g["serve.adapter.pins_inflight"] == 0
    assert g["serve.adapter.slots_used"] == 2
    # the stacks hold B pre-scaled by alpha / rank, zero-padded to the
    # pool rank; an evicted slot is all zeros again
    a, b = pool.stacks()["backbone_block0"]["query"]
    np.testing.assert_allclose(
        b[1].numpy(), fin["backbone_block0"]["query"]["lora_b"] * 2.0)
    pool.unload("third")
    assert not a[1].any() and not b[1].any()


def test_digest_equals_jax_and_files_cross_both_ways(pm, ads, dirs,
                                                    tmp_path):
    """The digest is ddw_tpu's hex for the same numpy leaves; a file saved
    by either package loads in the other with its header; the same id with
    other bytes, a wrong supplied digest and a tampered file are
    refused."""
    fin, legal = ads["fin"][1], ads["legal"][1]
    assert adapter_digest(fin) == jax_adapters.adapter_digest(fin)
    assert adapter_digest(legal) == jax_adapters.adapter_digest(legal)
    # extract_adapter over the port's own LoRA module gives the same tree
    ported = extract_adapter(_merged_model(dirs[0], "fin"))
    assert adapter_digest(ported) == adapter_digest(fin)
    p_port, p_jax = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    dg = save_adapter(p_port, fin, rank=2, alpha=4.0, meta={"v": 1})
    assert jax_adapters.save_adapter(p_jax, fin, rank=2, alpha=4.0,
                                     meta={"v": 1}) == dg
    for path in (p_port, p_jax):
        for loader in (load_adapter, jax_adapters.load_adapter):
            back, info = loader(path)
            assert (info["digest"], info["rank"], info["alpha"],
                    info["meta"]) == (dg, 2, 4.0, {"v": 1})
            assert adapter_digest(back) == dg
    pool = AdapterPool(pm.model, slots=2, rank=2, targets=TARGETS)
    pool.load("fin", fin, alpha=4.0)
    with pytest.raises(AdapterDigestMismatch):
        pool.load("fin", legal, alpha=4.0)           # same id, new bytes
    with pytest.raises(AdapterDigestMismatch):
        pool.load("legal", legal, alpha=4.0, digest="0" * 64)
    assert pool.salt_of("fin") == bytes.fromhex(dg)
    with np.load(p_jax) as z:
        arrays = {k: z[k] for k in z.files}
    victim = next(k for k in arrays if k.endswith("lora_b"))
    arrays[victim] = arrays[victim] + 1.0
    np.savez(p_jax, **arrays)
    with pytest.raises(AdapterDigestMismatch):
        load_adapter(p_jax)


# -- heterogeneous batched decode --------------------------------------------

HET_PROMPTS = _prompts([9, 14, 17, 11], seed=3)
HET_ADAPTERS = [None, "fin", "legal", None]


@functools.cache
def _jax_het_tokens(pkg_dir):
    """ddw_tpu's adapter engine over the same batch (built once)."""
    jpm = jax_lm_package.load_lm_package(pkg_dir)
    cfg = JaxEngineCfg(n_slots=4, steps_per_tick=2, default_timeout_s=600.0,
                       adapter_slots=2, adapter_rank=4)
    with JaxServingEngine(lm=jpm, cfg=cfg) as eng:
        for name, (_, ad) in _lora(pkg_dir).items():
            eng.load_adapter(name, adapter=ad, alpha=4.0, rank=2)
        futs = [eng.submit_generate(p, 8, adapter_id=a)
                for p, a in zip(HET_PROMPTS, HET_ADAPTERS)]
        return [f.result(timeout=WAIT).tokens for f in futs]


def test_heterogeneous_batch_equals_jax_and_sequential(pm, ads, dirs):
    """One decode batch holding fin + legal + two base rows: each row's
    greedy tokens equal ddw_tpu's adapter engine, and the port's
    sequential generate over the merged LoRA params (adapter rows) or the
    base package (base rows); a file-loaded adapter serves the same."""
    refs = [pm.generate(p[None, :], 8)[0] if a is None
            else _ref(dirs[0], a, p, 8)
            for p, a in zip(HET_PROMPTS, HET_ADAPTERS)]
    with _engine(pm, ads) as eng:
        futs = [eng.submit_generate(p, 8, adapter_id=a)
                for p, a in zip(HET_PROMPTS, HET_ADAPTERS)]
        got = [f.result(timeout=WAIT).tokens for f in futs]
        assert eng.adapters.gauges()["serve.adapter.pins_inflight"] == 0
        _pool_clean(eng.pool)
    for i, (g, r) in enumerate(zip(got, refs)):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, _jax_het_tokens(dirs[0])[i])
    # the adapters genuinely steered their rows
    assert not np.array_equal(refs[1], _ref(dirs[0], "legal",
                                            HET_PROMPTS[1], 8))


def test_base_rows_equal_an_adapter_free_engine(pm, ads, tmp_path):
    """Slot 0's null adapter adds exactly +0.0: base rows beside adapter
    rows give the adapter-free engine's tokens, greedy and seeded; an
    adapter loaded from its .npz serves the in-memory adapter's tokens."""
    path = str(tmp_path / "fin.npz")
    save_adapter(path, ads["fin"][1], rank=2, alpha=4.0)

    def run(eng):
        futs = [eng.submit_generate(p, 8, adapter_id=a,
                                    temperature=0.7 if i == 3 else 0.0,
                                    rng=torch.Generator().manual_seed(11))
                for i, (p, a) in enumerate(zip(HET_PROMPTS, HET_ADAPTERS))]
        return [f.result(timeout=WAIT).tokens for f in futs]

    with _engine(pm, ads) as eng:
        mixed = run(eng)
    with ServingEngine(lm=pm, cfg=EngineCfg(n_slots=4, steps_per_tick=2,
                                            default_timeout_s=600.0)) as eng:
        futs = [eng.submit_generate(p, 8, temperature=0.7 if i == 3 else 0.0,
                                    rng=torch.Generator().manual_seed(11))
                for i, p in enumerate(HET_PROMPTS)]
        plain = [f.result(timeout=WAIT).tokens for f in futs]
    for i in (0, 3):
        np.testing.assert_array_equal(mixed[i], plain[i])
    cfg = EngineCfg(n_slots=4, steps_per_tick=2, adapter_slots=1,
                    adapter_rank=2, default_timeout_s=600.0)
    with ServingEngine(lm=pm, cfg=cfg) as eng:
        res = eng.load_adapter("fin", path=path)
        assert res["digest"] == adapter_digest(ads["fin"][1])
        got = eng.generate(HET_PROMPTS[1], 8, adapter_id="fin").tokens
    np.testing.assert_array_equal(got, mixed[1])


def test_adapter_salted_prefix_never_cross_hits(pm, ads):
    """The same prompt under base, fin and legal never shares KV: the chain
    hash is seeded with the adapter digest. A same-adapter repeat still
    hits its own salted chain."""
    (p,) = _prompts([32], seed=4)
    with _engine(pm, ads) as eng:
        def hits():
            return eng.snapshot()["serve.prefix_hit_tokens"]

        eng.generate(p, 4)                           # seeds base chains
        h0 = hits()
        eng.generate(p, 4, adapter_id="fin")
        assert hits() == h0                          # no base->fin hit
        eng.generate(p, 4, adapter_id="legal")
        assert hits() == h0                          # no fin->legal hit
        eng.generate(p, 4, adapter_id="fin")
        assert hits() > h0                           # own salted chain
        h1 = hits()
        eng.generate(p, 4)                           # base still hits base
        assert hits() > h1
        _pool_clean(eng.pool)


def test_unknown_adapter_is_refused_with_no_leak(pm, ads):
    (p,) = _prompts([8], seed=5)
    with _engine(pm, ads) as eng:
        with pytest.raises(UnknownAdapter) as ei:
            eng.submit_generate(p, 4, adapter_id="nope")
        assert ei.value.adapter_id == "nope"
        assert set(ei.value.loaded) == {"fin", "legal"}
        assert eng.adapters.gauges()["serve.adapter.pins_inflight"] == 0
        assert eng.health()["queue_depth"] == 0
        eng.generate(p, 4, adapter_id="fin")
        assert eng.snapshot()["serve.adapter_pins"] == 1.0
        _pool_clean(eng.pool)
    with ServingEngine(lm=pm) as eng:                # adapters off
        with pytest.raises(UnknownAdapter):
            eng.submit_generate(p, 4, adapter_id="fin")
        with pytest.raises(ValueError, match="adapter pool"):
            eng.load_adapter("fin", adapter=ads["fin"][1])
        assert eng.adapter_view() == {}


def test_hot_load_evict_cycles_leak_nothing(pm, ads):
    """Load -> serve -> unload cycles (explicit and LRU-evicted) across a
    1-slot pool return every block, slot and pin to baseline, the churn
    visible in the engine counters."""
    fin, legal = ads["fin"][1], ads["legal"][1]
    cfg = EngineCfg(n_slots=2, steps_per_tick=2, default_timeout_s=600.0,
                    adapter_slots=1, adapter_rank=2)
    (p,) = _prompts([10], seed=6)
    with ServingEngine(lm=pm, cfg=cfg) as eng:
        for _ in range(2):
            eng.load_adapter("fin", adapter=fin, alpha=4.0, rank=2)
            eng.generate(p, 4, adapter_id="fin")
            eng.unload_adapter("fin")                  # explicit evict
            eng.load_adapter("legal", adapter=legal, alpha=4.0, rank=2)
            eng.generate(p, 4, adapter_id="legal")
            eng.load_adapter("fin", adapter=fin, alpha=4.0, rank=2)
            # ^ 1 slot: LRU-evicts legal in place
        snap = eng.snapshot()
        g = eng.adapters.gauges()
        view = eng.adapter_view()
        _pool_clean(eng.pool)
    assert snap["serve.adapter_loads"] == 5.0   # cycle 2's first load is a
    #                                             re-land of a resident fin
    assert snap["serve.adapter_evictions"] == 2.0      # the LRU ones only
    assert snap["serve.adapter_pins"] == 4.0
    assert g["serve.adapter.pins_inflight"] == 0
    assert g["serve.adapter.slots_used"] == 1
    assert list(view["adapters"]) == ["fin"]


def test_preemption_and_spec_identity_with_adapter_rows(pm, ads, dirs):
    """Out-of-blocks preemption with adapter rows in the batch, and the
    speculative tick with adapter rows in the verify pass (the draft pool
    carries no adapters): every row resumes / verifies to its sequential
    tokens; pins survive recompute; nothing leaks."""
    prompts = _prompts([30, 31, 33, 34], seed=17)
    names = [None, None, "fin", "legal"]
    steps = 30
    refs = [pm.generate(p[None, :], steps)[0] if a is None
            else _ref(dirs[0], a, p, steps) for p, a in zip(prompts, names)]
    with _engine(pm, ads, n_slots=2, steps_per_tick=4, kv_cache_blocks=12,
                 max_resident=4, block_overcommit=3.0,
                 adapter_rank=2) as eng:
        futs = [eng.submit_generate(p, steps, adapter_id=a)
                for p, a in zip(prompts, names)]
        out = [f.result(timeout=WAIT).tokens for f in futs]
        snap = eng.snapshot()
        assert eng.adapters.gauges()["serve.adapter.pins_inflight"] == 0
        _pool_clean(eng.pool)
    assert snap["serve.preemptions"] > 0, "overcommit never ran out"
    for o, r in zip(out, refs):
        np.testing.assert_array_equal(o, r)
    dm = LMPackagedModel(dirs[1], device="cpu")
    with _engine(pm, ads, n_slots=3, spec_k=3, decode_buckets=False,
                 draft=dm) as eng:
        futs = [eng.submit_generate(p[:12], 9, adapter_id=a)
                for p, a in zip(prompts[1:], names[1:])]
        out = [f.result(timeout=WAIT).tokens for f in futs]
        snap = eng.snapshot()
        _pool_clean(eng.pool)
        _pool_clean(eng._draft_pool)
    assert snap["serve.spec_proposed"] > 0
    for o, p, a in zip(out, prompts[1:], names[1:]):
        want = (pm.generate(p[None, :12], 9)[0] if a is None
                else _ref(dirs[0], a, p[:12], 9))
        np.testing.assert_array_equal(o, want)
