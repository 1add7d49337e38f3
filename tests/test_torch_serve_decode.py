"""The LM's serving decode modes in the PyTorch port
(``ddw_tpu_torch.models.lm``: ``slot_decode`` over ``init_slot_cache``,
``paged_decode`` over ``init_paged_cache``) against ``ddw_tpu`` on the CPU,
driven through both packages' pools with the same seeded numpy inputs:
f32 logits within 1e-5 of max |ref| and equal greedy tokens; inside the
port, paged decode equal to the contiguous path bit for bit with the same
``tiles_computed``; the per-row (slot) and per-query (paged) NaN poison."""

import functools

import jax
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.serve.blocks import BlockPool as JaxBlockPool
from ddw_tpu.serve.slots import SlotPool as JaxSlotPool
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.models.convert import load_flax_variables
from ddw_tpu_torch.models.lm import (build_lm, init_cache, init_paged_cache,
                                     init_slot_cache)
from ddw_tpu_torch.serve.blocks import BlockPool
from ddw_tpu_torch.serve.slots import SlotPool
from ddw_tpu_torch.utils.config import LMCfg

VOCAB = 48
BASE = dict(vocab_size=VOCAB, max_len=64, hidden=32, depth=2, num_heads=4,
            mlp_dim=64, dropout=0.0, dtype="float32")
VARIANTS = {"learned": {}, "rope": {"pos_encoding": "rope"},
            "gqa": {"num_kv_heads": 2}}
TOL = 1e-5          # of max |ref|, f32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread is fastest, and the test workers
    share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.cache
def _pair(variant="learned", max_len=64):
    cfg = dict(BASE, max_len=max_len, **VARIANTS[variant])
    jm = jax_build_lm(JaxLMCfg(**cfg))
    params = jm.init({"params": jax.random.PRNGKey(3)},
                     np.zeros((1, 8), np.int32))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    tm = load_flax_variables(build_lm(LMCfg(**cfg)), {"params": params})
    return jm, params, tm.eval()


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_slot_decode_matches_jax(variant):
    """Three slots admitted at different depths (one group prefill of two,
    one later), decoded together: per-step logits and greedy tokens."""
    jm, params, tm = _pair(variant)
    jpool = JaxSlotPool(jm, params, n_slots=3, steps_per_tick=1)
    tpool = SlotPool(tm, n_slots=3, steps_per_tick=1)
    prompts = _prompts((5, 11, 7))
    cur = np.zeros(3, np.int32)
    for group in ((0, 1), (2,)):
        pad = np.zeros((len(group), 16), np.int32)
        lens = np.array([len(prompts[i]) for i in group], np.int32)
        for r, i in enumerate(group):
            pad[r, :lens[r]] = prompts[i]
        jcache, jtok = jpool.prefill(pad, lens, np.zeros(len(group)),
                                     np.zeros((len(group), 2), np.uint32))
        tcache, ttok = tpool.prefill(pad, lens, np.zeros(len(group)),
                                     np.zeros(len(group), np.int64))
        np.testing.assert_array_equal(np.asarray(jtok), ttok)
        for r, i in enumerate(group):
            assert jpool.acquire() == tpool.acquire() == i
            jpool.insert(i, jcache, int(lens[r]), row=r)
            tpool.insert(i, tcache, int(lens[r]), row=r)
            cur[i] = ttok[r]
    jslot = jax.jit(lambda c, t: jpool._slot_model.apply(
        {"params": params, "cache": c}, t, mutable=["cache"]))
    for _ in range(6):
        jl, jv = jslot(jpool.cache, cur[:, None])
        jpool.cache = jv["cache"]
        with torch.no_grad():
            tl = tm(torch.from_numpy(cur[:, None]).long(),
                    cache=tpool.cache)
        _close(tl.numpy(), jl)
        nxt = tl[:, 0].argmax(-1).numpy().astype(np.int32)
        np.testing.assert_array_equal(nxt, np.asarray(jl[:, 0].argmax(-1)))
        cur = nxt
    assert tpool.cache["pos_index"].tolist() == \
        np.asarray(jpool.cache["pos_index"]).tolist()


def _paged_pools(jm, params, tm, n_blocks=24, bs=8):
    jpool = JaxBlockPool(jm, params, n_blocks=n_blocks, block_size=bs,
                         max_resident=4, steps_per_tick=1)
    tpool = BlockPool(tm, n_blocks=n_blocks, block_size=bs, max_resident=4,
                      steps_per_tick=1)
    return jpool, tpool


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_decode_matches_jax(variant):
    """The same admit/prefill/decode script through both block pools: a
    shared 16-token prefix (prefix hit + copy-on-write), per-call logits
    through the block tables and the greedy tokens."""
    jm, params, tm = _pair(variant)
    jpool, tpool = _paged_pools(jm, params, tm)
    base = _prompts((16,), seed=1)[0]
    prompts = [np.concatenate([base, p]) for p in _prompts((3, 6), seed=2)]
    prompts.append(base.copy())              # full hit, last token recomputed
    cur, rows = [], []
    for p in prompts:
        (jr, jhit), (tr, thit) = jpool.admit(p, 10), tpool.admit(p, 10)
        assert (jr, jhit) == (tr, thit)
        suffix = p[thit:]
        pad = np.zeros((1, 32), np.int32)
        pad[0, :suffix.size] = suffix
        jt = jpool.prefill([jr], pad, np.array([suffix.size], np.int32),
                           np.zeros(1, np.float32),
                           np.zeros((1, 2), np.uint32))
        tt = tpool.prefill([tr], pad, np.array([suffix.size], np.int32),
                           np.zeros(1, np.float32), np.zeros(1, np.int64))
        np.testing.assert_array_equal(jt, tt)
        for pool in (jpool, tpool):
            pool.register(tr, p)
            pool.note_prefilled(tr)
        cur.append(int(tt[0]))
        rows.append(tr)
    assert tpool.stats == {k: jpool.stats[k] for k in tpool.stats}
    assert tpool.stats["prefix_hit_tokens"] > 0
    assert tpool.stats["cow_copies"] >= 1
    toks = np.asarray(cur, np.int32)
    jstep = jax.jit(lambda c, t, bt, sp: jpool._model.apply(
        {"params": params, "cache": c}, t, block_tables=bt, start_pos=sp,
        mutable=["cache"]))
    for _ in range(5):
        jpool.prepare_tick(1)
        tpool.prepare_tick(1)
        tables, starts = tpool._tables_starts(rows)
        jt, js = jpool._tables_starts(rows)
        np.testing.assert_array_equal(tables, jt)
        jl, jv = jstep(jpool.cache, toks[:, None], tables, starts)
        jpool.cache = jv["cache"]
        with torch.no_grad():
            tl = tm(torch.from_numpy(toks[:, None]).long(),
                    cache=tpool.cache,
                    block_tables=torch.from_numpy(tables).long(),
                    start_pos=starts)
        _close(tl.numpy(), jl)
        toks = tl[:, 0].argmax(-1).numpy().astype(np.int32)
        np.testing.assert_array_equal(toks, np.asarray(jl[:, 0].argmax(-1)))
        for pool in (jpool, tpool):
            for st in pool._streams.values():
                st.filled += 1
    assert tpool.gauges() == {k: float(v) for k, v in jpool.gauges().items()
                              if k in tpool.gauges()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_equals_contiguous_bit_for_bit(variant):
    """At equal shapes, paged decode through scattered block tables gives
    the contiguous path's logits bit for bit, with the same tile count;
    max_len 512 puts two 256-key tiles in play."""
    _, _, tm = _pair(variant, 512)
    b, p, bs = 3, 250, 16
    n_tbl = 512 // bs
    prompt = torch.from_numpy(np.stack(_prompts((p,) * b, seed=4))).long()
    order = np.random.RandomState(5).permutation(b * n_tbl) + 1
    tables = torch.from_numpy(order.reshape(b, n_tbl)).long()
    with torch.no_grad():
        cc = init_cache(tm, b)
        pc = init_paged_cache(tm, 1 + b * n_tbl, bs)
        lc = tm(prompt, cache=cc)
        lp = tm(prompt, cache=pc, block_tables=tables,
                start_pos=np.zeros(b))
        assert torch.equal(lc, lp)
        tok = lc[:, -1].argmax(-1)
        for j in range(10):                   # crosses into the second tile
            a = tm(tok[:, None], cache=cc)
            c = tm(tok[:, None], cache=pc, block_tables=tables,
                   start_pos=np.full(b, p + j))
            assert torch.equal(a, c)
            tok = a[:, 0].argmax(-1)
    for i in range(tm.depth):
        key = f"backbone_block{i}"
        assert cc[key]["attn"]["tiles_computed"] == \
            pc[key]["attn"]["tiles_computed"] == 1 + 6 + 2 * 4


def test_paged_poisons_queries_past_max_len_like_jax():
    """A suffix whose padded tail runs past max_len: only those queries
    go NaN, in both packages; the real ones agree."""
    jm, params, tm = _pair()
    jpool, tpool = _paged_pools(jm, params, tm)
    tables = np.zeros((1, 8), np.int32)
    tables[0] = np.arange(1, 9)
    toks = _prompts((8,), seed=6)[0][None]
    starts = np.array([60], np.int32)           # queries at 60..67, max 64
    jl, _ = jpool._model.apply({"params": params, "cache": jpool.cache},
                               toks, block_tables=tables, start_pos=starts,
                               mutable=["cache"])
    with torch.no_grad():
        tl = tm(torch.from_numpy(toks).long(), cache=tpool.cache,
                block_tables=torch.from_numpy(tables).long(),
                start_pos=starts).numpy()
    jl = np.asarray(jl)
    assert np.isnan(tl[0, 4:]).all() and np.isnan(jl[0, 4:]).all()
    _close(tl[0, :4], jl[0, :4])


def test_slot_poisons_only_the_overflowing_row():
    _, _, tm = _pair()
    cache = init_slot_cache(tm, 2)
    for key, layer in cache.items():
        if key == "pos_index":
            layer[:] = (10, 64)
        else:
            layer["attn"]["cache_index"][:] = (10, 64)
    with torch.no_grad():
        out = tm(torch.tensor([[1], [2]]), cache=cache).numpy()
    assert np.isfinite(out[0]).all() and np.isnan(out[1]).all()
    with pytest.raises(ValueError, match="one token per slot"):
        tm(torch.zeros((2, 2), dtype=torch.long), cache=cache)
    with pytest.raises(ValueError, match="divide the attention tile"):
        init_paged_cache(tm, 8, 7)
    with pytest.raises(ValueError, match="null block"):
        init_paged_cache(tm, 1, 8)
