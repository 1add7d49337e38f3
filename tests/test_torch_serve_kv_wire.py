"""The KV block wire format (``KV_WIRE_VERSION = 1``) between ``ddw_tpu``
and the PyTorch port on the CPU: blocks exported by ``ddw_tpu``'s
``BlockPool`` import into the port's engine and continue with the same
greedy tokens; the port emits ``ddw_tpu``'s metadata (flax's cache-leaf
order — ``backbone_block10`` before ``backbone_block2`` — shapes, dtype
names, chain hashes) and ``ddw_tpu`` imports its payload; bf16 moves as raw
16-bit words; every malformed wire is refused with ``KVWireError`` before
the pool changes."""

import base64
import copy
import functools

import jax
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.serve.blocks import BlockPool as JaxBlockPool
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.models.convert import load_flax_variables
from ddw_tpu_torch.models.lm import build_lm
from ddw_tpu_torch.serve import EngineCfg, ServingEngine
from ddw_tpu_torch.serve.blocks import (KV_WIRE_VERSION, BlockPool,
                                        KVWireError)
from ddw_tpu_torch.serving.lm_package import LMPackagedModel
from ddw_tpu_torch.utils.config import LMCfg

VOCAB = 64
CFG = dict(vocab_size=VOCAB, max_len=96, hidden=32, depth=2, num_heads=2,
           mlp_dim=64, dropout=0.0, dtype="float32")
BS = 8
WAIT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread is fastest, and the test workers
    share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.cache
def _pair(**kw):
    cfg = dict(CFG, **kw)
    jm = jax_build_lm(JaxLMCfg(**cfg))
    params = jax.tree_util.tree_map(np.array, jm.init(
        {"params": jax.random.PRNGKey(1)}, np.zeros((1, 8), np.int32))[
            "params"])
    tm = load_flax_variables(build_lm(LMCfg(**cfg)), {"params": params})
    return jm, params, tm.eval()


def _prompt(n=27, seed=3):
    return np.random.RandomState(seed).randint(0, VOCAB, n).astype(np.int32)


def _prefilled(pool, prompt, keys):
    """Admit, prefill and register ``prompt`` in ``pool``."""
    row, hit = pool.admit(prompt, 4)
    pad = np.zeros((1, 32), np.int32)
    pad[0, :len(prompt) - hit] = prompt[hit:]
    pool.prefill([row], pad, np.array([len(prompt) - hit], np.int32),
                 np.zeros(1, np.float32), keys)
    pool.register(row, prompt)
    pool.note_prefilled(row)
    return row


def _jax_wire(prompt, **kw):
    jm, params, _ = _pair(**kw)
    jpool = JaxBlockPool(jm, params, n_blocks=16, block_size=BS,
                         max_resident=2, steps_per_tick=1)
    _prefilled(jpool, prompt, np.zeros((1, 2), np.uint32))
    return jpool, jpool.export_blocks(prompt)


def test_jax_blocks_continue_in_the_port_engine(tmp_path):
    """ddw_tpu's export lands in a port engine through ``kv_import``; the
    next request on that prompt prefix-hits the imported blocks and gives
    ddw_tpu's greedy tokens."""
    jm, params, _ = _pair()
    d = jax_lm_package.save_lm_package(str(tmp_path / "pkg"),
                                       JaxLMCfg(**CFG), params)
    prompt = _prompt()
    _, wire = _jax_wire(prompt)
    assert wire["version"] == KV_WIRE_VERSION and len(wire["hashes"]) == 3
    ref = jax_lm_package.LMPackagedModel(d).generate(prompt[None], 12)[0]
    with ServingEngine(lm=LMPackagedModel(d, device="cpu"), cfg=EngineCfg(
            n_slots=2, kv_block_size=BS)) as eng:
        got = eng.kv_import(wire)
        assert got["imported"] == 3 and got["skipped"] == 0
        assert got["bytes"] == 3 * 2 * 2 * BS * 2 * 16 * 4
        assert eng.kv_import(wire) == {"imported": 0, "skipped": 3,
                                       "bytes": 0}
        out = eng.submit_generate(prompt, 12).result(timeout=WAIT)
        longer = eng.submit_generate(np.concatenate([prompt, [5, 6]]),
                                     6).result(timeout=WAIT)
        snap = eng.snapshot()
        back = eng.kv_export(prompt, skip_hashes=wire["hashes"][:1])
    np.testing.assert_array_equal(out.tokens, ref)
    assert snap["serve.prefix_hit_tokens"] >= 24
    assert snap["serve.kv_blocks_migrated"] == 3
    np.testing.assert_array_equal(
        longer.tokens, jax_lm_package.LMPackagedModel(d).generate(
            np.concatenate([prompt, [5, 6]])[None], 6)[0])
    assert back["start_block"] == 1 and back["hashes"] == wire["hashes"]
    assert back["payload"] == wire["payload"][1:]   # the imported bits


@pytest.mark.parametrize("dtype,depth", [("float32", 2), ("bfloat16", 2),
                                         ("float32", 11)])
def test_port_wire_is_ddw_tpus(dtype, depth):
    """The port's export carries ddw_tpu's metadata and leaf order; each
    side imports the other's payload, bf16 as raw 16-bit words; at depth
    11 the flax order puts backbone_block10 second."""
    kw = dict(dtype=dtype, depth=depth)
    jm, params, tm = _pair(**kw)
    prompt = _prompt(25, seed=4)
    jpool, jwire = _jax_wire(prompt, **kw)
    tpool = BlockPool(tm, n_blocks=16, block_size=BS, max_resident=2,
                      steps_per_tick=1)
    _prefilled(tpool, prompt, np.zeros(1, np.int64))
    twire = tpool.export_blocks(prompt)
    assert {k: v for k, v in twire.items() if k != "payload"} == \
        {k: v for k, v in jwire.items() if k != "payload"}
    assert twire["leaves"][0] == [[BS, 2, 16], dtype]
    # the port's own K/V agrees with ddw_tpu's to the dtype's rounding
    for trow, jrow in zip(twire["payload"], jwire["payload"]):
        for tb, jb in zip(trow, jrow):
            np_dtype = np.float32 if dtype == "float32" else np.uint16
            t = np.frombuffer(base64.b64decode(tb), np_dtype)
            j = np.frombuffer(base64.b64decode(jb), np_dtype)
            if dtype == "bfloat16":             # the words as f32
                t, j = ((x.astype(np.uint32) << 16).view(np.float32)
                        for x in (t, j))
            tol = 1e-4 if dtype == "float32" else 2e-2   # bf16: a few ulp
            np.testing.assert_allclose(t, j, rtol=tol,
                                       atol=tol * np.abs(j).max())
    # ddw_tpu's payload lands bit for bit where flax's order puts it
    fresh = BlockPool(tm, n_blocks=16, block_size=BS, max_resident=2)
    assert fresh.import_blocks(jwire)["imported"] == 3
    again = fresh.export_blocks(prompt)
    assert again["payload"] == jwire["payload"]
    blk = fresh._full_map[bytes.fromhex(jwire["hashes"][0])]
    jblk = jpool._full_map[bytes.fromhex(jwire["hashes"][0])]
    last = f"backbone_block{depth - 1}"
    got = fresh.cache[last]["attn"]["kv_block_value"][blk]
    want = np.asarray(jpool.cache[last]["attn"]["kv_block_value"][jblk])
    np.testing.assert_array_equal(got.view(torch.int16).numpy() if
                                  dtype == "bfloat16" else got.numpy(),
                                  want.view(np.int16) if
                                  dtype == "bfloat16" else want)
    # and ddw_tpu takes the port's export
    jfresh = JaxBlockPool(jm, params, n_blocks=16, block_size=BS,
                          max_resident=2)
    assert jfresh.import_blocks(twire)["imported"] == 3


def test_malformed_wires_are_refused_before_the_pool_changes():
    _, _, tm = _pair()
    prompt = _prompt()
    _, wire = _jax_wire(prompt)
    pool = BlockPool(tm, n_blocks=16, block_size=BS, max_resident=2)
    before = (list(pool._free), pool._ref.tolist(), dict(pool._full_map))

    def bad(**change):
        w = copy.deepcopy(wire)
        for k, v in change.items():
            if v is None:
                del w[k]
            else:
                w[k] = v
        return w

    row = wire["payload"][0]
    cases = [
        ("wire version", bad(version=2)),
        ("block_size", bad(block_size=16)),
        ("geometry mismatch", bad(leaves=[[[BS, 2, 16], "bfloat16"]] * 4)),
        ("malformed leaf", bad(leaves=[["x"]])),
        ("no chain hashes", bad(hashes=[])),
        ("token list length", bad(tokens=wire["tokens"][:-1])),
        ("chain hash mismatch",
         bad(tokens=[(t + 1) % VOCAB for t in wire["tokens"]])),
        ("start_block", bad(start_block=9)),
        ("truncated payload", bad(payload=wire["payload"][:-1])),
        ("truncated payload row", bad(payload=[row[:-1]] + wire[
            "payload"][1:])),
        ("undecodable", bad(payload=[["!!"] + row[1:]] + wire[
            "payload"][1:])),
        ("truncated leaf payload", bad(payload=[[row[0][:-8]] + row[1:]]
                                       + wire["payload"][1:])),
    ]
    for what, w in cases:
        with pytest.raises(KVWireError, match=what):
            pool.import_blocks(w)
        assert (list(pool._free), pool._ref.tolist(),
                dict(pool._full_map)) == before, what
    with pytest.raises(KVWireError, match="dict"):
        pool.import_blocks([])
    assert pool.export_blocks(_prompt(5)) is None
