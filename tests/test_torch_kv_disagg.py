"""Prefill/decode disaggregation in the PyTorch port on the CPU: a
``role="prefill"`` engine never decodes and finishes every request at its
first token with its blocks left registered; the router's splitter hands
a request off prefill→decode over the versioned KV wire and the answer is
sequential generate's (greedy, and for a seed the decode engine's own
draw); a warm repeat migrates nothing (``skip_hashes``, the prefix index
as the transfer directory); a ``ddw_tpu`` prefill engine's export
continues in a port decode engine (and over the port gateway's
``/v1/kv/import``) with ``ddw_tpu``'s greedy tokens; and a malformed
wire is refused with a structured ``KVWireError`` (400 over HTTP) before
the decode pool changes. Every future is waited on with a timeout."""

import json

import jax
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.serve import EngineCfg as JaxEngineCfg
from ddw_tpu.serve import ServingEngine as JaxServingEngine
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.gateway import (Gateway, GatewayClient, GatewayError,
                                   ReplicaSet, chain_hash_hexes)
from ddw_tpu_torch.serve import EngineCfg, ServingEngine
from ddw_tpu_torch.serve.blocks import KV_WIRE_VERSION, KVWireError
from ddw_tpu_torch.serving.lm_package import LMPackagedModel

VOCAB = 64
BS = 8
CFG = dict(vocab_size=VOCAB, max_len=96, hidden=32, depth=2, num_heads=2,
           mlp_dim=64, dropout=0.0, dtype="float32")
WAIT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pkg_dir(tmp_path_factory):
    cfg = JaxLMCfg(**CFG)
    params = jax_build_lm(cfg).init({"params": jax.random.PRNGKey(0)},
                                    np.zeros((1, 8), np.int32))["params"]
    return jax_lm_package.save_lm_package(
        str(tmp_path_factory.mktemp("disagg_pkg") / "pkg"), cfg, params)


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


def _cfg(role, **kw):
    return EngineCfg(n_slots=2, steps_per_tick=4, role=role,
                     kv_block_size=BS, decode_buckets=False,
                     default_timeout_s=600.0, **kw)


@pytest.fixture(scope="module")
def disagg(pm):
    """A prefill-role and a decode-role port replica behind the splitter."""
    P = ServingEngine(lm=pm, cfg=_cfg("prefill"))
    D = ServingEngine(lm=pm, cfg=_cfg("decode"), replica_id=1)
    rs = ReplicaSet([P, D], cooldown_s=30.0)
    rs.prefix_index.poll_interval_s = 0.0
    rs.start()
    yield rs, P, D
    rs.stop()


def test_roles_validate_and_report():
    with pytest.raises(ValueError, match="role must be"):
        EngineCfg(role="draft")
    for role in ("prefill", "decode"):
        with pytest.raises(ValueError, match="requires the paged pool"):
            EngineCfg(role=role, paged=False)
    assert EngineCfg(role="both", paged=False).role == "both"


def test_prefill_role_finishes_at_the_first_token(pm):
    """A prefill replica answers one token per request (the colocated
    first token), never ticks decode, and keeps the prompt's full blocks
    registered for export."""
    (p,) = _prompts([3 * BS + 3], seed=1)
    ref = pm.generate(p[None], 6)[0]
    with ServingEngine(lm=pm, cfg=_cfg("prefill")) as eng:
        assert eng.role == "prefill" and eng.tp_degree == 1
        out = eng.submit_generate(p, 6).result(timeout=WAIT)
        wire = eng.kv_export(p)
        snap = eng.snapshot()
    assert list(out.tokens) == [ref[0]]
    assert snap["serve.decode_ticks"] == 0.0
    assert wire["version"] == KV_WIRE_VERSION and len(wire["hashes"]) == 3
    assert wire["hashes"] == chain_hash_hexes(p, BS)


def test_handoff_gives_the_colocated_greedy_tokens(disagg, pm):
    """A routed request prefills on P, migrates its blocks, decodes on D
    and answers sequential generate's tokens; the prefill replica never
    decodes; a warm repeat migrates no block (every full block is named in
    skip_hashes); the counters flow through the fleet snapshot."""
    rs, P, D = disagg
    (p,) = _prompts([2 * BS + 4], seed=11)
    ref = pm.generate(p[None], 8)[0]
    assert np.array_equal(rs.generate(p, 8).tokens, ref)
    snap = rs.snapshot()
    assert snap["serve.handoffs"] >= 1 and snap["serve.handoff_ms"] >= 0
    assert snap["serve.kv_blocks_migrated"] >= 2
    assert snap["serve.kv_bytes_migrated"] > 0
    assert P.snapshot()["serve.decode_ticks"] == 0.0
    migrated = D.snapshot()["serve.kv_blocks_migrated"]
    assert np.array_equal(rs.generate(p, 8).tokens, ref)
    assert D.snapshot()["serve.kv_blocks_migrated"] == migrated
    assert rs.snapshot()["serve.handoffs"] >= 2


def test_handoff_keeps_seeded_tokens_and_survives_a_prefill_restart(
        disagg, pm):
    """A seed samples the same tokens across the handoff as directly on
    the decode engine; an in-place prefill-replica restart drops its pool
    cold and the next request hands off again with a fresh migration."""
    rs, P, D = disagg
    (p,) = _prompts([2 * BS + 2], seed=13)
    a = rs.generate(p, 8, temperature=0.7,
                    rng=torch.Generator().manual_seed(17)).tokens
    direct = D.generate(p, 8, temperature=0.7,
                        rng=torch.Generator().manual_seed(17)).tokens
    assert np.array_equal(a, direct)
    before = rs.snapshot()["serve.handoffs"]
    migrated = D.snapshot()["serve.kv_blocks_migrated"]
    P.stop()
    P.restart()
    rs.prefix_index.drop_replica(0)
    (q,) = _prompts([3 * BS + 2], seed=19)
    ref = pm.generate(q[None], 6)[0]
    assert np.array_equal(rs.generate(q, 6).tokens, ref)
    assert rs.snapshot()["serve.handoffs"] > before
    assert D.snapshot()["serve.kv_blocks_migrated"] > migrated
    assert P.snapshot()["serve.decode_ticks"] == 0.0


def test_skip_hashes_ship_only_the_cold_tail(pm):
    """Blocks the receiver holds warm cross as hashes alone; the landed
    tail completes the chain, so the receiver re-exports the donor's full
    wire."""
    (p,) = _prompts([3 * BS + 1], seed=5)
    with ServingEngine(lm=pm, cfg=_cfg("prefill")) as P, \
            ServingEngine(lm=pm, cfg=_cfg("decode")) as D:
        P.submit_generate(p, 1).result(timeout=WAIT)
        full = P.kv_export(p)
        D.submit_generate(p[:BS + 1], 1).result(timeout=WAIT)  # block 0
        thin = P.kv_export(p, skip_hashes=full["hashes"][:1])
        assert thin["start_block"] == 1 and len(thin["payload"]) == 2
        assert thin["hashes"] == full["hashes"]
        res = D.kv_import(thin)
        assert res["imported"] == 2 and res["bytes"] > 0
        assert D.kv_export(p) == full
        ref = pm.generate(p[None], 5)[0]
        assert np.array_equal(
            D.submit_generate(p, 5).result(timeout=WAIT).tokens, ref)


def test_jax_prefill_continues_in_a_port_decode_engine(pkg_dir, pm, jpm):
    """``ddw_tpu``'s prefill-role engine exports; a port decode-role engine
    imports (directly, and through the port gateway's ``/v1/kv/import``)
    and gives ``ddw_tpu``'s greedy tokens."""
    prompts = _prompts([3 * BS + 2, 2 * BS + 5], seed=7)
    refs = [jpm.generate(p[None], 8)[0] for p in prompts]
    jP = JaxServingEngine(lm=jpm, cfg=JaxEngineCfg(
        n_slots=2, steps_per_tick=4, role="prefill", kv_block_size=BS))
    jP.start()
    try:
        wires = []
        for p in prompts:
            first = jP.submit_generate(p, 8).result(timeout=WAIT).tokens
            assert list(first) == [refs[len(wires)][0]]
            wires.append(jP.kv_export(p))
    finally:
        jP.stop()
    D = ServingEngine(lm=pm, cfg=_cfg("decode"))
    with D:
        res = D.kv_import(wires[0])
        assert res["imported"] == len(wires[0]["hashes"]) == 3
        out = D.submit_generate(prompts[0], 8).result(timeout=WAIT)
        assert np.array_equal(out.tokens, refs[0])
        assert D.snapshot()["serve.prefix_hit_tokens"] >= 3 * BS
    g = Gateway(ServingEngine(lm=pm, cfg=_cfg("decode")), grace_s=30.0)
    g.start(warmup_prompt_lens=())
    try:
        c = GatewayClient("127.0.0.1", g.port)
        assert c.wait_ready(WAIT)
        r = c._json_call("POST", "/v1/kv/import",
                         {"replica": 0, "wire": wires[1]})
        assert r["imported"] == 2
        assert np.array_equal(c.generate(prompts[1], 8)["tokens"], refs[1])
    finally:
        g.stop()


def _pool_state(eng):
    pool = eng.pool
    g = pool.gauges()
    return (pool.free_blocks_effective, len(pool._full_map),
            g["blocks_used"], g["blocks_cached"], g["blocks_free"])


def test_malformed_wire_is_refused_structured_and_atomic(pm):
    """Every defect raises KVWireError before the decode engine's pool
    changes (400 over HTTP, the pool still untouched); the clean wire
    lands whole afterwards."""
    (p,) = _prompts([3 * BS], seed=9)
    with ServingEngine(lm=pm, cfg=_cfg("prefill")) as P:
        P.submit_generate(p, 1).result(timeout=WAIT)
        wire = P.kv_export(p)

    def corrupt(**mut):
        w = json.loads(json.dumps(wire))
        w.update(mut)
        return w

    bad_tokens = list(wire["tokens"])
    bad_tokens[BS + 2] ^= 1
    cases = [corrupt(version=KV_WIRE_VERSION + 1),
             corrupt(block_size=BS * 2), corrupt(tokens=bad_tokens),
             corrupt(tokens=wire["tokens"][:-1]),
             corrupt(payload=wire["payload"][:-1]),
             corrupt(start_block=7), corrupt(hashes=[]), "not-a-wire"]
    D = ServingEngine(lm=pm, cfg=_cfg("decode"))
    g = Gateway(D, grace_s=30.0)
    g.start(warmup_prompt_lens=())
    try:
        before = _pool_state(D)
        for bad in cases:
            with pytest.raises(KVWireError):
                D.kv_import(bad)
            assert _pool_state(D) == before
        c = GatewayClient("127.0.0.1", g.port)
        with pytest.raises(GatewayError) as ei:
            c._json_call("POST", "/v1/kv/import",
                         {"replica": 0, "wire": cases[2]})
        assert ei.value.status == 400
        assert _pool_state(D) == before
        assert D.kv_import(wire)["imported"] == 3
        assert D.kv_export(p) == wire
    finally:
        g.stop()
