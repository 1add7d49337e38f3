"""Fleet supervision in the PyTorch port (``ddw_tpu_torch.gateway``
``ReplicaSet``, ``CircuitBreaker``, ``ReplicaSupervisor``, ``PrefixIndex``)
on the CPU. The host logic against ``ddw_tpu``'s on the same scripted
inputs: the circuit-breaker FSM on a scripted clock, routing accounting
and spill over scripted fakes, the all-open refusal, supervisor budgets and
the recycle/probe policy, ``chain_hash_hexes`` and the prefix index's
cache-aware routing — each package's trace equal to the other's. Then the
drills on a real two-replica port fleet under ``DDW_FAULT=serve:*``:
failover after a mid-queue crash keeps sequential generate's tokens (and a
seeded stream's), a stalled replica is detected, force-failed and restarted,
a recycle drains its slots to completion, and the index's keys are the
pools' own chain hashes. Every future is waited on with a timeout."""

import concurrent.futures
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import ddw_tpu.gateway as jgw
import ddw_tpu.serve as jserve
from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.serve.metrics import EngineMetrics as JaxEngineMetrics
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
import ddw_tpu_torch.gateway as tgw
import ddw_tpu_torch.serve as tserve
from ddw_tpu_torch.gateway import (CIRCUIT_CLOSED, PrefixIndex, ReplicaSet,
                                   ReplicaSupervisor, chain_hash_hexes)
from ddw_tpu_torch.serve import (EngineCfg, Overloaded, ReplicaFailed,
                                 ServingEngine, Unavailable)
from ddw_tpu_torch.serve.metrics import EngineMetrics
from ddw_tpu_torch.serving.lm_package import LMPackagedModel

VOCAB = 64
CFG = dict(vocab_size=VOCAB, max_len=96, hidden=32, depth=2, num_heads=2,
           mlp_dim=64, dropout=0.0, dtype="float32")
WAIT = 60


def _ns(gw, serve, metrics):
    return types.SimpleNamespace(
        ReplicaSet=gw.ReplicaSet, CircuitBreaker=gw.CircuitBreaker,
        ReplicaSupervisor=gw.ReplicaSupervisor, PrefixIndex=gw.PrefixIndex,
        chain_hash_hexes=gw.chain_hash_hexes, Overloaded=serve.Overloaded,
        ReplicaFailed=serve.ReplicaFailed, Unavailable=serve.Unavailable,
        EngineMetrics=metrics)


PORT = _ns(tgw, tserve, EngineMetrics)
JAX = _ns(jgw, jserve, JaxEngineMetrics)


def _both(trace):
    """Run ``trace`` against each package; their observations must agree."""
    got, want = trace(PORT), trace(JAX)
    assert got == want
    return got


# -- circuit breaker FSM on a scripted clock ----------------------------------

def _breaker_trace(ns):
    now = [100.0]
    b = ns.CircuitBreaker(failure_threshold=3, cooldown_s=5.0,
                          clock=lambda: now[0])
    out = []

    def see():
        out.append((b.state, b.available(), b.opened))

    see()
    b.record_failure()
    b.record_failure()
    see()
    b.record_success()
    b.record_failure()
    b.record_failure()
    see()
    b.record_failure()
    see()
    out.append(round(b.retry_after_ms(), 3))
    b.record_success()          # a straggler does not close an open circuit
    see()
    now[0] += 5.0               # cooldown lapses into half-open
    see()
    b.begin_probe()
    see()
    b.record_failure()          # failed probe re-opens
    see()
    b.half_open()
    b.begin_probe()
    b.record_success()
    see()
    b.trip()
    b.half_open()
    b.begin_probe()
    see()
    b.abort_probe()
    see()
    now[0] += 1.0
    out.append(round(b.retry_after_ms(), 3))
    return out


def test_circuit_breaker_fsm_equal_across_packages():
    out = _both(_breaker_trace)
    assert out[0] == ("closed", True, 0)
    assert out[3] == ("open", False, 1)
    assert out[9] == ("closed", True, 2)


# -- routing accounting over scripted fakes -----------------------------------

class _FakeEngine:
    def __init__(self, ns, refuse=0, dead=False):
        self.ns, self.refuse, self.dead = ns, refuse, dead
        self.futures, self.calls = [], 0
        self.metrics = ns.EngineMetrics()

    def start(self):
        return self

    def stop(self):
        pass

    def warmup(self, *a, **kw):
        pass

    def submit_generate(self, prompt, num_steps, **kw):
        self.calls += 1
        if self.dead:
            raise self.ns.ReplicaFailed("crash", replica=0)
        if self.refuse > 0:
            self.refuse -= 1
            raise self.ns.Overloaded("lm", 1, 1, retry_after_ms=42.0)
        f = concurrent.futures.Future()
        self.futures.append(f)
        return f


def _accounting_trace(ns):
    out = []
    a, b = _FakeEngine(ns), _FakeEngine(ns)
    rs = ns.ReplicaSet([a, b])
    a.dead = True
    fut = rs.submit_generate([1], 1)
    out.append((fut in b.futures, rs.outstanding()))
    fut.set_result(None)
    a.dead = False
    f1 = rs.submit_generate([1], 1)
    f1.set_exception(ns.ReplicaFailed("crash"))
    out.append(rs.outstanding())
    rs3 = ns.ReplicaSet([_FakeEngine(ns, refuse=5),
                         _FakeEngine(ns, refuse=5)])
    try:
        rs3.submit_generate([1], 1)
    except ns.Overloaded:
        out.append(("overloaded", rs3.outstanding(), rs3.retried_429))
    dead, full, ok = (_FakeEngine(ns, dead=True), _FakeEngine(ns, refuse=1),
                      _FakeEngine(ns))
    rs4 = ns.ReplicaSet([dead, full, ok])
    fut = rs4.submit_generate([1], 1)
    out.append((fut in ok.futures, rs4.breakers[0].state,
                rs4.outstanding()))
    return out


def test_routing_accounting_never_leaks_equal_across_packages():
    out = _both(_accounting_trace)
    assert out[0] == (True, [0, 1]) and out[1] == [0, 0]


def _all_open_trace(ns):
    a, b = _FakeEngine(ns), _FakeEngine(ns)
    rs = ns.ReplicaSet([a, b], failure_threshold=1, cooldown_s=30.0)
    rs.breakers[0].trip()
    rs.breakers[1].trip()
    out = []
    try:
        rs.submit_generate([1], 1)
    except ns.Unavailable as e:
        d = e.to_dict()
        out.append((d["error"], d["retry_after_ms"] > 0))
    snap = rs.snapshot()
    out.append((snap["gateway.circuit_r0"], snap["gateway.circuit_r1"]))
    rs.breakers[0].half_open()
    fut = rs.submit_generate([1], 1)
    out.append(fut in a.futures)
    try:
        rs.submit_generate([1], 1)
    except ns.Unavailable:
        out.append("probe slot claimed")
    fut.set_result(None)
    out.append(rs.breakers[0].state)
    out.append(rs.submit_generate([1], 1) in a.futures)
    return out


def test_all_circuits_open_refuse_structured_equal_across_packages():
    out = _both(_all_open_trace)
    assert out[0] == ("unavailable", True) and out[-2] == CIRCUIT_CLOSED


# -- supervisor policy over scripted fakes ------------------------------------

class _FakeRecyclable:
    """Health/restart/recycle surface with an optional probe surface."""

    def __init__(self, ns, wedged=False, drain_ok=True, probe_ok=None):
        self.ns = ns
        self.replica_id, self.generation = 0, 0
        self.on_failure, self.metrics, self._failed = None, None, None
        self.wedged, self.drain_ok = wedged, drain_ok
        self.warmups = self.restarts = self.recycles = self.probes = 0
        self._degraded = False
        if probe_ok is not None:
            self.pool = object()
            self.probe_ok = probe_ok

    def fail(self, kind="crash"):
        self._failed = self.ns.ReplicaFailed(kind, replica=self.replica_id,
                                             generation=self.generation)

    @property
    def failure(self):
        return self._failed

    def health(self):
        h = {"state": "failed" if self._failed else "alive",
             "replica": self.replica_id, "generation": self.generation,
             "running": self._failed is None, "last_tick_age_s": 0.0,
             "consecutive_errors": 0, "queue_depth": 0, "busy_slots": 0}
        if self._failed is None and self._degraded:
            h["state"], h["consecutive_errors"] = "degraded", 1
        return h

    def start(self):
        return self

    def stop(self):
        pass

    def warmup(self, lens):
        self.warmups += 1

    def restart(self):
        if self.wedged:
            raise RuntimeError("thread still running")
        self.restarts += 1
        self.generation += 1
        self._failed = None
        return self

    def clone_fresh(self):
        eng = _FakeRecyclable(self.ns)
        eng.replica_id, eng.generation = self.replica_id, self.generation + 1
        return eng

    def generate(self, prompt, num_steps, timeout_s=None):
        self.probes += 1
        if not self.probe_ok:
            raise self.ns.ReplicaFailed("crash", replica=self.replica_id)
        return "ok"

    def recycle(self, drain_timeout_s=30.0):
        if not self.drain_ok:
            return False
        self.recycles += 1
        self.generation += 1
        self._degraded = False
        return True

    def force_fail(self, kind="stalled", reason=""):
        self.fail(kind)


def _await(cond, timeout_s=WAIT):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _supervisor_trace(ns):
    """Budgeted restarts, the wedged-replica replace path, the over-budget
    dark circuit, degraded -> graceful recycle, drain timeout -> force
    fail, and the shadow probe closing or re-tripping the circuit."""
    out = []
    eng = _FakeRecyclable(ns)
    rs = ns.ReplicaSet([eng])
    sup = ns.ReplicaSupervisor(rs, max_restarts=2, backoff_base_s=0.0,
                               jitter=0.0, poll_interval_s=0.01).start()
    try:
        for n in (1, 2):
            eng.fail()
            rs.failure_event.set()
            assert _await(lambda: rs.restarts[0] >= n)
        out.append((eng.restarts, eng.warmups >= 2))
        eng.fail()
        rs.failure_event.set()
        assert _await(lambda: any(a.action == "budget_exhausted"
                                  for a in sup.attempts))
        out.append((rs.breakers[0].state, eng.restarts))
    finally:
        sup.stop()
    wedged = _FakeRecyclable(ns, wedged=True)
    rs2 = ns.ReplicaSet([wedged])
    sup2 = ns.ReplicaSupervisor(rs2, max_restarts=1, backoff_base_s=0.0,
                                jitter=0.0, poll_interval_s=0.01).start()
    try:
        wedged.fail()
        rs2.failure_event.set()
        assert _await(lambda: rs2.replicas[0] is not wedged)
        out.append((rs2.replicas[0].generation, rs2.restarts[0]))
    finally:
        sup2.stop()
    deg = _FakeRecyclable(ns)
    rs3 = ns.ReplicaSet([deg])
    sup3 = ns.ReplicaSupervisor(rs3, backoff_base_s=0.0, jitter=0.0,
                                poll_interval_s=0.01,
                                recycle_degraded_after_s=0.05).start()
    try:
        deg._degraded = True
        assert _await(lambda: deg.recycles >= 1)
        assert _await(lambda: any(a["action"] == "drained_restarted"
                                  for a in sup3.report()["attempts"]))
        out.append((deg.recycles, deg._failed is None,
                    rs3.breakers[0].state))
    finally:
        sup3.stop()
    stuck = _FakeRecyclable(ns, drain_ok=False)
    sup4 = ns.ReplicaSupervisor(ns.ReplicaSet([stuck]), max_restarts=1,
                                backoff_base_s=0.0, jitter=0.0,
                                poll_interval_s=0.01, drain_timeout_s=0.05)
    out.append((sup4.recycle(0), stuck._failed is not None,
                [a["action"] for a in sup4.report()["attempts"]]))
    for probe_ok in (True, False):
        p = _FakeRecyclable(ns, probe_ok=probe_ok)
        rs5 = ns.ReplicaSet([p])
        sup5 = ns.ReplicaSupervisor(
            rs5, max_restarts=1, backoff_base_s=0.0 if probe_ok else 5.0,
            jitter=0.0, poll_interval_s=0.01).start()
        try:
            p.fail()
            rs5.failure_event.set()
            want = "probed_closed" if probe_ok else "probe_failed"
            assert _await(lambda: any(a.readmit == want
                                      for a in sup5.attempts))
            out.append((want, rs5.breakers[0].state, p.probes >= 1))
        finally:
            sup5.stop()
    return out


def test_supervisor_policy_equal_across_packages():
    out = _both(_supervisor_trace)
    assert out[0] == (2, True)
    assert out[-2] == ("probed_closed", "closed", True)
    assert out[-1] == ("probe_failed", "open", True)


# -- prefix index and cache-aware routing -------------------------------------

@pytest.mark.parametrize("block_size", [1, 4, 16])
@pytest.mark.parametrize("salt", [b"", bytes(range(20))])
def test_chain_hash_hexes_equal_ddw_tpu(block_size, salt):
    rng = np.random.RandomState(block_size)
    toks = rng.randint(0, 50257, size=(53,)).astype(np.int32)
    got = chain_hash_hexes(toks, block_size, salt)
    assert got == jgw.chain_hash_hexes(toks, block_size, salt)
    assert len(got) == len(toks) // block_size
    assert chain_hash_hexes(list(toks[:block_size * 2]), block_size,
                            salt) == got[:2]


def _reg(key, toks):
    return ["register", key, list(toks)]


def _feed(seq, *events, reset=False):
    return {"seq": seq, "reset": reset, "events": list(events)}


def _index_trace(ns):
    idx = ns.PrefixIndex(hot_k=4)
    toks, out = [1, 2, 3, 4], []
    key = ns.chain_hash_hexes(toks, 4)[0]
    idx.observe(0, _feed(1, _reg(key, toks)))
    idx.observe(1, _feed(1, _reg(key, toks)))
    out.append(idx.match([1, 2, 3, 4, 9], count_hit=False))
    out.append(idx.match(toks, count_hit=False))
    idx.observe(0, _feed(2, ["evict", key]))
    out.append(idx.match([1, 2, 3, 4, 9], count_hit=False))
    idx.observe(1, _feed(2, ["evict", key]))
    out.append((idx.match([1, 2, 3, 4, 9], count_hit=False), idx.hot()))
    toks_b = [7, 8, 9, 10]
    idx.observe(0, _feed(1, _reg(ns.chain_hash_hexes(toks_b, 4)[0], toks_b),
                         reset=True))
    out.append((idx.match([7, 8, 9, 10, 1], count_hit=False),
                idx.summary()["keys"]))
    idx.drop_replica(0)
    out.append(idx.match([7, 8, 9, 10, 1], count_hit=False))
    return out


def test_prefix_index_feed_equal_across_packages():
    out = _both(_index_trace)
    assert out[0] == {0: 4, 1: 4} and out[1] == {0: 3, 1: 3}


class _FakeLoadEngine:
    def __init__(self, ns):
        self.depth, self.service_ms, self.prefill_token_ms = 0, 10.0, 1.0
        self.metrics = ns.EngineMetrics()
        self.futures = []

    def start(self):
        return self

    def stop(self):
        pass

    def load(self):
        return {"depth": self.depth, "busy": 0,
                "service_ms": self.service_ms,
                "prefill_token_ms": self.prefill_token_ms}

    def submit_generate(self, prompt, num_steps, **kw):
        f = concurrent.futures.Future()
        self.futures.append(f)
        return f


def _routing_trace(ns):
    cold, warm = _FakeLoadEngine(ns), _FakeLoadEngine(ns)
    rs = ns.ReplicaSet([cold, warm])
    toks = list(range(1, 9))
    hexes = ns.chain_hash_hexes(toks, 4)
    rs.prefix_index.observe(
        1, _feed(2, _reg(hexes[0], toks[:4]), _reg(hexes[1], toks)))
    out = []
    fut = rs.submit_generate(toks + [42], 4)
    out.append((fut in warm.futures, warm.metrics.routed_cache_hit))
    fut.set_result(None)
    warm.depth = 3
    fut = rs.submit_generate(toks + [42], 4)
    out.append((fut in cold.futures, cold.metrics.routed_wait_override))
    fut.set_result(None)
    out.append(rs.outstanding())
    return out


def test_prefix_routing_equal_across_packages():
    out = _both(_routing_trace)
    assert out == [(True, 1), (True, 1), [0, 0]]


# -- drills on a real two-replica port fleet ----------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pm(tmp_path_factory):
    cfg = JaxLMCfg(**CFG)
    params = jax_build_lm(cfg).init({"params": jax.random.PRNGKey(0)},
                                    np.zeros((1, 8), np.int32))["params"]
    out = jax_lm_package.save_lm_package(
        str(tmp_path_factory.mktemp("sup_pkg") / "pkg"), cfg, params)
    return LMPackagedModel(out, device="cpu")


@pytest.fixture(scope="module")
def fleet(pm):
    """One supervised two-replica fleet shared by the ordered drills: the
    crash drill restarts replica 0, the stall drill replica 1, the recycle
    drill replica 0 again."""
    engines = [ServingEngine(lm=pm, cfg=EngineCfg(n_slots=2,
                                                  steps_per_tick=2),
                             replica_id=i) for i in range(2)]
    rs = ReplicaSet(engines, cooldown_s=30.0)
    rs.prefix_index.poll_interval_s = 0.0
    sup = ReplicaSupervisor(rs, max_restarts=3, backoff_base_s=0.05,
                            backoff_max_s=0.2, jitter=0.0,
                            stall_timeout_s=3.0, poll_interval_s=0.05,
                            warmup_prompt_lens=(8, 16))
    rs.start()
    rs.warmup((8, 16))
    sup.start()
    yield rs, sup, engines
    sup.stop()
    rs.stop()


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=(n,)).astype(np.int32)
            for n in lengths]


def test_failover_keeps_tokens_after_mid_queue_crash(fleet, pm, monkeypatch):
    """``serve:crash:site=decode:replica=0`` kills replica 0 at its first
    decode tick: every future resolves, the requests that complete (those
    that queued behind the dead slots fail over to replica 1) give
    sequential generate's tokens (a seeded one the tokens its seed gives
    in-thread), the in-slot victims fail with a structured ReplicaFailed,
    and the supervisor restarts replica 0, which the shadow probe
    readmits."""
    rs, sup, engines = fleet
    prompts = _prompts([5, 9, 7, 4, 11, 6], seed=1)
    steps = 6
    refs = [pm.generate(p[None], steps)[0] for p in prompts]
    sp = _prompts([8], seed=9)[0]
    with ServingEngine(lm=pm, cfg=EngineCfg(n_slots=2)) as solo:
        sref = solo.generate(sp, steps, temperature=0.9,
                             rng=torch.Generator().manual_seed(3)).tokens
    monkeypatch.setenv("DDW_FAULT", "serve:crash:site=decode:replica=0")
    futs = [rs.submit_generate(p, steps) for p in prompts]
    sfut = rs.submit_generate(sp, steps, temperature=0.9,
                              rng=torch.Generator().manual_seed(3))
    outcomes = []
    for i, f in enumerate(futs):
        try:
            assert np.array_equal(f.result(timeout=WAIT).tokens, refs[i]), i
            outcomes.append("ok")
        except ReplicaFailed as e:
            assert e.to_dict()["error"] == "replica_failed"
            assert e.forensics["traceback"]
            outcomes.append("failed")
    try:
        assert np.array_equal(sfut.result(timeout=WAIT).tokens, sref)
    except ReplicaFailed:
        pass                    # it sat in the dead replica's slot
    assert "ok" in outcomes and "failed" in outcomes
    assert rs.snapshot()["gateway.replica_failures"] >= 1.0
    assert _await(lambda: rs.restarts[0] >= 1)
    assert _await(lambda: engines[0].state == "alive")
    assert engines[0].generation >= 1
    assert any(a.kind == "crash" and a.action == "restarted"
               for a in sup.attempts)
    assert _await(lambda: rs.breakers[0].state == CIRCUIT_CLOSED)
    assert np.array_equal(rs.generate(prompts[0], steps).tokens, refs[0])


def test_stalled_replica_is_force_failed_and_restarted(fleet, pm,
                                                       monkeypatch):
    """A decode tick that never returns is seen only by the heartbeat: the
    supervisor force-fails the replica (its futures resolve, nothing
    hangs) and restarts it in place."""
    rs, sup, engines = fleet
    assert _await(lambda: engines[0].state == "alive")
    monkeypatch.setenv("DDW_FAULT", "serve:stall:site=decode:replica=1")
    prompts = _prompts([5, 8, 6, 9], seed=2)
    steps = 4
    refs = [pm.generate(p[None], steps)[0] for p in prompts]
    futs = [rs.submit_generate(p, steps) for p in prompts]
    ok = 0
    for i, f in enumerate(futs):
        try:
            assert np.array_equal(f.result(timeout=WAIT).tokens, refs[i])
            ok += 1
        except (ReplicaFailed, Unavailable):
            pass
    assert ok >= 1
    assert _await(lambda: any(a.kind == "stalled" for a in sup.attempts))
    assert _await(lambda: rs.restarts[1] >= 1)
    assert _await(lambda: engines[1].state == "alive")
    assert engines[1].generation >= 1
    monkeypatch.delenv("DDW_FAULT")
    assert _await(lambda: rs.breakers[1].state == CIRCUIT_CLOSED)
    got = [rs.submit_generate(p, steps) for p in prompts]
    assert all(np.array_equal(f.result(timeout=WAIT).tokens, r)
               for f, r in zip(got, refs))


def test_recycle_drains_in_slot_work_to_completion(fleet, pm):
    """A recycle lets in-slot requests finish with their tokens (never
    failed over), keeps queued work for the next generation, readmits
    through the shadow probe, and draining refuses new work with
    Overloaded."""
    rs, sup, engines = fleet
    eng = engines[0]
    assert _await(lambda: eng.state == "alive")
    prompts = _prompts([5, 7, 6], seed=9)
    steps = 24
    refs = [pm.generate(p[None], steps)[0] for p in prompts]
    gen0 = eng.generation
    in_slots = threading.Event()

    def slow(i, t):
        time.sleep(0.005)

    def slow_mark(i, t):
        time.sleep(0.005)
        in_slots.set()

    futs = [eng.submit_generate(prompts[0], steps, on_token=slow),
            eng.submit_generate(prompts[1], steps, on_token=slow_mark),
            eng.submit_generate(prompts[2], steps)]
    assert in_slots.wait(WAIT)
    assert sup.recycle(0) is True
    for i, (f, ref) in enumerate(zip(futs, refs)):
        assert np.array_equal(f.result(timeout=WAIT).tokens, ref), i
    assert eng.generation == gen0 + 1
    rep = sup.report()
    assert any(a["action"] == "drained_restarted"
               and a["readmit"] == "probed_closed" for a in rep["attempts"])
    assert rs.breakers[0].state == CIRCUIT_CLOSED
    eng._draining.set()
    with pytest.raises(Overloaded):
        eng.submit_generate(prompts[0], 2)
    eng.resume_admission()
    assert np.array_equal(eng.generate(prompts[0], 6).tokens, refs[0][:6])


def test_index_keys_are_the_pools_chain_hashes(fleet, pm):
    """Traffic teaches the index who holds what: its keys are the holder
    pool's full-block hashes (and ``ddw_tpu``'s for the same tokens); the
    repeat request chases its prefix and keeps its tokens; a forced cold
    generate on the other replica gives the same."""
    rs, sup, engines = fleet
    (pa,) = _prompts([40], seed=3)
    ref = pm.generate(pa[None], 8)[0]
    assert np.array_equal(rs.generate(pa, 8).tokens, ref)
    assert np.array_equal(rs.generate(pa, 8).tokens, ref)
    rs.prefix_index.poll(rs.replicas)
    m = rs.prefix_index.match(pa, count_hit=False)
    assert m, "feed never reached the index"
    holder = max(m, key=m.get)
    pool = engines[holder].pool
    hexes = chain_hash_hexes(pa, pool.block_size)
    assert hexes == jgw.chain_hash_hexes(pa, pool.block_size)
    assert set(hexes) <= {h.hex() for h in pool._full_map}
    assert rs.snapshot()["serve.routed_cache_hit"] >= 1
    cold = engines[1 - holder].generate(pa, 8).tokens
    assert np.array_equal(cold, ref)
    feed = engines[holder].prefix_events(0)
    assert {"seq", "reset", "events"} <= set(feed)
    assert engines[holder].load()["free_block_frac"] <= 1.0
    s = rs.prefix_index.summary()
    assert s["block_size"] == pool.block_size and str(holder) in s["holders"]
    idx = PrefixIndex()
    idx.observe(0, feed)
    assert idx.match(pa, count_hit=False)
