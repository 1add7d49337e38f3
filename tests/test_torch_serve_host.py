"""The serving host logic of the PyTorch port against ``ddw_tpu`` on the
CPU, each driven by the same op script with the same fake clock:
``AdmissionController`` (the bounded queues, shedding, the structured
refusals), ``EngineMetrics`` (snapshot, eviction fallback, labelled
counters, the jsonl stream, the tracker export, fleet merge, and the
Prometheus text character for character), the ``BlockPool`` allocator
(refcounts, LIFO free lists, the chain-hashed prefix cache,
copy-on-write, preemption, gauges) and ``SlotPool`` bookkeeping; and the
latency-ladder helpers of ``obs/telemetry``."""

import functools
import json
import os

import jax
import numpy as np
import pytest

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.obs import telemetry as jax_telemetry
from ddw_tpu.serve import admission as jax_admission
from ddw_tpu.serve import metrics as jax_metrics
from ddw_tpu.serve.blocks import BlockPool as JaxBlockPool
from ddw_tpu.serve.blocks import OutOfBlocks as JaxOutOfBlocks
from ddw_tpu.serve.slots import SlotPool as JaxSlotPool
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.models.convert import load_flax_variables
from ddw_tpu_torch.models.lm import build_lm
from ddw_tpu_torch.obs import telemetry
from ddw_tpu_torch.serve import admission, metrics
from ddw_tpu_torch.serve.blocks import BlockPool, OutOfBlocks
from ddw_tpu_torch.serve.slots import SlotPool
from ddw_tpu_torch.tracking.tracker import Tracker
from ddw_tpu_torch.utils.config import LMCfg

CFG = dict(vocab_size=32, max_len=64, hidden=16, depth=1, num_heads=2,
           mlp_dim=32, dropout=0.0, dtype="float32")


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class _Req:
    """What the controller reads of a request: deadline, times, claimed."""

    class _T:
        def __init__(self, t):
            self.submitted = t

    def __init__(self, name, now, deadline=None, claimed=False):
        self.name, self.deadline, self.claimed = name, deadline, claimed
        self.times = self._T(now)


def _admission_script(mod):
    clock = _Clock()
    ctrl = mod.AdmissionController(3, clock=clock,
                                   per_kind={"lm_batch": 5})
    out = []

    def rec(*v):
        out.append(v)

    for i in range(4):
        try:
            ctrl.offer("lm", _Req(f"a{i}", clock.t, clock.t + 0.5 * i),
                       retry_after_ms=12.5 if i == 3 else None)
            rec("offer", i)
        except mod.Overloaded as e:
            rec("overloaded", e.to_dict(), str(e))
        clock.t += 0.1
    for i in range(6):
        try:
            ctrl.offer("lm_batch", _Req(f"b{i}", clock.t, None, i == 0))
        except mod.Overloaded as e:
            rec("overloaded", e.to_dict(), str(e))
    rec("depth", ctrl.depth(), ctrl.depth("lm"), ctrl.capacity_for("lm"),
        ctrl.capacity_for("lm_batch"), ctrl.count_claimed("lm_batch"))
    rec("oldest", round(ctrl.oldest_wait_s("lm"), 9), ctrl.peek("lm").name)
    clock.t += 0.35
    got, expired = ctrl.take("lm", 2)
    rec("take", [r.name for r in got], [r.name for r in expired])
    ctrl.requeue_front("lm", got[0])
    clock.t += 1.0
    rec("shed", [r.name for r in ctrl.shed_expired("lm")])
    rec("take", *[[r.name for r in x] for x in ctrl.take("lm_batch", 9)])
    rec("empty", ctrl.oldest_wait_s("lm"), ctrl.peek("image"))
    for exc in (mod.ReplicaFailed("crash", 1, 2, "queued", 3, {"x": 1}),
                mod.Unavailable("all circuits open", 250.0),
                mod.DeadlineExceeded("lm", 1234.5, 1000.0)):
        rec(type(exc).__name__, exc.to_dict(), str(exc))
    with pytest.raises(ValueError):
        mod.AdmissionController(0)
    with pytest.raises(ValueError):
        mod.AdmissionController(2, per_kind={"lm": 0})
    return out


def test_admission_controller_matches_jax():
    assert _admission_script(admission) == _admission_script(jax_admission)


def _metrics_script(mod, tmp_path, max_records):
    a = mod.EngineMetrics(max_records=max_records)
    b = mod.EngineMetrics()
    rng = np.random.RandomState(0)
    t = 100.0
    for i in range(9):
        m = a if i % 3 else b
        q, f, d = sorted(rng.uniform(0, 0.8, 3))
        m.record(mod.RequestRecord(
            "lm" if i % 4 else "image", t, t + q, t + f, t + d,
            tokens=int(rng.randint(1, 30)),
            lane="batch" if i == 5 else "interactive", trace_id=f"r{i}"))
        t += 0.05
        if i == 2:
            a.stream_to(str(tmp_path / "stream.jsonl"))
    a.count_overloaded()
    b.count_deadline()
    b.count_cancelled()
    a.count("prefills", 3)
    a.count("decode_ticks", 7)
    a.count("prefix_hit_blocks", 5)
    a.count("prefix_miss_blocks", 3)
    a.count_labeled("tenant_requests", "tenant", "acme", 2)
    b.count_labeled("tenant_sheds", "tenant", "noisy")
    a.set_gauges({"blocks_used": 6.0, "block_tokens_capacity": 96.0,
                  "block_tokens_used": 70.0,
                  "interactive_reserve_blocks": 4.0,
                  "reserve_free_blocks": 1.0})
    b.set_gauges({"blocks_used": 2.0})
    a.close_stream()
    merged = mod.merge_metrics([a, b])
    return {
        "a": a.snapshot(), "b": b.snapshot(), "merged": merged.snapshot(),
        "counters": a.counters_view(), "labeled": merged.labeled_view(),
        "prom": mod.render_prometheus(
            [a, b], extra_gauges={'ddw_gateway_outstanding{replica="0"}': 1.0,
                                  'ddw_gateway_outstanding{replica="1"}': 3.0}),
        "prom_a": a.prometheus(),
        "stream": open(tmp_path / "stream.jsonl").read(),
        "records": [r.to_dict() for r in a.records()],
    }


@pytest.mark.parametrize("max_records", [None, 2])
def test_engine_metrics_and_prometheus_text_match_jax(tmp_path, max_records):
    """The snapshot (raw-row percentiles, and with max_records 2 the ladder
    fallback after eviction), the jsonl rows and the Prometheus text equal
    ``ddw_tpu``'s character for character."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = _metrics_script(metrics, tmp_path / "t", max_records)
    ref = _metrics_script(jax_metrics, tmp_path / "j", max_records)
    assert got == ref
    assert "ddw_serve_completed_total 9" in got["prom"]
    if max_records:
        assert got["a"]["serve.records_evicted"] > 0


def test_latency_ladder_helpers_match_jax():
    rng = np.random.RandomState(1)
    vals = np.concatenate([rng.lognormal(2.0, 1.5, 200), [0.0, 1.0, 2.5,
                                                          1e4, 2e4]])
    counts = [0] * (len(telemetry.DIST_BUCKETS) + 1)
    for v in vals:
        i = telemetry.bucket_index(v)
        assert i == jax_telemetry.bucket_index(v)
        counts[i] += 1
    assert telemetry.DIST_BUCKETS == jax_telemetry.DIST_BUCKETS
    for q in (0, 1, 50, 95, 99, 100):
        assert telemetry.bucket_quantile(counts, q) == \
            jax_telemetry.bucket_quantile(counts, q)
    assert telemetry.bucket_quantile([0] * 14, 50) == 0.0


def test_metrics_log_to_the_port_tracker(tmp_path):
    run = Tracker(str(tmp_path / "runs"), "serving").start_run("engine")
    m = metrics.EngineMetrics()
    m.record(metrics.RequestRecord("lm", 1.0, 1.1, 1.2, 1.5, tokens=4))
    m.log_to(run)
    run.end()
    assert run.final_metrics()["serve.completed"] == 1.0
    rows = [json.loads(ln) for ln in open(os.path.join(
        run.run_dir, "artifacts", "serving", "serve_requests.jsonl"))]
    assert rows == [m.records()[0].to_dict()]


@functools.cache
def _models():
    jm = jax_build_lm(JaxLMCfg(**CFG))
    params = jax.tree_util.tree_map(np.array, jm.init(
        {"params": jax.random.PRNGKey(0)}, np.zeros((1, 8), np.int32))[
            "params"])
    tm = load_flax_variables(build_lm(LMCfg(**CFG)), {"params": params})
    return jm, params, tm.eval()


def _pool_state(pool):
    return {"free": list(pool._free), "ref": pool._ref.tolist(),
            "rows": list(pool._free_rows), "committed": pool._committed,
            "cached": list(pool._cached), "stats": {
                k: pool.stats[k] for k in (
                    "prefix_hit_tokens", "prefix_hit_blocks",
                    "prefix_miss_blocks", "cow_copies", "preemptions",
                    "batch_preemptions")},
            "streams": {r: (s.blocks, s.prompt_len, s.filled, s.total,
                            s.seq, s.lane)
                        for r, s in pool._streams.items()},
            "full": sorted((k.hex(), v) for k, v in pool._full_map.items()),
            "gauges": {k: v for k, v in pool.gauges().items()
                       if k != "tp_degree"},
            "events": pool.prefix_events(0),
            "free_eff": pool.free_blocks_effective,
            "min_remaining": pool.min_remaining_steps(),
            "reserve": round(pool.reserve_occupancy_pct, 9)}


def _block_script(pool, out_of_blocks):
    """Admissions with shared prefixes (full hits, tail hits, the clamped
    full-coverage CoW), ticks that allocate and preempt, releases into the
    idle LRU and reclaim under pressure."""
    rng = np.random.RandomState(7)
    base = rng.randint(0, 32, 24).astype(np.int32)
    prompts = [base[:20], base[:24], base[:20].copy(), base[:16],
               np.concatenate([base[:8], rng.randint(0, 32, 9)]).astype(
                   np.int32), base[:21]]
    log = []
    rows = {}
    for i, p in enumerate(prompts):
        lane = "batch" if i == 4 else "interactive"
        fits = pool.can_admit(len(p), 5, lane)
        log.append(("lookup", pool.lookup(p), fits))
        if not fits:
            continue
        try:
            row, hit = pool.admit(p, 5, lane=lane)
        except out_of_blocks:
            log.append(("oob", i))
            continue
        pool.register(row, p)
        pool.note_prefilled(row)
        rows[i] = row
        log.append(("admit", row, hit, _pool_state(pool)))
        if i == 1:
            pool.release(rows.pop(0))
            log.append(("release", _pool_state(pool)))
    log.append(("tick", pool.prepare_tick(4), _pool_state(pool)))
    log.append(("preempt", pool.preempt_youngest("batch"),
                pool.preempt_youngest("batch"), _pool_state(pool)))
    for row in list(pool._streams):
        pool.extend_row(row, 2)
    log.append(("extend", _pool_state(pool)))
    log.append(("tick", pool.prepare_tick(8), _pool_state(pool)))
    for row in list(pool._streams):
        pool.release(row)
    log.append(("drained", _pool_state(pool)))
    return log


def test_block_pool_bookkeeping_matches_jax():
    jm, params, tm = _models()
    for overcommit in (1.0, 3.0):
        kw = dict(n_blocks=20, block_size=4, max_resident=4,
                  steps_per_tick=2, overcommit=overcommit,
                  interactive_reserve=2)
        jpool = JaxBlockPool(jm, params, **kw)
        tpool = BlockPool(tm, **kw)
        got = _block_script(tpool, OutOfBlocks)
        ref = _block_script(jpool, JaxOutOfBlocks)
        assert got == ref
        assert any(e[0] == "admit" and e[2] for e in got)   # prefix hits
        assert tpool.stats["cow_copies"] > 0
        assert tpool.gauges()["blocks_used"] == 0.0
    assert got[-1][1]["stats"]["preemptions"] > 0
    # the chain hash is ddw_tpu's digest over int32 token bytes
    p = np.arange(13, dtype=np.int32)
    assert tpool._chain_hashes(p) == jpool._chain_hashes(p)
    assert tpool._chain_hashes(p, b"salt") == jpool._chain_hashes(p, b"salt")
    tpool.reset()
    assert tpool.free_blocks == 20 and tpool.free_slots == 4


def test_block_pool_refusals():
    _, _, tm = _models()
    with pytest.raises(ValueError, match="divide the attention tile"):
        BlockPool(tm, n_blocks=4, block_size=5, max_resident=2)
    with pytest.raises(ValueError, match="overcommit"):
        BlockPool(tm, n_blocks=4, block_size=4, max_resident=2,
                  overcommit=0.5)
    # a mesh is ported (test_torch_tp_serve.py); what stays refused is a
    # mesh without a model axis. Adapter stacks under tensor parallelism,
    # refused here before, shard with the model (test_torch_tp_lora.py)
    from ddw_tpu_torch.runtime.mesh import Mesh
    from ddw_tpu_torch.serve.adapters import AdapterPool

    with pytest.raises(ValueError, match="must carry a 'model' axis"):
        BlockPool(tm, n_blocks=4, block_size=4, max_resident=2,
                  mesh=Mesh(("data",), np.arange(2), {}, rank=0))
    # adapter stacks are ported (test_torch_serve_adapters.py): a pool
    # takes an AdapterPool and hands its slot 0 to a row without one

    pool = BlockPool(tm, n_blocks=4, block_size=4, max_resident=2,
                     adapters=AdapterPool(tm, slots=1, rank=2))
    stacks, idx = pool._adapters_for(pool._adapter_idx([None, None]))
    assert idx.tolist() == [0, 0] and set(stacks) == {
        f"backbone_block{i}" for i in range(tm.depth)}


def test_slot_pool_bookkeeping_matches_jax():
    jm, params, tm = _models()
    jpool = JaxSlotPool(jm, params, n_slots=3)
    tpool = SlotPool(tm, n_slots=3)
    for pool in (jpool, tpool):
        assert [pool.acquire() for _ in range(3)] == [0, 1, 2]
        assert pool.free_slots == 0
        with pytest.raises(RuntimeError, match="exhausted"):
            pool.acquire()
        pool.release(1)
        with pytest.raises(ValueError, match="already free"):
            pool.release(1)
        assert pool.acquire() == 1
        pool.reset()
        assert pool.free_slots == 3
    prompts = np.zeros((2, 8), np.int32)
    prompts[:, :5] = np.arange(10).reshape(2, 5)
    jc, _ = jpool.prefill(prompts, np.array([5, 3]), np.zeros(2),
                          np.zeros((2, 2), np.uint32))
    tc, _ = tpool.prefill(prompts, np.array([5, 3]), np.zeros(2),
                          np.zeros(2, np.int64))
    for pool, cache in ((jpool, jc), (tpool, tc)):
        slot = pool.acquire()
        pool.insert(slot, cache, 3, row=1)
    assert tpool.cache["pos_index"].tolist() == \
        np.asarray(jpool.cache["pos_index"]).tolist() == [3, 0, 0]
    np.testing.assert_allclose(
        tpool.cache["backbone_block0"]["attn"]["cached_key"][0, :3].numpy(),
        np.asarray(jpool.cache["backbone_block0"]["attn"]["cached_key"][
            0, :3]), rtol=1e-5, atol=1e-6)
    tpool.release(0)
    assert tpool.cache["backbone_block0"]["attn"]["cache_index"][0] == 0
