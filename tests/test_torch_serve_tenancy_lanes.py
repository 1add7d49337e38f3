"""Per-tenant QoS and bulk batch jobs in the PyTorch port
(``ddw_tpu_torch.serve.tenancy``, ``ddw_tpu_torch.serve.lanes``,
``ServingEngine(cfg=EngineCfg(tenants=...))`` and ``submit_batch``) on the
CPU in f32, mirroring ``tests/test_adapters.py`` and ``tests/test_lanes.py``:
the stride scheduler's picks equal ``ddw_tpu``'s for the same seeded
arrivals; a quota charge is all or nothing and released on completion,
shed, cancel and failure; tenant-attributed SLOs page the noisy tenant and
hold the quiet one; the pump's window, retry-once, permanent failure and
cancel; the reserve-watermark math and its auto default; batch items equal
direct greedy and seeded calls (each item's generator a pure function of
``(seed, index)``); interactive traffic preempts batch, tokens unchanged; a
job resumes across an engine restart exactly once; the lane metrics merge.
"""

import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.serve import tenancy as jax_tenancy
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.obs.slo import SLOMonitor
from ddw_tpu_torch.serve import (BatchJob, DeadlineExceeded, EngineCfg,
                                 EngineMetrics, JobLedger, Overloaded,
                                 QuotaExceeded, ReplicaFailed,
                                 RequestRecord, ServingEngine,
                                 TenancyController, TenantAwareAdmission,
                                 TenantSpec, render_prometheus,
                                 tenant_objectives)
from ddw_tpu_torch.serve.lanes import item_generator
from ddw_tpu_torch.serve.metrics import merge_metrics
from ddw_tpu_torch.serving.lm_package import LMPackagedModel

VOCAB = 64
WAIT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pm(tmp_path_factory):
    cfg = JaxLMCfg(vocab_size=VOCAB, max_len=96, hidden=32, depth=2,
                   num_heads=2, mlp_dim=64, dropout=0.0, dtype="float32")
    params = jax_build_lm(cfg).init({"params": jax.random.PRNGKey(0)},
                                    np.zeros((1, 8), np.int32))["params"]
    out = str(tmp_path_factory.mktemp("lane_pkg") / "pkg")
    return LMPackagedModel(jax_lm_package.save_lm_package(out, cfg, params),
                           device="cpu")


@pytest.fixture(scope="module")
def eng(pm):
    """One shared paged engine for the identity and restart drills."""
    with ServingEngine(lm=pm, cfg=EngineCfg(n_slots=2, steps_per_tick=2,
                                            default_timeout_s=600.0)) as e:
        yield e


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=(n,)).astype(np.int32)
            for n in lengths]


class _Req:
    def __init__(self, tenant, cost=1.0):
        self.tenant = tenant
        self.fair_cost = cost
        self.deadline = None
        self.claimed = False


class _R:
    """Fake per-item result for the pure pump tests."""

    def __init__(self, tokens):
        self.tokens = tokens


# -- tenancy -----------------------------------------------------------------

def test_stride_scheduler_picks_equal_jax():
    """Seeded arrivals (tenants, costs, interleaved takes) through both
    packages' TenantAwareAdmission give the same pick sequence; weight 3
    gets 3 of every 4 picks against weight 1 and a lower tier drains
    first."""
    specs = [("heavy", 3.0, 0), ("light", 1.0, 0), ("mid", 2.0, 0),
             ("vip", 1.0, -1)]
    rng = np.random.RandomState(7)
    script = []
    for _ in range(120):
        if rng.rand() < 0.6:
            script.append(("offer", specs[rng.randint(4)][0],
                           float(rng.choice([1.0, 2.0, 3.0]))))
        else:
            script.append(("take", None, None))
    picks = {}
    for name, mod in (("port", None), ("jax", jax_tenancy)):
        ts = (mod.TenantSpec if mod else TenantSpec)
        tc = (mod.TenancyController if mod else TenancyController)(
            [ts(n, weight=w, priority=p) for n, w, p in specs])
        adm = (mod.TenantAwareAdmission if mod else TenantAwareAdmission)(
            256, tc)
        out = []
        for op, tenant, cost in script:
            if op == "offer":
                adm.offer("lm_batch", _Req(tenant, cost))
            else:
                got, _ = adm.take("lm_batch", 1)
                out.append(got[0].tenant if got else None)
        while adm.depth("lm_batch"):
            out.append(adm.take("lm_batch", 1)[0][0].tenant)
        picks[name] = out
    assert picks["port"] == picks["jax"]
    tc = TenancyController([TenantSpec("heavy", weight=3.0),
                            TenantSpec("light", weight=1.0),
                            TenantSpec("vip", weight=1.0, priority=-1)])
    adm = TenantAwareAdmission(64, tc)
    for _ in range(12):
        adm.offer("lm_batch", _Req("heavy"))
        adm.offer("lm_batch", _Req("light"))
    adm.offer("lm_batch", _Req("vip"))
    seq = [adm.take("lm_batch", 1)[0][0].tenant for _ in range(13)]
    assert seq[0] == "vip"
    assert seq[1:].count("heavy") == 9 and seq[1:].count("light") == 3


def test_quota_charge_is_all_or_nothing_and_released_on_every_path(pm):
    tc = TenancyController([TenantSpec("t", token_quota=10, block_quota=4)])
    assert tc.charge("t", 2, 6) == "t"
    with pytest.raises(QuotaExceeded) as ei:
        tc.charge("t", 1, 6)                       # tokens would overflow
    e = ei.value
    assert (e.tenant, e.resource, e.used, e.quota) == ("t", "tokens", 6, 10)
    assert e.to_dict()["error"] == "quota_exceeded"
    v = tc.view()["t"]
    assert (v["blocks_held"], v["tokens_held"]) == (2, 6)   # nothing charged
    tc.release("t", 2, 6)
    assert tc.charge("t", 4, 10) == "t"            # full headroom is back
    # the engine releases the charge on completion, a refusal, a deadline
    # shed, a cancel while queued and a replica failure
    cfg = EngineCfg(n_slots=2, steps_per_tick=2, default_timeout_s=600.0,
                    tenants=({"name": "noisy", "token_quota": 12},
                             {"name": "quiet"}))
    (p,) = _prompts([8], seed=5)
    e = ServingEngine(lm=pm, cfg=cfg)

    def held():
        return e.tenancy.view()["noisy"]["tokens_held"]

    f1 = e.submit_generate(p, 8, tenant="noisy")      # engine not started
    with pytest.raises(QuotaExceeded) as ei:
        e.submit_generate(p, 8, tenant="noisy")       # 8 + 8 > 12
    assert ei.value.tenant == "noisy" and ei.value.resource == "tokens"
    assert e.snapshot()['serve.tenant_sheds{tenant="noisy"}'] == 1.0
    e.submit_generate(p, 4, tenant="quiet")           # others admit
    assert held() == 8
    assert f1.cancel() and held() == 8                # released when popped
    f3 = e.submit_generate(p, 4, tenant="noisy", timeout_s=1e-3)
    time.sleep(0.01)
    e.start()
    with pytest.raises(DeadlineExceeded):
        f3.result(timeout=WAIT)                       # deadline shed
    e.generate(p, 8, tenant="noisy")                  # completion
    assert held() == 0
    e.stop()
    e = ServingEngine(lm=pm, cfg=cfg)                 # queued, then failed
    f4 = e.submit_generate(p, 12, tenant="noisy")
    assert held() == 12
    e.force_fail("stalled", "quota drill")
    with pytest.raises(ReplicaFailed):
        f4.result(timeout=WAIT)
    assert held() == 0
    e.stop()


def test_tenant_slo_attribution_noisy_pages_quiet_holds(pm):
    """Per-tenant objectives over the engine's telemetry feed attribute
    burn to the right tenant: an impossible TTFT objective pages the noisy
    tenant while the quiet tenant holds full attainment."""
    specs = [TenantSpec("quiet", ttft_slo_ms=60_000.0, slo_target=0.9),
             TenantSpec("noisy", token_quota=64, ttft_slo_ms=0.0,
                        slo_target=0.99)]   # burn 100 >= the page burn
    objs = tenant_objectives(specs)
    assert [o.name for o in objs] == ["tenant:quiet:ttft",
                                      "tenant:noisy:ttft"]
    cfg = EngineCfg(n_slots=4, steps_per_tick=4, telemetry=True,
                    telemetry_interval_s=0.05, default_timeout_s=600.0,
                    tenants=tuple(s.to_dict() for s in specs))
    mon = SLOMonitor(objs, fast=(60.0, 30.0), clear_evals=1)
    with ServingEngine(lm=pm, cfg=cfg) as eng:
        for p in _prompts([8, 9, 10, 11], seed=8):
            eng.generate(p, 4, tenant="quiet")
            eng.generate(p, 4, tenant="noisy")
        time.sleep(0.15)
        feed = eng.telemetry_events()
        snap = eng.snapshot()
    mon.ingest(feed["source"], feed["samples"])
    now = max(s["ts"] for s in feed["samples"])
    for _ in range(2):                   # escalation is one step per eval
        states = mon.evaluate([feed], now=now)
    assert states == {"tenant:quiet:ttft": "ok", "tenant:noisy:ttft": "page"}
    st = mon.status()["objectives"]
    quiet = st["tenant:quiet:ttft"]["budget"]
    noisy = st["tenant:noisy:ttft"]["budget"]
    assert quiet["events_total"] == 4 and quiet["events_bad"] == 0
    assert noisy["events_bad"] == noisy["events_total"] == 4
    assert snap['serve.tenant_requests{tenant="quiet"}'] == 4.0
    assert snap['serve.tenant_requests{tenant="noisy"}'] == 4.0


# -- the pump, pure ----------------------------------------------------------

def test_pump_window_retry_exactly_once():
    """Window-bounded feeding; a retryable refusal re-queues at the front
    and resubmits after backoff; every row is recorded exactly once, in
    index order."""
    subs = []

    def submit(i):
        f = Future()
        subs.append((i, f))
        return f

    job = BatchJob("generate", 5, submit,
                   lambda i, r: {"index": i, "tokens": list(r.tokens)},
                   window=2, retry_base_s=0.01, retry_max_s=0.05)._start()
    assert len(subs) == 2                       # window bounds in-flight
    subs[0][1].set_result(_R([1, 2]))           # completion chains a feed
    assert len(subs) == 3
    subs[1][1].set_exception(Overloaded("lm_batch", 4, 4))  # -> requeue
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:          # backoff timer re-feeds
        for i, f in subs:
            if not f.done():
                f.set_result(_R([i]))
        if job.done:
            break
        time.sleep(0.01)
    p = job.wait(timeout_s=5.0)
    assert p["state"] == "done"
    assert p["completed"] == 5 and p["failed"] == 0
    assert p["requeues"] >= 1
    assert [r["index"] for r in job.result_rows()] == [0, 1, 2, 3, 4]


def test_pump_permanent_failure_and_cancel():
    """A non-retryable submit error fails only its item; cancel drops
    pending work but KEEPS completed rows, and is idempotent."""
    def submit(i):
        if i == 1:
            raise ValueError("bad item")
        return Future()

    job = BatchJob("generate", 3, submit,
                   lambda i, r: {"index": i}, window=3)._start()
    p = job.progress()
    assert p["failed"] == 1
    assert p["failures"][0]["index"] == 1
    assert p["failures"][0]["error"] == "ValueError"

    def submit2(i):
        f = Future()
        if i == 0:
            f.set_result(_R([7]))
        return f

    job2 = BatchJob("generate", 4, submit2,
                    lambda i, r: {"index": i, "tokens": list(r.tokens)},
                    window=2)._start()
    assert job2.progress()["completed"] == 1
    job2.cancel()
    job2.cancel()                              # idempotent
    p2 = job2.wait(timeout_s=5.0)
    assert p2["state"] == "cancelled"
    assert job2.result_rows() == [{"index": 0, "tokens": [7]}]
    led = JobLedger(max_jobs=8)
    led.add(job2)
    s = led.summary()
    assert s["jobs"] == 1 and s["cancelled"] == 1


# -- reserve watermark admission ---------------------------------------------

def test_reserve_watermark_admission_math(pm):
    """The batch budget is docked the interactive reserve; a batch item
    that can NEVER fit behind the watermark is refused at submit."""
    cfg = EngineCfg(n_slots=2, steps_per_tick=2, kv_cache_blocks=8,
                    interactive_reserve_blocks=4, default_timeout_s=600.0)
    with ServingEngine(lm=pm, cfg=cfg) as e:
        pool = e.pool
        assert pool.interactive_reserve == 4
        assert pool.can_admit(30, 7, lane="interactive")
        assert pool.can_admit(30, 7, lane="batch")          # 3 <= 4
        assert pool.can_admit(60, 10, lane="interactive")   # 5 <= 8
        assert not pool.can_admit(60, 10, lane="batch")     # 5 > 4
        assert pool.reserve_occupancy_pct == 0.0
        g = pool.gauges()
        assert g["interactive_reserve_blocks"] == 4.0
        assert g["reserve_free_blocks"] == 4.0
        p = _prompts([60], seed=1)[0]
        with pytest.raises(ValueError, match="batch lane"):
            e.submit_batch_item(p, 10)
        e.generate(p, 10)                      # interactive lane serves it
    cfg = EngineCfg(n_slots=2, steps_per_tick=2, kv_cache_blocks=16,
                    interactive_reserve_blocks=-1, default_timeout_s=600.0)
    with ServingEngine(lm=pm, cfg=cfg) as e:
        assert e.pool.interactive_reserve == 4   # auto: a quarter


# -- batch jobs through the engine -------------------------------------------

def test_batch_items_equal_direct_greedy_and_seeded(eng, pm):
    """A batch job's rows equal the direct path: greedy against sequential
    generate, seeded against submit_generate with item i's
    ``item_generator(seed, i)``. Lane metrics and depths flow."""
    prompts = _prompts([12, 20, 17, 9], seed=7)
    greedy = [pm.generate(p[None, :], 10)[0] for p in prompts]
    job = eng.submit_batch(prompts, kind="generate", num_steps=10)
    p = job.wait(timeout_s=WAIT)
    assert p["state"] == "done" and p["completed"] == 4
    for i, r in enumerate(job.result_rows()):
        assert r["tokens"] == [int(t) for t in greedy[i]], i
    direct = [eng.submit_generate(q, 8, temperature=0.7,
                                  rng=item_generator(11, i))
              for i, q in enumerate(prompts)]
    sampled = [f.result(timeout=WAIT).tokens for f in direct]
    job2 = eng.submit_batch(prompts, kind="generate", num_steps=8,
                            temperature=0.7, seed=11)
    job2.wait(timeout_s=WAIT)
    for i, r in enumerate(job2.result_rows()):
        assert r["tokens"] == [int(t) for t in sampled[i]], i
    assert [r["tokens"] for r in job2.result_rows()] != \
        [r["tokens"][:8] for r in job.result_rows()]   # it did sample
    snap = eng.snapshot()
    assert snap["serve.batch_items"] >= 8.0
    h = eng.health()
    assert h["interactive_depth"] == 0 and h["batch_depth"] == 0
    with pytest.raises(ValueError, match="seed"):
        eng.submit_batch(prompts, num_steps=4, temperature=0.7)


def test_interactive_preempts_batch_identical(pm):
    """Under a pool too tight for both lanes the interactive arrival evicts
    BATCH streams first and both lanes keep their tokens."""
    cfg = EngineCfg(n_slots=2, steps_per_tick=4, kv_cache_blocks=12,
                    max_resident=4, block_overcommit=3.0,
                    interactive_reserve_blocks=2, default_timeout_s=600.0)
    with ServingEngine(lm=pm, cfg=cfg) as e:
        bp = _prompts([30, 31, 33, 34], seed=3)
        ip = _prompts([28], seed=5)[0]
        bref = [pm.generate(p[None, :], 40)[0] for p in bp]
        iref = pm.generate(ip[None, :], 40)[0]
        job = e.submit_batch(bp, kind="generate", num_steps=40)
        deadline = time.monotonic() + 30
        while (e.health()["busy_slots"] < 2
               and time.monotonic() < deadline):
            time.sleep(0.002)            # let batch streams go resident
        fi = e.submit_generate(ip, 40)
        np.testing.assert_array_equal(fi.result(timeout=WAIT).tokens, iref)
        p = job.wait(timeout_s=WAIT)
        assert p["state"] == "done" and p["completed"] == 4
        for i, r in enumerate(job.result_rows()):
            assert r["tokens"] == [int(t) for t in bref[i]], i
        snap = e.snapshot()
        assert snap["serve.batch_preemptions"] >= 1.0
        assert snap["serve.batch_preemptions"] == snap["serve.preemptions"]


def test_job_resumes_across_engine_restart_exactly_once(eng, pm):
    """force_fail mid-job + restart(): in-flight items fail with a
    retryable ReplicaFailed, the pump backs off while the engine is down,
    and the SAME job finishes with every row exactly once."""
    prompts = _prompts([10, 14, 11, 13, 9, 12], seed=17)
    refs = [pm.generate(p[None, :], 12)[0] for p in prompts]
    gen_before = eng.generation
    job = eng.submit_batch(prompts, kind="generate", num_steps=12,
                           window=2, retry_base_s=0.02, retry_max_s=0.2)
    deadline = time.monotonic() + 60.0
    while (job.progress()["completed"] < 1
           and time.monotonic() < deadline):
        time.sleep(0.002)
    assert job.progress()["completed"] >= 1
    eng.force_fail("stalled", "lane drill")
    eng.restart()
    assert eng.generation == gen_before + 1
    p = job.wait(timeout_s=WAIT)
    assert p["state"] == "done"
    assert p["completed"] == 6 and p["failed"] == 0
    rows = job.result_rows()
    assert [r["index"] for r in rows] == list(range(6))   # no dup, no loss
    for i, r in enumerate(rows):
        assert r["tokens"] == [int(t) for t in refs[i]], i


def test_lane_metrics_snapshot_merge_prometheus():
    """Batch records count toward throughput but never the interactive
    latency tails; batch counters and the reserve gauge pair flow through
    snapshot, merge and Prometheus rendering."""
    a, b = EngineMetrics(), EngineMetrics()
    t0 = 100.0
    a.record(RequestRecord("lm", t0, t0 + 0.001, t0 + 0.003, t0 + 0.008,
                           tokens=6))
    a.record(RequestRecord("lm", t0, t0 + 0.002, t0 + 0.5, t0 + 1.0,
                           tokens=40, lane="batch"))
    b.record(RequestRecord("lm", t0, t0 + 0.001, t0 + 0.4, t0 + 0.9,
                           tokens=30, lane="batch"))
    a.count("batch_preemptions", 2)
    a.count("preemptions", 2)
    a.set_gauges({"interactive_reserve_blocks": 4.0,
                  "reserve_free_blocks": 1.0})
    snap = a.snapshot()
    assert snap["serve.batch_items"] == 1.0
    assert snap["serve.batch_tokens_out"] == 40.0
    assert snap["serve.tokens_out"] == 46.0
    assert snap["serve.total_ms_p99"] == pytest.approx(8.0)
    assert snap["serve.reserve_occupancy_pct"] == pytest.approx(75.0)
    merged = merge_metrics([a, b]).snapshot()
    assert merged["serve.batch_items"] == 2.0
    assert merged["serve.batch_tokens_out"] == 70.0
    assert merged["serve.batch_preemptions"] == 2.0
    text = render_prometheus([a, b])
    lines = dict(ln.rsplit(" ", 1) for ln in text.splitlines()
                 if ln and not ln.startswith("#"))
    assert lines["ddw_serve_batch_preemptions_total"] == "2"
    assert lines["ddw_serve_batch_items_total"] == "2"
    assert lines["ddw_serve_batch_tokens_out_total"] == "70"
