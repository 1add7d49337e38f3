"""The gateway-bound drills of the serving engine's satellites, on a port
fleet on the CPU (the counterparts of ``tests/test_adapters.py``,
``test_lanes.py``, ``test_telemetry.py`` and ``test_trace.py``'s fleet
drills): a staged ``/admin/adapters`` load that one replica cannot take
rolls back everywhere, a deploy fences it with 409, a healthy load salts
routing and unloads clean; ``/v1/batch`` submit, poll, NDJSON results and
cancel, with seeded rows equal to the in-thread engine's draws from
``item_generator(seed, i)``, lane depths and the ledger in ``/stats``;
``DDW_FAULT=serve:crash:site=batch`` mid-job resumes with every index
exactly once; the fleet telemetry endpoints and SLO exposition, and the
relay form on a telemetry-off gateway; a traced request that reads as one
causal chain from the gateway's http span to the decode span, joined to
the request's jsonl row; a crash's forensics carrying the flight
recorder's tail. Every gateway is stopped."""

import concurrent.futures
import dataclasses
import functools
import os
import time
import zlib

import jax
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.models.lora import merge_base_params
from ddw_tpu.serve import adapters as jax_adapters
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu_torch.gateway import (Gateway, GatewayClient, GatewayError,
                                   ReplicaSet)
from ddw_tpu_torch.obs.slo import SLOObjective
from ddw_tpu_torch.obs.trace import span_index
from ddw_tpu_torch.serve import EngineCfg, ReplicaFailed, ServingEngine
from ddw_tpu_torch.serve.adapters import save_adapter
from ddw_tpu_torch.serve.lanes import item_generator
from ddw_tpu_torch.serve.metrics import EngineMetrics
from ddw_tpu_torch.serving.lm_package import LMPackagedModel

VOCAB = 64
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
        str(tmp_path_factory.mktemp("drills_pkg") / "pkg"), cfg, params)


@pytest.fixture(scope="module")
def pm(pkg_dir):
    return LMPackagedModel(pkg_dir, device="cpu")


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=(n,)).astype(np.int32)
            for n in lengths]


# -- adapters: staged fleet load, rollback, deploy fence ----------------------

@functools.cache
def _adapter_tree(pkg_dir):
    """A rank-2 adapter over query/value/fc1 with a seeded nonzero B (a
    zero B would make the adapter the identity)."""
    jpm = jax_lm_package.load_lm_package(pkg_dir)
    lcfg = dataclasses.replace(jpm.lm_cfg, lora_rank=2, lora_alpha=4.0,
                               lora_targets=("query", "value", "fc1"))
    lparams = jax_build_lm(lcfg).init({"params": jax.random.PRNGKey(1)},
                                      np.zeros((1, 8), np.int32))["params"]
    lparams = merge_base_params(lparams, jpm.params)

    def rand_b(node, path=()):
        if isinstance(node, dict):
            return {k: rand_b(v, path + (k,)) for k, v in node.items()}
        if path and path[-1] == "lora_b":
            rng = np.random.RandomState(
                zlib.crc32("/".join(path).encode()) % 2**31)
            return (2.0 * rng.randn(*node.shape)).astype(np.float32)
        return np.asarray(node)

    return jax_adapters.extract_adapter(rand_b(lparams))


def test_gateway_staged_adapter_load_rollback_and_deploy_fence(
        pm, pkg_dir, tmp_path):
    apath = str(tmp_path / "fin.npz")
    dg = save_adapter(apath, _adapter_tree(pkg_dir), rank=2, alpha=4.0)
    cfg_a = EngineCfg(n_slots=2, steps_per_tick=2, default_timeout_s=600.0,
                      adapter_slots=2, adapter_rank=2)
    cfg_none = dataclasses.replace(cfg_a, adapter_slots=0)
    engines = [ServingEngine(lm=pm, cfg=cfg_a),
               ServingEngine(lm=pm, cfg=cfg_none)]
    gw = Gateway(engines, grace_s=60.0, supervise=False)
    gw.start(warmup_prompt_lens=(8,))
    cli = GatewayClient("127.0.0.1", gw.port, max_retries=0)
    try:
        with pytest.raises(GatewayError) as ei:
            cli.adapters(op="load", adapter_id="fin", path=apath)
        assert ei.value.status == 500
        assert ei.value.body["error"] == "stage_failed"
        assert ei.value.body["status"] == "rolled_back"
        assert engines[0].adapter_view()["adapters"] == {}
        assert "fin" not in gw.replica_set.adapter_digests
        with pytest.raises(GatewayError):
            cli.generate([1, 2, 3, 4], 2, adapter_id="fin")
    finally:
        gw.stop()
    eng = ServingEngine(lm=pm, cfg=cfg_a)
    gw = Gateway(eng, grace_s=60.0, supervise=False)
    gw.start(warmup_prompt_lens=(8,))
    cli = GatewayClient("127.0.0.1", gw.port, max_retries=0)
    try:
        out = cli.adapters(op="load", adapter_id="fin", path=apath)
        assert out["status"] == "loaded" and out["digest"] == dg
        assert gw.replica_set.adapter_digests["fin"] == dg
        view = cli.adapters(op="list")
        assert view["registry"]["fin"] == dg
        assert "fin" in view["replicas"]["0"]["adapters"]
        with gw._deploy_lock:
            gw.deploy_status["deploying"] = True
        with pytest.raises(GatewayError) as ei:
            cli.adapters(op="load", adapter_id="other", path=apath)
        assert ei.value.status == 409
        assert ei.value.body["error"] == "deploy_in_progress"
        with gw._deploy_lock:
            gw.deploy_status["deploying"] = False
        p = _prompts([6], seed=4)[0]
        adapted = cli.generate(p.tolist(), 5, adapter_id="fin")["tokens"]
        direct = eng.generate(p, 5, adapter_id="fin").tokens
        assert adapted == [int(t) for t in direct]
        assert adapted != [int(t) for t in pm.generate(p[None], 5)[0]]
        out = cli.adapters(op="unload", adapter_id="fin")
        assert out["status"] == "unloaded"
        assert cli.adapters(op="list")["registry"] == {}
        ops = [o["op"] + ":" + o["status"]
               for o in cli.stats()["adapters"]["ops"]]
        assert ops == ["load:loaded", "unload:unloaded"]
    finally:
        gw.stop()


# -- the batch lane over HTTP -------------------------------------------------

@pytest.fixture(scope="module")
def gwx(pm):
    """One supervised two-replica gateway: the endpoint drill runs clean,
    the chaos drill (after it) kills replica 0 at a batch admission."""
    engines = [ServingEngine(lm=pm, cfg=EngineCfg(
        n_slots=2, steps_per_tick=4, default_timeout_s=600.0),
        replica_id=i) for i in range(2)]
    g = Gateway(ReplicaSet(engines), grace_s=30.0,
                supervisor_kw=dict(max_restarts=2, backoff_base_s=0.1,
                                   backoff_max_s=0.5, jitter=0.0,
                                   poll_interval_s=0.05))
    g.start()
    c = GatewayClient("127.0.0.1", g.port)
    assert c.wait_ready(WAIT)
    yield g, c, engines
    g.stop()


def test_http_batch_endpoints_and_lane_stats(gwx, pm):
    """Seeded rows over the wire equal an in-thread engine's draws from
    ``item_generator(seed, i)``; a cancelled job keeps its completed
    rows; lanes and the ledger show in /stats and /readyz; unknown jobs
    404; batch counters reach /metrics."""
    g, cli, _ = gwx
    prompts = _prompts([14, 9, 12], seed=23)
    with ServingEngine(lm=pm, cfg=EngineCfg(n_slots=2)) as eng:
        refs = [eng.generate(p, 8, temperature=0.6,
                             rng=item_generator(5, i)).tokens
                for i, p in enumerate(prompts)]
    sub = cli.submit_batch(prompts, num_steps=8, temperature=0.6, seed=5)
    assert sub["total"] == 3
    st = cli.batch_wait(sub["job_id"], timeout_s=WAIT)
    assert st["state"] == "done" and st["completed"] == 3
    rows = cli.batch_results(sub["job_id"])
    assert [r["tokens"] for r in rows] == [[int(t) for t in r]
                                           for r in refs]
    sub2 = cli.submit_batch(_prompts([10] * 48, seed=3), num_steps=60)
    st2 = cli.batch_cancel(sub2["job_id"])
    assert st2["state"] == "cancelled"
    assert cli.batch_status(sub2["job_id"])["state"] == "cancelled"
    lanes = cli.stats()["lanes"]
    for key in ("interactive_depth", "batch_depth", "reserve_occupancy_pct",
                "jobs", "running", "done", "cancelled", "items_pending"):
        assert key in lanes, key
    assert lanes["done"] >= 1 and lanes["cancelled"] >= 1
    assert "lanes" in cli.readyz()[1]
    with pytest.raises(GatewayError) as ei:
        cli.batch_status("job-nope")
    assert ei.value.status == 404
    text = cli.metrics_text()
    assert "ddw_serve_batch_items" in text
    assert "ddw_serve_batch_preemptions" in text


def test_batch_site_crash_resumes_with_no_dup_and_no_loss(gwx, pm,
                                                          monkeypatch):
    """``serve:crash:site=batch:replica=0:after=2`` kills replica 0 at its
    third batch admission mid-job: the supervisor restarts it, the
    host-side pump resubmits, and every index lands once with sequential
    generate's tokens."""
    g, cli, engines = gwx
    gen0 = engines[0].generation
    monkeypatch.setenv("DDW_FAULT", "serve:crash:site=batch:replica=0:after=2")
    prompts = _prompts([14] * 10, seed=13)
    refs = [pm.generate(p[None], 12)[0] for p in prompts]
    sub = cli.submit_batch(prompts, num_steps=12)
    st = cli.batch_wait(sub["job_id"], timeout_s=WAIT)
    monkeypatch.delenv("DDW_FAULT")
    assert st["state"] == "done"
    assert st["completed"] == 10 and st["failed"] == 0
    rows = cli.batch_results(sub["job_id"])
    assert [r["index"] for r in rows] == list(range(10))
    for i, r in enumerate(rows):
        assert r["tokens"] == [int(t) for t in refs[i]], i
    deadline = time.monotonic() + WAIT
    while engines[0].generation == gen0 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert engines[0].generation > gen0      # the crash really happened


# -- fleet telemetry ----------------------------------------------------------

THRESHOLD_MS = 150.0


def test_fleet_endpoints_expose_telemetry_and_slo(pm):
    engs = [ServingEngine(lm=pm, cfg=EngineCfg(
        n_slots=4, steps_per_tick=8, telemetry=True,
        telemetry_interval_s=0.05, trace=True, default_timeout_s=600.0),
        replica_id=i) for i in range(2)]
    slos = [SLOObjective(name="ttft", kind="latency", signal="serve.ttft_ms",
                         threshold=THRESHOLD_MS, target=0.9)]
    gw = Gateway(engs, grace_s=60.0, supervise=False, trace=True,
                 telemetry=True, telemetry_interval_s=0.05, slos=slos)
    gw.start(warmup_prompt_lens=(8,))
    cli = GatewayClient("127.0.0.1", gw.port, max_retries=0)
    try:
        for seed in (3, 4):
            cli.generate(_prompts([8], seed=seed)[0], 6)
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            tv = cli.telemetry()
            ttft = tv["windows"]["60s"]["signals"].get("serve.ttft_ms")
            if ttft and ttft["n"] >= 2:
                break
            time.sleep(0.05)
        st = cli.stats()
        tm = st["telemetry"]
        assert tm["gateway"]["source"] == "gateway"
        assert tm["gateway"]["samples"] > 0
        assert set(tm["sources"]) >= {"gateway", "replica0", "replica1"}
        slo = st["slo"]
        assert slo["evals"] > 0 and "ttft" in slo["objectives"]
        assert slo["objectives"]["ttft"]["threshold"] == THRESHOLD_MS
        assert set(tv["windows"]) == {"1s", "10s", "60s"}
        sig = tv["windows"]["60s"]["signals"]
        ttft = sig["serve.ttft_ms"]
        assert ttft["kind"] == "dist" and ttft["n"] >= 2
        assert ttft["p50"] <= ttft["p95"] <= ttft["p99"]
        assert sig["serve.completed"]["kind"] == "counter"
        assert sig["gateway.inflight"]["kind"] == "gauge"
        feed = cli.telemetry(replica=0, since=0)
        assert feed["source"] == "replica0" and feed["replica"] == 0
        seqs = [s["seq"] for s in feed["samples"]]
        assert seqs and seqs == sorted(seqs)
        again = cli.telemetry(replica=0, since=feed["last_seq"])
        assert all(s["seq"] > feed["last_seq"] for s in again["samples"])
        text = cli.metrics_text()
        assert "ddw_telemetry_samples_dropped" in text
        assert 'ddw_slo_state{objective="ttft"}' in text
        assert 'ddw_slo_attainment{objective="ttft"}' in text
    finally:
        cli.close()
        gw.stop()


def test_telemetry_off_gateway_404s_but_relays_children():
    class _FakeEngine:
        def __init__(self):
            self.metrics = EngineMetrics()

        def start(self):
            return self

        def stop(self):
            pass

        def warmup(self, *a, **kw):
            pass

        def telemetry_events(self, since=0):
            return {"source": "replica0", "replica": 0, "dropped": 0,
                    "samples": [{"seq": since + 1, "ts": 1.0,
                                 "name": "serve.queue_depth",
                                 "kind": "gauge", "value": 3.0}],
                    "last_seq": since + 1}

    gw = Gateway([_FakeEngine()], grace_s=1.0, supervise=False)
    gw.start(warmup_prompt_lens=())
    try:
        cli = GatewayClient("127.0.0.1", gw.port, max_retries=0)
        with pytest.raises(GatewayError) as exc:
            cli.telemetry()
        assert exc.value.status == 404
        feed = cli.telemetry(replica=0, since=7)
        assert feed["source"] == "replica0"
        assert feed["samples"][0]["seq"] == 8
        assert "ddw_telemetry_samples_dropped" not in cli.metrics_text()
        cli.close()
    finally:
        gw.stop()


# -- tracing through the gateway ----------------------------------------------

def test_traced_request_reads_as_one_chain_and_joins_its_row(pm):
    engines = [ServingEngine(lm=pm, replica_id=i, cfg=EngineCfg(
        n_slots=2, steps_per_tick=2, default_timeout_s=600.0,
        trace=True, trace_capacity=512)) for i in range(2)]
    gw = Gateway(engines, trace=True, supervise=False)
    with gw:
        cli = GatewayClient("127.0.0.1", gw.port, timeout_s=90.0)
        assert cli.wait_ready(WAIT)
        r = cli.generate(_prompts([8])[0], 6, trace_id="parentage-drill")
        assert r["trace_id"] == "parentage-drill"
        assert len(r["tokens"]) == 6
        dump = gw.trace_dump()
        chain = span_index(dump["events"]).get("parentage-drill", [])
        by = {e["name"]: e for e in chain}
        assert {"http", "route", "queue", "prefill", "decode"} <= set(by)
        for child, parent in (("route", "http"), ("queue", "route"),
                              ("prefill", "queue"), ("decode", "prefill")):
            assert by[child]["parent"] == by[parent]["span"], (child,
                                                               parent)
        assert by["http"]["pid"] == "gateway"
        assert by["decode"]["pid"].startswith("replica")
        assert by["decode"]["args"]["ticks"] >= 2
        assert "deadline_ms" in by["queue"]["args"]
        assert dump["dropped"] == 0 and "gateway" in dump["sources"]
        r = cli.generate(_prompts([6], seed=3)[0], 4, trace_id="join-drill")
        recs = [rec.to_dict() for eng in engines
                for rec in eng.metrics._records]
        mine = [rec for rec in recs if rec.get("trace_id") == "join-drill"]
        assert len(mine) == 1 and mine[0]["tokens"] == 4
        tb = cli.stats()["trace"]
        assert tb["spans_dropped"] == 0 and tb["gateway"]["events"] > 0
        assert tb["replicas"] and all("events" in s for s in tb["replicas"])
        ch = cli.trace(chrome=True)
        assert {"M", "X", "s"} <= {e["ph"] for e in ch["traceEvents"]}


def test_serve_crash_forensics_carry_the_flight_tail(pm, monkeypatch):
    """``serve:crash:site=decode:after=1`` mid-decode: the future's
    ReplicaFailed carries the trace ring's tail from the doomed
    generation and the drop counter."""
    monkeypatch.setenv("DDW_FAULT", "serve:crash:site=decode:after=1")
    with ServingEngine(lm=pm, cfg=EngineCfg(
            n_slots=1, steps_per_tick=2, default_timeout_s=600.0,
            trace=True)) as eng:
        fut = eng.submit_generate(_prompts([8], seed=5)[0], 8)
        with pytest.raises(ReplicaFailed) as ei:
            fut.result(timeout=WAIT)
    flight = ei.value.forensics.get("flight")
    assert flight, "flight recorder missing from crash forensics"
    assert "prefill" in {e["name"] for e in flight}
    assert ei.value.forensics["spans_dropped"] == 0
    assert all(e["pid"] == "replica0" for e in flight)
