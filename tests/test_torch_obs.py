"""The observability plane of the PyTorch port on the CPU (``ddw_tpu_torch.
obs`` trace / telemetry / slo, ``ddw_tpu_torch.utils.sysmon``, and the
engine's and trainers' hooks), mirroring ``tests/test_trace.py``,
``tests/test_telemetry.py`` and ``tests/test_sysmon.py``: the trace ring's
drop-oldest accounting, ids and exporters, with the port's NDJSON loading
through ``ddw_tpu``'s ``load_events`` and both ``chrome_trace``s agreeing;
the hub's watermarks, drops and faulty collectors; ``window_stats``,
``merge_feeds`` and ``FleetTelemetry`` equal to ``ddw_tpu``'s on seeded
feeds; the SLO state machine making ``ddw_tpu``'s transitions on the same
feed, and its atomic postmortem; every incremented counter registered; the
trace-off and telemetry-off hot paths touching neither; an engine's request
spans chained from admission to the last token, and its flight recorder on
a failure; the sysmon keys and the monitor's series in a run; and the
trainers' ``trace_dir`` / ``monitor_interval_s`` / ``tracer=`` hooks (span
names equal to ``ddw_tpu``'s LMTrainer's)."""

import dataclasses
import glob
import json
import os
import re
import time

import jax
import numpy as np
import pytest
import torch

from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.obs import slo as jax_slo
from ddw_tpu.obs import telemetry as jax_telemetry
from ddw_tpu.obs import trace as jax_trace
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
from ddw_tpu.utils.config import TrainCfg as JaxTrainCfg
from ddw_tpu_torch.obs.slo import PAGE, SLOMonitor, SLOObjective
from ddw_tpu_torch.obs.telemetry import (FleetTelemetry, TelemetryHub,
                                         merge_feeds, signal_registry,
                                         tee_run, window_stats)
from ddw_tpu_torch.obs.trace import (Tracer, chrome_trace, load_events,
                                     span_index, to_ndjson)
from ddw_tpu_torch.serve import (EngineCfg, EngineMetrics, ServingEngine,
                                 render_prometheus)
from ddw_tpu_torch.serving.lm_package import LMPackagedModel
from ddw_tpu_torch.tracking.tracker import Tracker
from ddw_tpu_torch.train import lm_trainer as tlt
from ddw_tpu_torch.utils.config import LMCfg, TrainCfg
from ddw_tpu_torch.utils.sysmon import (SystemMonitor, host_keys_available,
                                        sample_system)

VOCAB = 64
WAIT = 120
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    out = str(tmp_path_factory.mktemp("obs_pkg") / "pkg")
    return LMPackagedModel(jax_lm_package.save_lm_package(out, cfg, params),
                           device="cpu")


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=(n,)).astype(np.int32)
            for n in lengths]


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# -- the trace ring and its exporters ----------------------------------------

def test_trace_ring_ids_and_exporters_cross_packages(tmp_path):
    """Drop-oldest accounting, pre-allocated span ids and parentage; the
    port's NDJSON and Chrome exports reload through ddw_tpu's load_events,
    and both packages' chrome_trace give the same document for the same
    events; the flight dump loads and fails best-effort."""
    tr = Tracer(capacity=4, process="unit")
    for i in range(10):
        tr.instant(f"ev{i}", "test")
    assert tr.spans_dropped == 6
    assert [e["name"] for e in tr.drain()] == ["ev6", "ev7", "ev8", "ev9"]
    s = tr.summary()
    assert (s["events"], s["dropped"], s["last_seq"]) == (4, 6, 10)
    assert [e["name"] for e in tr.drain(since=8)] == ["ev8", "ev9"]

    tr = Tracer(capacity=64, process="replica0")
    with tr.span("outer", "test", trace="t1", args={"k": 1}) as sp:
        child = tr.record_span("inner", "test", 1.0, 2.0, trace="t1",
                               parent=sp.id)
        sp.set(routed=3)
    a = tr.record_span("queue", "serve", 1.0, 1.1, trace="tr-1",
                       tid="serve")
    tr.record_span("decode", "serve", 1.1, 1.5, trace="tr-1", parent=a,
                   tid="serve", args={"tokens": 4})
    evs = tr.drain()
    inner = next(e for e in evs if e["name"] == "inner")
    assert inner["parent"] == sp.id and inner["span"] == child
    assert inner["dur"] == pytest.approx(1e6)
    assert Tracer(capacity=4)._next_span_id() != tr._next_span_id()

    nd = tmp_path / "ring.ndjson"
    nd.write_text(to_ndjson(evs))
    for loader in (load_events, jax_trace.load_events):
        back = loader(str(nd))
        assert [e["name"] for e in back] == [e["name"] for e in evs]
        assert back[-1]["parent"] == a and back[-1]["trace"] == "tr-1"
    ch = chrome_trace(evs)
    assert ch == jax_trace.chrome_trace(evs)
    cj = tmp_path / "ring.chrome.json"
    cj.write_text(json.dumps(ch))
    dec = next(e for e in jax_trace.load_events(str(cj))
               if e["name"] == "decode")
    assert dec["pid"] == "replica0" and dec["parent"] == a
    assert span_index(evs)["tr-1"] == jax_trace.span_index(evs)["tr-1"]
    assert tr.dump_flight(str(tmp_path / "flight.json"))
    assert len(load_events(str(tmp_path / "flight.json"))) == len(evs)
    assert tr.dump_flight(str(tmp_path / "nope" / "f.json")) is False


# -- the hub -----------------------------------------------------------------

def test_hub_watermarks_drops_and_faulty_collectors():
    hub = TelemetryHub(capacity=16, source="t", clock=_Clock(50.0))
    hub.record("c", 1.0, kind="counter")
    hub.observe("lat_ms", 5.0)
    d = hub.drain(0)
    assert [s["name"] for s in d["samples"]] == ["c", "lat_ms"]
    assert d["samples"][1]["kind"] == "dist" and d["last_seq"] == 2
    assert hub.drain(2)["samples"] == [] and hub.drain(2)["last_seq"] == 2
    small = TelemetryHub(capacity=4, clock=_Clock())
    for i in range(10):
        small.record("g", float(i))
    assert small.samples_dropped == 6
    assert [s["value"] for s in small.drain(0)["samples"]] == [6, 7, 8, 9]
    with pytest.raises(ValueError):
        TelemetryHub(capacity=0)
    hub = TelemetryHub(clock=_Clock(7.0))
    hub.add_collector(lambda: {"q": ("gauge", 3.0), "c": ("counter", 7.0)})

    def boom():
        raise RuntimeError("sampling must never take down the component")

    hub.add_collector(boom)
    hub.collect_once()
    hub.collect_once()
    assert len(hub.drain(0)["samples"]) == 4
    hub = TelemetryHub(interval_s=0.01, source="t")
    hub.add_collector(lambda: {"tick": ("counter", 1.0)})
    hub.start()
    deadline = time.time() + 5.0
    while time.time() < deadline and not hub.summary()["last_seq"]:
        time.sleep(0.01)
    hub.stop()
    n = hub.summary()["last_seq"]
    assert n > 0
    time.sleep(0.05)
    assert hub.summary()["last_seq"] == n          # really stopped


def _seeded_feeds(seed, now, n_src=3):
    """Random counter / gauge / dist samples over three sources, with a
    counter reset in one source."""
    rng = np.random.RandomState(seed)
    feeds = []
    for src in range(n_src):
        samples, seq, cum = [], 0, 0.0
        for _ in range(60):
            seq += 1
            ts = float(now - rng.uniform(0, 90))
            kind = ("counter", "gauge", "dist")[rng.randint(3)]
            if kind == "counter":
                cum += float(rng.randint(0, 5))
                if rng.rand() < 0.05:
                    cum = 0.0                      # a respawned source
                v = cum
            else:
                v = float(rng.lognormal(3.0, 1.0))
            samples.append({"seq": seq, "ts": ts, "name": f"{kind}.x",
                            "kind": kind, "value": v})
        samples.sort(key=lambda s: s["ts"])
        feeds.append({"source": f"r{src}", "samples": samples})
    return feeds


def test_window_stats_merge_feeds_and_fleet_equal_jax():
    now = 10_000.0
    feeds = _seeded_feeds(3, now)
    widths = (1.0, 10.0, 60.0)
    assert (merge_feeds(feeds, widths=widths, now=now)
            == jax_telemetry.merge_feeds(feeds, widths=widths, now=now))
    for f in feeds:
        assert (window_stats(f, widths=widths, now=now)
                == jax_telemetry.window_stats(f, widths=widths, now=now))
    port, ref = FleetTelemetry(widths=widths), \
        jax_telemetry.FleetTelemetry(widths=widths)
    for f in feeds + [{"source": "r0", "samples": feeds[0]["samples"][:5]},
                      {"source": "r1", "cached": True,
                       "samples": feeds[1]["samples"][:3]}]:
        assert port.ingest(f["source"], f) == ref.ingest(f["source"], f)
    port.drop_replica("r2")
    ref.drop_replica("r2")
    assert port.merged(now=now) == ref.merged(now=now)
    hub = TelemetryHub(clock=_Clock())
    tee = tee_run(type("R", (), {"log_metric": lambda *a, **k: None,
                                 "log_metrics": lambda *a, **k: None})(),
                  hub)
    tee.log_metrics({"chain_ms": 12.0, "images_per_sec": 5.0, "note": "x"})
    assert hub.signals() == {"chain_ms": "dist", "images_per_sec": "gauge"}


def test_slo_transitions_equal_jax_and_sentinel(tmp_path):
    """The same feed sequence (healthy, a burn, recovery) through both
    SLOMonitors gives the same states, transition history and budgets;
    a page writes one atomic postmortem."""
    def mk(mod, dump=None):
        obj = mod.SLOObjective(name="ttft", kind="latency",
                               signal="serve.ttft_ms", threshold=50.0,
                               target=0.9)
        return mod.SLOMonitor([obj], fast=(10.0, 5.0), slow=(40.0, 20.0),
                              page_burn=2.0, warn_burn=1.0, clear_evals=2,
                              clock=_Clock(5000.0), dump_dir=dump)

    rng = np.random.RandomState(11)
    port = mk(__import__("ddw_tpu_torch.obs.slo", fromlist=["x"]),
              str(tmp_path))
    ref = mk(jax_slo)
    now, seq = 5000.0, 0
    for step in range(30):
        now += 1.0
        bad = 8 <= step < 14                      # a burst of slow requests
        vals = (rng.uniform(100, 500, 4) if bad
                else rng.uniform(1, 40, 4))
        samples = []
        for v in vals:
            seq += 1
            samples.append({"seq": seq, "ts": now - 0.5,
                            "name": "serve.ttft_ms", "kind": "dist",
                            "value": float(v)})
        feeds = [{"source": "r0", "samples": samples}]
        for mon in (port, ref):
            mon.ingest("r0", samples)
        assert port.evaluate(feeds, now=now) == ref.evaluate(feeds, now=now)
    hist = [(h["from"], h["to"]) for h in port.history]
    assert hist == [(h["from"], h["to"]) for h in ref.history]
    assert ("warning", "page") in hist and hist[-1][1] == "ok"
    assert (port.status()["objectives"]["ttft"]["budget"]
            == ref.status()["objectives"]["ttft"]["budget"])
    assert len(port.dumps) == 1 and not glob.glob(str(tmp_path / "*.tmp"))
    with open(port.dumps[0]) as f:
        payload = json.load(f)
    assert payload["transition"]["to"] == PAGE
    assert set(payload) == {"objective", "transition", "burn_windows",
                            "windows", "budget", "history", "flight"}
    with pytest.raises(ValueError):
        SLOObjective(name="x", kind="latency", signal="s", target=1.0)


def test_every_incremented_counter_is_exported_and_registered():
    """Every counter name the port's serve/ and obs/ increment appears in
    the Prometheus exposition and in signal_registry."""
    srcs = []
    for pkg in ("ddw_tpu_torch/serve", "ddw_tpu_torch/obs"):
        srcs += glob.glob(os.path.join(REPO, pkg, "*.py"))
    count_re = re.compile(r'\.count(?:_labeled)?\(\s*"([a-z0-9_]+)"')
    method_re = re.compile(r"\.count_(overloaded|deadline|cancelled)\(")
    stats_re = re.compile(r'self\.stats\["([a-z0-9_]+)"\]')
    method_map = {"overloaded": "shed_overloaded",
                  "deadline": "shed_deadline", "cancelled": "cancelled"}
    names = set()
    for path in srcs:
        with open(path) as f:
            text = f.read()
        names.update(count_re.findall(text))
        names.update(method_map[m] for m in method_re.findall(text))
        if path.endswith("blocks.py"):
            names.update(stats_re.findall(text))
        if path.endswith("engine.py"):
            names.update(re.findall(r'\("(adapter_[a-z0-9_]+)", ad\.',
                                    text))
    assert {"prefills", "decode_ticks", "shed_overloaded",
            "prefix_hit_tokens", "spec_proposed", "spec_accepted",
            "tenant_requests", "tenant_sheds", "adapter_loads",
            "adapter_evictions", "adapter_pins"} <= names
    reg = signal_registry()
    exposition = render_prometheus([EngineMetrics()])
    for name in sorted(names):
        assert f"ddw_serve_{name}_total" in exposition, name
        assert reg.get(f"serve.{name}") == "counter", name


# -- the engine's hooks --------------------------------------------------------

class _Counting:
    """Records every attribute touch: stands in for the tracer or the hub
    to pin that the off switch keeps the hot path free of them."""

    def __init__(self):
        object.__setattr__(self, "touches", [])

    def __getattr__(self, name):
        self.touches.append(name)
        return lambda *a, **k: None


def test_trace_off_and_telemetry_off_never_touch_tracer_or_hub(pm):
    with ServingEngine(lm=pm, cfg=EngineCfg(
            n_slots=2, steps_per_tick=2, default_timeout_s=600.0)) as eng:
        tstub, hstub = _Counting(), _Counting()
        eng.tracer, eng.telem = tstub, hstub
        assert eng._tracing is False and eng._telemetry is False
        r1 = eng.submit_generate(_prompts([8], seed=7)[0], 6).result(WAIT)
        r2 = eng.submit_generate(_prompts([12], seed=8)[0], 4).result(WAIT)
        assert len(r1.tokens) == 6 and len(r2.tokens) == 4
        assert tstub.touches == [] and hstub.touches == []
        eng.telem = None
        feed = eng.telemetry_events(since=5)
        assert feed["samples"] == [] and feed["last_seq"] == 5
        assert eng.health()["telemetry"] is None
        assert eng.health()["trace"] is None


def test_engine_spans_chain_each_request_and_ride_failures(pm, tmp_path):
    """trace=True: each request's spans share its trace id and chain
    queue -> prefill -> decode by parent pointers, from submission to its
    last token; telemetry=True observes each request and samples
    counters; monitor_interval_s logs sys.* series into the run; a
    forced failure carries the ring's tail."""
    tracker = Tracker(str(tmp_path / "runs"), experiment="obs")
    run = tracker.start_run("serve")
    cfg = EngineCfg(n_slots=2, steps_per_tick=2, default_timeout_s=600.0,
                    trace=True, telemetry=True, telemetry_interval_s=0.02)
    prompts = _prompts([8, 13, 5], seed=3)
    eng = ServingEngine(lm=pm, cfg=cfg, run=run, monitor_interval_s=0.02)
    with eng:
        futs = [eng.submit_generate(p, 6, trace_id=f"req-{i}")
                for i, p in enumerate(prompts)]
        res = [f.result(timeout=WAIT) for f in futs]
        time.sleep(0.1)
        feed = eng.telemetry_events()
        evs = eng.trace_events()["events"]
        assert eng.health()["trace"]["events"] == len(evs)
    by_trace = span_index(evs)
    for i, r in enumerate(res):
        chain = by_trace[f"req-{i}"]
        assert [e["name"] for e in chain] == ["queue", "prefill", "decode"]
        for prev, nxt in zip(chain, chain[1:]):
            assert nxt["parent"] == prev["span"]
        t_last = chain[-1]["ts"] + chain[-1]["dur"]
        assert t_last >= chain[0]["ts"] + r.total_ms * 1e3 * 0.99
    assert any(e["name"] == "tick" for e in evs)
    assert {"serve.ttft_ms", "serve.prefills"} <= {
        s["name"] for s in feed["samples"]}
    mon = SLOMonitor([SLOObjective(name="ttft", kind="latency",
                                   signal="serve.ttft_ms",
                                   threshold=60_000.0, target=0.99)])
    assert mon.evaluate([feed]) == {"ttft": "ok"}
    run.end()
    if host_keys_available():
        hist = tracker.get_run(run.run_id).metric_history(
            "sys.host_mem_percent")
        assert len(hist) >= 2
    eng.force_fail("stalled", "flight drill")
    flight = eng.failure.forensics["flight"]
    assert {"prefill", "decode"} <= {e["name"] for e in flight}
    assert eng.failure.forensics["spans_dropped"] == 0
    eng.stop()


# -- sysmon --------------------------------------------------------------------

def test_sysmon_keys_and_monitor_series(tmp_path):
    """Host keys when psutil imports (absent, not faked, otherwise); no
    device keys for a CPU device; the monitor logs ordered series into a
    run and stops idempotently."""
    s = sample_system(torch.device("cpu"))
    assert not any(k.startswith("sys.device_") for k in s)
    if host_keys_available():
        assert 0.0 <= s["sys.host_cpu_percent"] <= 100.0
        assert 0.0 < s["sys.host_mem_percent"] <= 100.0
        assert s["sys.proc_rss_gb"] > 0.0
    else:
        assert s == {}
    tracker = Tracker(str(tmp_path), experiment="mon")
    with tracker.start_run("utilization") as run:
        with SystemMonitor(run, interval_s=0.02, device="cpu"):
            time.sleep(0.15)
    if host_keys_available():
        hist = tracker.get_run(run.run_id).metric_history(
            "sys.host_mem_percent")
        assert len(hist) >= 2
        assert [st for st, _ in hist] == sorted(st for st, _ in hist)
    mon = SystemMonitor(run=None, interval_s=0.02).start()
    time.sleep(0.05)
    mon.stop()
    mon.stop()
    assert mon._thread is None


# -- the trainers' hooks ---------------------------------------------------------

LM = dict(vocab_size=VOCAB, max_len=64, hidden=32, depth=2, num_heads=2,
          mlp_dim=64, dropout=0.0, dtype="float32")


def _lm_tokens(n=32, seq=16, seed=0):
    rng = np.random.RandomState(seed)
    starts = rng.randint(0, VOCAB, size=(n, 1))
    steps = rng.randint(1, 4, size=(n, 1))
    return ((starts + steps * np.arange(seq + 1)[None, :])
            % VOCAB).astype(np.int32)


def test_lm_trainer_tracer_span_names_equal_jax(tmp_path):
    """LMTrainer(tracer=) records ddw_tpu's chain-boundary spans: the same
    names, categories, count and k per span as ddw_tpu's LMTrainer over the
    same plan; trace_dir writes a Chrome trace and logs the param, and the
    monitor logs sys.* series."""
    tr = TrainCfg(batch_size=4, epochs=2, warmup_epochs=0,
                  learning_rate=5e-3, steps_per_dispatch=2)
    jtracer = jax_trace.Tracer(process="train")
    jcfg = JaxTrainCfg(**dataclasses.asdict(tr) | {"num_devices": 1})
    JaxLMTrainer(JaxLMCfg(**LM), jcfg, tracer=jtracer).fit(_lm_tokens())
    tracer = Tracer(process="train")
    tracker = Tracker(str(tmp_path / "runs"), experiment="lm")
    run = tracker.start_run("lm")
    cfg = dataclasses.replace(tr, trace_dir=str(tmp_path / "trace"),
                              monitor_interval_s=0.02)
    tlt.LMTrainer(LMCfg(**LM), cfg, device="cpu", run=run,
                  tracer=tracer).fit(_lm_tokens())
    run.end()

    def shape(evs):
        return [(e["name"], e["cat"], e["tid"], e["args"]["k"],
                 e["args"]["chained"], e["args"]["epoch"]) for e in evs]

    got, want = tracer.drain(), jtracer.drain()
    assert shape(got) == shape(want) and len(got) >= 4
    assert [e["args"]["step"] for e in got] == \
        [e["args"]["step"] for e in want]
    traces = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]
    params = tracker.get_run(run.run_id).params()
    assert params["trace_dir"] == os.path.abspath(str(tmp_path / "trace"))
    if host_keys_available():
        assert tracker.get_run(run.run_id).metric_history(
            "sys.host_mem_percent")
