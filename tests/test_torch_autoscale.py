"""The autoscaler of the PyTorch port (``ddw_tpu_torch.autoscale``) on the
CPU, against ``ddw_tpu.autoscale`` on the same scripted inputs:
``ScalePolicy`` decisions (burn, queue, hysteresis band, the two window
speeds, both cooldowns, min/max clamps) and the input reducers agree; the
controller's burst-out / idle-in cycle over scripted fakes leaves the same
sizes, surge order, counters and journal rows; the four fault arms
(``spawn_fail``, ``stall_drain``, ``crash_mid_scale`` with its reconcile,
``flap``) and the deploy-lock exclusion behave alike. Then the gateway's
autoscale HTTP surface, and a burst/idle cycle over real port engines in
which greedy tokens never change across membership changes."""

import concurrent.futures
import json
import os
import threading
import types

import jax
import numpy as np
import pytest
import torch

import ddw_tpu.autoscale as jauto
import ddw_tpu.deploy.journal as jjournal
import ddw_tpu.gateway as jgw
import ddw_tpu.runtime.faults as jfaults
from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.serve.metrics import EngineMetrics as JaxEngineMetrics
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
import ddw_tpu_torch.autoscale as tauto
import ddw_tpu_torch.deploy.journal as tjournal
import ddw_tpu_torch.gateway as tgw
import ddw_tpu_torch.runtime.faults as tfaults
from ddw_tpu_torch.gateway import Gateway, GatewayClient, GatewayError
from ddw_tpu_torch.serve import EngineCfg, ServingEngine
from ddw_tpu_torch.serve.metrics import EngineMetrics
from ddw_tpu_torch.serving.lm_package import LMPackagedModel

WAIT = 60


def _ns(auto, gw, journal, faults, metrics):
    return types.SimpleNamespace(
        ScalePolicy=auto.ScalePolicy, PolicyInputs=auto.PolicyInputs,
        AutoscaleController=auto.AutoscaleController,
        inputs_from_windows=auto.inputs_from_windows,
        max_burn=auto.max_burn, ReplicaSet=gw.ReplicaSet,
        RolloutJournal=journal.RolloutJournal,
        AutoscaleCrash=faults.AutoscaleCrash, EngineMetrics=metrics)


PORT = _ns(tauto, tgw, tjournal, tfaults, EngineMetrics)
JAX = _ns(jauto, jgw, jjournal, jfaults, JaxEngineMetrics)


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _policy(ns, clk, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 3)
    kw.setdefault("queue_out", 8.0)
    kw.setdefault("queue_in", 1.0)
    kw.setdefault("out_cooldown_s", 0.0)
    kw.setdefault("in_cooldown_s", 0.0)
    return ns.ScalePolicy(clock=clk, **kw)


def _decision(d):
    return (d.action, d.desired, d.current, d.reason,
            round(d.cooldown_remaining_s, 6))


# each scenario: policy kwargs, then (advance_s, note, fast, slow) steps
SCENARIOS = {
    "burn_and_max": (dict(max_replicas=4, queue_out=None, queue_in=None),
                     [(0, None, dict(replicas=1, burn=3.0), None),
                      (0, None, dict(replicas=4, burn=3.0), None),
                      (0, None, dict(replicas=2, burn=0.1), None)]),
    "hysteresis": ({}, [(0, None, dict(replicas=2, queue_depth=8.0), None),
                        (0, None, dict(replicas=3),
                         dict(replicas=3, queue_depth=9.0)),
                        (0, None, dict(replicas=3), dict(replicas=3))]),
    "fast_window_out": ({}, [(0, None, dict(replicas=1, queue_depth=100.0),
                              dict(replicas=1))]),
    "cooldowns": (dict(out_cooldown_s=10.0, in_cooldown_s=30.0),
                  [(0, "out", None, None),
                   (5, None, dict(replicas=2, queue_depth=100.0), None),
                   (0, None, dict(replicas=2), None),
                   (5, None, dict(replicas=2, queue_depth=100.0), None),
                   (20, None, dict(replicas=2), None)]),
    "min_clamp": ({}, [(0, None, dict(replicas=1), None)]),
    "ttft_and_occupancy": (dict(ttft_out_ms=500.0, ttft_in_ms=100.0,
                                occupancy_out_pct=90.0,
                                occupancy_in_pct=30.0),
                           [(0, None, dict(replicas=2, ttft_p95_ms=900.0),
                             None),
                            (0, None, dict(replicas=2, occupancy_pct=95.0),
                             None),
                            (0, None, dict(replicas=2, ttft_p95_ms=50.0,
                                           occupancy_pct=10.0), None)]),
}


def _policy_trace(ns, name):
    kw, steps = SCENARIOS[name]
    clk = _Clock()
    p = _policy(ns, clk, **kw)
    out = []
    for adv, note, fast, slow in steps:
        clk.advance(adv)
        if note:
            p.note_scaled(note)
            continue
        d = p.decide(ns.PolicyInputs(**fast),
                     ns.PolicyInputs(**slow) if slow else None)
        out.append(_decision(d))
    out.append(sorted(p.describe().items()))
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_decisions_equal_across_packages(name):
    got = _policy_trace(PORT, name)
    assert got == _policy_trace(JAX, name)
    assert any(d[0] in ("out", "in", "hold") for d in got[:-1])


def test_policy_validation_and_reducers_equal():
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                dict(step=0), dict(queue_out=8.0, queue_in=None),
                dict(queue_out=8.0, queue_in=8.0)):
        for ns in (PORT, JAX):
            with pytest.raises(ValueError):
                ns.ScalePolicy(**bad)
    status = {"objectives": {
        "ttft": {"burn": {"fast/1m": {"burn": 3.5}, "slow/30m": {
            "burn": 1.1}}},
        "availability": {"burn": {"fast/1m": {"burn": 0.2}}}},
        "evals": 7, "history": []}
    merged = {"windows": {"10s": {"signals": {
        "serve.queue_depth": {"kind": "gauge", "last_sum": 12.0},
        "serve.ttft_ms": {"kind": "dist", "p95": 850.0},
        "serve.blocks_total": {"kind": "gauge", "last_sum": 100.0},
        "serve.blocks_free": {"kind": "gauge", "last_sum": 25.0}}}}}
    for arg in (status, None, {}, {"o": {"burn": {"w": {"burn": 2.0}}}}):
        assert PORT.max_burn(arg) == JAX.max_burn(arg)
    for m, w in ((merged, "10s"), ({}, "10s"), (merged, "60s")):
        a = PORT.inputs_from_windows(m, w, replicas=3)
        b = JAX.inputs_from_windows(m, w, replicas=3)
        assert vars(a) == vars(b)


# -- the controller over scripted fakes ---------------------------------------

class _Eng:
    """Scripted replica with a deterministic greedy generate (a pure
    function of the prompt), recording start/warmup/probe/stop."""

    def __init__(self, ns, rs_ref=None):
        self.metrics = ns.EngineMetrics()
        self.events, self.stopped = [], False
        self._rs_ref = rs_ref

    def start(self):
        self.events.append("start")
        return self

    def stop(self):
        self.stopped = True
        self.events.append("stop")

    def warmup(self, prompt_lens=(8,)):
        self.events.append("warmup")

    def probe(self, timeout_s=None):
        self.events.append("probe")
        if self._rs_ref is not None:
            assert self not in self._rs_ref.replicas

    def submit_generate(self, prompt, num_steps, **kw):
        f = concurrent.futures.Future()
        f.set_result([(sum(prompt) * 31 + k) % 50257
                      for k in range(num_steps)])
        return f


def _merged_fn(state):
    def merged():
        sig = {"serve.queue_depth": {"kind": "gauge",
                                     "last_sum": state.get("queue", 0.0)}}
        win = {"signals": sig}
        return {"windows": {"10s": win, "60s": win}}
    return merged


def _controller(ns, rs, clk, state, jdir=None, **kw):
    spawned = []

    def spawn():
        e = _Eng(ns, rs_ref=rs)
        spawned.append(e)
        return e

    kw.setdefault("policy", _policy(ns, clk))
    ctrl = ns.AutoscaleController(
        rs, spawn_fn=spawn, merged_fn=_merged_fn(state), journal_dir=jdir,
        clock=clk, drain_timeout_s=kw.pop("drain_timeout_s", 5.0), **kw)
    ctrl._spawned = spawned
    return ctrl


def _cycle_trace(ns, jdir):
    clk = _Clock()
    first = _Eng(ns)
    rs = ns.ReplicaSet([first])
    state = {"queue": 100.0}
    ctrl = _controller(ns, rs, clk, state, jdir)
    prompt, steps = [5, 6, 7], 4
    expected = rs.submit_generate(prompt, steps).result(1.0)
    out = []
    for q in (100.0, 100.0, 100.0, 0.0, 0.0, 0.0):
        state["queue"] = q
        d = ctrl.tick()
        out.append((d.action, len(rs.replicas),
                    rs.submit_generate(prompt, steps).result(1.0)
                    == expected))
    out.append([e.events[:3] for e in ctrl._spawned])
    m = rs.fleet_metrics
    out.append((m.scale_outs, m.scale_ins, first.stopped,
                ctrl.scale_events, ctrl.last_error,
                m.gauges_view()["fleet_size"]))
    out.append(ns.RolloutJournal.load(jdir))
    with open(os.path.join(jdir, "steps.jsonl")) as f:
        out.append([json.loads(line)["step"] for line in f])
    return out


def test_burst_out_idle_in_cycle_equal_across_packages(tmp_path):
    got = _cycle_trace(PORT, str(tmp_path / "port"))
    assert got == _cycle_trace(JAX, str(tmp_path / "jax"))
    assert [s for _, s, _ in got[:6]] == [2, 3, 3, 2, 1, 1]
    assert all(ok for *_, ok in got[:6])
    assert got[6] == [["start", "warmup", "probe"]] * 2
    assert got[7][:3] == (2, 2, True)


def _fault_trace(ns, arm, jdir, monkeypatch):
    clk = _Clock()
    out = []
    if arm == "spawn_fail":
        monkeypatch.setenv("DDW_FAULT", "autoscale:spawn_fail")
        rs = ns.ReplicaSet([_Eng(ns)])
        ctrl = _controller(ns, rs, clk, {"queue": 100.0}, jdir)
        out.append(ctrl.tick().action)
        out.append((len(rs.replicas), ctrl.scale_events,
                    rs.fleet_metrics.scale_outs,
                    "spawn" in ctrl.last_error,
                    ns.RolloutJournal.load(jdir)))
        monkeypatch.delenv("DDW_FAULT")
        ctrl.tick()
        out.append(len(rs.replicas))
    elif arm == "stall_drain":
        monkeypatch.setenv("DDW_FAULT", "autoscale:stall_drain")
        rs = ns.ReplicaSet([_Eng(ns), _Eng(ns)])
        ctrl = _controller(ns, rs, clk, {"queue": 0.0}, jdir,
                           drain_timeout_s=0.0)
        out.append(ctrl.tick().action)
        out.append((len(rs.replicas), rs.breakers[0].state,
                    rs.fleet_metrics.scale_ins,
                    "drain stall" in ctrl.last_error,
                    ns.RolloutJournal.load(jdir)))
    elif arm == "crash_mid_scale":
        monkeypatch.setenv("DDW_FAULT", "autoscale:crash_mid_scale")
        rs = ns.ReplicaSet([_Eng(ns)])
        ctrl = _controller(ns, rs, clk, {"queue": 100.0}, jdir)
        with pytest.raises(ns.AutoscaleCrash):
            ctrl.tick()
        left = ns.RolloutJournal.load(jdir)
        out.append((len(rs.replicas), ctrl._deploy_status["deploying"],
                    left["meta"]["direction"],
                    [r["step"] for r in left["steps"]]))
        monkeypatch.delenv("DDW_FAULT")
        ctrl2 = _controller(ns, rs, clk, {"queue": 0.0}, jdir)
        got = ctrl2.reconcile()
        out.append((got["meta"]["direction"], ns.RolloutJournal.load(jdir),
                    rs.fleet_metrics.journal_resumes, ctrl2.reconcile()))
    else:                                   # flap
        monkeypatch.setenv("DDW_FAULT", "autoscale:flap")
        rs = ns.ReplicaSet([_Eng(ns)])
        ctrl = _controller(ns, rs, clk, {"queue": 0.0},
                           policy=_policy(ns, clk, out_cooldown_s=100.0,
                                          in_cooldown_s=100.0))
        for _ in range(20):
            ctrl.tick()
            clk.advance(1.0)
        out.append((ctrl.scale_events, len(rs.replicas), ctrl.ticks))
    monkeypatch.delenv("DDW_FAULT", raising=False)
    return out


@pytest.mark.parametrize("arm", ["spawn_fail", "stall_drain",
                                 "crash_mid_scale", "flap"])
def test_fault_arms_equal_across_packages(tmp_path, monkeypatch, arm):
    got = _fault_trace(PORT, arm, str(tmp_path / "port"), monkeypatch)
    want = _fault_trace(JAX, arm, str(tmp_path / "jax"), monkeypatch)
    assert got == want
    expect = {"spawn_fail": lambda o: o[1][0] == 1 and o[2] == 2,
              "stall_drain": lambda o: o[1][:2] == (2, "closed"),
              "crash_mid_scale": lambda o: o[0][2] == "out"
              and o[1][1] is None and o[1][2] == 1,
              "flap": lambda o: o[0] == (1, 2, 20)}[arm]
    assert expect(got), got


def test_deploy_lock_blocks_scaling_in_both():
    def trace(ns):
        clk = _Clock()
        rs = ns.ReplicaSet([_Eng(ns)])
        status = {"deploying": True, "status": "rolling"}
        ctrl = ns.AutoscaleController(
            rs, policy=_policy(ns, clk),
            merged_fn=_merged_fn({"queue": 100.0}),
            deploy_lock=threading.Lock(), deploy_status=status, clock=clk,
            spawn_fn=lambda: _Eng(ns))
        d = ctrl.tick()
        out = [(d.action, d.reason, ctrl.blocked,
                rs.fleet_metrics.autoscale_blocked, len(rs.replicas),
                dict(status))]
        status["deploying"] = False
        out.append((ctrl.tick().action, len(rs.replicas), status["status"]))
        return out

    got = trace(PORT)
    assert got == trace(JAX)
    assert got[0][0] == "hold" and got[1][:2] == ("out", 2)


# -- the gateway surface and real engines -------------------------------------

def test_gateway_autoscale_http_surface(tmp_path):
    clk = _Clock()
    rs = tgw.ReplicaSet([_Eng(PORT)])
    state = {"queue": 0.0}
    gw = Gateway(rs, supervise=False, autoscale=True,
                 autoscale_journal_dir=str(tmp_path / "scale-journal"),
                 autoscale_kw=dict(policy=_policy(PORT, clk), clock=clk,
                                   spawn_fn=lambda: _Eng(PORT),
                                   merged_fn=_merged_fn(state),
                                   slo_status_fn=None,
                                   tick_interval_s=3600.0))
    gw.start(warmup_prompt_lens=())
    try:
        cli = GatewayClient("127.0.0.1", gw.port, max_retries=0)
        _status, ready = cli.readyz()
        assert ready["autoscale"]["enabled"] is True
        assert ready["autoscale"]["actual"] == 1
        state["queue"] = 100.0
        gw.autoscaler.tick()
        a = cli.stats()["autoscale"]
        assert a["actual"] == 2 and a["scale_events"] == 1
        assert a["last_decision"]["action"] == "out"
        text = cli.metrics_text()
        assert "ddw_serve_scale_outs_total 1" in text
        assert "ddw_serve_fleet_size" in text
        out = cli._json_call("POST", "/admin/autoscale",
                             {"max_replicas": 2})
        assert out["policy"]["max_replicas"] == 2
        with pytest.raises(GatewayError) as ei:
            cli._json_call("POST", "/admin/autoscale", {"min_replicas": 0})
        assert ei.value.status == 400
        with gw._deploy_lock:
            gw.deploy_status["deploying"] = True
        try:
            with pytest.raises(GatewayError) as ei:
                cli._json_call("POST", "/admin/autoscale", {"enabled": True})
            assert ei.value.status == 409
        finally:
            with gw._deploy_lock:
                gw.deploy_status["deploying"] = False
        out = cli._json_call("POST", "/admin/autoscale", {"enabled": False})
        assert out["enabled"] is False and gw.autoscaler.tick() is None
    finally:
        gw.stop()
    assert gw.autoscaler is None


@pytest.fixture(scope="module")
def pm(tmp_path_factory):
    cfg = JaxLMCfg(vocab_size=64, max_len=96, hidden=32, depth=2,
                   num_heads=2, mlp_dim=64, dropout=0.0, dtype="float32")
    params = jax_build_lm(cfg).init({"params": jax.random.PRNGKey(0)},
                                    np.zeros((1, 8), np.int32))["params"]
    d = jax_lm_package.save_lm_package(
        str(tmp_path_factory.mktemp("auto_pkg") / "pkg"), cfg, params)
    return LMPackagedModel(d, device="cpu")


def test_real_engines_scale_out_and_in_with_the_same_tokens(pm, tmp_path):
    """A burst scales a one-engine port fleet out by one (the candidate a
    clone_fresh of the first, warmed and probed before routing) and idle
    scales it back in with drain-first retirement; every answer across
    the membership changes is sequential generate's."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        clk = _Clock()
        rs = tgw.ReplicaSet([ServingEngine(lm=pm, cfg=EngineCfg(
            n_slots=2, steps_per_tick=2))])
        state = {"queue": 100.0}
        ctrl = tauto.AutoscaleController(
            rs, policy=_policy(PORT, clk, max_replicas=2),
            merged_fn=_merged_fn(state), clock=clk,
            journal_dir=str(tmp_path / "journal"), drain_timeout_s=30.0,
            warmup_prompt_lens=(8,))
        rs.start()
        prompts = [np.arange(1, n + 1, dtype=np.int32) % 64
                   for n in (5, 9, 14)]
        refs = [pm.generate(p[None], 6)[0] for p in prompts]
        sizes = []
        for q in (100.0, 0.0):
            state["queue"] = q
            ctrl.tick()
            sizes.append(len(rs.replicas))
            futs = [rs.submit_generate(p, 6) for p in prompts]
            assert all(np.array_equal(f.result(timeout=WAIT).tokens, r)
                       for f, r in zip(futs, refs))
        assert sizes == [2, 1]
        assert rs.fleet_metrics.scale_outs == 1
        assert rs.fleet_metrics.scale_ins == 1
        assert ctrl.last_error is None
        assert tjournal.RolloutJournal.load(str(tmp_path / "journal")) \
            is None
        rs.stop()
    finally:
        torch.set_num_threads(before)
