"""The deploy plane of the PyTorch port (``ddw_tpu_torch.deploy``) on the
CPU. Host logic against ``ddw_tpu``'s on the same scripted inputs: rollout
journals written by either package load in the other; ``CanaryJudge``
verdicts agree on scripted probe and relay windows; the controller's roll,
rollback, no-rollback, canary promote and reject, surge, surge failure,
crash-and-resume and majority convergence leave the same steps, statuses
and end states over scripted fakes in both packages. Then a module-scoped
fleet of two ``ProcessReplica`` children (``--device cpu``) on a package
``ddw_tpu`` wrote: greedy tokens equal the in-thread fleet's and
``ddw_tpu``'s, a seed samples the in-thread engine's tokens through the
process hop and over HTTP, a SIGKILLed child is restarted by the
supervisor with its tokens, and a child asked for the card on a machine
without one exits with its startup error. The second package (another
seed) is written in both frameworks' formats; the rolling deploy onto it
under load and a worker started by hand ride tier-2. ``SSHTransport`` is
driven through local stand-ins for ``ssh`` and ``scp``."""

import json
import os
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

import ddw_tpu.deploy as jdeploy
import ddw_tpu.gateway as jgw
from ddw_tpu.models.lm import build_lm as jax_build_lm
from ddw_tpu.serve.metrics import EngineMetrics as JaxEngineMetrics
from ddw_tpu.serving import lm_package as jax_lm_package
from ddw_tpu.utils.config import LMCfg as JaxLMCfg
import ddw_tpu_torch.deploy as tdeploy
import ddw_tpu_torch.gateway as tgw
from ddw_tpu_torch.deploy import ProcessReplica
from ddw_tpu_torch.gateway import Gateway, GatewayClient
from ddw_tpu_torch.serve import EngineCfg, ServingEngine
from ddw_tpu_torch.serve.metrics import EngineMetrics
from ddw_tpu_torch.serving.lm_package import LMPackagedModel, save_lm_package
from ddw_tpu_torch.utils.config import LMCfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread (the process replicas' children
    take this process's count), and the test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ns(deploy, gw, metrics):
    return types.SimpleNamespace(
        DeployController=deploy.DeployController,
        RolloutJournal=deploy.RolloutJournal, CanaryJudge=deploy.CanaryJudge,
        resume_rollout=deploy.resume_rollout, ReplicaSet=gw.ReplicaSet,
        EngineMetrics=metrics)


PORT = _ns(tdeploy, tgw, EngineMetrics)
JAX = _ns(jdeploy, jgw, JaxEngineMetrics)


def _both(trace, *args):
    got, want = trace(PORT, *args), trace(JAX, *args)
    assert got == want
    return got


# -- the rollout journal, across packages -------------------------------------

def _write_journal(ns, d):
    j = ns.RolloutJournal(d)
    j.begin({"strategy": "canary", "target_dir": "new", "canary_index": 0,
             "n_replicas": 2, "old_dirs": ["old", "old"],
             "old_drafts": [None, None],
             "old_checkpoints": ["digest:old", "digest:old"]})
    j.record_step({"replica": 0, "action": "recycled", "ok": True})
    j.note(target_checkpoint="digest:new")
    with open(os.path.join(d, "steps.jsonl"), "a") as f:
        f.write('{"replica": 1, "action": "recy')      # a torn tail row
    return j


@pytest.mark.parametrize("writer,reader", [(PORT, JAX), (JAX, PORT)],
                         ids=["port-to-jax", "jax-to-port"])
def test_journal_written_by_either_package_loads_in_the_other(
        tmp_path, writer, reader):
    d = str(tmp_path / "journal")
    _write_journal(writer, d)
    rec = reader.RolloutJournal.load(d)
    assert rec == writer.RolloutJournal.load(d)
    assert rec["meta"]["status"] == "rolling"
    assert rec["meta"]["target_checkpoint"] == "digest:new"
    assert [s["replica"] for s in rec["steps"]] == [0]
    j2 = reader.RolloutJournal(d)           # the reader appends and ends it
    j2.resume_appending()
    j2.record_step({"replica": 1, "action": "recycled", "ok": True})
    j2.finish("done")
    assert writer.RolloutJournal.load(d) is None
    with open(os.path.join(d, "steps.jsonl")) as f:
        assert json.loads(f.read().splitlines()[-1])["replica"] == 1


# -- the canary judge on scripted windows -------------------------------------

class _ProbeEngine:
    def __init__(self, fail=False, relay_ms=None):
        self.fail = fail
        self._relay = list(relay_ms or ())
        self._seq = 0

    def probe(self, timeout_s=30.0):
        if self.fail:
            raise RuntimeError("probe refused")

    def telemetry_events(self, since=0):
        out = []
        for v in self._relay:
            self._seq += 1
            out.append({"seq": self._seq, "kind": "dist",
                        "name": "serve.ttft_ms", "value": v})
        self._relay = []
        return [e for e in out if e["seq"] > since]


def _judge_trace(ns, case):
    engines = {
        "healthy": lambda: [_ProbeEngine(), _ProbeEngine()],
        "failing": lambda: [_ProbeEngine(fail=True), _ProbeEngine()],
        "relay": lambda: [_ProbeEngine(relay_ms=[400.0, 420.0, 390.0,
                                                 410.0]),
                          _ProbeEngine(relay_ms=[4.0, 5.0, 6.0, 5.0])],
    }[case]()
    v = ns.CanaryJudge(types.SimpleNamespace(replicas=engines), 0,
                       window_s=0.3, probe_interval_s=0.01).run()
    return (v["verdict"], v["reason"], v["canary"]["errors"] > 0,
            v["baseline"]["replicas"], sorted(v.get("relay_tails") or {}))


@pytest.mark.parametrize("case", ["healthy", "failing", "relay"])
def test_canary_judge_verdicts_equal_across_packages(case):
    verdict = _both(_judge_trace, case)[:2]
    assert verdict == {"healthy": ("promote", "window_elapsed"),
                       "failing": ("reject", "canary_errors"),
                       "relay": ("reject", "relay_ttft_ms_p99")}[case]


def test_injected_canary_degradation_rejects_in_both(monkeypatch):
    monkeypatch.setenv("DDW_FAULT", "deploy:degrade_canary:ttft_ms=30")

    def trace(ns):
        v = ns.CanaryJudge(types.SimpleNamespace(
            replicas=[_ProbeEngine(), _ProbeEngine()]), 0, window_s=30.0,
            probe_interval_s=0.01, min_floor_ms=5.0).run()
        return v["verdict"], v["reason"]

    assert _both(trace) == ("reject", "canary_probe_p99")


# -- the controller over scripted fakes ---------------------------------------

class _RollEngine:
    def __init__(self, ns, model_dir="old", fail_on=(), clone_fails=False):
        self.ns, self.model_dir, self.generation = ns, model_dir, 0
        self.fail_on, self.clone_fails = set(fail_on), clone_fails
        self._pending, self.stopped = None, False
        self.metrics = ns.EngineMetrics()

    def start(self):
        return self

    def stop(self):
        self.stopped = True

    def warmup(self, *a, **kw):
        pass

    def probe(self, timeout_s=30.0):
        pass

    def set_checkpoint(self, model_dir):
        self._pending = model_dir

    def recycle(self, drain_timeout_s=30.0):
        if self._pending in self.fail_on:
            return False
        if self._pending is not None:
            self.model_dir, self._pending = self._pending, None
        self.generation += 1
        return True

    def clone_fresh(self):
        if self.clone_fails:
            raise RuntimeError("spawn failed")
        new = _RollEngine(self.ns, self._pending or self.model_dir)
        new.generation = self.generation + 1
        self._pending = None
        return new

    def health(self):
        return {"state": "alive", "replica": 0,
                "generation": self.generation,
                "checkpoint": f"digest:{self.model_dir}"}


class _FakeSupervisor:
    def __init__(self, rs):
        self.rs, self.recycles = rs, []

    def recycle(self, i, kind="degraded"):
        self.recycles.append((i, kind))
        return self.rs.replicas[i].recycle()

    def report(self):
        return {"attempts": [], "recycles": list(self.recycles)}

    def stop(self):
        pass


def _summary(out, rs, sup):
    return (out["status"], out["deploying"], out["fleet_generation"],
            [(s["replica"], s["action"], s.get("ok")) for s in out["steps"]],
            out.get("replica_end_state"),
            [e.model_dir for e in rs.replicas], sup.recycles)


def _controller_trace(ns, case, tmp):
    kw = dict(settle_timeout_s=5.0)
    if case == "roll":
        engines = [_RollEngine(ns), _RollEngine(ns)]
    elif case in ("rollback", "no_rollback"):
        engines = [_RollEngine(ns), _RollEngine(ns, fail_on=("new",))]
        kw["rollback"] = case == "rollback"
    elif case == "surge":
        engines = [_RollEngine(ns), _RollEngine(ns)]
        kw["strategy"] = "surge"
    elif case == "surge_fail":
        engines = [_RollEngine(ns, clone_fails=True), _RollEngine(ns)]
        kw["strategy"] = "surge"
    else:                                   # canary
        engines = [_RollEngine(ns), _RollEngine(ns)]
        kw.update(strategy="canary", judge_window_s=0.3,
                  judge_kw={"probe_interval_s": 0.01})
    rs = ns.ReplicaSet(engines)
    sup = _FakeSupervisor(rs)
    out = ns.DeployController(rs, sup, "new", **kw).run()
    m = rs.fleet_metrics
    return _summary(out, rs, sup) + (m.surge_spawns, m.canary_promoted,
                                     m.canary_rejected)


@pytest.mark.parametrize("case", ["roll", "rollback", "no_rollback", "surge",
                                  "surge_fail", "canary"])
def test_controller_outcomes_equal_across_packages(tmp_path, case):
    out = _both(_controller_trace, case, str(tmp_path))
    status = {"roll": "done", "rollback": "rolled_back",
              "no_rollback": "aborted", "surge": "done",
              "surge_fail": "aborted", "canary": "done"}[case]
    assert out[0] == status and out[1] is False


def test_canary_reject_restages_the_old_weights_in_both(monkeypatch):
    monkeypatch.setenv("DDW_FAULT",
                       "deploy:degrade_canary:ttft_ms=30:replica=0")

    def trace(ns):
        rs = ns.ReplicaSet([_RollEngine(ns), _RollEngine(ns)])
        sup = _FakeSupervisor(rs)
        out = ns.DeployController(
            rs, sup, "new", strategy="canary", judge_window_s=30.0,
            judge_kw={"probe_interval_s": 0.01, "min_floor_ms": 5.0},
            settle_timeout_s=5.0).run()
        return _summary(out, rs, sup)

    out = _both(trace)
    assert out[0] == "rejected" and out[5] == ["old", "old"]


def test_crash_mid_roll_resumes_to_one_digest_in_both(tmp_path,
                                                      monkeypatch):
    def trace(ns, jd):
        rs = ns.ReplicaSet([_RollEngine(ns), _RollEngine(ns)])
        sup = _FakeSupervisor(rs)
        monkeypatch.setenv("DDW_FAULT", "deploy:crash_mid_roll:after=1")
        out = ns.DeployController(rs, sup, "new", settle_timeout_s=5.0,
                                  journal=ns.RolloutJournal(jd)).run()
        first = _summary(out, rs, sup)
        monkeypatch.delenv("DDW_FAULT")
        ctrl = ns.resume_rollout(rs, sup, jd, settle_timeout_s=5.0)
        out2 = ctrl.run()
        return (first, _summary(out2, rs, sup), out2.get("resumed"),
                rs.fleet_metrics.journal_resumes,
                ns.RolloutJournal.load(jd))

    got = trace(PORT, str(tmp_path / "port"))
    want = trace(JAX, str(tmp_path / "jax"))
    assert got == want
    assert got[0][0] == "crashed" and got[1][0] == "done"
    assert got[1][5] == ["new", "new"] and got[4] is None


def test_mixed_fleet_converges_to_the_majority_in_both(tmp_path):
    def trace(ns, jd):
        rs = ns.ReplicaSet([_RollEngine(ns, "new"), _RollEngine(ns, "new"),
                            _RollEngine(ns, "old")])
        sup = _FakeSupervisor(rs)
        out = ns.resume_rollout(rs, sup, jd, settle_timeout_s=5.0).run()
        return _summary(out, rs, sup)

    got = trace(PORT, str(tmp_path / "a"))
    assert got == trace(JAX, str(tmp_path / "b"))
    assert got[5] == ["new"] * 3


def test_gateway_admits_exactly_one_concurrent_deploy(tmp_path):
    class _Slow(_RollEngine):
        def recycle(self, drain_timeout_s=30.0):
            time.sleep(0.2)
            return super().recycle(drain_timeout_s)

    rs = tgw.ReplicaSet([_Slow(PORT), _Slow(PORT)])
    gw = Gateway(rs, supervise=False,
                 deploy_journal_dir=str(tmp_path / "journal"))
    gw.supervisor = _FakeSupervisor(rs)
    barrier, results = threading.Barrier(2), []

    def racer():
        barrier.wait()
        results.append(gw.start_deploy("new", settle_timeout_s=5.0))

    threads = [threading.Thread(target=racer) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert sorted(results) == [False, True]
    deadline = time.monotonic() + WAIT
    while gw.deploy_status.get("deploying") and time.monotonic() < deadline:
        time.sleep(0.02)
    assert gw.deploy_status["status"] == "done"
    assert tdeploy.RolloutJournal.load(str(tmp_path / "journal")) is None
    with pytest.raises(ValueError):
        gw.start_deploy("new", strategy="bluegreen")
    assert gw.deploy_status["deploying"] is False


# -- the process fleet --------------------------------------------------------

VOCAB = 64
LM = dict(vocab_size=VOCAB, max_len=64, hidden=32, depth=1, num_heads=2,
          mlp_dim=128, dropout=0.0, dtype="float32")
ENGINE_CFG = {"n_slots": 2, "queue_depth": 16, "kv_block_size": 8,
              "max_resident": 2, "min_bucket": 4,
              "default_timeout_s": 600.0}
PROMPT = [1, 2, 3]


def _jax_params(seed):
    return jax_build_lm(JaxLMCfg(**LM)).init(
        {"params": jax.random.PRNGKey(seed)},
        np.zeros((1, 8), np.int32))["params"]


@pytest.fixture(scope="module")
def pkgs(tmp_path_factory):
    """pkg_a (the boot checkpoint, written by ``ddw_tpu``) and pkg_b (the
    deploy target, another seed) written by both frameworks from the same
    weights: both of b's loads give the same tokens, which differ from
    a's."""
    root = tmp_path_factory.mktemp("deploy_pkgs")
    a = jax_lm_package.save_lm_package(str(root / "pkg_a"), JaxLMCfg(**LM),
                                       _jax_params(0))
    pb = _jax_params(1)
    b_jax = jax_lm_package.save_lm_package(str(root / "pkg_b_jax"),
                                           JaxLMCfg(**LM), pb)
    b_port = save_lm_package(str(root / "pkg_b_port"), LMCfg(**LM),
                             jax.tree_util.tree_map(np.asarray, pb))
    out = {}
    for name, d in (("a", a), ("b_jax", b_jax), ("b", b_port)):
        pm = LMPackagedModel(d, device="cpu")
        out[name] = (d, pm.content_digest,
                     [int(t) for t in pm.generate(np.array([PROMPT]), 4)[0]])
    assert out["b"][2] == out["b_jax"][2] != out["a"][2]
    assert out["a"][2] == [int(t) for t in jax_lm_package.load_lm_package(
        a).generate(np.array([PROMPT]), 4)[0]]
    return out


@pytest.fixture(scope="module")
def fleet(pkgs, tmp_path_factory):
    """Two ProcessReplica children (CPU, one thread each, as this process)
    behind one supervised gateway. The tier-2 deploy drill runs last and
    leaves pkg_b."""
    work = tmp_path_factory.mktemp("deploy_fleet")
    reps = [ProcessReplica(pkgs["a"][0], replica_id=i,
                           engine_cfg=ENGINE_CFG, warmup_lens=(4,),
                           spawn_timeout_s=150.0, device="cpu",
                           workdir=str(work / f"r{i}"))
            for i in range(2)]
    for i in range(2):
        os.makedirs(str(work / f"r{i}"), exist_ok=True)
    gw = Gateway(reps, supervisor_kw={"poll_interval_s": 0.1,
                                      "backoff_base_s": 0.1,
                                      "backoff_max_s": 0.5, "jitter": 0.0})
    gw.start(warmup_prompt_lens=(4,))
    cli = GatewayClient("127.0.0.1", gw.port, timeout_s=90.0, max_retries=8)
    try:
        yield gw, cli
    finally:
        gw.drain(grace_s=10.0)
        for r in reps:
            r.stop()


def test_process_fleet_serves_the_in_thread_tokens_and_restarts(
        fleet, pkgs, monkeypatch):
    """Greedy tokens through the process hop equal the in-thread engine's
    and ``ddw_tpu``'s; a seed samples the in-thread engine's tokens through
    ``ProcessReplica.submit_generate`` and over the gateway; a SIGKILLed
    child is restarted by the supervisor and serves the same tokens; a
    child asked for the card where there is none exits with its startup
    error (it never carries on on the CPU)."""
    gw, cli = fleet
    ref_a = pkgs["a"][2]
    for _ in range(4):
        assert cli.generate(PROMPT, 4)["tokens"] == ref_a
    rows = cli.batch_items([PROMPT, PROMPT], num_steps=4)
    assert [r["row"]["tokens"] for r in rows] == [ref_a, ref_a]
    assert cli.stats()["deploy"]["checkpoints"] == [pkgs["a"][1]] * 2
    pids = {r._proc.pid for r in gw.replica_set.replicas}
    assert len(pids) == 2 and os.getpid() not in pids
    prompt = np.array([5, 9, 2, 7, 1], np.int32)
    with ServingEngine(lm=LMPackagedModel(pkgs["a"][0], device="cpu"),
                       cfg=EngineCfg(**ENGINE_CFG)) as eng:
        sref = eng.generate(prompt, 8, temperature=0.9,
                            rng=torch.Generator().manual_seed(21)).tokens
    rep = gw.replica_set.replicas[1]
    got = rep.submit_generate(prompt, 8, temperature=0.9,
                              rng=torch.Generator().manual_seed(21))
    assert np.array_equal(got.result(timeout=WAIT).tokens, sref)
    assert cli.generate(prompt, 8, temperature=0.9,
                        seed=21)["tokens"] == [int(t) for t in sref]
    victim = gw.replica_set.replicas[0]
    base = gw.replica_set.restarts[0]
    victim._proc.kill()
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        h0 = gw.replica_set.fleet_health()[0]
        if (gw.replica_set.restarts[0] > base and h0["state"] == "alive"
                and h0["circuit"] == "closed"):
            break
        time.sleep(0.2)
    else:
        pytest.fail(f"replica 0 not restarted: "
                    f"{gw.replica_set.fleet_health()[0]}")
    assert cli.generate(PROMPT, 4)["tokens"] == ref_a
    assert (0, "killed", "restarted") in [
        (a.replica, a.kind, a.action) for a in gw.supervisor.attempts]
    # no card, no explicit device: the child refuses to start
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    lonely = ProcessReplica(pkgs["a"][0], replica_id=5,
                            engine_cfg=ENGINE_CFG, spawn_timeout_s=60.0)
    try:
        lonely.start()
        with pytest.raises(RuntimeError, match="died during startup"):
            lonely.warmup()
        with open(lonely.log_path) as f:
            assert "device='cpu'" in f.read()
        assert lonely.last_exit_code not in (None, 0)
    finally:
        lonely.stop()
    # tensor parallelism rides in through the kwarg or engine_cfg, the
    # kwarg winning, and the clone keeps it (the tp=2 fleet itself is the
    # slow drill of test_torch_tp_serve.py)
    for kw, want in ((dict(tp=2), 2), (dict(engine_cfg={"tp": 2}), 2),
                     (dict(engine_cfg={"tp": 4}, tp=2), 2)):
        rep = ProcessReplica(pkgs["a"][0], **kw)
        clone = rep.clone_fresh()
        try:
            assert rep.tp == want and clone.tp == want
        finally:
            rep.stop()
            clone.stop()


@pytest.mark.slow
def test_rolling_deploy_under_load_drops_nothing(fleet, pkgs):
    """A rolling deploy of the port-written pkg_b across the process fleet
    while closed-loop clients run: zero failed requests, both replicas on
    the new digest, fleet generation bumped, pkg_b's tokens after."""
    gw, cli = fleet
    dir_b, digest_b, ref_b = pkgs["b"]
    stop, done, failures = threading.Event(), [0], []

    def pound():
        c = GatewayClient("127.0.0.1", gw.port, timeout_s=90.0,
                          max_retries=8)
        while not stop.is_set():
            try:
                c.generate(PROMPT, 4)
                done[0] += 1
            except Exception as e:              # noqa: BLE001
                failures.append(repr(e))

    workers = [threading.Thread(target=pound, daemon=True)
               for _ in range(3)]
    for w in workers:
        w.start()
    try:
        deadline = time.monotonic() + 30.0
        while done[0] < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        before = done[0]
        assert cli.deploy(dir_b)
        deadline = time.monotonic() + 240.0
        while time.monotonic() < deadline:
            dv = cli.stats()["deploy"]
            if not dv["deploying"]:
                break
            time.sleep(0.2)
        during = done[0] - before
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=60.0)
    assert dv["status"] == "done" and dv["fleet_generation"] == 1
    assert dv["checkpoints"] == [digest_b] * 2
    assert not failures, failures[:5]
    assert during > 0
    assert cli.generate(PROMPT, 4)["tokens"] == ref_b


@pytest.mark.slow
def test_serve_worker_loads_a_package_ddw_tpu_wrote_by_hand(pkgs, tmp_path):
    """``python -m ddw_tpu_torch.deploy._serve_worker --device cpu`` as an
    operator starts it: the port file appears, /readyz turns 200, a
    SIGTERM drains it to exit 0."""
    port_file = str(tmp_path / "port.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddw_tpu_torch.deploy._serve_worker",
         "--model-dir", pkgs["b_jax"][0], "--port-file", port_file,
         "--device", "cpu", "--threads", "1", "--warmup", "[4]"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + WAIT
        while not os.path.exists(port_file) and time.monotonic() < deadline:
            time.sleep(0.05)
        with open(port_file) as f:
            port = json.load(f)["port"]
        c = GatewayClient("127.0.0.1", port)
        assert c.wait_ready(WAIT)
        assert c.generate(PROMPT, 4)["tokens"] == pkgs["b_jax"][2]
        proc.terminate()
        assert proc.wait(timeout=WAIT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_ssh_transport_stages_spawns_and_reads_through_its_commands(
        tmp_path):
    """``SSHTransport`` with its ``ssh`` and ``scp`` commands replaced by
    local stand-ins (the host argument ignored, the command run here):
    staging copies the package once per digest, ``popen`` forwards only
    the ``DDW_`` environment (the stand-in runs the command in an empty
    one), ``read_file`` and ``probe`` go through the session. No
    network."""
    import textwrap

    from ddw_tpu_torch.deploy.transport import (LocalExecTransport,
                                                SSHTransport, transport_for)

    fake_ssh = tmp_path / "fake_ssh.py"
    fake_ssh.write_text(textwrap.dedent('''
        import os, subprocess, sys
        sys.exit(subprocess.run(sys.argv[2], shell=True, env={
            "PATH": os.environ["PATH"]}).returncode)
        '''))
    fake_scp = tmp_path / "fake_scp.py"
    fake_scp.write_text(textwrap.dedent('''
        import shutil, sys
        shutil.copytree(sys.argv[1], sys.argv[2].split(":", 1)[1])
        '''))
    src = tmp_path / "pkg"
    src.mkdir()
    (src / "weights.bin").write_bytes(b"\x01\x02")
    t = SSHTransport("box", user="me", python=sys.executable,
                     staging_root=str(tmp_path / "staging"),
                     ssh=(sys.executable, str(fake_ssh)),
                     scp=(sys.executable, str(fake_scp)))
    dst = t.stage(str(src))
    assert os.path.isfile(os.path.join(dst, "weights.bin"))
    assert t.stage(str(src)) == dst and t.stages == 1 and t.stage_hits == 1
    log = str(tmp_path / "child.log")
    proc = t.popen([sys.executable, "-c",
                    "import os; print(os.environ.get('DDW_FAULT'), "
                    "os.environ.get('JAX_PLATFORMS'))"],
                   env={"DDW_FAULT": "serve:crash", "JAX_PLATFORMS": "cpu",
                        "SECRET": "x"}, log_path=log)
    assert proc.wait(timeout=60) == 0
    assert open(log).read().split() == ["serve:crash", "None"]
    port_file = tmp_path / "port.json"
    port_file.write_text('{"port": 1}')
    assert json.loads(t.read_file(str(port_file)))["port"] == 1
    with pytest.raises(FileNotFoundError):
        t.read_file(str(tmp_path / "absent.json"))
    assert t.probe() is True
    assert t.describe()["host"] == "me@box"
    assert isinstance(transport_for("localhost"), LocalExecTransport)
    assert isinstance(transport_for("gpu7"), SSHTransport)
