"""The port's GangSupervisor (``ddw_tpu_torch.runtime.supervisor``) on
failure paths driven by the deterministic ``DDW_FAULT`` hooks, on the CPU,
with real process gangs — case for case with ``tests/test_supervisor.py`` —
and its host logic against ``ddw_tpu``'s: GangError classification, the
dead-rank forensics, ``AttemptReport`` / ``GangFailure`` text and the
backoff schedule at ``jitter=0``.

The worker is a minimal supervised train loop with the trainers' contract:
restore from the latest durable checkpoint, per-step fault hook and
preemption check, a gloo all-reduce per step (so a dead rank leaves the
other blocked in a collective — the case the gang kill exists for), and a
checkpoint after every step. The ranks import this module to find their
functions: nothing of JAX at the top."""

import functools
import threading
import time

import pytest

from ddw_tpu_torch.runtime.launcher import GangError, Launcher
from ddw_tpu_torch.runtime.supervisor import (AttemptReport, GangFailure,
                                              GangSupervisor)

TOTAL_STEPS = 6


def _supervised_worker(ckpt_dir: str, total_steps: int,
                       step_sleep_s: float = 0.0,
                       started_path: str | None = None) -> dict:
    """Runs inside each rank. Checkpoints under ``ckpt_dir`` (rank-0
    writer), resumes from the newest good step, steps through a gloo
    all-reduce. With ``started_path``, rank 0 drops that file after the
    second step of generation 0 and every step sleeps ``step_sleep_s``."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from ddw_tpu_torch.checkpoint.ckpt import CheckpointManager
    from ddw_tpu_torch.runtime.faults import (Preempted, maybe_fault,
                                              preemption_requested)

    mgr = CheckpointManager(ckpt_dir)
    state = {"w": np.zeros((4,), np.float32), "step": np.asarray(0, np.int32)}
    start = 0
    if mgr.latest_step() is not None:
        state, start = mgr.restore(state)
        start = int(start)
    for step in range(start, total_steps):
        maybe_fault("step", step=step, ckpt_dir=ckpt_dir)
        if preemption_requested():
            mgr.save(state, step, metadata={"preempted": True})
            mgr.wait()
            raise Preempted(step)
        total = torch.ones(1)
        if dist.is_initialized():
            dist.all_reduce(total)             # the gang barrier
        state = {"w": state["w"] + float(total[0]),
                 "step": np.asarray(step + 1, np.int32)}
        mgr.save(state, step + 1)
        if (started_path and step >= 1
                and os.environ.get("DDW_PROCESS_ID") == "0"
                and os.environ.get("DDW_RESTART_GEN", "0") == "0"
                and not os.path.exists(started_path)):
            with open(started_path, "w") as f:
                f.write("started")
        time.sleep(step_sleep_s)
    mgr.close()
    return {"final_step": int(state["step"]), "resume_step": start,
            "generation": int(os.environ.get("DDW_RESTART_GEN", "0"))}


def _gang(timeout_s=300, **kw):
    # short preemption grace: peers wedged in a collective are killed fast
    # (test speed), but the SIGTERM forward still reaches live ranks
    kw.setdefault("preempt_grace_s", 2.0)
    return Launcher(np=2, devices_per_proc=1, timeout_s=timeout_s, **kw)


def _supervisor(launcher, **kw):
    kw.setdefault("backoff_base_s", 0.05)
    kw.setdefault("jitter", 0.0)
    return GangSupervisor(launcher, **kw)


# -- acceptance: crash -> bounded auto-restart-from-checkpoint -------------

@pytest.mark.faults
def test_crash_restart_resumes_from_checkpoint_and_completes(
        tmp_path, monkeypatch, worker_pythonpath):
    """crash:rank=1:step=3 with max_restarts=2: the supervisor relaunches
    the gang and generation 1 resumes from the durable checkpoint."""
    baseline = Launcher(np=-1).run(
        functools.partial(_supervised_worker, str(tmp_path / "base"),
                          TOTAL_STEPS))
    assert baseline["final_step"] == TOTAL_STEPS

    monkeypatch.setenv("DDW_FAULT", "crash:rank=1:step=3")
    sup = _supervisor(_gang(), max_restarts=2)
    out = sup.run(functools.partial(_supervised_worker,
                                    str(tmp_path / "ck"), TOTAL_STEPS))
    assert out["final_step"] == baseline["final_step"] == TOTAL_STEPS
    assert out["resume_step"] == 3
    assert out["generation"] == 1
    assert len(sup.attempts) == 1 and sup.attempts[0].kind == "crash"
    from ddw_tpu_torch.runtime.faults import EXIT_FAULT_CRASH

    assert EXIT_FAULT_CRASH in sup.attempts[0].exit_codes
    assert sup.attempts[0].dead_rank == 1
    assert sup.attempts[0].exit_signal is None
    assert sup.attempts[0].recovery == "whole-world"


@pytest.mark.faults
def test_max_restarts_zero_raises_gangfailure_with_exit_codes(
        tmp_path, monkeypatch, worker_pythonpath):
    monkeypatch.setenv("DDW_FAULT", "crash:rank=1:step=1")
    sup = _supervisor(_gang(), max_restarts=0)
    with pytest.raises(GangFailure, match="failed permanently") as exc:
        sup.run(functools.partial(_supervised_worker,
                                  str(tmp_path / "ck"), TOTAL_STEPS))
    from ddw_tpu_torch.runtime.faults import EXIT_FAULT_CRASH

    assert len(exc.value.attempts) == 1
    assert EXIT_FAULT_CRASH in exc.value.attempts[0].exit_codes
    assert exc.value.exit_codes == [exc.value.attempts[0].exit_codes]


@pytest.mark.faults
def test_gangfailure_carries_rank0_traceback(tmp_path, monkeypatch,
                                             worker_pythonpath):
    monkeypatch.setenv("DDW_FAULT", "raise:rank=0:step=1")
    sup = _supervisor(_gang(), max_restarts=0)
    with pytest.raises(GangFailure, match="injected fault") as exc:
        sup.run(functools.partial(_supervised_worker,
                                  str(tmp_path / "ck"), TOTAL_STEPS))
    assert "FaultInjected" in exc.value.rank0_traceback
    assert "injected fault" in exc.value.rank0_traceback


# -- graceful preemption ---------------------------------------------------

@pytest.mark.faults
def test_preemption_restarts_outside_crash_budget(tmp_path, monkeypatch,
                                                  worker_pythonpath):
    """SIGTERM-driven preemption: the worker checkpoints and exits
    EXIT_PREEMPTED; the supervisor restarts it even with max_restarts=0."""
    monkeypatch.setenv("DDW_FAULT", "preempt:rank=0:step=2")
    sup = _supervisor(_gang(), max_restarts=0)
    out = sup.run(functools.partial(_supervised_worker,
                                    str(tmp_path / "ck"), TOTAL_STEPS))
    assert out["final_step"] == TOTAL_STEPS
    assert out["resume_step"] == 2
    assert out["generation"] == 1
    assert len(sup.attempts) == 1 and sup.attempts[0].kind == "preempted"


@pytest.mark.faults
@pytest.mark.slow   # two full gang generations; preemption class keeps
#                     test_preemption_restarts_outside_crash_budget in tier-1
def test_preemption_budget_exhaustion_raises(tmp_path, monkeypatch,
                                             worker_pythonpath):
    monkeypatch.setenv("DDW_FAULT", "preempt:rank=0:step=0:gen=*")
    sup = _supervisor(_gang(), max_restarts=0, max_preemption_restarts=1)
    with pytest.raises(GangFailure) as exc:
        sup.run(functools.partial(_supervised_worker,
                                  str(tmp_path / "ck"), TOTAL_STEPS))
    assert [a.kind for a in exc.value.attempts] == ["preempted", "preempted"]


@pytest.mark.faults
@pytest.mark.slow   # two full gang generations of slow steps — tier-2 drill
def test_broadcast_preemption_reaches_every_rank(tmp_path, worker_pythonpath):
    """broadcast_preemption() forwards SIGTERM to ALL ranks, every rank
    checkpoints and exits EXIT_PREEMPTED, and the supervisor resumes to
    completion without touching the crash budget."""
    from ddw_tpu_torch.runtime.faults import EXIT_PREEMPTED

    started = tmp_path / "started"
    launcher = _gang(preempt_grace_s=30.0)
    sup = _supervisor(launcher, max_restarts=0)

    def trigger():
        while not started.exists():
            time.sleep(0.05)
        time.sleep(0.1)  # land mid-sleep of the next step, on both ranks
        assert launcher.broadcast_preemption() == 2

    t = threading.Thread(target=trigger, daemon=True)
    t.start()
    out = sup.run(functools.partial(_supervised_worker,
                                    str(tmp_path / "ck"), 12, 0.25,
                                    str(started)))
    t.join(timeout=10)
    assert out["final_step"] == 12
    assert out["generation"] == 1
    assert len(sup.attempts) == 1 and sup.attempts[0].kind == "preempted"
    assert sup.attempts[0].exit_codes == [EXIT_PREEMPTED, EXIT_PREEMPTED]


# -- attempt reports into the tracker --------------------------------------

@pytest.mark.faults
def test_supervisor_reports_attempts_to_tracker(tmp_path, monkeypatch,
                                                worker_pythonpath):
    import json
    import os

    from ddw_tpu_torch.tracking.tracker import Tracker

    monkeypatch.setenv("DDW_FAULT", "crash:rank=1:step=2")
    run = Tracker(str(tmp_path / "mlruns"), "gang").start_run("supervised")
    sup = _supervisor(_gang(), max_restarts=2, tracker_run=run)
    out = sup.run(functools.partial(_supervised_worker,
                                    str(tmp_path / "ck"), TOTAL_STEPS))
    run.end()
    assert out["final_step"] == TOTAL_STEPS
    m = run.final_metrics()
    assert m["supervisor.generations"] == 2.0
    assert m["supervisor.failed_attempts"] == 1.0
    assert m["supervisor.crash_restarts"] == 1.0
    assert m["supervisor.preemption_restarts"] == 0.0
    assert run.metric_history("supervisor.attempt_elapsed_s")[0][0] == 0
    assert run.meta()["tags"]["supervisor.outcome"] == "completed"
    art = os.path.join(run.run_dir, "artifacts", "supervisor",
                       "supervisor_attempts.json")
    with open(art) as f:
        data = json.load(f)
    assert data["outcome"] == "completed"
    assert data["attempts"][0]["kind"] == "crash"
    assert data["attempts"][0]["generation"] == 0


@pytest.mark.faults
@pytest.mark.slow   # tracker-reporting class keeps
#                     test_supervisor_reports_attempts_to_tracker in tier-1
def test_supervisor_reports_failed_outcome(tmp_path, monkeypatch,
                                           worker_pythonpath):
    from ddw_tpu_torch.tracking.tracker import Tracker

    monkeypatch.setenv("DDW_FAULT", "crash:rank=1:step=1")
    run = Tracker(str(tmp_path / "mlruns"), "gang").start_run("supervised")
    sup = _supervisor(_gang(), max_restarts=0, tracker_run=run)
    with pytest.raises(GangFailure):
        sup.run(functools.partial(_supervised_worker,
                                  str(tmp_path / "ck"), TOTAL_STEPS))
    assert run.meta()["tags"]["supervisor.outcome"] == "failed"
    assert run.final_metrics()["supervisor.failed_attempts"] == 1.0


# -- silent early exit + torn checkpoint + deadline ------------------------

@pytest.mark.faults
def test_exit0_early_surfaces_missing_result(tmp_path, monkeypatch,
                                             worker_pythonpath):
    monkeypatch.setenv("DDW_FAULT", "exit0_early:step=1")
    with pytest.raises(GangError, match="missing or unreadable") as exc:
        _gang().run(functools.partial(_supervised_worker,
                                      str(tmp_path / "ck"), TOTAL_STEPS))
    assert exc.value.kind == "result-missing"
    assert exc.value.exit_codes == [0, 0]


@pytest.mark.faults
def test_ckpt_torn_crash_quarantined_on_restart(tmp_path, monkeypatch,
                                                worker_pythonpath):
    import os

    ckpt_dir = str(tmp_path / "ck")
    monkeypatch.setenv("DDW_FAULT", "ckpt_torn:rank=0:step=3")
    sup = _supervisor(_gang(), max_restarts=2)
    out = sup.run(functools.partial(_supervised_worker, ckpt_dir,
                                    TOTAL_STEPS))
    assert out["final_step"] == TOTAL_STEPS
    assert out["resume_step"] == 3
    torn = [d for d in os.listdir(ckpt_dir) if ".torn" in d]
    assert torn, "torn step dir was not quarantined"
    assert not os.path.exists(os.path.join(ckpt_dir, "step_0000001003"))


@pytest.mark.faults
def test_stall_hits_gang_deadline(tmp_path, monkeypatch, worker_pythonpath):
    """A stalled rank trips the shared gang deadline (classified
    'deadline', not 'crash') instead of hanging the driver forever; the
    peer's collective, bounded by the same timeout from a later start,
    does not fail first."""
    monkeypatch.setenv("DDW_FAULT", "stall:rank=1:step=2")
    with pytest.raises(GangError, match="deadline") as exc:
        _gang(timeout_s=6).run(
            functools.partial(_supervised_worker, str(tmp_path / "ck"),
                              TOTAL_STEPS))
    assert exc.value.kind == "deadline"


@pytest.mark.slow
@pytest.mark.faults
def test_stall_deadline_then_restart_completes(tmp_path, monkeypatch,
                                               worker_pythonpath):
    monkeypatch.setenv("DDW_FAULT", "stall:rank=1:step=2")
    sup = _supervisor(_gang(timeout_s=15), max_restarts=1)
    out = sup.run(functools.partial(_supervised_worker,
                                    str(tmp_path / "ck"), TOTAL_STEPS))
    assert out["final_step"] == TOTAL_STEPS
    assert out["resume_step"] == 2
    assert sup.attempts[0].kind == "deadline"


# -- pure classification logic, against ddw_tpu's ---------------------------

def test_gangerror_preemption_classification():
    from ddw_tpu_torch.runtime.faults import EXIT_PREEMPTED

    mk = lambda codes: GangError("x", kind="crash", exit_codes=codes)  # noqa: E731
    assert mk([EXIT_PREEMPTED, -9]).is_preemption
    assert mk([EXIT_PREEMPTED, 0]).is_preemption
    assert mk([EXIT_PREEMPTED, EXIT_PREEMPTED]).is_preemption
    assert mk([EXIT_PREEMPTED, 1]).is_preemption
    assert not mk([0, 1]).is_preemption
    assert not mk([None, -9]).is_preemption


CODE_CASES = [[83, -9], [83, 0], [83, 83], [83, 1], [0, 1], [None, -9],
              [1, -9], [1, 77], [1, 1], [0, 0], [None, None], [85, 1, 0],
              [1, -15, 77], [0, 84]]


@pytest.mark.parametrize("codes", CODE_CASES)
def test_classification_and_forensics_equal_ddw_tpu(codes):
    """GangError.is_preemption and the supervisor's dead-rank forensics
    give ddw_tpu's answers on the same exit codes."""
    from ddw_tpu.runtime.launcher import GangError as JGangError
    from ddw_tpu.runtime.supervisor import GangSupervisor as JSup

    got = GangError("x", kind="crash", exit_codes=codes)
    want = JGangError("x", kind="crash", exit_codes=codes)
    assert got.is_preemption == want.is_preemption
    for kind in ("crash", "preempted", "deadline"):
        assert GangSupervisor._dead_rank(codes, kind) == \
            JSup._dead_rank(codes, kind)


def test_ranks_the_launcher_killed_are_never_the_root_cause():
    """A survivor the gang kill reaches before its own collective error
    exits it leaves -9, indistinguishable by exit code from a rank killed
    from outside: the launcher names the ranks it killed
    (GangError.killed_ranks) and the forensics pass over them, so rank 1's
    injected crash (77) is the root cause whichever exit the scheduler
    lets land first. Without the record the answer is ddw_tpu's."""
    from ddw_tpu.runtime.supervisor import GangSupervisor as JSup

    assert GangSupervisor._dead_rank([-9, 77], "crash", (0,)) == (1, None)
    assert GangSupervisor._dead_rank([1, 77], "crash", ()) == (1, None)
    assert GangSupervisor._dead_rank([-9, 77], "crash") == \
        JSup._dead_rank([-9, 77], "crash") == (0, 9)
    # a kill that took every abnormal rank leaves the kill as the answer
    assert GangSupervisor._dead_rank([-9, 0], "crash", (0,)) == (0, 9)
    assert GangError("x", kind="crash", exit_codes=[-9, 77]
                     ).killed_ranks == ()


def test_attempt_report_and_gangfailure_text_equal_ddw_tpu():
    from ddw_tpu.runtime import supervisor as jsup

    rows = [dict(generation=0, kind="crash", exit_codes=[1, 77],
                 rank0_traceback=None, elapsed_s=2.345, dead_rank=1),
            dict(generation=0, kind="rank-death", exit_codes=[-9],
                 rank0_traceback=None, elapsed_s=0.0, dead_rank=1,
                 exit_signal=9, recovery="elastic"),
            dict(generation=1, kind="rank-death", exit_codes=[85],
                 rank0_traceback=None, elapsed_s=0.0, dead_rank=2,
                 recovery="shrink", old_world_size=3, new_world_size=2),
            dict(generation=2, kind="preempted", exit_codes=[83, 1],
                 rank0_traceback="Traceback:\n  boom\nValueError: x",
                 elapsed_s=10.0, dead_rank=0)]
    got = [AttemptReport(**r) for r in rows]
    want = [jsup.AttemptReport(**r) for r in rows]
    assert [str(a) for a in got] == [str(a) for a in want]
    assert str(GangFailure(got, 2)) == str(jsup.GangFailure(want, 2))
    assert GangFailure(got, 2).rank0_traceback == \
        jsup.GangFailure(want, 2).rank0_traceback
    assert GangFailure(got, 2, flight=[{"a": 1}]).flight == [{"a": 1}]


def test_backoff_schedule_equals_ddw_tpu(monkeypatch):
    """At jitter=0 the n-th restart sleeps base * 2**(n-1) capped at the
    maximum, as ddw_tpu's supervisor does."""
    from ddw_tpu.runtime import supervisor as jsup

    from ddw_tpu_torch.runtime import supervisor as tsup

    def schedule(module, sup_cls, launcher):
        slept = []
        monkeypatch.setattr(module.time, "sleep", slept.append)
        sup = sup_cls(launcher, backoff_base_s=0.5, backoff_max_s=5.0,
                      jitter=0.0)
        for n in range(1, 8):
            sup._backoff(n)
        monkeypatch.undo()
        return slept

    from ddw_tpu.runtime.launcher import Launcher as JLauncher

    got = schedule(tsup, tsup.GangSupervisor, Launcher(np=2))
    want = schedule(jsup, jsup.GangSupervisor, JLauncher(np=2))
    assert got == want == [0.5, 1.0, 2.0, 4.0, 5.0, 5.0, 5.0]


def test_restart_generation_reads_the_env(monkeypatch):
    from ddw_tpu.runtime.supervisor import restart_generation as jgen

    from ddw_tpu_torch.runtime.supervisor import restart_generation

    for value in (None, "", "3", "x"):
        if value is None:
            monkeypatch.delenv("DDW_RESTART_GEN", raising=False)
        else:
            monkeypatch.setenv("DDW_RESTART_GEN", value)
        assert restart_generation() == jgen()
