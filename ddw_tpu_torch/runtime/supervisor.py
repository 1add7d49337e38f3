"""Gang supervisor — bounded auto-restart-from-checkpoint over the Launcher;
the port of ``ddw_tpu.runtime.supervisor``.

The :class:`~ddw_tpu_torch.runtime.launcher.Launcher` implements the *detection*
half of the reference's all-or-nothing gang semantics (poll every rank, kill
the gang on the first abnormal exit, one shared deadline — the Spark-barrier
behavior of Horovod jobs, arXiv:1802.05799 §"fault tolerance"); its recovery
story is the operator's: "restart from the last checkpoint". This module is
that recovery half, automated:

- on a worker crash or gang deadline, re-launch the whole gang with
  exponential backoff + jitter, passing ``DDW_RESTART_GEN=<n>`` through the
  env so the train fn knows it is a restart and resumes from the latest
  *durable* checkpoint (``CheckpointManager.latest_step`` — which quarantines
  torn step dirs, :mod:`ddw_tpu_torch.checkpoint.ckpt`) instead of step 0;
- graceful preemption (a rank exited ``EXIT_PREEMPTED`` after its SIGTERM
  handler let the step loop checkpoint and leave cleanly) is *restartable
  progress*, not failure: it has its own, larger budget and does not consume
  ``max_restarts``;
- when the budget is exhausted, raise :class:`GangFailure` carrying the full
  per-attempt forensic record (exit codes, rank-0 tracebacks, elapsed time
  per generation) instead of only the last error string.

The supervised train fn needs no new API: write checkpoints under a stable
directory and pass ``resume=True`` (restore-from-empty is a no-op, so
generation 0 starts from step 0 and every later generation resumes).
:func:`restart_generation` exposes the counter for fns that want to branch.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Any, Callable

from ddw_tpu_torch.runtime.faults import (  # noqa: F401  (re-exported: one
    EXIT_PREEMPTED,                         # import site for supervision
    #                                         and preemption)
    Preempted,
    install_preemption_handler,
    preemption_requested,
    reset_preemption,
)
from ddw_tpu_torch.runtime.launcher import GangError, Launcher


def restart_generation() -> int:
    """Which restart generation this process is running in (0 = first
    launch). Set in the worker env by the supervisor."""
    try:
        return int(os.environ.get("DDW_RESTART_GEN", "0") or 0)
    except ValueError:
        return 0


@dataclasses.dataclass
class AttemptReport:
    """One recovery-worthy event, as the supervisor saw it: a failed
    generation (``recovery="whole-world"``), a single-rank death the
    launcher healed in place (``recovery="elastic"``), a permanent loss the
    gang absorbed by re-forming at a smaller world (``recovery="shrink"``,
    with ``old_world_size``/``new_world_size`` and the evicted rank's
    forensics), or a re-expansion (``recovery="grow"``). ``dead_rank`` /
    ``exit_signal`` carry the which-rank-died-and-how forensics (signal
    deaths — SIGKILL'd / OOM'd hosts — have a negative waitpid code; the
    positive signal number lands here)."""

    generation: int
    kind: str                       # crash | deadline | preempted | coord-bind
    #                                 | result-missing | rank-death | regrow
    exit_codes: list
    rank0_traceback: str | None
    elapsed_s: float
    dead_rank: int | None = None    # first abnormally-exited rank
    exit_signal: int | None = None  # signal that killed it, if any
    recovery: str = "whole-world"   # elastic | shrink | grow | whole-world
    old_world_size: int | None = None   # shrink/grow: world before the event
    new_world_size: int | None = None   # shrink/grow: world after the event

    def __str__(self) -> str:
        where = (f" (rank {self.dead_rank}"
                 + (f", signal {self.exit_signal}" if self.exit_signal
                    else "")
                 + f", {self.recovery})") if self.dead_rank is not None else ""
        world = (f", world {self.old_world_size}->{self.new_world_size}"
                 if self.new_world_size is not None else "")
        return (f"gen {self.generation}: {self.kind}{where}{world}, exit "
                f"codes {self.exit_codes}, after {self.elapsed_s:.1f}s")


class GangFailure(RuntimeError):
    """The gang died permanently: restart budget exhausted (or restarts
    disabled). Carries every attempt's exit codes and the most recent rank-0
    traceback, so the root cause survives N failed generations."""

    def __init__(self, attempts: list[AttemptReport], max_restarts: int,
                 flight: list | None = None):
        self.attempts = list(attempts)
        self.max_restarts = max_restarts
        # flight recorder: the supervising process's last trace events
        # (attempt spans, restart instants) — same shape as the serving
        # side's ReplicaFailed forensics["flight"]
        self.flight = list(flight) if flight else []
        self.exit_codes = [a.exit_codes for a in attempts]
        self.rank0_traceback = next(
            (a.rank0_traceback for a in reversed(attempts)
             if a.rank0_traceback), None)
        lines = [f"gang failed permanently after {len(attempts)} attempt(s) "
                 f"(max_restarts={max_restarts}):"]
        lines += [f"  {a}" for a in attempts]
        if self.rank0_traceback:
            lines.append("rank-0 traceback (most recent attempt that "
                         "captured one):")
            lines += ["  " + ln for ln in
                      str(self.rank0_traceback).splitlines()]
        super().__init__("\n".join(lines))


class GangSupervisor:
    """Run a train fn through a :class:`Launcher` gang, restarting the gang
    from the latest durable checkpoint on failure.

    ``max_restarts`` bounds crash/deadline restarts (0 = fail on the first
    abnormal death — the pre-supervisor behavior, but with the structured
    :class:`GangFailure`). ``max_preemption_restarts`` bounds graceful
    preemptions separately: a preempted gang checkpointed and exited cleanly,
    so rescheduling it is cheap forward progress, not failure churn — only a
    preemption *storm* should give up. Backoff between restarts is
    ``backoff_base_s * 2**(restart-1)`` capped at ``backoff_max_s``, plus
    uniform jitter of up to ``jitter * delay`` (decorrelates re-rendezvous
    stampedes when several supervised jobs share a cluster event).

    With an ``np=-1`` launcher the fn runs in-process exactly once —
    restarting the surrounding process is not the supervisor's to do.

    ``tracker_run`` (a :class:`ddw_tpu_torch.tracking.tracker.Run`) makes the
    recovery story a first-class tracked artifact: whatever the outcome,
    the supervisor logs per-attempt metrics (``supervisor.attempt_*`` series
    indexed by generation), the restart/preemption totals, an ``outcome``
    tag, and a ``supervisor_attempts.json`` forensic artifact — so "how
    often did this job die and why" is queryable next to its loss curves
    instead of buried in driver logs.
    """

    def __init__(self, launcher: Launcher, max_restarts: int = 2,
                 max_preemption_restarts: int = 8,
                 backoff_base_s: float = 1.0, backoff_max_s: float = 30.0,
                 jitter: float = 0.25, tracker_run=None, tracer=None):
        self.launcher = launcher
        self.max_restarts = max_restarts
        self.max_preemption_restarts = max_preemption_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.jitter = jitter
        self.tracker_run = tracker_run
        self.tracer = tracer    # optional obs.Tracer: attempt spans + the
        #                         ring's tail attached to GangFailure.flight
        self.attempts: list[AttemptReport] = []  # failed attempts, last run()
        self.generations = 0                     # gangs launched, last run()

    def _fail(self) -> GangFailure:
        flight = self.tracer.tail(64) if self.tracer is not None else None
        return GangFailure(self.attempts, self.max_restarts, flight=flight)

    def run(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        if self.launcher.np == -1:
            self.generations = 1
            return self.launcher.run(fn, *args, **kwargs)
        self.attempts = []
        crash_restarts = preempt_restarts = 0
        gen = 0
        try:
            while True:
                self.generations = gen + 1
                t0 = time.monotonic()
                try:
                    value = self.launcher._run_multiproc(
                        fn, args, kwargs,
                        extra_env={"DDW_RESTART_GEN": str(gen)})
                    self._harvest_elastic(gen)
                    if self.tracer is not None:
                        self.tracer.record_span(
                            "gang_attempt", "supervisor", t0,
                            time.monotonic(), tid="supervisor",
                            args={"generation": gen, "outcome": "completed"})
                    self._report("completed", crash_restarts,
                                 preempt_restarts)
                    return value
                except GangError as e:
                    self._harvest_elastic(gen)
                    kind = "preempted" if e.is_preemption else e.kind
                    dead, sig = self._dead_rank(e.exit_codes, kind,
                                                e.killed_ranks)
                    self.attempts.append(AttemptReport(
                        generation=gen, kind=kind, exit_codes=e.exit_codes,
                        rank0_traceback=e.rank0_traceback,
                        elapsed_s=time.monotonic() - t0,
                        dead_rank=dead, exit_signal=sig,
                        recovery="whole-world"))
                    if self.tracer is not None:
                        self.tracer.record_span(
                            "gang_attempt", "supervisor", t0,
                            time.monotonic(), tid="supervisor",
                            args={"generation": gen, "outcome": kind,
                                  "dead_rank": dead,
                                  "exit_codes": list(e.exit_codes)})
                    if kind == "preempted":
                        preempt_restarts += 1
                        if preempt_restarts > self.max_preemption_restarts:
                            raise self._fail() from e
                    else:
                        crash_restarts += 1
                        if crash_restarts > self.max_restarts:
                            raise self._fail() from e
                self._backoff(crash_restarts + preempt_restarts)
                gen += 1
        except GangFailure:
            self._report("failed", crash_restarts, preempt_restarts)
            raise

    @staticmethod
    def _dead_rank(exit_codes: list, kind: str,
                   killed=()) -> tuple[int | None, int | None]:
        """Forensics for a whole-gang failure: which rank's death is the
        ROOT CAUSE, and the signal that killed it when the waitpid code
        says signal death. Peers dying as collective-error collateral exit
        1 (the worker's generic-error path), so among the abnormal exits a
        distinguished death — a signal, or any non-1 code — outranks an
        exit-1 neighbor. Ranks the launcher killed itself (``killed``,
        :attr:`GangError.killed_ranks`) are collateral too: their SIGKILL
        only counts when no other rank died."""
        if kind == "preempted":
            for rank, code in enumerate(exit_codes):
                if code == EXIT_PREEMPTED:
                    return rank, None
            return None, None
        abnormal = [(r, c) for r, c in enumerate(exit_codes)
                    if c is not None and c not in (0, EXIT_PREEMPTED)]
        if any(r not in killed for r, _ in abnormal):
            abnormal = [(r, c) for r, c in abnormal if r not in killed]
        if not abnormal:
            return None, None
        rank, code = next(((r, c) for r, c in abnormal if c != 1),
                          abnormal[0])
        return rank, (-code if code < 0 else None)

    def _harvest_elastic(self, gen: int) -> None:
        """Fold the launcher's in-place recoveries (ElasticEvent) into the
        attempt record: same forensic surface as a whole-world restart,
        tagged ``recovery="elastic"`` (single-rank respawn),
        ``recovery="shrink"`` (permanent loss absorbed at world−1, with the
        old/new world sizes and the evicted rank's exit forensics), or
        ``recovery="grow"`` (re-expansion) — so 'which rank died, how, and
        what recovery it cost' is one queryable list either way."""
        recovery_by_kind = {"respawn": "elastic", "shrink": "shrink",
                            "grow": "grow"}
        for ev in getattr(self.launcher, "elastic_events", []):
            kind = getattr(ev, "kind", "respawn")
            self.attempts.append(AttemptReport(
                generation=gen,
                kind="regrow" if kind == "grow" else "rank-death",
                exit_codes=[ev.exit_code], rank0_traceback=None,
                elapsed_s=0.0, dead_rank=ev.dead_rank,
                exit_signal=ev.exit_signal,
                recovery=recovery_by_kind.get(kind, "elastic"),
                old_world_size=getattr(ev, "old_world", None),
                new_world_size=getattr(ev, "new_world", None)))

    def _report(self, outcome: str, crash_restarts: int,
                preempt_restarts: int) -> None:
        """Surface the attempt record into the tracker run (no-op without
        one; never takes the job down — the record is observability)."""
        run = self.tracker_run
        if run is None:
            return
        try:
            elastic = [a for a in self.attempts if a.recovery == "elastic"]
            shrinks = [a for a in self.attempts if a.recovery == "shrink"]
            failed = [a for a in self.attempts
                      if a.recovery not in ("elastic", "shrink", "grow")]
            run.log_metrics({
                "supervisor.generations": float(self.generations),
                "supervisor.failed_attempts": float(len(failed)),
                "supervisor.crash_restarts": float(crash_restarts),
                "supervisor.preemption_restarts": float(preempt_restarts),
                "supervisor.elastic_recoveries": float(len(elastic)),
                "supervisor.shrink_recoveries": float(len(shrinks)),
            })
            # gang.world_size gauge: the world-size timeline across every
            # re-negotiation (launch-time np, then each shrink/grow).
            run.log_metric("gang.world_size", float(self.launcher.np),
                           step=0)
            for k, a in enumerate(a for a in self.attempts
                                  if a.recovery in ("shrink", "grow")):
                run.log_metric("gang.world_size", float(a.new_world_size),
                               step=k + 1)
            for a in failed:
                run.log_metric("supervisor.attempt_elapsed_s", a.elapsed_s,
                               step=a.generation)
                run.log_metric(
                    "supervisor.attempt_preempted",
                    1.0 if a.kind == "preempted" else 0.0,
                    step=a.generation)
                if a.dead_rank is not None:
                    run.log_metric("supervisor.attempt_dead_rank",
                                   float(a.dead_rank), step=a.generation)
            for k, a in enumerate(elastic):
                run.log_metric("supervisor.elastic_dead_rank",
                               float(a.dead_rank), step=k)
            run.set_tags({"supervisor.outcome": outcome})
            import json

            art = run.artifact_dir("supervisor")
            with open(os.path.join(art, "supervisor_attempts.json"),
                      "w") as f:
                json.dump({"outcome": outcome,
                           "max_restarts": self.max_restarts,
                           "max_preemption_restarts":
                               self.max_preemption_restarts,
                           "attempts": [dataclasses.asdict(a)
                                        for a in self.attempts]},
                          f, indent=2, default=str)
        except Exception:
            pass

    def _backoff(self, nth_restart: int) -> None:
        delay = min(self.backoff_max_s,
                    self.backoff_base_s * (2 ** max(0, nth_restart - 1)))
        delay += random.uniform(0.0, self.jitter * delay)
        if delay > 0:
            time.sleep(delay)
