"""Strategy-aware weight rollouts across a live replica fleet.

Three strategies, one controller, one forensics surface:

- ``rolling`` (the default): one replica at a time —
  stage the new checkpoint (:meth:`set_checkpoint`, applied at the next
  restart), hand the replica to the supervisor's
  :meth:`~ddw_tpu_torch.gateway.ReplicaSupervisor.recycle` path (circuit tripped
  → drain in-flight work to completion → restart on the new weights →
  re-warm → shadow-probe → readmit), verify it came back serving the
  TARGET digest on a CLOSED circuit, then advance. Siblings carry the
  interactive load the whole time — zero dropped requests is the contract
  the drills pin.
- ``canary``: roll ONE replica, hold it at ``canary_fraction`` of eligible
  traffic (weighted routing in :class:`~ddw_tpu_torch.gateway.ReplicaSet`), and
  let a :class:`~ddw_tpu_torch.deploy.CanaryJudge` compare its SLO tails +
  error counters to the rest-of-fleet baseline over ``judge_window_s``.
  Verdict ``promote`` continues the roll fleet-wide; ``reject`` restages
  the OLD checkpoint (and draft) on the canary, recycles it back, and
  leaves the structured verdict forensics in ``deploy_view`` — the fleet
  never saw the bad checkpoint beyond one held replica.
- ``surge``: spawn the new-generation replica BEFORE draining the old one
  (``clone_fresh`` → start → warmup off-traffic →
  :meth:`~ddw_tpu_torch.gateway.ReplicaSupervisor.surge_swap`), so fleet
  capacity never dips below N during the rollout; the retired generation
  drains its in-flight work to completion, then exits — the
  Horovod-elastic membership framing (grow first, shrink after).

Verification is digest-based: the first successfully-rolled replica names
the target digest through its health (the engine's ``checkpoint_id``), and
every later replica must match it. A replica that fails to drain, fails
its warmup probe, or comes back on the wrong digest ABORTS the rollout: no
further replicas are touched, and (with ``rollback=True``, the default)
the failed replica is re-staged on its OLD checkpoint and recycled back.
Replicas that already completed the roll KEEP the new weights — a
half-rolled fleet serves both checkpoints correctly (requests are
checkpoint-agnostic), and re-running the deploy resumes the roll; rolling
the winners back would double the disruption to un-break nothing. That
asymmetry is now SURFACED, not just documented: the terminal status
carries ``replica_end_state`` (``kept_new`` / ``restored_old`` /
``untouched`` per replica) and ``/readyz`` reports ``mixed_checkpoints``
whenever fleet digests disagree.

With a :class:`~ddw_tpu_torch.deploy.RolloutJournal` attached, every replica
step is fsync'd before the next begins and the plan (strategy, target,
per-replica old dirs/digests) is journaled up front — a gateway killed
mid-rollout leaves a journal whose meta still says ``rolling``, and
:func:`resume_rollout` (run by ``Gateway.start``) converges the fleet:
rolling/surge rollouts RESUME toward the target (replicas already on the
target digest are skipped as ``already_current``), a canary rollout that
died before its verdict ROLLS the canary BACK (no verdict = no
promotion), and a mixed-digest fleet with no journal at all converges to
its majority digest. ``DDW_FAULT=deploy:crash_mid_roll`` drives that path
deterministically in tests (:mod:`ddw_tpu_torch.runtime.faults`).

Forensics: every step lands in the shared status dict (the gateway's
``/stats`` ``deploy`` block and ``deploy_view``) tagged with the replica's
new generation, and the supervisor's attempt ledger carries the same steps
under ``kind="deploy"``.

The port of ``ddw_tpu.deploy.controller``: the same host logic,
importing nothing of ``ddw_tpu``.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from ddw_tpu_torch.runtime.faults import DeployCrash, maybe_deploy_fault

__all__ = ["DeployController", "DeployStep", "resume_rollout", "STRATEGIES"]

_UNSET = object()       # "this deploy does not touch the draft package"

STRATEGIES = ("rolling", "canary", "surge")


@dataclasses.dataclass
class DeployStep:
    """One replica's roll, as recorded in the deploy forensics."""

    replica: int
    action: str          # recycled | surged | already_current |
    #                      canary_promoted | canary_rejected |
    #                      verify_failed | drain_failed | surge_failed |
    #                      rolled_back | rollback_failed
    ok: bool
    generation: int = 0
    checkpoint: str | None = None
    detail: str = ""
    elapsed_s: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class DeployController:
    """Drives one rollout; built per-rollout (the gateway's
    ``start_deploy`` spawns it on a control thread). ``status`` is the
    externally-visible dict it mutates under ``status_lock`` — the
    gateway shares its own so ``/stats`` reads live progress."""

    def __init__(self, replica_set, supervisor, model_dir: str,
                 rollback: bool = True, status: dict | None = None,
                 status_lock: threading.Lock | None = None,
                 settle_timeout_s: float = 60.0, draft_dir=_UNSET,
                 tracer=None, strategy: str = "rolling",
                 canary_fraction: float = 0.1,
                 judge_window_s: float = 5.0, canary_index: int = 0,
                 judge_kw: dict | None = None, journal=None,
                 resume: bool = False, skip_current: bool = False,
                 target_digest: str | None = None, only=None,
                 final_status: str = "done"):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown deploy strategy {strategy!r}; "
                             f"expected one of {STRATEGIES}")
        self.rs = replica_set
        self.supervisor = supervisor
        self.model_dir = model_dir
        self.draft_dir = draft_dir   # speculative-decode draft staged
        #                              alongside the target; _UNSET = the
        #                              deploy leaves the draft alone
        self.rollback = rollback
        self.settle_timeout_s = settle_timeout_s
        self.strategy = strategy
        self.canary_fraction = canary_fraction
        self.judge_window_s = judge_window_s
        self.canary_index = canary_index
        self.judge_kw = dict(judge_kw or {})
        self.journal = journal       # RolloutJournal | None: fsync'd plan +
        #                              per-step rows (the crash-resume state)
        self.resume = resume         # True = resume_rollout built us over an
        #                              interrupted journal (append, don't
        #                              truncate; count journal_resumes)
        self.skip_current = skip_current    # skip replicas already on the
        #                              target digest (resume idempotence)
        self.only = list(only) if only is not None else None   # restrict
        #                              the roll to these replica indices
        self.final_status = final_status    # terminal status on success
        #                              ("rolled_back" for a resume that
        #                              un-rolls a verdict-less canary)
        self.status = status if status is not None else {
            "deploying": False, "status": "idle", "fleet_generation": 0,
            "steps": []}
        self._status_lock = status_lock or threading.Lock()
        self.steps: list[DeployStep] = []
        self._want_digest: str | None = target_digest
        self._rolled = 0             # completed per-replica steps (the
        #                              mid_roll fault counts these)
        self._end: dict[int, str] = {}      # replica -> kept_new |
        #                              restored_old (terminal summary)
        self.tracer = tracer         # the gateway's, when it traces: every
        self._trace_id = None        # rollout step lands on one trace id
        self._root_span = None       # so Perfetto shows the whole roll
        if tracer is not None:
            from ddw_tpu_torch.obs.trace import gen_id
            self._trace_id = f"deploy-{gen_id()[:8]}"

    # -- status plumbing -----------------------------------------------------
    def _set(self, **kw) -> None:
        with self._status_lock:
            self.status.update(kw)

    def _fleet_counters(self):
        """Rollout lifecycle counters land on the fleet-level metrics a
        ReplicaSet owns (they survive replica replacement and merge into
        snapshot()/Prometheus with everything else). A bare fake without
        one gets a throwaway sink so call sites stay unconditional."""
        m = getattr(self.rs, "fleet_metrics", None)
        if m is None:
            from ddw_tpu_torch.serve.metrics import EngineMetrics
            m = EngineMetrics()
        return m

    def _record(self, step: DeployStep, old_dir=None, old_draft=None) -> None:
        self.steps.append(step)
        with self._status_lock:
            self.status.setdefault("steps", []).append(step.to_dict())
        if self.journal is not None:
            row = step.to_dict()
            row["old_dir"] = old_dir
            row["old_draft"] = old_draft
            self.journal.record_step(row)
        if self.tracer is not None:
            # one span per rollout step, reconstructed from the step's own
            # clock (t1 = now, t0 = t1 - elapsed) — the forensics dict and
            # the trace can never disagree about duration
            t1 = time.monotonic()
            self.tracer.record_span(
                f"deploy.{step.action}", "deploy",
                t1 - step.elapsed_s, t1, trace=self._trace_id,
                parent=self._root_span, tid="deploy",
                args={"replica": step.replica, "ok": step.ok,
                      "generation": step.generation,
                      "checkpoint": step.checkpoint,
                      "detail": step.detail})

    def _finalize(self, status: str, bump_generation: bool = False) -> None:
        """Terminal bookkeeping: per-replica end states surfaced, journal
        finalized, ``deploying`` cleared. The journal's terminal record
        lands BEFORE the in-memory status flips: the journal is the
        durable truth the restart reconciler reads, so an observer who
        sees ``status=done`` must never find a still-``rolling`` journal
        behind it (and a crash in the gap must not trigger a spurious
        resume of a finished rollout)."""
        end = {str(i): self._end.get(i, "untouched")
               for i in range(len(self.rs.replicas))}
        self._journal_finish(status)
        with self._status_lock:
            if bump_generation:
                self.status["fleet_generation"] = \
                    self.status.get("fleet_generation", 0) + 1
            self.status["replica_end_state"] = end
            self.status.update(deploying=False, status=status)

    def _journal_finish(self, status: str) -> None:
        """Best-effort terminal journal write: a disk error here must not
        leave ``deploying`` stuck True (the status update still runs)."""
        if self.journal is not None:
            try:
                self.journal.finish(status)
            except OSError:
                pass

    # -- the roll ------------------------------------------------------------
    def _health(self, i: int) -> dict:
        try:
            return self.rs.replicas[i].health()
        except Exception:
            return {}

    def _settled(self, i: int, want_digest: str | None) -> tuple[bool, str]:
        """A rolled replica counts only when it is alive on a CLOSED
        circuit AND reports the target digest (when one is known yet)."""
        deadline = time.monotonic() + self.settle_timeout_s
        last = ""
        while time.monotonic() < deadline:
            h = self._health(i)
            circuit = self.rs.breakers[i].state
            ck = h.get("checkpoint")
            if (h.get("state") in ("alive", "degraded")
                    and circuit == "closed"
                    and ck is not None
                    and (want_digest is None or ck == want_digest)):
                return True, ck
            last = (f"state={h.get('state')} circuit={circuit} "
                    f"checkpoint={ck}")
            time.sleep(0.05)
        return False, last

    def _indices(self) -> list[int]:
        if self.only is not None:
            return [i for i in self.only
                    if 0 <= i < len(self.rs.replicas)]
        return list(range(len(self.rs.replicas)))

    def _stage(self, eng, model_dir, draft_dir) -> None:
        if draft_dir is _UNSET:
            eng.set_checkpoint(model_dir)
        else:
            eng.set_checkpoint(model_dir, draft_dir=draft_dir)

    def _already_current(self, i: int) -> bool:
        """Resume idempotence: a replica whose health already reports the
        target digest has nothing to do — re-rolling it would only pay a
        pointless drain."""
        if not self.skip_current or self._want_digest is None:
            return False
        if self._health(i).get("checkpoint") != self._want_digest:
            return False
        self._end[i] = "kept_new"
        self._rolled += 1
        self._record(DeployStep(
            replica=i, action="already_current", ok=True,
            generation=getattr(self.rs.replicas[i], "generation", 0),
            checkpoint=self._want_digest))
        return True

    def _journal_begin(self) -> None:
        if self.journal is None:
            return
        if self.resume:
            self.journal.resume_appending()
            return
        health = []
        try:
            health = self.rs.fleet_health()
        except Exception:
            pass
        self.journal.begin({
            "strategy": self.strategy,
            "target_dir": self.model_dir,
            "has_draft": self.draft_dir is not _UNSET,
            "draft_dir": (None if self.draft_dir is _UNSET
                          else self.draft_dir),
            "rollback": self.rollback,
            "canary_index": self.canary_index,
            "canary_fraction": self.canary_fraction,
            "n_replicas": len(self.rs.replicas),
            "old_dirs": [getattr(e, "model_dir", None)
                         for e in self.rs.replicas],
            "old_drafts": [getattr(e, "draft_dir", None)
                           for e in self.rs.replicas],
            "old_checkpoints": [h.get("checkpoint") for h in health],
        })

    def run(self) -> dict:
        """Roll the fleet; returns the final status dict. Never raises —
        a deploy is an operator action whose failure mode is a recorded
        abort, not a crashed control thread. (The one exception is the
        injected :class:`DeployCrash`, which by design dies WITHOUT
        finalizing the journal — the in-process stand-in for a gateway
        SIGKILL that the reconciler drills recover from.)"""
        self._set(deploying=True, status="rolling",
                  target_dir=self.model_dir, strategy=self.strategy)
        if self.resume:
            self._set(resumed=True)
            self._fleet_counters().count("journal_resumes")
        t_roll = time.monotonic()
        if self.tracer is not None:
            # pre-allocated so step spans can parent on it before it lands
            self._root_span = self.tracer._next_span_id()
        try:
            self._journal_begin()
            if self.strategy == "canary":
                return self._run_canary()
            if self.strategy == "surge":
                return self._run_surge()
            return self._run_rolling()
        except DeployCrash as e:
            # simulated mid-roll gateway death: clear the in-memory flag
            # (a real SIGKILL clears it by dying) but leave the journal
            # UNFINISHED — resume_rollout must converge the fleet
            self._set(deploying=False, status="crashed", error=str(e))
            return self.status
        except Exception as e:               # belt-and-braces: record, don't
            self._journal_finish("aborted")  # leave "deploying" stuck True
            self._set(deploying=False, status="aborted", error=repr(e))
            return self.status
        finally:
            if self.tracer is not None:
                self.tracer.record_span(
                    "deploy", "deploy", t_roll, time.monotonic(),
                    trace=self._trace_id, tid="deploy",
                    span=self._root_span,
                    args={"target": self.model_dir,
                          "strategy": self.strategy,
                          "status": self.status.get("status"),
                          "steps": len(self.steps)})

    # -- rolling -------------------------------------------------------------
    def _run_rolling(self) -> dict:
        for i in self._indices():
            maybe_deploy_fault("mid_roll", n=self._rolled)
            if self._already_current(i):
                continue
            if not self._roll_replica(i):
                return self.status
        self._finalize(self.final_status,
                       bump_generation=self.final_status == "done")
        return self.status

    def _roll_replica(self, i: int) -> bool:
        """Stage + recycle + settle one replica (the shared per-replica
        step for rolling and canary). False = the roll aborted here (the
        abort/rollback bookkeeping already ran)."""
        eng = self.rs.replicas[i]
        t0 = time.monotonic()
        old_dir = getattr(eng, "model_dir", None)
        old_draft = getattr(eng, "draft_dir", None)
        try:
            self._stage(eng, self.model_dir, self.draft_dir)
        except AttributeError:
            self._record(DeployStep(
                replica=i, action="verify_failed", ok=False,
                detail="replica has no set_checkpoint hook"))
            self._abort(i, old_dir, old_draft)
            return False
        try:
            ok = self.supervisor.recycle(i, kind="deploy")
        except Exception:            # recycle never should, but a
            ok = False               # deploy must not crash on it
        if not ok:
            # recycle already escalated to force_fail + the
            # supervisor's crash-restart path; the replica will
            # come back, but NOT via the drain contract — abort
            eng = self.rs.replicas[i]   # may have been replaced
            self._record(DeployStep(
                replica=i, action="drain_failed", ok=False,
                generation=getattr(eng, "generation", 0),
                detail="recycle did not complete in budget",
                elapsed_s=time.monotonic() - t0))
            self._abort(i, old_dir, old_draft)
            return False
        eng = self.rs.replicas[i]
        settled, got = self._settled(i, self._want_digest)
        if not settled:
            self._record(DeployStep(
                replica=i, action="verify_failed", ok=False,
                generation=getattr(eng, "generation", 0),
                detail=got, elapsed_s=time.monotonic() - t0))
            self._abort(i, old_dir, old_draft)
            return False
        if self._want_digest is None:
            self._want_digest = got   # the first roll names the target
            self._set(target_checkpoint=self._want_digest)
            if self.journal is not None:
                self.journal.note(target_checkpoint=self._want_digest)
        self._end[i] = "kept_new"
        self._rolled += 1
        self._record(DeployStep(
            replica=i, action="recycled", ok=True,
            generation=getattr(eng, "generation", 0),
            checkpoint=got, elapsed_s=time.monotonic() - t0),
            old_dir=old_dir, old_draft=old_draft)
        return True

    # -- canary --------------------------------------------------------------
    def _run_canary(self) -> dict:
        from ddw_tpu_torch.deploy.canary import CanaryJudge

        ci = self.canary_index
        if ci >= len(self.rs.replicas):
            raise ValueError(f"canary index {ci} out of range")
        eng = self.rs.replicas[ci]
        old_dir = getattr(eng, "model_dir", None)
        old_draft = getattr(eng, "draft_dir", None)
        # Weight the canary BEFORE rolling it: the instant the recycled
        # replica comes back routable it is already holding candidate
        # weights, and only the canary fraction may ever see those. The
        # weighting stays up through a reject's rollback for the same
        # reason — it drops only once the replica no longer serves the
        # candidate (promote blesses it; rollback recycles it away).
        set_canary = getattr(self.rs, "set_canary", None)
        cleared = [set_canary is None]

        def _unweight():
            if not cleared[0]:
                cleared[0] = True
                self.rs.clear_canary()

        if set_canary is not None:
            set_canary(ci, self.canary_fraction)
        try:
            if not self._roll_replica(ci):
                return self.status
            # hold the canary at its traffic fraction and judge it
            self._set(status="canary_holding")
            t_judge = time.monotonic()
            judge = CanaryJudge(
                self.rs, ci, window_s=self.judge_window_s,
                publish=lambda v: self._set(canary=v), **self.judge_kw)
            verdict = judge.run()
            self._set(canary=verdict)
            if verdict.get("verdict") == "promote":
                _unweight()
                self._fleet_counters().count("canary_promoted")
                self._record(DeployStep(
                    replica=ci, action="canary_promoted", ok=True,
                    checkpoint=self._want_digest,
                    detail=verdict.get("reason", ""),
                    elapsed_s=time.monotonic() - t_judge))
                for i in self._indices():
                    if i == ci:
                        continue
                    maybe_deploy_fault("mid_roll", n=self._rolled)
                    if self._already_current(i):
                        continue
                    if not self._roll_replica(i):
                        return self.status
                self._finalize("done", bump_generation=True)
                return self.status
            # reject: restage the OLD checkpoint (and draft) on the canary
            # and recycle it back — the rest of the fleet never saw the
            # candidate
            self._fleet_counters().count("canary_rejected")
            self._record(DeployStep(
                replica=ci, action="canary_rejected", ok=True,
                checkpoint=self._want_digest,
                detail=f"{verdict.get('reason', '')}; restaging {old_dir}",
                elapsed_s=time.monotonic() - t_judge))
            self._set(status="rolling_back")
            t0 = time.monotonic()
            ok = False
            try:
                # re-fetch: the recycle may have replaced the engine object
                self._stage(self.rs.replicas[ci], old_dir,
                            old_draft if self.draft_dir is not _UNSET
                            else _UNSET)
                ok = self.supervisor.recycle(ci, kind="rollback")
                if ok:
                    ok, _ = self._settled(ci, None)
            except Exception:
                ok = False
            _unweight()    # the candidate weights are out of rotation now
            self._end[ci] = "restored_old" if ok else "untouched"
            self._record(DeployStep(
                replica=ci, action="rolled_back" if ok else "rollback_failed",
                ok=ok, generation=getattr(self.rs.replicas[ci],
                                          "generation", 0),
                detail=f"restaged {old_dir}",
                elapsed_s=time.monotonic() - t0),
                old_dir=old_dir, old_draft=old_draft)
            self._finalize("rejected" if ok else "aborted")
            return self.status
        finally:
            _unweight()

    # -- surge ---------------------------------------------------------------
    def _run_surge(self) -> dict:
        for i in self._indices():
            maybe_deploy_fault("mid_roll", n=self._rolled)
            if self._already_current(i):
                continue
            if not self._surge_replica(i):
                return self.status
        self._finalize(self.final_status,
                       bump_generation=self.final_status == "done")
        return self.status

    def _surge_replica(self, i: int) -> bool:
        """Spawn-before-drain: build + start + warm the new-generation
        replica OFF-traffic, then cut the slot over atomically
        (``surge_swap``) and let the old generation drain to completion.
        A failed spawn/warmup leaves the OLD replica serving untouched
        (its staged checkpoint is reverted) — surge failures cost zero
        capacity."""
        old = self.rs.replicas[i]
        t0 = time.monotonic()
        old_dir = getattr(old, "model_dir", None)
        old_draft = getattr(old, "draft_dir", None)
        try:
            self._stage(old, self.model_dir, self.draft_dir)
        except AttributeError:
            self._record(DeployStep(
                replica=i, action="verify_failed", ok=False,
                detail="replica has no set_checkpoint hook"))
            self._journal_finish("aborted")
            self._set(deploying=False, status="aborted")
            return False
        new_eng = None
        try:
            new_eng = old.clone_fresh()     # consumes the staged checkpoint
            new_eng.start()
            lens = tuple(getattr(self.supervisor, "warmup_prompt_lens",
                                 (8,)) or ())
            if lens:
                new_eng.warmup(lens)
        except Exception as e:
            # the old replica never stopped serving; un-stage and abort
            if new_eng is not None:
                try:
                    new_eng.stop()
                except Exception:
                    pass
            try:
                self._stage(old, old_dir,
                            old_draft if self.draft_dir is not _UNSET
                            else _UNSET)
            except Exception:
                pass
            self._record(DeployStep(
                replica=i, action="surge_failed", ok=False,
                detail=f"spawn/warmup failed: {e!r}"[:200],
                elapsed_s=time.monotonic() - t0))
            self._finalize("aborted")
            return False
        if hasattr(self.supervisor, "surge_swap"):
            self.supervisor.surge_swap(i, new_eng)
        else:                               # scripted fakes in unit tests
            self.rs.replace(i, new_eng)
            try:
                old.stop()
            except Exception:
                pass
        settled, got = self._settled(i, self._want_digest)
        if not settled:
            self._record(DeployStep(
                replica=i, action="verify_failed", ok=False,
                generation=getattr(new_eng, "generation", 0),
                detail=got, elapsed_s=time.monotonic() - t0))
            self._finalize("aborted")
            return False
        if self._want_digest is None:
            self._want_digest = got
            self._set(target_checkpoint=self._want_digest)
            if self.journal is not None:
                self.journal.note(target_checkpoint=self._want_digest)
        self._fleet_counters().count("surge_spawns")
        self._end[i] = "kept_new"
        self._rolled += 1
        self._record(DeployStep(
            replica=i, action="surged", ok=True,
            generation=getattr(new_eng, "generation", 0),
            checkpoint=got, elapsed_s=time.monotonic() - t0),
            old_dir=old_dir, old_draft=old_draft)
        return True

    # -- abort / rollback ----------------------------------------------------
    def _abort(self, failed_i: int, old_dir: str | None,
               old_draft: str | None = None) -> None:
        """Stop the roll at the failed replica. With rollback on, re-stage
        its previous checkpoint and recycle it back; already-rolled
        replicas keep the new weights (see module docstring)."""
        if not (self.rollback and old_dir is not None):
            self._finalize("aborted")
            return
        self._set(status="rolling_back")
        eng = self.rs.replicas[failed_i]
        t0 = time.monotonic()
        ok = False
        try:
            self._stage(eng, old_dir,
                        old_draft if self.draft_dir is not _UNSET
                        else _UNSET)
            ok = self.supervisor.recycle(failed_i, kind="rollback")
            if ok:
                ok, _ = self._settled(failed_i, None)
        except Exception:
            ok = False
        if ok:
            self._end[failed_i] = "restored_old"
        self._record(DeployStep(
            replica=failed_i, action="rolled_back" if ok
            else "rollback_failed", ok=ok,
            generation=getattr(self.rs.replicas[failed_i],
                               "generation", 0),
            detail=f"restaged {old_dir}", elapsed_s=time.monotonic() - t0),
            old_dir=old_dir, old_draft=old_draft)
        self._finalize("rolled_back" if ok else "aborted")


# -- crash recovery (Gateway.start's reconciler) -----------------------------

def resume_rollout(replica_set, supervisor, journal_dir: str,
                   status: dict | None = None, status_lock=None,
                   tracer=None, settle_timeout_s: float = 60.0,
                   ) -> DeployController | None:
    """Build the controller that converges a fleet some dead gateway left
    half-rolled, or None when there is nothing to recover. Two detection
    paths, in priority order:

    1. **Unfinished journal** (meta still ``rolling``): rolling/surge
       rollouts resume toward the journaled target — replicas already on
       the target digest are skipped (``already_current``), the torn or
       missing final step re-runs. A canary rollout that died before its
       verdict rolls the canary BACK to its journaled old checkpoint (no
       verdict = no promotion; safety wins).
    2. **Mixed digests, no journal**: the fleet converges to its majority
       digest (ties break toward replica 0's), using the model_dir of a
       replica already serving it. Operators see the same signal as the
       reconciler via ``/readyz``'s ``mixed_checkpoints``.

    The caller runs the returned controller on a deploy thread exactly as
    ``start_deploy`` would; ``journal_resumes`` is counted by the
    controller's resume path."""
    from ddw_tpu_torch.deploy.journal import RolloutJournal

    rec = RolloutJournal.load(journal_dir)
    common = dict(status=status, status_lock=status_lock, tracer=tracer,
                  settle_timeout_s=settle_timeout_s)
    if rec is not None:
        meta, steps = rec["meta"], rec["steps"]
        journal = RolloutJournal(journal_dir)
        strategy = meta.get("strategy", "rolling")
        has_draft = bool(meta.get("has_draft"))
        n = int(meta.get("n_replicas") or len(replica_set.replicas))
        promoted = any(s.get("action") == "canary_promoted" for s in steps)
        if strategy == "canary" and not promoted:
            # verdict never landed: un-roll the canary to its old weights
            ci = int(meta.get("canary_index") or 0)
            old_dirs = meta.get("old_dirs") or [None] * n
            old_drafts = meta.get("old_drafts") or [None] * n
            old_cks = meta.get("old_checkpoints") or [None] * n
            old_dir = old_dirs[ci] if ci < len(old_dirs) else None
            if old_dir is None:
                journal.resume_appending()
                journal.finish("aborted")   # nothing restorable; unstick
                return None
            return DeployController(
                replica_set, supervisor, old_dir,
                draft_dir=(old_drafts[ci] if has_draft else _UNSET),
                strategy="rolling", journal=journal, resume=True,
                skip_current=True,
                target_digest=old_cks[ci] if ci < len(old_cks) else None,
                only=[ci], final_status="rolled_back", **common)
        target = meta.get("target_dir")
        if target is None:
            journal.resume_appending()
            journal.finish("aborted")
            return None
        return DeployController(
            replica_set, supervisor, target,
            draft_dir=(meta.get("draft_dir") if has_draft else _UNSET),
            rollback=bool(meta.get("rollback", True)),
            strategy="surge" if strategy == "surge" else "rolling",
            journal=journal, resume=True, skip_current=True,
            target_digest=meta.get("target_checkpoint"), **common)
    # no journal: a mixed-digest fleet (an older gateway, a deleted journal
    # dir) still converges — majority digest wins
    try:
        health = replica_set.fleet_health()
    except Exception:
        return None
    digests = [h.get("checkpoint") for h in health]
    live = [d for d in digests if d]
    if len(set(live)) <= 1:
        return None
    counts: dict[str, int] = {}
    for d in live:
        counts[d] = counts.get(d, 0) + 1
    best = max(counts.values())
    majority = next(d for d in digests if d and counts[d] == best)
    model_dir = next(
        (getattr(replica_set.replicas[i], "model_dir", None)
         for i, d in enumerate(digests)
         if d == majority
         and getattr(replica_set.replicas[i], "model_dir", None)), None)
    if model_dir is None:
        return None
    journal = RolloutJournal(journal_dir)
    return DeployController(
        replica_set, supervisor, model_dir, strategy="rolling",
        journal=journal, resume=True, skip_current=True,
        target_digest=majority, **common)
