"""AutoscaleController — the reconciler loop converging actual → desired.

:class:`~ddw_tpu_torch.autoscale.policy.ScalePolicy` is the pure half of the
autoscaling loop (telemetry windows in, one desired replica count out);
this module is the actuating half, run on the gateway:

- **scale-out is surge-style**: the new replica (``spawn_fn``, defaulting
  to ``clone_fresh`` of an existing :class:`~ddw_tpu_torch.deploy.
  ProcessReplica` — which carries its spawn transport, so remote-host
  children scale the same way) is started, warmed, warm-replayed with the
  fleet's hot prefixes, and shadow-probed BEFORE
  :meth:`~ddw_tpu_torch.gateway.ReplicaSet.add_replica` admits it — client
  capacity is never consumed by a cold replica, and a failed spawn or
  probe costs the fleet nothing;
- **scale-in drains first**: the least-loaded eligible replica (never the
  canary, never the last decode-capable engine) has its breaker tripped
  (out of routing), its outstanding work drained to completion under a
  deadline, and only then is it removed — ``remove_replica`` renumbers
  the router's slots and clears every router-side per-slot cache
  (:meth:`PrefixIndex.drop_replica`, :meth:`FleetTelemetry.
  drop_replica`), and :meth:`ReplicaSupervisor.note_removed` keeps the
  recovery arrays in step. A drain that times out ABORTS the scale-in:
  the breaker closes, the replica keeps serving, nothing is lost;
- **every decision journals**: scale events reuse the rollout journal's
  fsync discipline (:class:`~ddw_tpu_torch.deploy.journal.RolloutJournal`,
  separate directory) — ``begin`` before the first mutation, a step row
  per phase, ``finish`` after the last. A gateway killed mid-scale leaves
  a non-terminal journal that :meth:`reconcile` (run from
  ``Gateway.start``) finalizes on restart; the policy then re-converges
  the fleet from live telemetry, which is the correct desired state by
  definition;
- **rollouts and scale events exclude each other** through the gateway's
  deploy lock: a tick that finds ``deploying`` set defers its decision
  and counts ``serve.autoscale_blocked`` (blocked is COUNTED, never
  raced); while a scale event runs, the same flag makes
  ``POST /admin/deploy`` answer 409.

Fault hooks (``DDW_FAULT=autoscale:...`` — :func:`~ddw_tpu_torch.runtime.
faults.maybe_autoscale_fault`): ``spawn_fail`` aborts a scale-out before
admission, ``stall_drain`` wedges the scale-in drain until the deadline
aborts it, ``crash_mid_scale`` dies at a journal boundary (the reconcile
drill), ``flap`` feeds the policy alternating synthetic pressure (the
cooldown/hysteresis drill).

The port of ``ddw_tpu.autoscale.controller``: the same host logic,
importing nothing of ``ddw_tpu``.
"""

from __future__ import annotations

import threading
import time

from ddw_tpu_torch.autoscale.policy import (PolicyInputs, ScaleDecision,
                                            ScalePolicy, inputs_from_windows,
                                            max_burn)
from ddw_tpu_torch.deploy.journal import RolloutJournal
from ddw_tpu_torch.runtime.faults import FaultInjected, maybe_autoscale_fault

__all__ = ["AutoscaleController"]


class AutoscaleController:
    """Reconcile the fleet's replica count to the policy's desired count.

    Everything the controller touches is injectable for tests: the policy
    clock, ``spawn_fn`` (return a NOT-started engine), ``merged_fn`` /
    ``slo_status_fn`` (the telemetry inputs), and the deploy lock/status
    shared with the gateway. Call :meth:`tick` directly for deterministic
    drills, or :meth:`start` for the background loop."""

    def __init__(self, replica_set, supervisor=None, policy=None,
                 spawn_fn=None, journal_dir: str | None = None,
                 deploy_lock=None, deploy_status: dict | None = None,
                 merged_fn=None, slo_status_fn=None, lifecycle=None,
                 tick_interval_s: float = 2.0,
                 drain_timeout_s: float = 30.0,
                 warmup_prompt_lens=(8,), warm_replay_k: int = 8,
                 probe_timeout_s: float = 30.0, enabled: bool = True,
                 clock=time.monotonic):
        self.rs = replica_set
        self.supervisor = supervisor
        self.policy = policy if policy is not None else ScalePolicy()
        self.spawn_fn = spawn_fn
        self.journal_dir = journal_dir
        self._deploy_lock = deploy_lock or threading.Lock()
        self._deploy_status = (deploy_status if deploy_status is not None
                               else {})
        self._merged_fn = merged_fn
        self._slo_status_fn = slo_status_fn
        self.lifecycle = lifecycle
        self.tick_interval_s = float(tick_interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.warmup_prompt_lens = tuple(warmup_prompt_lens or ())
        self.warm_replay_k = int(warm_replay_k)
        self.probe_timeout_s = float(probe_timeout_s)
        self.enabled = bool(enabled)
        self._clock = clock
        self.ticks = 0              # decide invocations (the flap parity)
        self.scale_events = 0       # COMPLETED out+in events
        self.blocked = 0            # decisions deferred under the deploy lock
        self.last_decision: dict | None = None
        self.last_error: str | None = None
        self.reconciled: dict | None = None     # leftover journal finalized
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._push_gauges(len(self.rs.replicas))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "AutoscaleController":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="ddw-autoscale", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_interval_s):
            try:
                self.tick()
            except Exception as e:  # a reconcile bug (or an injected
                self.last_error = repr(e)   # crash) must not kill the loop
                #                             — the next tick re-converges

    # -- control surface (POST /admin/autoscale) ------------------------------
    def configure(self, enabled: bool | None = None,
                  min_replicas: int | None = None,
                  max_replicas: int | None = None) -> dict:
        """Enable/disable the loop and move the policy's bounds; validates
        the same invariants as policy construction and answers the updated
        view. Raises ``ValueError`` on a bad bound pair."""
        lo = (self.policy.min_replicas if min_replicas is None
              else int(min_replicas))
        hi = (self.policy.max_replicas if max_replicas is None
              else int(max_replicas))
        if lo < 1:
            raise ValueError(f"min_replicas must be >= 1, got {lo}")
        if hi < lo:
            raise ValueError(f"max_replicas ({hi}) < min_replicas ({lo})")
        self.policy.min_replicas = lo
        self.policy.max_replicas = hi
        if enabled is not None:
            self.enabled = bool(enabled)
        return self.view()

    def view(self) -> dict:
        """The ``/stats`` / ``/readyz`` autoscale block."""
        actual = len(self.rs.replicas)
        last = dict(self.last_decision) if self.last_decision else None
        return {"enabled": self.enabled, "actual": actual,
                "desired": (last or {}).get("desired", actual),
                "last_decision": last,
                "cooldown_remaining_s": {
                    "out": round(self.policy.cooldown_remaining("out"), 3),
                    "in": round(self.policy.cooldown_remaining("in"), 3)},
                "policy": self.policy.describe(),
                "ticks": self.ticks, "scale_events": self.scale_events,
                "blocked": self.blocked, "last_error": self.last_error}

    # -- startup reconcile (the journal's read side) --------------------------
    def reconcile(self) -> dict | None:
        """Finalize a non-terminal scale journal a dead gateway left behind
        (crash mid-scale-out/in). The fleet this gateway just constructed
        IS the ground truth — the journal is closed as aborted with a
        reconcile note, and the policy re-converges the count from live
        telemetry on the next ticks. Returns the leftover record, or None
        when the journal is clean."""
        if not self.journal_dir:
            return None
        left = RolloutJournal.load(self.journal_dir)
        if left is None:
            return None
        j = RolloutJournal(self.journal_dir)
        j.resume_appending()
        j.record_step({"step": "reconciled",
                       "fleet_size": len(self.rs.replicas)})
        j.note(reconciled=True)
        j.finish("aborted")
        try:
            self.rs.fleet_metrics.count("journal_resumes")
        except Exception:
            pass
        self.reconciled = left
        self.last_error = None
        return left

    # -- one reconcile tick ---------------------------------------------------
    def tick(self) -> ScaleDecision | None:
        """Decide, then (maybe) converge one step. Returns the decision,
        or None when disabled / the gateway is draining."""
        if not self.enabled:
            return None
        if self.lifecycle is not None and self.lifecycle.state in (
                "draining", "stopped"):
            return None
        self.ticks += 1
        fast, slow = self._inputs()
        spec = maybe_autoscale_fault("decide", n=self.ticks)
        if spec is not None and spec.kind == "flap":
            # synthetic alternating pressure: odd ticks press every out
            # signal, even ticks read dead idle — the policy's cooldowns
            # and hysteresis band are what keep the fleet from thrashing
            press = self.ticks % 2 == 1
            synth = PolicyInputs(replicas=len(self.rs.replicas),
                                 burn=1e9 if press else 0.0,
                                 queue_depth=1e9 if press else 0.0)
            fast = slow = synth
        decision = self.policy.decide(fast, slow)
        self._record(decision)
        if decision.action == "hold":
            self._push_gauges(decision.desired)
            return decision
        # mutual exclusion with rollouts: the SAME lock + flag
        # DeployController runs under, so a scale event and a rollout can
        # never interleave — a blocked decision is counted, not raced
        with self._deploy_lock:
            if self._deploy_status.get("deploying"):
                self.blocked += 1
                try:
                    self.rs.fleet_metrics.count("autoscale_blocked")
                except Exception:
                    pass
                decision = ScaleDecision(
                    "hold", decision.current, decision.current,
                    f"scale-{decision.action} deferred: rollout holds "
                    f"the deploy lock")
                self._record(decision)
                return decision
            prev = self._deploy_status.get("status", "idle")
            self._deploy_status["deploying"] = True
            self._deploy_status["status"] = "autoscaling"
        try:
            if decision.action == "out":
                self._scale_out(decision)
            else:
                self._scale_in(decision)
        finally:
            with self._deploy_lock:
                self._deploy_status["deploying"] = False
                self._deploy_status["status"] = prev
        self._push_gauges(decision.desired)
        return decision

    # -- scale out (surge admission: warm + probe BEFORE routing) -------------
    def _scale_out(self, decision: ScaleDecision) -> bool:
        j = self._journal({"direction": "out", "from": decision.current,
                           "to": decision.desired,
                           "reason": decision.reason})
        eng = None
        try:
            maybe_autoscale_fault("spawn", n=self.scale_events)
            eng = self._spawn()
            eng.start()
            if self.warmup_prompt_lens:
                eng.warmup(self.warmup_prompt_lens)
            self._step(j, {"step": "warmed"})
            self._warm_replay(eng)
            self._probe(eng)
            self._step(j, {"step": "probed"})
        except (FaultInjected, Exception) as e:
            # the surge guarantee: a failed spawn/warm/probe costs the
            # routed fleet NOTHING — the candidate never joined it
            self._retire_failed(eng)
            self.last_error = repr(e)
            self._finish(j, "aborted", error=repr(e))
            return False
        i = self.rs.add_replica(eng)
        if self.supervisor is not None:
            self.supervisor.note_added()
        self._step(j, {"step": "admitted", "slot": i})
        # the crash drill's boundary: admitted but not yet finalized —
        # a gateway killed here reconciles the journal at next start()
        maybe_autoscale_fault("mid_scale", n=1)
        try:
            self.rs.fleet_metrics.count("scale_outs")
        except Exception:
            pass
        self.scale_events += 1
        self.policy.note_scaled("out")
        self.last_error = None
        self._finish(j, "done", slot=i)
        return True

    # -- scale in (drain first; a timed-out drain aborts, never kills) --------
    def _scale_in(self, decision: ScaleDecision) -> bool:
        i = self._pick_victim()
        if i is None:
            self._record(ScaleDecision(
                "hold", decision.current, decision.current,
                "scale-in pressed but no eligible victim (canary / last "
                "decode-capable replica)"))
            return False
        j = self._journal({"direction": "in", "from": decision.current,
                           "to": decision.desired, "slot": i,
                           "reason": decision.reason})
        with self.rs._lock:
            breakers = self.rs.breakers
            eng = self.rs.replicas[i] if i < len(self.rs.replicas) else None
        if eng is None:
            self._finish(j, "aborted", error="victim slot vanished")
            return False
        breakers[i].trip()          # out of routing while it drains
        try:
            drained = self._drain(i)
        except Exception as e:      # injected drain crash: abort the event,
            breakers[i].close()     # keep the replica serving
            self.last_error = repr(e)
            self._finish(j, "aborted", error=repr(e))
            return False
        if not drained:
            breakers[i].close()     # abort: the replica keeps serving
            self.last_error = f"drain of slot {i} timed out"
            self._finish(j, "aborted", error=self.last_error)
            return False
        self._step(j, {"step": "drained", "slot": i})
        removed = self.rs.remove_replica(i)
        if self.supervisor is not None:
            self.supervisor.note_removed(i)
        self._step(j, {"step": "removed", "slot": i})
        maybe_autoscale_fault("mid_scale", n=1)
        try:
            removed.stop()          # in-flight stragglers finish inside
        except Exception:
            pass
        try:
            self.rs.fleet_metrics.count("scale_ins")
        except Exception:
            pass
        self.scale_events += 1
        self.policy.note_scaled("in")
        self.last_error = None
        self._finish(j, "done", slot=i)
        return True

    # -- helpers --------------------------------------------------------------
    def _spawn(self):
        """A NOT-yet-admitted engine: ``spawn_fn`` when injected, else a
        fresh clone of any replica exposing ``clone_fresh`` (a
        :class:`~ddw_tpu_torch.deploy.ProcessReplica` clone inherits its spawn
        transport — remote children scale through the same path)."""
        if self.spawn_fn is not None:
            return self.spawn_fn()
        for eng in list(self.rs.replicas):
            if hasattr(eng, "clone_fresh"):
                return eng.clone_fresh()
        raise RuntimeError("autoscale needs spawn_fn, or a replica "
                           "exposing clone_fresh()")

    @staticmethod
    def _retire_failed(eng) -> None:
        if eng is None:
            return
        try:
            eng.stop()
        except Exception:
            pass

    def _probe(self, eng) -> None:
        """Shadow-verify the candidate end to end before admission —
        the supervisor's readmission discipline, applied pre-admission.
        Engines without a probe surface pass (their warmup already ran
        real device work)."""
        if hasattr(eng, "probe"):
            eng.probe(timeout_s=self.probe_timeout_s)
        elif getattr(eng, "pool", None) is not None and \
                hasattr(eng, "generate"):
            eng.generate([1, 2, 3, 4], 1, timeout_s=self.probe_timeout_s)

    def _warm_replay(self, eng) -> int:
        """Replay the fleet's hot prefixes through the candidate's normal
        prefill path (one-step greedy — bit-identical by construction) so
        it joins holding the hot set. Best effort."""
        if not self.warm_replay_k:
            return 0
        idx = getattr(self.rs, "prefix_index", None)
        if idx is None or not hasattr(eng, "submit_generate"):
            return 0
        n = 0
        for toks in idx.hot(self.warm_replay_k):
            try:
                eng.submit_generate(
                    toks, 1, temperature=0.0,
                    timeout_s=self.probe_timeout_s).result(
                        self.probe_timeout_s)
                n += 1
            except Exception:
                break       # a cold join beats a blocked scale-out
        return n

    def _pick_victim(self) -> int | None:
        """Least-loaded retire candidate: never the canary slot, never the
        last decode-capable replica (a fleet must keep answering decode-
        bearing traffic), ties by index for determinism."""
        with self.rs._lock:
            outs = list(self.rs._outstanding)
            replicas = self.rs.replicas
            can = self.rs._canary
        n = len(replicas)
        if n <= 1:
            return None
        canary_i = can[0] if can is not None else None
        decode = [i for i in range(n)
                  if self.rs._role(replicas[i]) != "prefill"]
        cands = [i for i in range(n)
                 if i != canary_i
                 and not (i in decode and len(decode) <= 1)]
        if not cands:
            return None
        return min(cands, key=lambda i: (outs[i] if i < len(outs) else 0, i))

    def _drain(self, i: int) -> bool:
        """Wait for slot ``i``'s outstanding work to reach zero, bounded by
        ``drain_timeout_s``. The ``stall_drain`` fault wedges inside the
        hook until the deadline's ``should_abort`` fires."""
        deadline = self._clock() + self.drain_timeout_s
        while True:
            maybe_autoscale_fault(
                "drain", should_abort=lambda: self._clock() >= deadline)
            outs = self.rs.outstanding()
            if i >= len(outs) or outs[i] <= 0:
                return True
            if self._clock() >= deadline:
                return False
            time.sleep(0.01)

    def _inputs(self) -> tuple[PolicyInputs, PolicyInputs]:
        n = len(self.rs.replicas)
        burn = 0.0
        if self._slo_status_fn is not None:
            try:
                burn = max_burn(self._slo_status_fn())
            except Exception:
                burn = 0.0
        merged: dict = {}
        if self._merged_fn is not None:
            try:
                merged = self._merged_fn() or {}
            except Exception:
                merged = {}
        return (inputs_from_windows(merged, "10s", n, burn=burn),
                inputs_from_windows(merged, "60s", n, burn=burn))

    def _record(self, decision: ScaleDecision) -> None:
        self.last_decision = {
            "action": decision.action, "desired": decision.desired,
            "current": decision.current, "reason": decision.reason,
            "cooldown_remaining_s": round(decision.cooldown_remaining_s, 3),
            "tick": self.ticks, "t": time.time()}

    def _push_gauges(self, desired: int) -> None:
        """desired vs actual, pushed as fleet gauges (they render as
        ``serve.desired_replicas`` / ``serve.fleet_size`` in the snapshot
        and as ``ddw_serve_*`` in the Prometheus exposition)."""
        fm = self.rs.fleet_metrics
        try:
            g = fm.gauges_view()
            g["desired_replicas"] = float(desired)
            g["fleet_size"] = float(len(self.rs.replicas))
            fm.set_gauges(g)
        except Exception:
            pass        # fakes without the gauge surface still scale

    # -- journal plumbing (fsync discipline shared with deploys) --------------
    def _journal(self, meta: dict) -> RolloutJournal | None:
        if not self.journal_dir:
            return None
        j = RolloutJournal(self.journal_dir)
        j.begin({"kind": "autoscale", **meta})
        return j

    @staticmethod
    def _step(j: RolloutJournal | None, row: dict) -> None:
        if j is not None:
            j.record_step(row)

    @staticmethod
    def _finish(j: RolloutJournal | None, status: str, **note) -> None:
        if j is None:
            return
        if note:
            j.note(**note)
        j.finish(status)
