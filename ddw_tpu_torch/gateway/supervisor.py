"""ReplicaSupervisor — bounded auto-restart over a serving replica fleet.

The :class:`~ddw_tpu_torch.gateway.ReplicaSet` is the *containment* half of
serving fault tolerance: a dead replica's circuit opens, its queued work
fails over to siblings, and routing walks around the corpse. This module is
the *recovery* half, the serving analog of
:class:`~ddw_tpu_torch.runtime.supervisor.GangSupervisor` — same discipline,
different failure geometry (threads in one process, restart one replica,
keep serving on the rest):

- a monitor thread watches every replica's :meth:`~ddw_tpu_torch.serve.
  ServingEngine.health` — woken immediately by the set's ``failure_event``,
  polling otherwise — and classifies two conditions: **failed** (the engine
  reported terminal death: crash, stall-abort, error-budget exhaustion) and
  **stalled** (the loop heartbeat's ``last_tick_age_s`` exceeded
  ``stall_timeout_s`` — a wedged device op or an injected
  ``DDW_FAULT=serve:stall``; the supervisor declares it dead via
  ``force_fail``, which also fails its futures so no client hangs);
- recovery is **bounded restart with backoff + jitter**, mirroring the gang
  supervisor's budgets: up to ``max_restarts`` per replica, delay
  ``backoff_base_s * 2**(n-1)`` capped at ``backoff_max_s`` plus uniform
  jitter (decorrelates a fleet-wide event from stampeding the device). A
  replica over budget stays dark — its circuit stays open, the fleet keeps
  serving degraded, and the per-attempt forensics are kept;
- the **rejoin is warmup-gated** through the same discipline as
  :class:`~ddw_tpu_torch.gateway.ServerLifecycle` readiness: the restarted engine
  re-compiles nothing in place (:meth:`~ddw_tpu_torch.serve.ServingEngine.
  restart` keeps program caches) but is still driven through
  ``warmup(prompt_lens)`` before its breaker half-opens — no live request
  pays a cold path behind a circuit that claimed the replica was back. A
  thread wedged in real device work cannot be joined; that replica is
  **replaced** (``clone_fresh`` + ``ReplicaSet.replace``) and the
  replacement pays its compile inside the warmup gate, not on traffic;
- the rejoin is also **cache-warmed**: before the shadow probe, the fleet
  prefix index's top-K hot prefixes (:meth:`~ddw_tpu_torch.gateway.
  prefix_index.PrefixIndex.hot`) are replayed through the restarted
  replica's normal prefill path — one-step greedy generates, bit-identical
  by construction, no KV shipping — so a recycled or hot-swapped replica
  rejoins holding the fleet's hot set instead of re-prefilling it on live
  traffic (``warm_replay_k`` sizes the replay; 0 disables).

Per-attempt records (:class:`ReplicaAttempt`) mirror ``AttemptReport``:
which replica, which generation, what killed it, how recovery went —
queryable via :meth:`ReplicaSupervisor.report` and surfaced through the
gateway's ``/stats``.

The port of ``ddw_tpu.gateway.supervisor``: the same host logic,
importing nothing of ``ddw_tpu``.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

__all__ = ["ReplicaSupervisor", "ReplicaAttempt"]


@dataclasses.dataclass
class ReplicaAttempt:
    """One observed replica death + the recovery attempted for it."""

    replica: int
    generation: int
    kind: str                   # crash | stalled | errors | error | degraded
    action: str                 # restarted | replaced | drained_restarted
    #                             | drain_timeout | budget_exhausted
    elapsed_s: float            # detection -> serving again (0 if not)
    forensics: dict
    readmit: str = ""           # probed_closed | probe_failed | half_open
    #                             (how the replica re-entered routing)

    def __str__(self) -> str:
        via = f" [{self.readmit}]" if self.readmit else ""
        return (f"replica {self.replica} gen {self.generation}: "
                f"{self.kind} -> {self.action}{via} "
                f"({self.elapsed_s:.2f}s)")


class ReplicaSupervisor:
    """Watch a :class:`~ddw_tpu_torch.gateway.ReplicaSet`, restart dead replicas
    within budget, and gate their rejoin on warmup.

    ``lifecycle`` (a :class:`~ddw_tpu_torch.gateway.ServerLifecycle`) scopes the
    supervisor to the serving process's own state machine: once the process
    is draining or stopped, dead replicas stay dead — restarting an engine
    the drain is about to stop would race it back to life.
    """

    def __init__(self, replica_set, max_restarts: int = 2,
                 backoff_base_s: float = 0.25, backoff_max_s: float = 30.0,
                 jitter: float = 0.25, stall_timeout_s: float = 30.0,
                 poll_interval_s: float = 0.25,
                 warmup_prompt_lens=(8,), lifecycle=None,
                 shadow_probe: bool = True, probe_timeout_s: float = 30.0,
                 recycle_degraded_after_s: float | None = None,
                 drain_timeout_s: float = 30.0,
                 warm_replay_k: int = 8):
        self.rs = replica_set
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.jitter = jitter
        self.stall_timeout_s = stall_timeout_s
        self.poll_interval_s = poll_interval_s
        self.warmup_prompt_lens = tuple(warmup_prompt_lens or ())
        self.lifecycle = lifecycle
        # Shadow probing (docs/serving.md): a replica rejoining behind an
        # open circuit is verified with a supervisor-issued warmup request
        # straight against the engine — success CLOSES the circuit, so no
        # live client request is ever spent as the half-open guinea pig.
        # Engines without a probe surface fall back to the half-open gate.
        self.shadow_probe = shadow_probe
        self.probe_timeout_s = probe_timeout_s
        # Graceful recycle: a replica continuously degraded for this long is
        # drained (in-slot requests run to completion, queue preserved) and
        # restarted in place, instead of waiting for its error budget to
        # fail it the hard way. None = only explicit recycle() calls.
        self.recycle_degraded_after_s = recycle_degraded_after_s
        self.drain_timeout_s = drain_timeout_s
        # Warm replay: how many of the fleet's hottest prefixes a restarted
        # replica replays (through its normal prefill) before readmission.
        self.warm_replay_k = warm_replay_k
        self.probes = 0             # shadow probes issued (telemetry)
        self.attempts: list[ReplicaAttempt] = []
        self._next_attempt_at = [0.0] * len(replica_set.replicas)
        self._degraded_since = [None] * len(replica_set.replicas)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ReplicaSupervisor":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="ddw-replica-supervisor", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.rs.failure_event.set()     # unblock the wait
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def __enter__(self) -> "ReplicaSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def report(self) -> dict:
        """The forensic record: restart counts per replica + every attempt
        (the GangFailure-style story, queryable instead of buried in
        logs)."""
        with self._lock:
            return {"max_restarts": self.max_restarts,
                    "restarts": list(self.rs.restarts),
                    "shadow_probes": self.probes,
                    "attempts": [dataclasses.asdict(a)
                                 for a in self.attempts]}

    # -- elastic membership (the autoscaler's bookkeeping hooks) -------------
    def note_added(self) -> None:
        """A slot was appended to the fleet (autoscale scale-out): grow the
        per-slot recovery state in step."""
        with self._lock:
            self._next_attempt_at.append(0.0)
            self._degraded_since.append(None)

    def note_removed(self, i: int) -> None:
        """Slot ``i`` was retired (scale-in): drop its recovery state — the
        slots above renumber exactly as ``ReplicaSet.remove_replica`` did,
        and their backoff clocks travel with them."""
        with self._lock:
            if 0 <= i < len(self._next_attempt_at):
                self._next_attempt_at.pop(i)
                self._degraded_since.pop(i)

    # -- monitor loop --------------------------------------------------------
    def _draining(self) -> bool:
        return (self.lifecycle is not None
                and self.lifecycle.state in ("draining", "stopped"))

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.rs.failure_event.wait(timeout=self.poll_interval_s)
            self.rs.failure_event.clear()
            if self._stop.is_set() or self._draining():
                continue
            now = time.monotonic()
            for i, eng in enumerate(list(self.rs.replicas)):
                try:
                    if not hasattr(eng, "health"):
                        continue
                    while i >= len(self._next_attempt_at):
                        self.note_added()   # fleet grew under the monitor
                    h = eng.health()
                    if (h["state"] in ("alive", "degraded") and h["running"]
                            and h["last_tick_age_s"] > self.stall_timeout_s):
                        # the loop's heartbeat went stale: declare it dead
                        # so its futures resolve and its circuit opens; the
                        # restart below reclaims (or replaces) the thread
                        eng.force_fail("stalled")
                        h = eng.health()
                    if (h["state"] == "failed"
                            and now >= self._next_attempt_at[i]):
                        self._recover(i, eng)
                        continue
                    # degraded-too-long: graceful recycle BEFORE the error
                    # budget fails it the hard way — in-slot work completes
                    # instead of being failed over
                    if (self.recycle_degraded_after_s is not None
                            and h["state"] == "degraded" and h["running"]):
                        if self._degraded_since[i] is None:
                            self._degraded_since[i] = now
                        elif (now - self._degraded_since[i]
                                >= self.recycle_degraded_after_s
                                and now >= self._next_attempt_at[i]):
                            self.recycle(i)
                            self._degraded_since[i] = None
                    else:
                        self._degraded_since[i] = None
                except Exception:
                    continue    # a monitor bug must never kill the monitor

    def _recover(self, i: int, eng) -> None:
        n_prior = self.rs.restarts[i]
        failure = getattr(eng, "failure", None)
        kind = failure.kind if failure is not None else "error"
        forensics = dict(failure.forensics) if failure is not None else {}
        gen = getattr(eng, "generation", 0)
        if n_prior >= self.max_restarts:
            with self._lock:
                if not any(a.replica == i and a.action == "budget_exhausted"
                           for a in self.attempts):
                    self.attempts.append(ReplicaAttempt(
                        replica=i, generation=gen, kind=kind,
                        action="budget_exhausted", elapsed_s=0.0,
                        forensics=forensics))
            return                  # stays dark; circuit stays open
        t0 = time.monotonic()
        action = "restarted"
        try:
            try:
                eng.restart()
            except RuntimeError:
                # thread wedged in device work — abandon it, swap in a
                # fresh engine over the same handles (compiles inside the
                # warmup gate below, not on live traffic)
                eng = eng.clone_fresh()
                self.rs.replace(i, eng)
                eng.start()
                action = "replaced"
            if self.warmup_prompt_lens:
                eng.warmup(self.warmup_prompt_lens)
        except Exception as e:      # the restart itself died: try again
            self._next_attempt_at[i] = time.monotonic() + self._backoff(
                n_prior + 1)
            self.rs.note_restart(i)
            with self._lock:
                self.attempts.append(ReplicaAttempt(
                    replica=i, generation=gen, kind=kind,
                    action=f"restart_failed: {e!r}"[:200], elapsed_s=0.0,
                    forensics=forensics))
            self.rs.failure_event.set()
            return
        self.rs.note_restart(i)
        self._next_attempt_at[i] = time.monotonic() + self._backoff(
            n_prior + 1)
        # Record the attempt BEFORE the (blocking) shadow probe, then fill
        # in how the replica re-entered routing once the probe resolves —
        # the restart is a fact the moment the engine is serving again.
        att = ReplicaAttempt(
            replica=i, generation=getattr(eng, "generation", gen),
            kind=kind, action=action, elapsed_s=time.monotonic() - t0,
            forensics=forensics)
        with self._lock:
            self.attempts.append(att)
        self._warm_replay(i, eng)
        att.readmit = self._readmit(i, eng)     # warmed: probe, then admit

    # -- warm replay: rejoin holding the fleet's hot prefixes -----------------
    def _warm_replay(self, i: int, eng) -> int:
        """Replay the fleet prefix index's top-K hot prefixes through a
        restarted replica's NORMAL prefill path (one-step greedy generates
        — bit-identical by construction, no KV shipping) so it rejoins
        holding the fleet's hot set instead of re-prefilling it on live
        traffic. Runs behind the still-open circuit, before the shadow
        probe. Best effort: a failed replay leaves the replica cold,
        never dark."""
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
                break       # a cold rejoin beats blocking recovery
        if n:
            try:
                eng.metrics.count("warm_replays", n)
            except Exception:
                pass        # fakes without metrics still recycle
        return n

    # -- rejoin gate: shadow probe > live half-open probe ---------------------
    def _readmit(self, i: int, eng) -> str:
        """Bring a warmed replica back into routing. With shadow probing a
        supervisor-issued request (never a client's) verifies the replica
        end to end: success closes the circuit outright; failure re-trips
        it and the next backoff window applies. Engines without a probe
        surface keep the classic half-open single-live-probe gate."""
        probe = None
        if self.shadow_probe:
            if hasattr(eng, "probe"):
                # an explicit probe surface (process replicas: one real
                # request through the child's own HTTP door) beats guessing
                # from engine internals
                probe = lambda: eng.probe(  # noqa: E731
                    timeout_s=self.probe_timeout_s)
            elif getattr(eng, "pool", None) is not None and \
                    hasattr(eng, "generate"):
                probe = lambda: eng.generate(  # noqa: E731
                    [1, 2, 3, 4], 1, timeout_s=self.probe_timeout_s)
            elif getattr(eng, "_image", None) is not None and \
                    hasattr(eng, "submit_predict"):
                import numpy as _np

                h = eng._image
                probe = lambda: eng.submit_predict(  # noqa: E731
                    _np.zeros((h.height, h.width, 3), _np.float32),
                    timeout_s=self.probe_timeout_s).result(
                        self.probe_timeout_s)
        if probe is None:
            self.rs.breakers[i].half_open()
            return "half_open"
        self.probes += 1
        try:
            probe()
        except Exception:
            self.rs.breakers[i].trip()
            self.rs.failure_event.set()     # revisit after backoff
            return "probe_failed"
        self.rs.breakers[i].close()
        return "probed_closed"

    # -- graceful recycle (drain-then-restart; never fails in-slot work) -----
    def recycle(self, i: int, kind: str = "degraded") -> bool:
        """Drain replica ``i``'s in-slot requests to completion, restart it
        in place (queued work preserved, served by the next generation),
        re-warm, shadow-probe, and readmit. The operator-facing building
        block for rolling restarts / weight hot-swap (the
        :class:`~ddw_tpu_torch.deploy.DeployController` calls this with
        ``kind="deploy"`` after staging a checkpoint swap), and the
        automatic path for degraded-too-long replicas. Falls back to
        ``force_fail`` (today's hard path — futures failed over) when the
        drain times out. Returns True on a clean recycle."""
        eng = self.rs.replicas[i]
        if not hasattr(eng, "recycle"):
            return False
        t0 = time.monotonic()
        gen = getattr(eng, "generation", 0)
        # stop routing new work at it while it drains (honest refusals at
        # the engine door would spill anyway; the open circuit is cheaper)
        self.rs.breakers[i].trip()
        ok = False
        try:
            ok = eng.recycle(drain_timeout_s=self.drain_timeout_s)
        except Exception:
            ok = False
        if not ok:
            with self._lock:
                self.attempts.append(ReplicaAttempt(
                    replica=i, generation=gen, kind=kind,
                    action="drain_timeout", elapsed_s=time.monotonic() - t0,
                    forensics={}))
            try:
                eng.force_fail("stalled")   # escalate: the hard path
            except Exception:
                pass
            self.rs.failure_event.set()
            return False
        try:
            if self.warmup_prompt_lens:
                eng.warmup(self.warmup_prompt_lens)
        except Exception:
            pass
        self.rs.note_restart(i)
        self._next_attempt_at[i] = time.monotonic() + self._backoff(1)
        att = ReplicaAttempt(
            replica=i, generation=getattr(eng, "generation", gen),
            kind=kind, action="drained_restarted",
            elapsed_s=time.monotonic() - t0, forensics={})
        with self._lock:
            self.attempts.append(att)
        self._warm_replay(i, eng)
        att.readmit = self._readmit(i, eng)
        return True

    # -- surge swap (spawn-before-drain; capacity never dips) -----------------
    def surge_swap(self, i: int, new_eng) -> bool:
        """Swap ``new_eng`` (already started AND warmed by the caller — its
        compile happened off-traffic) into slot ``i`` and retire the old
        engine by draining it: :meth:`~ddw_tpu_torch.gateway.ReplicaSet.replace`
        is the atomic cutover, so the slot serves continuously and fleet
        capacity never dips below N; the old generation's ``stop()`` lets
        in-flight work run to completion before the process exits (the
        Horovod-elastic membership-change framing: grow first, shrink
        after). The building block :class:`~ddw_tpu_torch.deploy.
        DeployController` uses per replica with ``strategy="surge"``.
        Returns False (old engine force-failed, swap still landed) only if
        the retire path raised."""
        old = self.rs.replicas[i]
        gen = getattr(new_eng, "generation", 0)
        t0 = time.monotonic()
        self.rs.replace(i, new_eng)
        ok = True
        try:
            old.stop()          # SIGTERM path: drains in-flight, then exits
        except Exception:
            ok = False
            try:
                old.force_fail("surge_retire")
            except Exception:
                pass
        self.rs.note_restart(i)
        with self._lock:
            self.attempts.append(ReplicaAttempt(
                replica=i, generation=gen, kind="deploy",
                action="surged" if ok else "surge_retire_failed",
                elapsed_s=time.monotonic() - t0, forensics={}))
        return ok

    def _backoff(self, nth_restart: int) -> float:
        delay = min(self.backoff_max_s,
                    self.backoff_base_s * (2 ** max(0, nth_restart - 1)))
        return delay + random.uniform(0.0, self.jitter * delay)
