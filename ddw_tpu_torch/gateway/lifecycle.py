"""Serving lifecycle — readiness gating and graceful drain (the port of
``ddw_tpu.gateway.lifecycle``).

A serving process has exactly four states a load balancer cares about, and
the transitions between them are where requests get dropped if nobody owns
them. This module owns them:

::

    STARTING ──warmup done──► READY ──SIGTERM/drain()──► DRAINING ──► STOPPED
       │                        │                           │
    /healthz 200            /readyz 200                /readyz 503
    /readyz 503             admit requests             refuse new (503),
                                                       finish in-flight

- **readiness is gated on warmup**: the HTTP listener comes up first (so
  ``/healthz`` answers and orchestrators don't kill a compiling process),
  but ``/readyz`` stays 503 and requests are refused until every replica's
  program lattice has run once — no live request ever pays first-call cost
  behind a load balancer that believed the pod was ready.
- **drain is the serving half of preemption**: the same SIGTERM contract
  the runtime layer gives training gangs (``Launcher.preempt_grace_s``
  forwards the signal and allows a grace window to checkpoint —
  docs/fault_tolerance.md) applies to serving: stop admission immediately
  (new requests see 503 + ``Retry-After`` so the balancer respills them),
  let in-flight slots run to completion within the grace window, then stop
  the engines. :func:`runtime_grace_s` reads the grace window from
  :class:`~ddw_tpu_torch.runtime.launcher.Launcher`'s ``preempt_grace_s``
  default, so the two drains share one number by construction.

The in-flight ledger is a plain counted critical section
(:meth:`ServerLifecycle.try_begin_request` / :meth:`end_request`) held for
the WHOLE response — including the chunked streaming tail — so
``await_drained`` returning True means every byte of every admitted
response has been written, not merely that the engines went idle.
"""

from __future__ import annotations

import inspect
import signal
import threading

__all__ = ["ServerLifecycle", "runtime_grace_s", "STARTING", "READY",
           "DRAINING", "STOPPED"]

STARTING = "starting"
READY = "ready"
DRAINING = "draining"
STOPPED = "stopped"


def runtime_grace_s() -> float:
    """The runtime layer's preemption grace window
    (``Launcher.preempt_grace_s`` default) — read from the signature so the
    serving drain and the training-gang drain share one number by
    construction."""
    from ddw_tpu_torch.runtime.launcher import Launcher

    return float(inspect.signature(Launcher.__init__)
                 .parameters["preempt_grace_s"].default)


class ServerLifecycle:
    """State machine + in-flight request ledger for one serving process.

    ``health_fn`` (optional, set by the gateway) reports fleet degradation
    *within* READY: a process whose replicas are partially dead is still
    ready — it serves on the survivors — but a load balancer weighing
    backends and an operator reading ``/readyz`` both want the distinction,
    so :meth:`readiness` carries it alongside the FSM state. The same
    principle as warmup gating: readiness tells the truth about what is
    behind the socket."""

    def __init__(self, grace_s: float | None = None):
        self.grace_s = runtime_grace_s() if grace_s is None else grace_s
        self._cv = threading.Condition()
        self._state = STARTING
        self._inflight = 0
        self._prev_sigterm = None
        self.health_fn = None       # () -> list[per-replica health dicts]

    # -- state ---------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._cv:
            return self._state

    @property
    def is_ready(self) -> bool:
        return self.state == READY

    def readiness(self) -> tuple[bool, dict]:
        """The /readyz truth: (ready, body). Ready as long as the process
        is READY and at least one replica can take traffic; the body names
        the degradation (replicas up / total) so a fleet running on
        survivors is visible without scraping /metrics."""
        state = self.state
        body: dict = {"status": "ready" if state == READY else state}
        if self.health_fn is None:
            return state == READY, body
        try:
            health = self.health_fn()
        except Exception:
            return state == READY, body
        up = sum(1 for h in health
                 if h.get("state") in ("alive", "degraded"))
        body["replicas_up"] = up
        body["replicas"] = len(health)
        if up < len(health):
            body["degraded"] = True
        if state == READY and health and up == 0:
            # every replica is dead: admitting traffic would only shed —
            # tell the balancer to send it elsewhere until one rejoins
            body["status"] = "no_replicas"
            return False, body
        return state == READY, body

    def mark_ready(self) -> None:
        with self._cv:
            if self._state == STARTING:
                self._state = READY

    def begin_drain(self) -> bool:
        """Stop admission. Returns False if drain already began."""
        with self._cv:
            if self._state in (DRAINING, STOPPED):
                return False
            self._state = DRAINING
            self._cv.notify_all()
            return True

    def mark_stopped(self) -> None:
        with self._cv:
            self._state = STOPPED
            self._cv.notify_all()

    # -- in-flight ledger ----------------------------------------------------
    def try_begin_request(self) -> bool:
        """Admit one request into the in-flight ledger; False means refuse
        (not ready yet, or draining) — the caller answers 503."""
        with self._cv:
            if self._state != READY:
                return False
            self._inflight += 1
            return True

    def end_request(self) -> None:
        with self._cv:
            self._inflight -= 1
            if self._inflight == 0:
                self._cv.notify_all()

    @property
    def inflight(self) -> int:
        with self._cv:
            return self._inflight

    def await_drained(self, timeout_s: float | None = None) -> bool:
        """Block until every admitted response has fully written (the
        ledger hits zero) or the grace window runs out. True = clean."""
        deadline = timeout_s if timeout_s is not None else self.grace_s
        with self._cv:
            return self._cv.wait_for(lambda: self._inflight == 0,
                                     timeout=deadline)

    # -- SIGTERM wiring ------------------------------------------------------
    def install_sigterm(self, drain_fn) -> None:
        """Route SIGTERM to ``drain_fn`` (run on a fresh thread — signal
        handlers must not block, and the drain waits out the grace window).
        Main-thread only, like every signal.signal call; the previous
        handler is kept for :meth:`restore_sigterm`."""
        def _handler(_sig, _frame):
            threading.Thread(target=drain_fn, name="ddw-gateway-drain",
                             daemon=True).start()

        self._prev_sigterm = signal.signal(signal.SIGTERM, _handler)

    def restore_sigterm(self) -> None:
        """Best-effort: a drain triggered BY the signal runs off the main
        thread, where re-installing handlers is forbidden — keep the saved
        handler so a main-thread caller (test teardown) can retry."""
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                return               # not the main thread; handler kept
            self._prev_sigterm = None
