"""Admission control — the port of ``ddw_tpu.serve.admission`` (pure host
logic, copied): bounded queues, deadlines, structured load shedding.

An online engine under overload has exactly three honest options: queue
(bounded — an unbounded queue converts overload into unbounded latency),
refuse at the door (backpressure the caller can act on), or shed work whose
deadline already passed (device time spent on an answer nobody is waiting
for is stolen from requests that could still make their SLO). This module
implements all three as data, not policy buried in the engine loop:

- :class:`AdmissionController` holds one bounded FIFO per request kind;
  ``offer`` refuses with a structured :class:`Overloaded` (capacity, depth,
  ``retry_after_ms``) the moment the queue is full — submission never
  blocks and never hangs;
- every queued request carries an absolute ``deadline``; ``take`` pops in
  arrival order but splits expired requests out BEFORE any device work is
  spent on them, so the engine completes them with
  :class:`DeadlineExceeded` instead of prefilling a corpse.

Both reply types are exceptions (a future can carry them) AND structured
records (``to_dict``) so a transport layer can serialize the reply without
parsing message strings — the same discipline as
``ddw_tpu``'s ``runtime.launcher.GangError``.
"""

from __future__ import annotations

import collections
import threading
import time


class Rejected(RuntimeError):
    """Base of the structured serving refusals."""

    def to_dict(self) -> dict:
        raise NotImplementedError


class Overloaded(Rejected):
    """Queue full at submission time — backpressure, not a hang. Carries
    what a client-side retry policy needs: the configured capacity, the
    depth observed, and a crude ``retry_after_ms`` hint (current depth times
    the recent per-request service estimate, when known)."""

    def __init__(self, kind: str, capacity: int, depth: int,
                 retry_after_ms: float | None = None):
        self.kind = kind
        self.capacity = capacity
        self.depth = depth
        self.retry_after_ms = retry_after_ms
        hint = (f"; retry in ~{retry_after_ms:.0f} ms"
                if retry_after_ms else "")
        super().__init__(
            f"{kind} queue full ({depth}/{capacity}); request refused{hint}")

    def to_dict(self) -> dict:
        return {"error": "overloaded", "kind": self.kind,
                "capacity": self.capacity, "depth": self.depth,
                "retry_after_ms": self.retry_after_ms}


class ReplicaFailed(Rejected):
    """The replica holding this request died (engine loop crash, stall, or
    error budget exhausted) before the request completed. Structured à la
    ``ddw_tpu``'s ``GangFailure``: what killed the
    replica (``kind``), which replica/generation, where the request was in
    its lifecycle (``phase``: queued / in_slot / submitted), how many tokens
    it had already emitted, and the replica's forensic record (traceback,
    consecutive errors, last-tick age). Queued requests with nothing emitted
    are failover candidates — a gateway's ``ReplicaSet``
    resubmits them to a sibling instead of surfacing this; everything else
    maps to 503 + ``Retry-After`` at the gateway (a sibling or a restarted
    replica may serve the retry)."""

    def __init__(self, kind: str, replica: int = 0, generation: int = 0,
                 phase: str = "submitted", emitted: int = 0,
                 forensics: dict | None = None):
        self.kind = kind
        self.replica = replica
        self.generation = generation
        self.phase = phase
        self.emitted = emitted
        self.forensics = dict(forensics or {})
        super().__init__(
            f"replica {replica} (gen {generation}) failed: {kind}; request "
            f"was {phase} with {emitted} token(s) emitted")

    def to_dict(self) -> dict:
        return {"error": "replica_failed", "kind": self.kind,
                "replica": self.replica, "generation": self.generation,
                "phase": self.phase, "emitted": self.emitted,
                "forensics": self.forensics}


class Unavailable(Rejected):
    """No replica can take this request right now — every circuit is open
    (fleet-wide failure or restarts in flight). Unlike :class:`Overloaded`
    this is not backpressure from a live queue but absence of a server;
    the gateway maps it to 503 + ``Retry-After`` so a balancer respills and
    a client retries once the supervisor readmits a replica."""

    def __init__(self, reason: str, retry_after_ms: float | None = None):
        self.reason = reason
        self.retry_after_ms = retry_after_ms
        hint = (f"; retry in ~{retry_after_ms:.0f} ms"
                if retry_after_ms else "")
        super().__init__(f"no replica available ({reason}){hint}")

    def to_dict(self) -> dict:
        return {"error": "unavailable", "reason": self.reason,
                "retry_after_ms": self.retry_after_ms}


class DeadlineExceeded(Rejected):
    """The request's deadline passed while it was still queued — shed
    before any device work was spent on it."""

    def __init__(self, kind: str, waited_ms: float, timeout_ms: float):
        self.kind = kind
        self.waited_ms = waited_ms
        self.timeout_ms = timeout_ms
        super().__init__(f"{kind} request shed after {waited_ms:.0f} ms in "
                         f"queue (deadline {timeout_ms:.0f} ms)")

    def to_dict(self) -> dict:
        return {"error": "deadline_exceeded", "kind": self.kind,
                "waited_ms": self.waited_ms, "timeout_ms": self.timeout_ms}


class AdmissionController:
    """Bounded per-kind FIFOs with deadline-aware dequeue. Thread-safe:
    callers submit from any thread; the engine loop drains from one."""

    def __init__(self, capacity: int, clock=time.monotonic,
                 per_kind: dict[str, int] | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        for k, c in (per_kind or {}).items():
            if c < 1:
                raise ValueError(
                    f"per-kind capacity must be >= 1, got {k}={c}")
        self.capacity = capacity
        self.per_kind = dict(per_kind or {})  # kind -> capacity override
        #                      (the batch lane queues deeper than the
        #                      interactive default — backlog is its job)
        self._clock = clock
        self._queues: dict[str, collections.deque] = {}
        self._lock = threading.Lock()

    def capacity_for(self, kind: str) -> int:
        return self.per_kind.get(kind, self.capacity)

    def depth(self, kind: str | None = None) -> int:
        with self._lock:
            if kind is not None:
                return len(self._queues.get(kind, ()))
            return sum(len(q) for q in self._queues.values())

    def oldest_wait_s(self, kind: str) -> float | None:
        """How long the head-of-line request has been queued (None when
        empty) — the dynamic batcher's flush trigger."""
        with self._lock:
            q = self._queues.get(kind)
            if not q:
                return None
            return self._clock() - q[0].times.submitted

    def peek(self, kind: str):
        """The head-of-line request without dequeuing it (None when
        empty) — the paged engine's admission loop inspects the head's
        block budget before committing to pop it."""
        with self._lock:
            q = self._queues.get(kind)
            return q[0] if q else None

    def count_claimed(self, kind: str) -> int:
        """Queued requests whose future already transitioned to RUNNING —
        preempted streams waiting to re-admit. They are in-flight work,
        not fresh load: a drain is not complete while any remain."""
        with self._lock:
            q = self._queues.get(kind)
            if not q:
                return 0
            return sum(1 for r in q if getattr(r, "claimed", False))

    def requeue_front(self, kind: str, request) -> None:
        """Put a request back at the HEAD of its queue, bypassing the
        capacity bound — the preemption path (a stream evicted mid-decode
        for blocks was already admitted once; bouncing it off a full door
        would turn backpressure into data loss). Oldest-first order is
        preserved: the preempted request re-admits before anything that
        arrived after it."""
        with self._lock:
            self._queues.setdefault(
                kind, collections.deque()).appendleft(request)

    def offer(self, kind: str, request,
              retry_after_ms: float | None = None) -> None:
        """Enqueue or raise :class:`Overloaded`. The capacity bound is
        per-kind (an LM burst must not starve image admission)."""
        with self._lock:
            q = self._queues.setdefault(kind, collections.deque())
            cap = self.per_kind.get(kind, self.capacity)
            if len(q) >= cap:
                raise Overloaded(kind, cap, len(q), retry_after_ms)
            q.append(request)

    def take(self, kind: str, max_n: int) -> tuple[list, list]:
        """Pop up to ``max_n`` live requests in arrival order. Returns
        ``(admitted, expired)`` — expired requests (deadline already past)
        do not count against ``max_n`` and must be completed with
        :class:`DeadlineExceeded` by the caller, never run."""
        admitted, expired = [], []
        now = self._clock()
        with self._lock:
            q = self._queues.get(kind)
            while q and len(admitted) < max_n:
                req = q.popleft()
                if req.deadline is not None and now > req.deadline:
                    expired.append(req)
                else:
                    admitted.append(req)
        return admitted, expired

    def shed_expired(self, kind: str) -> list:
        """Remove every already-expired request from the queue (in place,
        order preserved for the rest)."""
        now = self._clock()
        expired = []
        with self._lock:
            q = self._queues.get(kind)
            if q:
                live = [r for r in q
                        if not (r.deadline is not None and now > r.deadline)]
                expired = [r for r in q
                           if r.deadline is not None and now > r.deadline]
                q.clear()
                q.extend(live)
        return expired
