"""ReplicaSet — one front door over N serving-engine replicas.

A single :class:`~ddw_tpu_torch.serve.ServingEngine` is bounded by its slot pool:
``n_slots`` sequences decode per dispatch and everyone else queues. The
fleet answer is horizontal — more engine replicas, each with its own
compiled programs and KV pool — and this class is the piece that makes N
replicas look like one engine to the transport layer above it:

- **routing is admission-aware and cache-aware**: every submission goes to
  the replica with the lowest projected wait — queue depth + busy slots
  weighted by the engine's own decaying per-request service estimate
  (``ServingEngine.load()``), falling back to the outstanding-futures
  count for replicas that don't expose load. Generate submissions also
  credit expected prefill savings: the fleet prefix index
  (:class:`~ddw_tpu_torch.gateway.prefix_index.PrefixIndex`) reports each
  replica's longest cached prefix of the prompt, and matched tokens x that
  replica's per-prefilled-token EWMA are subtracted from its projected
  wait — requests chase their warm prefix only while the holder's queue
  stays cheaper than a cold prefill elsewhere. Routing never changes
  results, only placement: every replica computes bit-identical tokens.
  Outstanding counts are kept here, incremented at submit and decremented
  by a future done-callback, so routing needs no cross-thread peeking
  into engine internals;
- **roles disaggregate prefill from decode**: a replica advertising
  ``role="prefill"`` never takes decode-bearing traffic directly. A
  generate submission against a mixed fleet is split instead: the
  TTFT-aware splitter prefills on the replica whose prefix credit +
  projected wait is lowest, exports the prompt's KV blocks over the
  versioned wire (:meth:`~ddw_tpu_torch.serve.blocks.BlockPool.export_blocks`),
  imports them into the decode replica chosen by projected wait +
  block-pool headroom, and submits the full request there — the prefix
  index doubles as the transfer directory, so blocks the receiver already
  holds warm never cross the wire. Any handoff failure falls back to
  colocated routing on a decode-capable replica; clients never see a
  migration error;
- **every replica sits behind a circuit breaker**
  (:class:`CircuitBreaker`): consecutive :class:`~ddw_tpu_torch.serve.admission.
  ReplicaFailed` outcomes — or the engine's own death report — open the
  circuit and routing skips the replica entirely; after a cooldown (or the
  supervisor's explicit warmed-rejoin gate) ONE half-open probe request is
  admitted, and its outcome closes or re-opens the circuit. When every
  circuit is open the set refuses with a structured
  :class:`~ddw_tpu_torch.serve.admission.Unavailable` (503 + ``Retry-After`` at
  the gateway) — never a hang;
- **backpressure spills sideways once**: a submission refused with
  :class:`~ddw_tpu_torch.serve.Overloaded` by the best replica is retried on the
  next candidate before the refusal surfaces. A dead replica
  (``ReplicaFailed`` at submit) does NOT consume that budget — routing
  walks past corpses to any live sibling;
- **failover adopts a dead replica's queue**: when an engine dies it hands
  its queued, nothing-emitted requests to :meth:`_on_replica_failure` (the
  engine's ``on_failure`` hook); each is resubmitted to a healthy sibling
  *with its original future intact* when its deadline (and the sibling's
  projected wait) allows, else completed with the structured refusal —
  callers see tokens or a clean 503/504, never a hang. Requests that had
  already streamed tokens fail with ``ReplicaFailed`` (re-running them
  would duplicate the stream; the client's retry policy owns that call);
- **metrics aggregate** (:func:`ddw_tpu_torch.serve.metrics.merge_metrics`):
  ``snapshot()`` and ``prometheus()`` reduce over every replica's records,
  with per-replica outstanding/circuit/restart gauges alongside.

The submission surface mirrors the engine (``submit_generate`` /
``submit_predict`` / ``warmup`` / ``start`` / ``stop`` / context manager),
so anything written against one engine — the HTTP gateway, the load
generator, the tests — serves a fleet by swapping the object. Restarting
dead replicas is not this class's job: :class:`~ddw_tpu_torch.gateway.supervisor.
ReplicaSupervisor` watches the same health surface and owns recovery.

The port of ``ddw_tpu.gateway.replica``: the same host logic,
importing nothing of ``ddw_tpu``.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time

from ddw_tpu_torch.gateway.prefix_index import PrefixIndex
from ddw_tpu_torch.serve.admission import (DeadlineExceeded, Overloaded,
                                           ReplicaFailed, Unavailable)
from ddw_tpu_torch.serve.lanes import item_generator
from ddw_tpu_torch.serve.metrics import (EngineMetrics, merge_metrics,
                                         render_prometheus)

__all__ = ["ReplicaSet", "CircuitBreaker",
           "CIRCUIT_CLOSED", "CIRCUIT_HALF_OPEN", "CIRCUIT_OPEN"]

CIRCUIT_CLOSED = "closed"
CIRCUIT_HALF_OPEN = "half_open"
CIRCUIT_OPEN = "open"

# numeric encodings for the flat snapshot / Prometheus gauge
_CIRCUIT_CODE = {CIRCUIT_CLOSED: 0.0, CIRCUIT_HALF_OPEN: 1.0,
                 CIRCUIT_OPEN: 2.0}


class CircuitBreaker:
    """Per-replica request-outcome FSM: CLOSED (routing) → OPEN (skipped)
    → HALF_OPEN (one probe) → CLOSED, the classic pattern.

    OPENs on ``failure_threshold`` consecutive replica-fault outcomes, on a
    failed half-open probe, or on an explicit :meth:`trip` (the engine's
    death report / the supervisor's stall verdict). After ``cooldown_s`` it
    lapses to HALF_OPEN by itself; the supervisor's :meth:`half_open` opens
    the probe window immediately after a warmed restart instead of waiting
    out the clock. Only replica faults count — ``Overloaded`` and deadline
    sheds are honest load answers from a *live* replica, not failures."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 5.0,
                 clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CIRCUIT_CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False
        self.opened = 0             # total trips (telemetry)

    def _state_locked(self) -> str:
        if (self._state == CIRCUIT_OPEN
                and self._clock() - self._opened_at >= self.cooldown_s):
            self._state = CIRCUIT_HALF_OPEN
            self._probing = False
        return self._state

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def available(self) -> bool:
        """Peek: would a submission be routed here right now? (CLOSED, or
        HALF_OPEN with the probe slot free.)"""
        with self._lock:
            s = self._state_locked()
            return s == CIRCUIT_CLOSED or (s == CIRCUIT_HALF_OPEN
                                           and not self._probing)

    def begin_probe(self) -> None:
        """Claim the single HALF_OPEN probe slot (no-op when CLOSED)."""
        with self._lock:
            if self._state_locked() == CIRCUIT_HALF_OPEN:
                self._probing = True

    def abort_probe(self) -> None:
        """Release the probe slot on a neutral outcome (deadline shed,
        cancel) that proves nothing about replica health."""
        with self._lock:
            self._probing = False

    def record_success(self) -> None:
        with self._lock:
            if self._state == CIRCUIT_OPEN:
                return      # a straggler finishing does not close an
            #                 opened circuit — only a probe can
            self._state = CIRCUIT_CLOSED
            self._consecutive = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            s = self._state_locked()
            self._consecutive += 1
            if (s == CIRCUIT_HALF_OPEN
                    or self._consecutive >= self.failure_threshold):
                self._trip_locked()

    def trip(self) -> None:
        """Force OPEN now — the engine reported itself dead; waiting for
        request outcomes to accumulate would route traffic into a corpse."""
        with self._lock:
            self._trip_locked()

    def _trip_locked(self) -> None:
        if self._state != CIRCUIT_OPEN:
            self.opened += 1
        self._state = CIRCUIT_OPEN
        self._opened_at = self._clock()
        self._probing = False

    def half_open(self) -> None:
        """Open the probe window immediately (the supervisor's rejoin gate
        after a warmed restart) instead of waiting out the cooldown."""
        with self._lock:
            if self._state == CIRCUIT_OPEN:
                self._state = CIRCUIT_HALF_OPEN
                self._probing = False

    def close(self) -> None:
        """Close the circuit on EXTERNAL evidence of health — the
        supervisor's shadow warmup probe succeeded against the replica
        directly, so no live client request has to play guinea pig in the
        half-open window."""
        with self._lock:
            self._state = CIRCUIT_CLOSED
            self._consecutive = 0
            self._probing = False

    def retry_after_ms(self) -> float:
        """How long until this circuit's next probe window (0 when not
        OPEN) — the honest Retry-After hint for a fleet-wide refusal."""
        with self._lock:
            if self._state_locked() != CIRCUIT_OPEN:
                return 0.0
            return max(0.0, (self._opened_at + self.cooldown_s
                             - self._clock()) * 1e3)


class ReplicaSet:
    """Admission-aware, circuit-breaking router over engine replicas."""

    def __init__(self, replicas, failure_threshold: int = 3,
                 cooldown_s: float = 5.0, route_by_prefix: bool = True):
        if hasattr(replicas, "submit_generate"):   # a bare engine
            replicas = [replicas]
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("ReplicaSet needs at least one engine replica")
        n = len(self.replicas)
        self._failure_threshold = failure_threshold   # for added slots
        self._cooldown_s = cooldown_s
        self._outstanding = [0] * n
        self._where: dict = {}      # future -> replica index (for the
        #                             done-callback and failover moves)
        self._lock = threading.Lock()
        self.breakers = [CircuitBreaker(failure_threshold, cooldown_s)
                         for _ in range(n)]
        self.restarts = [0] * n     # supervisor restarts, via note_restart
        self.replica_failures = 0   # terminal engine deaths observed
        self.failed_over = 0        # requests adopted by a sibling
        self.retried_429 = 0        # refusals absorbed by a sibling retry
        self.failure_event = threading.Event()   # supervisor wake-up
        self.prefix_index = PrefixIndex()   # fleet prefix map: fed from
        #                                     the pools' event logs on the
        #                                     routing path, read by the
        #                                     supervisor's warm replay
        self.route_by_prefix = route_by_prefix   # False = pure projected-
        #                                          wait (least-outstanding)
        #                                          routing, the A/B baseline
        #                                          tools/serving_curve.py
        #                                          measures against
        self.tracer = None          # obs.Tracer installed by the Gateway
        #                             when tracing: routing decisions become
        #                             spans (projected wait, prefix credit,
        #                             chosen replica, spill/failover)
        self.telemetry = None       # obs.FleetTelemetry installed by the
        #                             Gateway when sampling: replace() must
        #                             clear the dead engine's cached series
        #                             so merged windows don't mix epochs
        self.fleet_metrics = EngineMetrics()    # fleet-level counters (the
        #                             rollout lifecycle: canary verdicts,
        #                             surge spawns, journal resumes) — owned
        #                             here, not by a replica, so replace()
        #                             can't lose them; merged into
        #                             snapshot()/prometheus() with the rest
        self._canary = None         # (replica index, traffic fraction)
        #                             while a canary deploy holds one
        #                             replica at a weighted share
        self._canary_count = 0      # deterministic diversion counter
        self.adapter_digests: dict[str, str] = {}   # adapter_id -> sha256
        #                             hex, fed by the gateway's
        #                             /admin/adapters staged load — the
        #                             salt source for adapter-aware prefix
        #                             routing (an unknown adapter routes
        #                             by load alone; its salted chains
        #                             can't match base keys anyway)
        for i, eng in enumerate(self.replicas):
            self._wire(i, eng)

    def _wire(self, i: int, eng) -> None:
        """Attach the fleet identity + failover hook (best-effort: plain
        fakes without the attributes still route)."""
        try:
            eng.replica_id = i
            eng.on_failure = (lambda failure, salvage, _i=i:
                              self._on_replica_failure(_i, failure, salvage))
        except AttributeError:
            pass

    # -- lifecycle (fan-out) ------------------------------------------------
    def start(self) -> "ReplicaSet":
        for eng in self.replicas:
            eng.start()
        return self

    def stop(self) -> None:
        for eng in self.replicas:
            eng.stop()

    def warmup(self, prompt_lens=(8,)) -> None:
        for eng in self.replicas:
            eng.warmup(prompt_lens)

    def __enter__(self) -> "ReplicaSet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def replace(self, i: int, eng) -> None:
        """Swap in a replacement replica (the clone_fresh recovery path for
        a wedged thread). Outstanding futures of the old engine keep their
        accounting — they resolve through the same done-callback."""
        self._wire(i, eng)
        self.replicas[i] = eng
        self.prefix_index.drop_replica(i)   # a fresh engine holds nothing
        if self.telemetry is not None:
            self.telemetry.drop_replica(f"replica{i}")

    def note_restart(self, i: int) -> None:
        with self._lock:
            if 0 <= i < len(self.restarts):
                self.restarts[i] += 1

    # -- elastic membership (the autoscaler's actuation surface) -------------
    #
    # Membership changes REPLACE the per-slot lists instead of mutating
    # them in place: a router thread that captured the old lists under the
    # lock keeps a mutually consistent (replicas, breakers, outstanding)
    # view for the rest of its submission — it can still route to a
    # retiring replica (which refuses and spills sideways, never a torn
    # IndexError), but it can never observe lists of different lengths.
    # fleet_metrics is untouched by construction: it is owned here, not
    # per-slot, so scale events can't lose canary/handoff/journal counters.

    def add_replica(self, eng) -> int:
        """Admit an ALREADY-WARM replica into the routed fleet (the
        autoscale controller spawns, warms, and shadow-probes it first —
        capacity is never consumed by a cold replica). Returns the new
        slot index."""
        self._wire(len(self.replicas), eng)
        with self._lock:
            i = len(self.replicas)
            self.replicas = self.replicas + [eng]
            self._outstanding = self._outstanding + [0]
            self.breakers = self.breakers + [CircuitBreaker(
                self._failure_threshold, self._cooldown_s)]
            self.restarts = self.restarts + [0]
        return i

    def remove_replica(self, i: int):
        """Retire slot ``i`` from the routed fleet: pop every per-slot
        structure, renumber the slots above it (in-flight futures keep
        their accounting through the renumbered ``_where`` map), and clear
        the router-side caches — :meth:`PrefixIndex.drop_replica` and
        :meth:`FleetTelemetry.drop_replica` — for every source whose slot
        identity changed, so repeated scale cycles leak nothing. Returns
        the removed engine; the CALLER owns its drain/stop discipline (by
        the time this runs the victim should hold no outstanding work)."""
        with self._lock:
            n = len(self.replicas)
            if n <= 1:
                raise ValueError("cannot remove the last replica")
            if not 0 <= i < n:
                raise IndexError(f"replica slot {i} out of range 0..{n - 1}")
            eng = self.replicas[i]
            self.replicas = self.replicas[:i] + self.replicas[i + 1:]
            self._outstanding = (self._outstanding[:i]
                                 + self._outstanding[i + 1:])
            self.breakers = self.breakers[:i] + self.breakers[i + 1:]
            self.restarts = self.restarts[:i] + self.restarts[i + 1:]
            for fut, j in list(self._where.items()):
                if j == i:          # victim stragglers: accounting already
                    self._where.pop(fut)        # popped with the slot
                elif j > i:
                    self._where[fut] = j - 1
            can = self._canary
            if can is not None:
                ci, frac = can
                if ci == i:
                    self._canary = None
                elif ci > i:
                    self._canary = (ci - 1, frac)
        # every slot >= i changed identity: drop the router-side caches
        # keyed by the OLD slot numbers (the prefix feed's since=0 re-poll
        # and the telemetry re-ingest rebuild them for the new numbering)
        for old in range(i, n):
            self.prefix_index.drop_replica(old)
            if self.telemetry is not None:
                self.telemetry.drop_replica(f"replica{old}")
        for j in range(i, len(self.replicas)):
            self._wire(j, self.replicas[j])
        return eng

    # -- routing ------------------------------------------------------------
    def outstanding(self) -> list[int]:
        with self._lock:
            return list(self._outstanding)

    def fleet_health(self) -> list[dict]:
        """Per-replica health + circuit view (the /stats payload)."""
        with self._lock:
            replicas = self.replicas
            breakers = self.breakers
            restarts = list(self.restarts)
            outs = list(self._outstanding)
        out = []
        for i, eng in enumerate(replicas):
            h = (eng.health() if hasattr(eng, "health")
                 else {"state": "unknown", "replica": i})
            h["circuit"] = breakers[i].state
            h["restarts"] = restarts[i]
            h["outstanding"] = outs[i]
            out.append(h)
        return out

    def _score(self, i: int, outstanding: int, saved_tokens: int = 0,
               replicas=None):
        """Projected-wait routing key: (estimated wait ms, pending work,
        index). Engines exposing ``load()`` are scored on queue depth +
        busy slots x their own EWMA service estimate — the ROADMAP's
        admission-aware routing; anything else falls back to the
        outstanding-futures count (ties by index keep it deterministic).
        ``saved_tokens`` is this replica's cached-prefix match for the
        prompt being routed: matched tokens x its per-prefilled-token EWMA
        are credited against the wait, so a warm replica wins exactly
        until its queue costs more than the cold prefill elsewhere.
        ``replicas`` is the caller's captured membership view (elastic
        fleets replace the list on scale events)."""
        eng = (replicas if replicas is not None else self.replicas)[i]
        if hasattr(eng, "load"):
            try:
                ld = eng.load()
                pending = float(ld["depth"] + ld["busy"])
                wait = pending * float(ld.get("service_ms") or 0.0)
                if saved_tokens:
                    wait -= (saved_tokens
                             * float(ld.get("prefill_token_ms") or 0.0))
                return (wait, pending, i)
            except Exception:
                pass
        return (0.0 if not saved_tokens else -float(saved_tokens),
                float(outstanding), i)

    def _scored(self, exclude=(), matched=None, weighted=True) -> list:
        """``weighted=False`` skips the canary reorder (and its diversion
        counter) — the telemetry sampler's read-only view."""
        with self._lock:
            # one consistent membership view: the per-slot lists are
            # replaced (never resized in place) on scale events, so
            # capturing them together under the lock can't tear
            outs = list(self._outstanding)
            replicas = self.replicas
            breakers = self.breakers
        scored = [self._score(i, outs[i],
                              matched.get(i, 0) if matched else 0,
                              replicas=replicas)
                  for i in range(len(replicas))
                  if i not in exclude and breakers[i].available()]
        scored.sort()
        return self._canary_reorder(scored) if weighted else scored

    # -- canary weighting ----------------------------------------------------
    def set_canary(self, i: int, fraction: float) -> None:
        """Hold replica ``i`` at ``fraction`` of eligible traffic while a
        canary deploy judges it. ``fraction=0`` is a *dark* canary: no
        client traffic unless every sibling refuses (the canary stays a
        last-resort spill target — a 429 to the client would be a worse
        outcome than a canary-served request)."""
        with self._lock:
            self._canary = (i, max(0.0, min(1.0, float(fraction))))
            self._canary_count = 0

    def clear_canary(self) -> None:
        with self._lock:
            self._canary = None

    def _canary_reorder(self, scored: list) -> list:
        """Weighted canary routing over the projected-wait order: a
        deterministic counter diverts ≈``fraction`` of eligible requests to
        the canary; everything else prefers the siblings (canary demoted to
        last-resort spill). The tie-break discipline carries over —
        a diverted request still loses the canary if its projected wait is
        GENUINELY longer than the best sibling's, so holding a fraction
        never queues clients behind a struggling canary."""
        with self._lock:
            can = self._canary
            if can is None:
                return scored
            self._canary_count += 1
            n = self._canary_count
        ci, frac = can
        canary = [s for s in scored if s[-1] == ci]
        rest = [s for s in scored if s[-1] != ci]
        if not canary or not rest:
            return scored
        if (int(n * frac) > int((n - 1) * frac)
                and canary[0][0] <= rest[0][0]):
            return canary + rest
        return rest + canary

    def _order(self, exclude=(), matched=None) -> list[int]:
        """Healthy replica indices, best candidate first. ``matched`` is
        the prefix index's slot -> matched-prefix-tokens map for the
        prompt being routed (None for non-generate submissions)."""
        return [s[-1] for s in self._scored(exclude, matched)]

    def _min_retry_ms(self) -> float:
        hints = [b.retry_after_ms() for b in self.breakers]
        live = [h for h in hints if h > 0]
        return min(live) if live else 1000.0

    def _dec(self, i: int) -> None:
        with self._lock:
            if 0 <= i < len(self._outstanding):
                self._outstanding[i] -= 1

    def _on_done(self, fut) -> None:
        """Every routed future lands here exactly once — the accounting
        decrement AND the breaker's outcome feed. Submission paths that
        raise never registered the future, so the counter can't leak.
        ``_where`` is renumbered by ``remove_replica``, so the slot read
        here tracks membership changes that happened mid-flight."""
        with self._lock:
            i = self._where.pop(fut, None)
            if i is not None and i < len(self._outstanding):
                self._outstanding[i] -= 1
            breakers = self.breakers
        if i is None or i >= len(breakers):
            return
        try:
            exc = None if fut.cancelled() else fut.exception()
        except Exception:
            exc = None
        if exc is None:
            breakers[i].record_success()
        elif isinstance(exc, ReplicaFailed):
            breakers[i].record_failure()
        else:
            # Overloaded/DeadlineExceeded are honest load answers from a
            # live replica — neutral for health, but a claimed probe slot
            # must not leak
            breakers[i].abort_probe()

    def _submit(self, method: str, args, kwargs, prompt=None):
        tracer = self.tracer
        t_route = time.monotonic() if tracer is not None else 0.0
        matched = None
        hexes: list = []
        adapter_id = kwargs.get("adapter_id")
        salt = b""
        if adapter_id is not None:
            dg = self.adapter_digests.get(adapter_id)
            if dg:
                salt = bytes.fromhex(dg)
            else:
                # digest unknown at the routing layer: the request's
                # salted chains can't match any base key, so a base match
                # would route it to warmth it cannot use — skip matching
                prompt = None
        if prompt is not None and self.route_by_prefix:
            try:        # index staleness/unavailability must never block
                self.prefix_index.poll(self.replicas)
                matched, hexes = self.prefix_index.match(
                    prompt, with_hashes=True, salt=salt)
                matched = matched or None
            except Exception:
                matched, hexes = None, []
        exclude = ()
        if method in ("submit_generate", "submit_batch_item"):
            # a pure prefill worker finishes every generate at its first
            # emitted token — decode-bearing requests must not land there
            # while a decode-capable sibling exists
            exclude = self._prefill_only()
        if method == "submit_generate" and exclude and adapter_id is None:
            # adapter-tagged requests never take the prefill→decode
            # handoff: adapter residency (slot + salt) is replica-local
            # and salted blocks are excluded from KV export by design
            fut = self._try_handoff(args, kwargs, matched, hexes)
            if fut is not None:
                return fut
        scored = self._scored(exclude=exclude, matched=matched)
        order = [s[-1] for s in scored]
        if not order:
            raise Unavailable("all replica circuits open",
                              retry_after_ms=self._min_retry_ms())
        with self._lock:
            replicas = self.replicas       # consistent membership view for
            breakers = self.breakers       # the rest of this submission
        # the routing span is allocated up front so the engine's own chain
        # (queue -> prefill -> decode) can parent on it across the hop
        route_sid = None
        if tracer is not None and "trace_id" in kwargs:
            route_sid = tracer._next_span_id()
            parent = kwargs.get("parent_span")
            kwargs = dict(kwargs, parent_span=route_sid)
        last = None
        overloads = 0
        for i in order:
            if overloads >= 2:
                break               # the single-sideways-spill budget
            if i >= len(replicas):
                continue            # slot retired between score and submit
            with self._lock:
                if i < len(self._outstanding):
                    self._outstanding[i] += 1
            try:
                fut = getattr(replicas[i], method)(*args, **kwargs)
            except Overloaded as e:
                self._dec(i)
                last = e
                overloads += 1
                if overloads < 2 and i != order[-1]:
                    with self._lock:
                        self.retried_429 += 1
                continue
            except ReplicaFailed as e:
                self._dec(i)        # a corpse doesn't consume the 429
                last = e            # budget — walk to any live sibling
                breakers[i].record_failure()
                continue
            except BaseException:
                self._dec(i)     # validation errors etc. must not leak
                raise            # an outstanding count into the router
            if matched:
                self._count_routing(i, matched)
            if route_sid is not None:
                wait, pending, _ = next(s for s in scored if s[-1] == i)
                tracer.record_span(
                    "route", "gateway", t_route, time.monotonic(),
                    trace=kwargs.get("trace_id"), parent=parent,
                    tid="router", span=route_sid,
                    args={"replica": i, "projected_wait_ms": round(wait, 3),
                          "prefix_tokens": (matched.get(i, 0)
                                            if matched else 0),
                          "spills": overloads})
            breakers[i].begin_probe()
            with self._lock:
                self._where[fut] = i
            fut.add_done_callback(self._on_done)
            return fut
        raise last

    def _count_routing(self, i: int, matched: dict[int, int]) -> None:
        """Feed the routing counters on the replica that took the request:
        a cache hit when it held any prefix of the prompt, a wait override
        when the longest holder's queue priced it out of its own prefix
        and the request prefilled cold (or colder) elsewhere."""
        best = max(matched.values())
        try:
            m = self.replicas[i].metrics
            if matched.get(i, 0) > 0:
                m.count("routed_cache_hit")
            if matched.get(i, 0) < best:
                m.count("routed_wait_override")
        except Exception:
            pass        # fakes without metrics still route

    # -- disaggregated prefill/decode ----------------------------------------
    @staticmethod
    def _role(eng) -> str:
        """The replica's serving role (duck-typed; plain fakes and older
        engines are full-service ``both``)."""
        try:
            return str(getattr(eng, "role", "both") or "both")
        except Exception:
            return "both"

    def _prefill_only(self) -> tuple:
        """Slots holding pure prefill workers — excluded from
        decode-bearing submissions whenever a decode-capable sibling
        exists (a ``role="prefill"`` engine finishes every generate at
        its first emitted token, which would truncate a multi-step
        request routed there). With no decode-capable sibling nothing is
        excluded: a degenerate all-prefill fleet still answers."""
        pre, dec = [], False
        for i, eng in enumerate(self.replicas):
            if self._role(eng) == "prefill":
                pre.append(i)
            else:
                dec = True
        return tuple(pre) if (pre and dec) else ()

    def _decode_score(self, i: int, outstanding: int, replicas=None):
        """Decode-placement key: projected wait first, then block-pool
        headroom (``free_block_frac`` from ``load()``) — between equally
        idle decode replicas the request lands where the KV pool has the
        most room, so imported blocks don't reclaim someone else's warm
        prefix."""
        eng = (replicas if replicas is not None else self.replicas)[i]
        wait, free = float(outstanding), 1.0
        if hasattr(eng, "load"):
            try:
                ld = eng.load()
                wait = (float(ld["depth"] + ld["busy"])
                        * float(ld.get("service_ms") or 0.0))
                free = float(ld.get("free_block_frac", 1.0))
            except Exception:
                pass
        return (wait, -free, i)

    def _try_handoff(self, args, kwargs, matched, hexes):
        """Disaggregated submit: prefill on P, migrate the prompt's KV
        blocks, decode on D. Returns the decode replica's future, or
        ``None`` to fall back to colocated routing — no viable pair, P
        and D collapse to the same replica, or ANY migration step failed
        (the fallback is the zero-client-visible-failure guarantee the
        chaos drill pins). Runs synchronously on the submitting thread:
        the handoff IS the request's prefill phase, so its latency is
        TTFT, not hidden queueing."""
        prompt, num_steps = args[0], args[1]
        try:
            if int(num_steps) <= 1:
                return None     # a 1-step request is pure prefill —
            #                     nothing to disaggregate
        except Exception:
            return None
        try:
            with self._lock:
                replicas = self.replicas    # one consistent membership view
                breakers = self.breakers
                outs = list(self._outstanding)
            avail = [i for i in range(len(replicas))
                     if breakers[i].available()]
            pcap = [i for i in avail
                    if self._role(replicas[i]) in ("prefill", "both")]
            dcap = [i for i in avail
                    if self._role(replicas[i]) != "prefill"]
            if not pcap or not dcap:
                return None
            # TTFT-aware split: P chases the warm prefix (prefix credit
            # against projected wait, the _score discipline), D weighs
            # projected wait + pool headroom.
            pi = min(self._score(i, outs[i],
                                 matched.get(i, 0) if matched else 0,
                                 replicas=replicas)
                     for i in pcap)[-1]
            di = min(self._decode_score(i, outs[i], replicas=replicas)
                     for i in dcap)[-1]
            if pi == di:
                return None     # one replica wins both phases: colocated
            p_eng, d_eng = replicas[pi], replicas[di]
            if (not hasattr(p_eng, "kv_export")
                    or not hasattr(d_eng, "kv_import")):
                return None
            t0 = time.monotonic()
            # Phase 1 — prefill on P: a synthetic one-step GREEDY request
            # (the sampled token is discarded; KV is sampling-independent)
            # that finishes through the normal release path, leaving the
            # prompt's blocks registered in P's prefix cache.
            p_eng.submit_generate(prompt, 1,
                                  temperature=0.0).result(timeout=60.0)
            # Phase 2 — migrate. The prefix index doubles as the transfer
            # directory: blocks D already holds warm are named in
            # skip_hashes and never cross the wire.
            bs = self.prefix_index.block_size
            skip = (hexes[:matched.get(di, 0) // bs]
                    if (matched and hexes and bs) else ())
            wire = p_eng.kv_export(prompt, skip_hashes=skip)
            if wire is not None:
                d_eng.kv_import(wire)
            # Phase 3 — the full request on D, with the router's normal
            # accounting; D's admission prefix-hits the imported blocks
            # and re-derives the first token bit-identically.
            with self._lock:
                if di < len(self._outstanding):
                    self._outstanding[di] += 1
            try:
                fut = d_eng.submit_generate(*args, **kwargs)
            except BaseException:
                self._dec(di)
                raise
            self.fleet_metrics.count("handoffs")
            self.fleet_metrics.count(
                "handoff_ms", int((time.monotonic() - t0) * 1e3))
            if matched:
                self._count_routing(di, matched)
            if self.tracer is not None:
                self.tracer.instant(
                    "handoff", "gateway",
                    trace=kwargs.get("trace_id"), tid="router",
                    args={"prefill": pi, "decode": di,
                          "skip_blocks": len(skip),
                          "ms": round((time.monotonic() - t0) * 1e3, 3)})
            breakers[di].begin_probe()
            with self._lock:
                self._where[fut] = di
            fut.add_done_callback(self._on_done)
            return fut
        except Exception:
            return None     # ANY handoff failure → colocated fallback

    # -- failover (the dead replica's on_failure hook) -----------------------
    def _on_replica_failure(self, i: int, failure: ReplicaFailed,
                            salvage) -> None:
        """Runs on the dying engine's (or the supervisor's) thread: open
        the circuit immediately, then re-home every salvaged queued request
        — original futures intact — or complete it with a structured
        refusal. Nothing may leave here unresolved."""
        self.breakers[i].trip()
        with self._lock:
            self.replica_failures += 1
        for kind, req in salvage:
            try:
                self._failover(i, kind, req, failure)
            except Exception:
                self._complete(req, ReplicaFailed(
                    failure.kind, replica=i, phase="queued",
                    forensics=failure.forensics))
        self.failure_event.set()

    def _failover(self, src: int, kind: str, req,
                  failure: ReplicaFailed) -> None:
        now = time.monotonic()
        deadline = getattr(req, "deadline", None)
        if deadline is not None and now > deadline:
            waited = (now - req.times.submitted) * 1e3
            self._complete(req, DeadlineExceeded(
                kind, waited, (deadline - req.times.submitted) * 1e3))
            return
        exclude = (src,) + (self._prefill_only()
                            if kind == "generate" else ())
        with self._lock:
            replicas = self.replicas        # consistent membership view
        for j in self._order(exclude=exclude):
            if j >= len(replicas):
                continue        # slot retired between score and adopt
            eng = replicas[j]
            if not hasattr(eng, "adopt"):
                continue
            if deadline is not None and hasattr(eng, "load"):
                ld = eng.load()
                est_s = ((ld["depth"] + ld["busy"])
                         * (ld.get("service_ms") or 0.0)) / 1e3
                if now + est_s > deadline:
                    continue    # deadline-aware: don't queue where the
                #                 wait already busts the SLO
            try:
                eng.adopt(kind, req)
            except (Overloaded, ReplicaFailed, ValueError):
                continue
            with self._lock:
                fut = req.future
                prev = self._where.get(fut)
                if prev is not None:    # move the outstanding count with it
                    if prev < len(self._outstanding):
                        self._outstanding[prev] -= 1
                    if j < len(self._outstanding):
                        self._outstanding[j] += 1
                    self._where[fut] = j
                self.failed_over += 1
            if self.tracer is not None:
                self.tracer.instant(
                    "failover", "gateway",
                    trace=getattr(req, "trace_id", None), tid="router",
                    args={"from": src, "to": j, "kind": kind})
            return
        self._complete(req, Unavailable(
            "no sibling could adopt the request before its deadline",
            retry_after_ms=self._min_retry_ms()))

    @staticmethod
    def _complete(req, exc: Exception) -> None:
        if not req.future.done():
            try:
                req.future.set_exception(exc)
            except Exception:
                pass

    # -- submission (engine surface) ----------------------------------------
    def submit_generate(self, prompt, num_steps: int, **kw):
        return self._submit("submit_generate", (prompt, num_steps), kw,
                            prompt=prompt)

    def submit_predict(self, item, **kw):
        return self._submit("submit_predict", (item,), kw)

    def submit_batch_item(self, prompt, num_steps: int, **kw):
        """Batch-lane generate item, routed like any other submission —
        per-item routing is what makes a bulk job job-aware at the fleet
        level: outstanding counts, breakers, and the sideways-429 spill
        all apply per item, and a dead replica's items fail fast for the
        job pump to resubmit."""
        return self._submit("submit_batch_item", (prompt, num_steps), kw)

    def submit_batch_predict(self, item, **kw):
        return self._submit("submit_batch_predict", (item,), kw)

    def submit_batch_items(self, items, indices, kind: str = "generate",
                           num_steps: int | None = None,
                           temperature: float = 0.0,
                           seed: int | None = None,
                           timeout_s: float = 0.0) -> list:
        """Route a GROUP of batch-lane items to ONE replica — the pump's
        per-replica batching: a process replica takes the whole group in a
        single HTTP exchange (``submit_batch_items`` on the engine), an
        in-thread engine takes a per-item loop. Returns one future per
        item, every one registered with this set's accounting + breaker
        feed. Items a mid-group refusal strands come back as pre-failed
        futures carrying the refusal (the pump requeues them); the
        group-level spill budget matches ``_submit``'s."""
        indices = list(indices)
        order = self._order(exclude=(self._prefill_only()
                                     if kind == "generate" else ()))
        if not order:
            raise Unavailable("all replica circuits open",
                              retry_after_ms=self._min_retry_ms())
        with self._lock:
            replicas = self.replicas        # consistent membership view
            breakers = self.breakers
        last: Exception | None = None
        overloads = 0
        for i in order:
            if overloads >= 2:
                break
            if i >= len(replicas):
                continue        # slot retired between score and submit
            eng = replicas[i]
            try:
                if hasattr(eng, "submit_batch_items"):
                    futs = eng.submit_batch_items(
                        items, indices, kind=kind, num_steps=num_steps,
                        temperature=temperature, seed=seed,
                        timeout_s=timeout_s)
                else:
                    futs = self._batch_item_loop(
                        eng, items, indices, kind, num_steps, temperature,
                        seed, timeout_s)
            except Overloaded as e:
                last = e
                overloads += 1
                if overloads < 2 and i != order[-1]:
                    with self._lock:
                        self.retried_429 += 1
                continue
            except ReplicaFailed as e:
                last = e
                breakers[i].record_failure()
                continue
            breakers[i].begin_probe()
            with self._lock:
                ok = i < len(self._outstanding)
                for fut in futs:
                    if ok and not fut.done():   # pre-failed stragglers stay
                        self._outstanding[i] += 1   # out of the breaker
                        self._where[fut] = i        # feed — the replica
            #                                         never saw them
            for fut in futs:
                if not fut.done():
                    fut.add_done_callback(self._on_done)
            return futs
        raise last

    def _batch_item_loop(self, eng, items, indices, kind, num_steps,
                         temperature, seed, timeout_s) -> list:
        """Per-item submission of a group against ONE in-thread engine.
        The first item's refusal propagates (the group spills sideways);
        a refusal mid-group pre-fails the REMAINING items' futures locally
        so the landed prefix keeps its engine slots."""
        seeded = (kind == "generate" and temperature > 0.0
                  and seed is not None)
        futs: list = []
        pending_exc: Exception | None = None
        for pos, (item, idx) in enumerate(zip(items, indices)):
            if pending_exc is None:
                try:
                    if kind == "generate":
                        rng = item_generator(seed, idx) if seeded else None
                        fut = eng.submit_batch_item(
                            item, num_steps, temperature=temperature,
                            rng=rng, timeout_s=timeout_s)
                    else:
                        fut = eng.submit_batch_predict(
                            item, timeout_s=timeout_s)
                    futs.append(fut)
                    continue
                except (Overloaded, ReplicaFailed) as e:
                    if pos == 0:
                        raise
                    pending_exc = e
            fut = concurrent.futures.Future()
            fut.set_running_or_notify_cancel()
            fut.set_exception(pending_exc)
            futs.append(fut)
        return futs

    def submit_batch(self, items, kind: str = "generate", **kw):
        """Start a host-side :class:`~ddw_tpu_torch.serve.lanes.BatchJob` whose
        items route across this set (see :func:`~ddw_tpu_torch.serve.lanes.
        start_batch_job` for the knobs)."""
        from ddw_tpu_torch.serve.lanes import start_batch_job
        return start_batch_job(self, items, kind=kind, **kw)

    def generate(self, prompt, num_steps: int, **kw):
        return self.submit_generate(prompt, num_steps, **kw).result()

    def predict(self, items, timeout_s: float | None = None):
        futs = [self.submit_predict(x, timeout_s=timeout_s) for x in items]
        return [f.result() for f in futs]

    # -- fleet metrics -------------------------------------------------------
    def merged_metrics(self):
        return merge_metrics([eng.metrics for eng in self.replicas]
                             + [self.fleet_metrics])

    def snapshot(self) -> dict[str, float]:
        """Fleet SLO view: the merged engine snapshot plus the routing
        layer's own numbers (replica count, sideways retries, outstanding /
        circuit state / restart count per replica)."""
        out = self.merged_metrics().snapshot()
        with self._lock:
            outstanding = list(self._outstanding)
            restarts = list(self.restarts)
            breakers = self.breakers
            out["gateway.retried_429"] = float(self.retried_429)
            out["gateway.replica_failures"] = float(self.replica_failures)
            out["gateway.failed_over"] = float(self.failed_over)
        out["gateway.replicas"] = float(len(outstanding))
        for i, n in enumerate(outstanding):
            out[f"gateway.outstanding_r{i}"] = float(n)
            out[f"gateway.circuit_r{i}"] = _CIRCUIT_CODE[breakers[i].state]
            out[f"gateway.restarts_r{i}"] = float(restarts[i])
        return out

    def prometheus(self) -> str:
        with self._lock:
            replicas = self.replicas
            breakers = self.breakers
            gauges = {f'ddw_gateway_outstanding{{replica="{i}"}}': float(n)
                      for i, n in enumerate(self._outstanding)}
            gauges["ddw_gateway_retried_429"] = float(self.retried_429)
            gauges["ddw_gateway_replica_failures"] = float(
                self.replica_failures)
            for i, n in enumerate(self.restarts):
                gauges[f'ddw_gateway_restarts{{replica="{i}"}}'] = float(n)
        for i, b in enumerate(breakers):
            gauges[f'ddw_gateway_circuit_state{{replica="{i}"}}'] = \
                _CIRCUIT_CODE[b.state]
        gauges["ddw_gateway_replicas"] = float(len(replicas))
        return render_prometheus([eng.metrics for eng in replicas]
                                 + [self.fleet_metrics],
                                 extra_gauges=gauges)
