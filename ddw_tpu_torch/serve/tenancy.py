"""Per-tenant QoS — quotas at admission, weighted fair share, priority
tiers, and tenant-attributed SLOs; the port of ``ddw_tpu.serve.tenancy``
(host logic, copied).

The two lanes (interactive / batch) are CLASS isolation: latency traffic
is protected from throughput traffic, but tenants inside a lane still share
one FIFO — a noisy tenant's burst queues ahead of everyone and its sheds
page as FLEET degradation. This module graduates the lane scheduler into
real multi-tenancy:

- **Quotas at admission** (:class:`TenancyController.charge`): each tenant
  may hold at most ``block_quota`` worst-case KV blocks and
  ``token_quota`` in-flight positions. The charge happens at SUBMIT time
  (worst case, like the pool's own ``_committed`` budget) and is released
  on EVERY completion path — finish, shed, failure, cancel — so a tenant
  saturating its quota gets structured 429 :class:`QuotaExceeded`
  (tenant-tagged ``Retry-After``) while everyone else admits normally.
- **Weighted fair share** (:class:`TenantAwareAdmission`): the batch lane
  queue becomes per-tenant sub-queues drained by STRIDE scheduling — each
  admitted request advances its tenant's virtual-time pass by
  ``cost / weight``, and the scheduler always picks the lowest pass within
  the highest-priority non-empty tier. A tenant with weight 3 gets 3x the
  batch throughput of a weight-1 tenant under contention, exactly; an idle
  tenant's pass snaps forward on arrival so sleeping never banks credit.
- **Priority tiers**: lower ``priority`` drains strictly first (tier 0 is
  interactive-adjacent; tiers only reorder BETWEEN tenants — preempted
  re-admissions keep absolute precedence via the main queue, preserving
  the engine's recompute contract).
- **Tenant-attributed SLOs** (:func:`tenant_objectives`): one burn-rate
  objective per tenant whose NAME carries the tenant id, over the per-
  tenant signals the engine emits (``serve.tenant.<t>.ttft_ms``,
  ``.completed``, ``.sheds``) — a tenant's surge pages as THEIR
  degradation in :class:`ddw_tpu_torch.obs.slo.SLOMonitor`, not the fleet's.
"""

from __future__ import annotations

import collections
import threading
import time

from ddw_tpu_torch.serve.admission import (AdmissionController, Overloaded,
                                     Rejected)

DEFAULT_TENANT = "default"      # tenant-less traffic accounts here


class QuotaExceeded(Rejected):
    """A tenant is at its admission quota — per-tenant backpressure. Maps
    to 429 at the gateway with the tenant id in the body and a
    ``Retry-After`` hint (the tenant's own oldest in-flight request is the
    natural release horizon)."""

    def __init__(self, tenant: str, resource: str, used: float, quota: float,
                 requested: float, retry_after_ms: float | None = None):
        self.tenant = tenant
        self.resource = resource      # "blocks" | "tokens"
        self.used = used
        self.quota = quota
        self.requested = requested
        self.retry_after_ms = retry_after_ms
        hint = (f"; retry in ~{retry_after_ms:.0f} ms"
                if retry_after_ms else "")
        super().__init__(
            f"tenant {tenant!r} {resource} quota exceeded: holds "
            f"{used:g}/{quota:g}, requested {requested:g} more{hint}")

    def to_dict(self) -> dict:
        return {"error": "quota_exceeded", "tenant": self.tenant,
                "resource": self.resource, "used": self.used,
                "quota": self.quota, "requested": self.requested,
                "retry_after_ms": self.retry_after_ms}


class TenantSpec:
    """One tenant's QoS contract. ``weight`` is the fair-share weight in
    the batch lane; ``priority`` the tier (lower drains first);
    ``block_quota`` / ``token_quota`` bound concurrently-charged worst-case
    KV blocks / cache positions (None = unbounded); ``ttft_slo_ms`` +
    ``slo_target`` parameterize the tenant's burn-rate objective."""

    __slots__ = ("name", "weight", "priority", "block_quota", "token_quota",
                 "ttft_slo_ms", "slo_target")

    def __init__(self, name: str, weight: float = 1.0, priority: int = 0,
                 block_quota: int | None = None,
                 token_quota: int | None = None,
                 ttft_slo_ms: float | None = None,
                 slo_target: float = 0.99):
        if not name:
            raise ValueError("tenant name must be non-empty")
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        self.name = name
        self.weight = float(weight)
        self.priority = int(priority)
        self.block_quota = block_quota
        self.token_quota = token_quota
        self.ttft_slo_ms = ttft_slo_ms
        self.slo_target = float(slo_target)

    @classmethod
    def from_dict(cls, d: dict) -> "TenantSpec":
        return cls(d["name"], weight=d.get("weight", 1.0),
                   priority=d.get("priority", 0),
                   block_quota=d.get("block_quota"),
                   token_quota=d.get("token_quota"),
                   ttft_slo_ms=d.get("ttft_slo_ms"),
                   slo_target=d.get("slo_target", 0.99))

    def to_dict(self) -> dict:
        return {"name": self.name, "weight": self.weight,
                "priority": self.priority, "block_quota": self.block_quota,
                "token_quota": self.token_quota,
                "ttft_slo_ms": self.ttft_slo_ms,
                "slo_target": self.slo_target}


class _Usage:
    __slots__ = ("blocks", "tokens", "pass_", "admitted", "completed",
                 "sheds", "emitted")

    def __init__(self):
        self.blocks = 0
        self.tokens = 0
        self.pass_ = 0.0
        self.admitted = 0
        self.completed = 0
        self.sheds = 0
        self.emitted = 0


class TenancyController:
    """Quota accounting + fair-share virtual time for a set of tenants.

    Unknown tenants are auto-registered with ``default_spec``'s knobs (a
    fresh spec under their own name), so tenancy is opt-in per tenant:
    naming a tenant in a request is enough to get accounting and fair
    share; quotas bite only where configured.
    """

    def __init__(self, specs: "list[TenantSpec] | tuple[TenantSpec, ...]" = (),
                 default_spec: TenantSpec | None = None,
                 clock=time.monotonic):
        self._lock = threading.Lock()
        self._specs: dict[str, TenantSpec] = {s.name: s for s in specs}
        self._default = default_spec or TenantSpec(DEFAULT_TENANT)
        self._usage: dict[str, _Usage] = {}
        self._clock = clock

    def spec(self, tenant: str | None) -> TenantSpec:
        t = tenant or DEFAULT_TENANT
        with self._lock:
            s = self._specs.get(t)
            if s is None:
                d = self._default
                s = self._specs[t] = TenantSpec(
                    t, weight=d.weight, priority=d.priority,
                    block_quota=d.block_quota, token_quota=d.token_quota,
                    ttft_slo_ms=d.ttft_slo_ms, slo_target=d.slo_target)
            return s

    def tenants(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(set(self._specs) | set(self._usage)))

    def _u(self, tenant: str) -> _Usage:
        u = self._usage.get(tenant)
        if u is None:
            u = self._usage[tenant] = _Usage()
        return u

    # ------------------------------------------------------------- quotas
    def charge(self, tenant: str | None, blocks: int, tokens: int,
               retry_after_ms: float | None = None) -> str:
        """Reserve a request's worst-case footprint against its tenant's
        quotas — all-or-nothing; raises :class:`QuotaExceeded` without
        charging anything. Returns the resolved tenant name (the handle
        :meth:`release` takes)."""
        s = self.spec(tenant)
        with self._lock:
            u = self._u(s.name)
            if s.block_quota is not None and \
                    u.blocks + blocks > s.block_quota:
                raise QuotaExceeded(s.name, "blocks", u.blocks,
                                    s.block_quota, blocks, retry_after_ms)
            if s.token_quota is not None and \
                    u.tokens + tokens > s.token_quota:
                raise QuotaExceeded(s.name, "tokens", u.tokens,
                                    s.token_quota, tokens, retry_after_ms)
            u.blocks += blocks
            u.tokens += tokens
            u.admitted += 1
            return s.name

    def release(self, tenant: str, blocks: int, tokens: int) -> None:
        """Return a charge. The engine zeroes the request's recorded charge
        after calling this, making every completion path idempotent."""
        with self._lock:
            u = self._u(tenant)
            u.blocks = max(0, u.blocks - blocks)
            u.tokens = max(0, u.tokens - tokens)

    # --------------------------------------------------------- accounting
    def note_completed(self, tenant: str, emitted: int) -> None:
        with self._lock:
            u = self._u(tenant)
            u.completed += 1
            u.emitted += emitted

    def note_shed(self, tenant: str) -> None:
        with self._lock:
            self._u(tenant).sheds += 1

    # ---------------------------------------------------------- fair share
    def advance_pass(self, tenant: str, cost: float) -> None:
        """Stride bookkeeping: admitting ``cost`` units (cache positions)
        of a tenant's work advances its virtual time by ``cost/weight``."""
        s = self.spec(tenant)
        with self._lock:
            self._u(s.name).pass_ += max(cost, 1.0) / s.weight

    def snap_pass(self, tenant: str, floor: float) -> None:
        """An idle tenant re-arriving snaps forward to the scheduler's
        current virtual time — sleeping must not bank credit (standard
        start-time fair queueing)."""
        with self._lock:
            u = self._u(tenant)
            if u.pass_ < floor:
                u.pass_ = floor

    def pass_of(self, tenant: str) -> float:
        with self._lock:
            return self._u(tenant).pass_

    # --------------------------------------------------------------- view
    def view(self) -> dict:
        with self._lock:
            return {
                t: {"blocks_held": u.blocks, "tokens_held": u.tokens,
                    "pass": round(u.pass_, 3), "admitted": u.admitted,
                    "completed": u.completed, "sheds": u.sheds,
                    "emitted": u.emitted,
                    "spec": (self._specs[t].to_dict()
                             if t in self._specs else None)}
                for t, u in sorted(self._usage.items())}


def tenant_objectives(specs, signal_prefix: str = "serve.tenant"):
    """One latency burn-rate objective per tenant with a ``ttft_slo_ms``:
    the objective NAME carries the tenant id (``tenant:<name>:ttft``), so
    when :class:`ddw_tpu_torch.obs.slo.SLOMonitor` pages, the transition record
    and the degradation sentinel attribute the burn to THAT tenant."""
    from ddw_tpu_torch.obs.slo import SLOObjective

    out = []
    for s in specs:
        if s.ttft_slo_ms is None:
            continue
        out.append(SLOObjective(
            name=f"tenant:{s.name}:ttft",
            kind="latency",
            signal=f"{signal_prefix}.{s.name}.ttft_ms",
            threshold=float(s.ttft_slo_ms),
            target=s.slo_target,
            description=f"tenant {s.name}: time-to-first-token under "
                        f"{s.ttft_slo_ms:g} ms for {s.slo_target:.2%} "
                        f"of requests"))
    return out


class TenantAwareAdmission(AdmissionController):
    """AdmissionController whose BATCH-lane queue is per-tenant stride-
    scheduled. Every other kind (interactive ``lm``, ``image``, …) keeps
    the base FIFO bit-for-bit.

    Structure per fair kind: the base deque (``self._queues[kind]``) holds
    ONLY re-queued preempted requests (``requeue_front``) — they were
    already admitted once and keep absolute precedence, preserving the
    engine's recompute contract — plus per-tenant sub-queues drained by
    (priority tier, virtual-time pass). ``peek``/``take`` agree on the
    pick by construction (same selection rule, same state).
    """

    FAIR_KINDS = ("lm_batch",)

    def __init__(self, capacity: int, tenancy: TenancyController,
                 clock=time.monotonic,
                 per_kind: dict[str, int] | None = None):
        super().__init__(capacity, clock=clock, per_kind=per_kind)
        self.tenancy = tenancy
        self._tq: dict[str, dict[str, collections.deque]] = {
            k: {} for k in self.FAIR_KINDS}

    @staticmethod
    def _tenant_of(request) -> str:
        return getattr(request, "tenant", None) or DEFAULT_TENANT

    @staticmethod
    def _cost_of(request) -> float:
        cost = getattr(request, "fair_cost", None)
        if cost is not None:
            return float(cost)
        prompt = getattr(request, "prompt", None)
        steps = getattr(request, "num_steps", 0) or 0
        return float((0 if prompt is None else len(prompt)) + steps)

    # ------------------------------------------------------- pick helpers
    def _pick_tenant_locked(self, kind: str) -> str | None:
        """Lowest (priority, pass) among tenants with queued work."""
        best, best_key = None, None
        for t, q in self._tq[kind].items():
            if not q:
                continue
            s = self.tenancy.spec(t)
            key = (s.priority, self.tenancy.pass_of(t))
            if best_key is None or key < best_key:
                best, best_key = t, key
        return best

    def _fair_depth_locked(self, kind: str) -> int:
        return (len(self._queues.get(kind, ()))
                + sum(len(q) for q in self._tq[kind].values()))

    # ---------------------------------------------------------- overrides
    def depth(self, kind: str | None = None) -> int:
        if kind in self.FAIR_KINDS:
            with self._lock:
                return self._fair_depth_locked(kind)
        if kind is None:
            base = super().depth(None)
            with self._lock:
                extra = sum(len(q) for k in self.FAIR_KINDS
                            for q in self._tq[k].values())
            return base + extra
        return super().depth(kind)

    def oldest_wait_s(self, kind: str) -> float | None:
        if kind not in self.FAIR_KINDS:
            return super().oldest_wait_s(kind)
        with self._lock:
            heads = [q[0] for q in ([self._queues.get(kind)]
                                    + list(self._tq[kind].values())) if q]
            if not heads:
                return None
            return self._clock() - min(r.times.submitted for r in heads)

    def peek(self, kind: str):
        if kind not in self.FAIR_KINDS:
            return super().peek(kind)
        with self._lock:
            q = self._queues.get(kind)
            if q:
                return q[0]
            t = self._pick_tenant_locked(kind)
            return self._tq[kind][t][0] if t is not None else None

    def count_claimed(self, kind: str) -> int:
        if kind not in self.FAIR_KINDS:
            return super().count_claimed(kind)
        with self._lock:
            qs = [self._queues.get(kind, ())] + list(
                self._tq[kind].values())
            return sum(1 for q in qs for r in q
                       if getattr(r, "claimed", False))

    def offer(self, kind: str, request,
              retry_after_ms: float | None = None) -> None:
        if kind not in self.FAIR_KINDS:
            return super().offer(kind, request, retry_after_ms)
        t = self._tenant_of(request)
        with self._lock:
            cap = self.per_kind.get(kind, self.capacity)
            depth = self._fair_depth_locked(kind)
            if depth >= cap:
                raise Overloaded(kind, cap, depth, retry_after_ms)
            q = self._tq[kind].get(t)
            if q is None:
                q = self._tq[kind][t] = collections.deque()
            if not q:
                # arrival after idle: snap the tenant's pass to the current
                # scheduler floor so it competes from NOW, not from history
                floors = [self.tenancy.pass_of(o)
                          for o, oq in self._tq[kind].items() if oq and o != t]
                if floors:
                    self.tenancy.snap_pass(t, min(floors))
            q.append(request)

    def take(self, kind: str, max_n: int) -> tuple[list, list]:
        if kind not in self.FAIR_KINDS:
            return super().take(kind, max_n)
        admitted, expired = [], []
        now = self._clock()
        with self._lock:
            # re-queued preempted work first, arrival order (the base
            # contract verbatim)
            q = self._queues.get(kind)
            while q and len(admitted) < max_n:
                req = q.popleft()
                if req.deadline is not None and now > req.deadline:
                    expired.append(req)
                else:
                    admitted.append(req)
            # then stride-pick across tenants
            while len(admitted) < max_n:
                t = self._pick_tenant_locked(kind)
                if t is None:
                    break
                req = self._tq[kind][t].popleft()
                if req.deadline is not None and now > req.deadline:
                    expired.append(req)   # no pass charge: no work granted
                    continue
                admitted.append(req)
                self.tenancy.advance_pass(t, self._cost_of(req))
        return admitted, expired

    def shed_expired(self, kind: str) -> list:
        if kind not in self.FAIR_KINDS:
            return super().shed_expired(kind)
        now = self._clock()
        expired = []
        with self._lock:
            qs = [self._queues.get(kind)] + list(self._tq[kind].values())
            for q in qs:
                if not q:
                    continue
                live = [r for r in q
                        if not (r.deadline is not None and now > r.deadline)]
                expired.extend(r for r in q
                               if r.deadline is not None and now > r.deadline)
                q.clear()
                q.extend(live)
        return expired
