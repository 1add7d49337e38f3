"""ScalePolicy — declarative traffic → desired-replica-count math.

The telemetry plane (:mod:`ddw_tpu_torch.obs.telemetry`) already serves aligned
10s/60s windows over the fleet (queue depths, TTFT dists, block-pool
occupancy) and the SLO monitor (:mod:`ddw_tpu_torch.obs.slo`) reduces them to
burn rates. This module is the pure half of closing the autoscaling loop:
it turns those numbers into ONE integer — the replica count the fleet
should converge to — with every anti-flap mechanism a bursty workload
needs expressed declaratively:

- **separate out/in thresholds** per signal, validated at construction so
  the scale-in bound is strictly below the scale-out bound — the gap IS
  the hysteresis band where the policy holds;
- **two window speeds**: scale-OUT pressure is judged on the fast (10s)
  window so a burst is answered in seconds, scale-IN quiescence on the
  slow (60s) window so a lull between bursts does not shed capacity the
  next burst needs;
- **per-direction cooldowns**, both stamped by ANY completed scale event,
  so an out cannot be chased by an immediate in (or vice versa) no matter
  how the signals oscillate;
- **min/max bounds** clamping the desired count.

Everything here is clock-injected and side-effect free (`decide` mutates
nothing) — the unit tests drive burn-rate in → desired count out with no
fleet, no threads, no sleeps. The controller owns the only mutation:
:meth:`ScalePolicy.note_scaled` after a scale event actually lands.

The port of ``ddw_tpu.autoscale.policy``: the same host logic,
importing nothing of ``ddw_tpu``.
"""

from __future__ import annotations

import dataclasses
import time

__all__ = ["PolicyInputs", "ScaleDecision", "ScalePolicy",
           "inputs_from_windows", "max_burn"]


@dataclasses.dataclass(frozen=True)
class PolicyInputs:
    """One window's reduction of the fleet telemetry — what the policy
    sees. All pressure signals are FLEET totals; the policy normalizes
    queue depth per replica itself (a deep queue on a big fleet is not
    pressure). Build from live telemetry with :func:`inputs_from_windows`
    or construct directly in tests."""

    replicas: int = 1              # actual fleet size when sampled
    burn: float = 0.0              # max SLO fast-window burn rate
    queue_depth: float = 0.0       # fleet queue depth (gauge last_sum)
    ttft_p95_ms: float = 0.0       # interactive TTFT p95 over the window
    occupancy_pct: float = 0.0     # block-pool occupancy, 0..100

    @property
    def queue_per_replica(self) -> float:
        return self.queue_depth / max(1, self.replicas)


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One decide tick's verdict. ``action`` is ``"out"``/``"in"``/
    ``"hold"``; ``desired`` is the count to converge to (== ``current``
    on hold); ``reason`` names the signal (and its window) that drove the
    verdict, or why a pressed direction was suppressed (cooldown, bounds,
    hysteresis band)."""

    action: str
    desired: int
    current: int
    reason: str
    cooldown_remaining_s: float = 0.0


class ScalePolicy:
    """Desired-count policy over the 10s/60s telemetry windows.

    Scale OUT when ANY out-threshold is exceeded on the fast inputs;
    scale IN only when EVERY signal sits below its (strictly lower)
    in-threshold on the slow inputs. A threshold set to ``None`` disables
    that signal in both directions. ``step`` replicas are added/removed
    per event (default 1 — the surge admission cost is per replica, so
    converging one at a time keeps every intermediate fleet probed and
    warm).
    """

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 burn_out: float | None = 2.0, burn_in: float | None = 0.5,
                 queue_out: float | None = 8.0, queue_in: float | None = 1.0,
                 ttft_out_ms: float | None = None,
                 ttft_in_ms: float | None = None,
                 occupancy_out_pct: float | None = 90.0,
                 occupancy_in_pct: float | None = 40.0,
                 out_cooldown_s: float = 10.0, in_cooldown_s: float = 30.0,
                 step: int = 1, clock=time.monotonic):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(f"max_replicas ({max_replicas}) < min_replicas "
                             f"({min_replicas})")
        if step < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        for name, out_thr, in_thr in (("burn", burn_out, burn_in),
                                      ("queue", queue_out, queue_in),
                                      ("ttft_ms", ttft_out_ms, ttft_in_ms),
                                      ("occupancy_pct", occupancy_out_pct,
                                       occupancy_in_pct)):
            if (out_thr is None) != (in_thr is None):
                raise ValueError(f"{name}: out/in thresholds must be set "
                                 f"together (got out={out_thr}, in={in_thr})")
            if out_thr is not None and not in_thr < out_thr:
                raise ValueError(
                    f"{name}: scale-in threshold ({in_thr}) must be "
                    f"strictly below scale-out ({out_thr}) — the gap is "
                    f"the hysteresis band")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.step = step
        self.out_cooldown_s = out_cooldown_s
        self.in_cooldown_s = in_cooldown_s
        self._clock = clock
        self._signals = [
            ("burn", burn_out, burn_in,
             lambda inp: inp.burn),
            ("queue_per_replica", queue_out, queue_in,
             lambda inp: inp.queue_per_replica),
            ("ttft_p95_ms", ttft_out_ms, ttft_in_ms,
             lambda inp: inp.ttft_p95_ms),
            ("occupancy_pct", occupancy_out_pct, occupancy_in_pct,
             lambda inp: inp.occupancy_pct),
        ]
        self._last_scaled = {"out": None, "in": None}   # event stamps

    # -- cooldown clock ------------------------------------------------------
    def note_scaled(self, direction: str, now: float | None = None) -> None:
        """Stamp a COMPLETED scale event. Both direction clocks restart —
        an out followed by an instant in (or the reverse) is exactly the
        flap the cooldowns exist to forbid."""
        if direction not in ("out", "in"):
            raise ValueError(f"direction must be 'out' or 'in', "
                             f"got {direction!r}")
        t = self._clock() if now is None else now
        self._last_scaled["out"] = t
        self._last_scaled["in"] = t

    def cooldown_remaining(self, direction: str,
                           now: float | None = None) -> float:
        t = self._clock() if now is None else now
        last = self._last_scaled[direction]
        if last is None:
            return 0.0
        width = (self.out_cooldown_s if direction == "out"
                 else self.in_cooldown_s)
        return max(0.0, width - (t - last))

    # -- the verdict ---------------------------------------------------------
    def decide(self, fast: PolicyInputs, slow: PolicyInputs | None = None,
               now: float | None = None) -> ScaleDecision:
        """One reconcile tick's verdict. ``fast`` is the smoothing-window
        (10s) reduction judging scale-OUT pressure; ``slow`` the SLO-window
        (60s) reduction judging scale-IN quiescence (defaults to ``fast``
        for single-window callers/tests). Pure: no clock stamping — the
        controller calls :meth:`note_scaled` only after the event lands."""
        t = self._clock() if now is None else now
        slow = fast if slow is None else slow
        current = max(1, fast.replicas)

        pressed = None              # first out-threshold exceeded (fast)
        for name, out_thr, _in_thr, get in self._signals:
            if out_thr is not None and get(fast) > out_thr:
                pressed = f"{name} {get(fast):g} > {out_thr:g} (fast)"
                break
        if pressed is not None:
            remaining = self.cooldown_remaining("out", now=t)
            if remaining > 0.0:
                return ScaleDecision(
                    "hold", current, current,
                    f"out pressed ({pressed}) but in cooldown",
                    cooldown_remaining_s=remaining)
            desired = min(current + self.step, self.max_replicas)
            if desired <= current:
                return ScaleDecision("hold", current, current,
                                     f"out pressed ({pressed}) but at "
                                     f"max_replicas={self.max_replicas}")
            return ScaleDecision("out", desired, current, pressed)

        quiet = True                # ALL signals below in-thresholds (slow)
        blocker = ""
        for name, out_thr, in_thr, get in self._signals:
            if in_thr is None:
                continue
            if get(slow) >= in_thr:
                quiet = False
                blocker = f"{name} {get(slow):g} >= {in_thr:g} (slow)"
                break
        if quiet:
            remaining = self.cooldown_remaining("in", now=t)
            if remaining > 0.0:
                return ScaleDecision(
                    "hold", current, current,
                    "idle but in cooldown",
                    cooldown_remaining_s=remaining)
            desired = max(current - self.step, self.min_replicas)
            if desired >= current:
                return ScaleDecision("hold", current, current,
                                     f"idle but at min_replicas="
                                     f"{self.min_replicas}")
            return ScaleDecision("in", desired, current,
                                 "all signals below scale-in thresholds")
        return ScaleDecision("hold", current, current,
                             f"hysteresis band: {blocker}")

    def describe(self) -> dict:
        """The knob set, for ``/stats`` and ``POST /admin/autoscale``."""
        out = {"min_replicas": self.min_replicas,
               "max_replicas": self.max_replicas, "step": self.step,
               "out_cooldown_s": self.out_cooldown_s,
               "in_cooldown_s": self.in_cooldown_s}
        for name, out_thr, in_thr, _get in self._signals:
            out[f"{name}_out"] = out_thr
            out[f"{name}_in"] = in_thr
        return out


# -- telemetry extraction -----------------------------------------------------

def max_burn(slo_status: dict | None) -> float:
    """The worst burn rate across every SLO objective's windows — the
    single scalar the policy's ``burn`` signal wants. Accepts the full
    :meth:`SLOMonitor.status` dict or just its ``objectives`` map. 0.0
    with no monitor or no burn data (absence of evidence must not scale
    the fleet)."""
    worst = 0.0
    status = slo_status or {}
    objs = status.get("objectives", status)
    for obj in objs.values():
        if not isinstance(obj, dict):
            continue
        for win in (obj.get("burn") or {}).values():
            if not isinstance(win, dict):
                continue
            try:
                worst = max(worst, float(win.get("burn", 0.0)))
            except (TypeError, ValueError):
                continue
    return worst


def inputs_from_windows(merged: dict, window: str, replicas: int,
                        burn: float = 0.0) -> PolicyInputs:
    """Reduce ONE aligned window of :meth:`FleetTelemetry.merged` output
    to :class:`PolicyInputs`. ``window`` is the width label (``"10s"`` /
    ``"60s"``); signals the window lacks contribute 0 (a quiet fleet
    produces no TTFT samples — that reads as no pressure, correctly)."""
    signals = (merged.get("windows", {}).get(window, {})
               .get("signals", {}))

    def last_sum(name: str) -> float:
        return float(signals.get(name, {}).get("last_sum", 0.0))

    queue = last_sum("serve.queue_depth")
    ttft = float(signals.get("serve.ttft_ms", {}).get("p95", 0.0))
    total = last_sum("serve.blocks_total")
    free = last_sum("serve.blocks_free")
    occupancy = 100.0 * (1.0 - free / total) if total > 0 else 0.0
    return PolicyInputs(replicas=max(1, replicas), burn=burn,
                        queue_depth=queue, ttft_p95_ms=ttft,
                        occupancy_pct=occupancy)
