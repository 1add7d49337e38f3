"""SLO error budgets with multi-window burn-rate alerting + the sentinel;
the port of ``ddw_tpu.obs.slo`` (host logic, copied).

A declarative :class:`SLOObjective` names a telemetry signal and a
good/bad rule; the :class:`SLOMonitor` evaluates every objective over the
fleet's merged sample feeds each telemetry tick. The alerting math is the
SRE-workbook shape:

- *bad fraction* over a trailing window — latency objectives count dist
  observations above the threshold, availability objectives count failure
  counters against the success counter, throughput objectives flag a
  window whose rate sits under the floor;
- *burn rate* = bad fraction / (1 - target): 1.0 burns the error budget
  exactly at the sustainable pace, N burns it N times faster;
- *multi-window pairs*: a PAGE needs the fast pair (default 5m AND 1m)
  burning at ``page_burn`` — the long window proves it is not a blip, the
  short window proves it is still happening; a WARNING needs either pair
  at ``warn_burn`` (default slow pair 60m/5m). All four widths are
  constructor knobs so drills compress hours to seconds.

The per-objective alert FSM (``ok -> warning -> page``) escalates at most
one level per evaluation (warning-before-page ordering is structural, not
probabilistic) and de-escalates only after ``clear_evals`` consecutive
healthy evaluations — hysteresis, so one good window cannot silence a
page. Every transition appends to a bounded history, is recorded on the
gateway tracer (category ``slo``), and surfaces in ``/readyz`` as
``degraded`` detail.

Error-budget accounting is cumulative and exact: the monitor ingests each
fresh sample exactly once (the gateway hands it the
:meth:`~ddw_tpu_torch.obs.telemetry.FleetTelemetry.ingest` return), so
``events_total``/``events_bad`` — and the attainment ``/stats`` reports —
agree with an offline recount of the same run (tools/load_gen.py's
cross-check arm pins this).

**The sentinel**: on a transition INTO ``page`` the monitor snapshots the
offending windows, burn rates, budget, transition history, and the
flight-recorder tail into ``degradation.<ts>.json`` (atomic tmp +
``os.replace``, the ``dump_flight`` discipline) — a drill injecting
``DDW_FAULT=serve:stall`` leaves a self-contained post-mortem artifact
with zero operator intervention. See ``ddw_tpu``'s docs/observability.md.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

from ddw_tpu_torch.obs.telemetry import merge_feeds

__all__ = ["SLOObjective", "SLOMonitor", "OK", "WARNING", "PAGE"]

OK, WARNING, PAGE = "ok", "warning", "page"
_LEVEL = {OK: 0, WARNING: 1, PAGE: 2}
_STATE = {0: OK, 1: WARNING, 2: PAGE}


@dataclasses.dataclass
class SLOObjective:
    """One declarative objective over a telemetry signal.

    ``kind``:

    - ``latency``: ``signal`` is a dist feed (e.g. ``serve.ttft_ms``);
      an observation is good iff ``value <= threshold``; ``target`` is
      the good fraction (p99 <= X ms == target 0.99, threshold X).
    - ``availability``: ``signal`` is the success counter
      (``serve.completed``), ``bad_signals`` the failure counters; the
      bad fraction is failures / (successes + failures).
    - ``throughput``: ``signal`` is a counter whose windowed rate must
      stay >= ``threshold`` (units/second); a window under the floor is
      all-bad, over it all-good.
    """

    name: str
    kind: str                    # "latency" | "availability" | "throughput"
    signal: str
    threshold: float = 0.0
    target: float = 0.99
    bad_signals: tuple = ()
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("latency", "availability", "throughput"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {self.target}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _json_default(obj):
    """Serializer of last resort for the sentinel payload: flight spans
    and sampled values may carry numpy scalars — a post-mortem must not
    be lost to a dtype."""
    for cast in (float, int):
        try:
            return cast(obj)
        except (TypeError, ValueError):
            continue
    return str(obj)


def _window_values(feeds, name: str, lo: float, hi: float) -> list[float]:
    out = []
    for feed in feeds:
        for s in feed.get("samples", []):
            if s["name"] == name and lo < s["ts"] <= hi:
                out.append(s["value"])
    return out


def _window_rate(feeds, name: str, lo: float, hi: float) -> tuple[float, int]:
    """Fleet rate of a cumulative counter over (lo, hi] — per-source
    deltas (reset-rebased) summed, like :func:`merge_feeds`."""
    from ddw_tpu_torch.obs.telemetry import _counter_delta

    delta = 0.0
    n = 0
    for feed in feeds:
        samples = [s for s in feed.get("samples", []) if s["name"] == name]
        d, k = _counter_delta(samples, lo, hi)
        delta += d
        n += k
    return delta, n


class SLOMonitor:
    """Evaluates objectives over merged feeds; owns the alert FSMs, the
    cumulative error budgets, and the degradation sentinel. Thread-safe:
    the gateway's telemetry thread evaluates, HTTP threads read."""

    def __init__(self, objectives, tracer=None,
                 fast=(300.0, 60.0), slow=(3600.0, 300.0),
                 page_burn: float = 14.4, warn_burn: float = 6.0,
                 clear_evals: int = 3, dump_dir: str | None = None,
                 flight_fn=None, history_cap: int = 256, clock=time.time):
        self.objectives = list(objectives)
        self.tracer = tracer
        self.fast = tuple(fast)
        self.slow = tuple(slow)
        self.page_burn = page_burn
        self.warn_burn = warn_burn
        self.clear_evals = max(1, int(clear_evals))
        self.dump_dir = dump_dir
        self.flight_fn = flight_fn          # () -> flight-recorder tail
        self._clock = clock
        self._lock = threading.Lock()
        self._state: dict[str, int] = {o.name: 0 for o in self.objectives}
        self._since: dict[str, float] = {o.name: clock()
                                         for o in self.objectives}
        self._calm: dict[str, int] = {o.name: 0 for o in self.objectives}
        self._burns: dict[str, dict] = {o.name: {} for o in self.objectives}
        self._total: dict[str, int] = {o.name: 0 for o in self.objectives}
        self._bad: dict[str, int] = {o.name: 0 for o in self.objectives}
        # availability accounting: last cumulative value per
        # (source, signal), so each counter increment is counted once
        self._counter_last: dict[tuple, float] = {}
        self.history: list[dict] = []
        self.history_cap = history_cap
        self.dumps: list[str] = []          # degradation artifacts written
        self.dump_errors: list[str] = []    # artifacts LOST (and why)
        self.evals = 0

    # -- budget accounting (each fresh sample exactly once) ------------------
    def ingest(self, source: str, samples) -> None:
        with self._lock:
            for obj in self.objectives:
                if obj.kind == "latency":
                    for s in samples:
                        if s["name"] != obj.signal:
                            continue
                        self._total[obj.name] += 1
                        if s["value"] > obj.threshold:
                            self._bad[obj.name] += 1
                elif obj.kind == "availability":
                    good = self._counter_ingest(source, obj.signal, samples)
                    bad = 0
                    for bs in obj.bad_signals:
                        bad += self._counter_ingest(source, bs, samples)
                    self._total[obj.name] += int(good + bad)
                    self._bad[obj.name] += int(bad)
                # throughput budgets accrue per evaluated window (below):
                # a rate floor has no per-event denominator

    def _counter_ingest(self, source: str, name: str, samples) -> float:
        delta = 0.0
        key = (source, name)
        for s in samples:
            if s["name"] != name:
                continue
            v = s["value"]
            prev = self._counter_last.get(key)
            # first sight (the absolute value IS the increment since this
            # source's epoch) and reset rebase (a respawned source
            # restarts at zero) both contribute v
            delta += v if (prev is None or v < prev) else v - prev
            self._counter_last[key] = v
        return delta

    # -- evaluation ----------------------------------------------------------
    def _bad_fraction(self, obj: SLOObjective, feeds, width: float,
                      now: float):
        """(bad_fraction, n_events) over the trailing window; fraction is
        None when the window holds no data (no data is not an outage —
        a quiet fleet must not page)."""
        lo, hi = now - width, now
        if obj.kind == "latency":
            vals = _window_values(feeds, obj.signal, lo, hi)
            if not vals:
                return None, 0
            bad = sum(1 for v in vals if v > obj.threshold)
            return bad / len(vals), len(vals)
        if obj.kind == "availability":
            good, gn = _window_rate(feeds, obj.signal, lo, hi)
            bad = 0.0
            bn = 0
            for bs in obj.bad_signals:
                d, k = _window_rate(feeds, bs, lo, hi)
                bad += d
                bn += k
            if gn + bn == 0 or good + bad <= 0:
                return None, 0
            return bad / (good + bad), int(good + bad)
        # throughput: a window with traffic under the floor is all-bad
        delta, n = _window_rate(feeds, obj.signal, lo, hi)
        if n == 0:
            return None, 0
        return (1.0 if delta / width < obj.threshold else 0.0), n

    def evaluate(self, feeds, now: float | None = None) -> dict:
        """One evaluation pass over the fleet's current feeds. Returns
        ``{objective: state}`` after any transitions."""
        now = self._clock() if now is None else now
        transitions = []
        with self._lock:
            self.evals += 1
            out = {}
            for obj in self.objectives:
                budget = 1.0 - obj.target
                burns = {}
                for label, width in (("fast_long", self.fast[0]),
                                     ("fast_short", self.fast[1]),
                                     ("slow_long", self.slow[0]),
                                     ("slow_short", self.slow[1])):
                    frac, n = self._bad_fraction(obj, feeds, width, now)
                    burns[label] = {
                        "width_s": width, "n": n,
                        "bad_fraction": (None if frac is None
                                         else round(frac, 6)),
                        "burn": (0.0 if frac is None
                                 else round(frac / budget, 4))}
                if obj.kind == "throughput":
                    # budget accounting per evaluated fast-short window
                    frac = burns["fast_short"]["bad_fraction"]
                    if frac is not None:
                        self._total[obj.name] += 1
                        if frac > 0:
                            self._bad[obj.name] += 1
                self._burns[obj.name] = burns
                page = (burns["fast_long"]["burn"] >= self.page_burn
                        and burns["fast_short"]["burn"] >= self.page_burn)
                warn = ((burns["fast_long"]["burn"] >= self.warn_burn
                         and burns["fast_short"]["burn"] >= self.warn_burn)
                        or (burns["slow_long"]["burn"] >= self.warn_burn
                            and burns["slow_short"]["burn"]
                            >= self.warn_burn))
                desired = 2 if page else (1 if warn else 0)
                cur = self._state[obj.name]
                nxt = cur
                if desired > cur:
                    nxt = cur + 1               # escalate one step per eval
                    self._calm[obj.name] = 0
                elif desired < cur:
                    self._calm[obj.name] += 1
                    if self._calm[obj.name] >= self.clear_evals:
                        nxt = cur - 1           # hysteresis satisfied
                        self._calm[obj.name] = 0
                else:
                    self._calm[obj.name] = 0
                if nxt != cur:
                    rec = {"ts": now, "objective": obj.name,
                           "from": _STATE[cur], "to": _STATE[nxt],
                           "burn": {k: v["burn"] for k, v in burns.items()}}
                    self._state[obj.name] = nxt
                    self._since[obj.name] = now
                    self.history.append(rec)
                    del self.history[:-self.history_cap]
                    transitions.append((obj, rec, feeds))
                out[obj.name] = _STATE[self._state[obj.name]]
        # side effects outside the lock: tracer appends and the sentinel
        # dump must never block a concurrent /stats read
        for obj, rec, feeds_ in transitions:
            if self.tracer is not None:
                try:
                    self.tracer.instant(
                        f"slo.{obj.name}", "slo", tid="slo",
                        args={"from": rec["from"], "to": rec["to"],
                              **{f"burn_{k}": v
                                 for k, v in rec["burn"].items()}})
                except Exception as e:  # the timeline is garnish; neither
                    self.dump_errors.append(repr(e))  # the FSM nor the
                    #                         sentinel may hang on it
            if rec["to"] == PAGE:
                self._dump_degradation(obj, rec, feeds_, rec["ts"])
        return out

    # -- the sentinel --------------------------------------------------------
    def _dump_degradation(self, obj: SLOObjective, rec: dict, feeds,
                          now: float) -> None:
        if self.dump_dir is None:
            return
        path = os.path.join(self.dump_dir,
                            f"degradation.{int(now * 1000)}.json")
        try:
            widths = sorted(set(self.fast + self.slow))
            payload = {
                "objective": obj.to_dict(),
                "transition": rec,
                "burn_windows": self._burns.get(obj.name, {}),
                "windows": merge_feeds(feeds, widths=widths, now=now),
                "budget": self._budget_view(obj),
                "history": list(self.history),
                "flight": [],
            }
            if self.flight_fn is not None:
                try:
                    payload["flight"] = self.flight_fn()
                except Exception:
                    pass    # forensics must not mask the degradation
            os.makedirs(self.dump_dir, exist_ok=True)
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=_json_default)
            os.replace(tmp, path)
            self.dumps.append(path)
        except Exception as e:     # best-effort like dump_flight, but
            self.dump_errors.append(repr(e))    # counted, never silent

    # -- reading -------------------------------------------------------------
    def _budget_view(self, obj: SLOObjective) -> dict:
        total = self._total[obj.name]
        bad = self._bad[obj.name]
        frac = bad / total if total else 0.0
        budget = 1.0 - obj.target
        return {"events_total": total, "events_bad": bad,
                "bad_fraction": round(frac, 6),
                "attainment": round(1.0 - frac, 6),
                "budget_consumed_pct": round(100.0 * frac / budget, 2)}

    def state(self, name: str) -> str:
        with self._lock:
            return _STATE[self._state[name]]

    def status(self) -> dict:
        """The ``/stats`` SLO block: per-objective FSM state, burn rates,
        and the cumulative error budget (``attainment`` is the number the
        load-gen cross-check arm recomputes offline)."""
        with self._lock:
            objectives = {}
            for obj in self.objectives:
                objectives[obj.name] = {
                    "kind": obj.kind, "signal": obj.signal,
                    "threshold": obj.threshold, "target": obj.target,
                    "state": _STATE[self._state[obj.name]],
                    "since": self._since[obj.name],
                    "burn": self._burns[obj.name],
                    "budget": self._budget_view(obj)}
            return {"objectives": objectives, "evals": self.evals,
                    "history": list(self.history[-32:]),
                    "dumps": list(self.dumps),
                    "dump_errors": list(self.dump_errors),
                    "config": {"fast": list(self.fast),
                               "slow": list(self.slow),
                               "page_burn": self.page_burn,
                               "warn_burn": self.warn_burn,
                               "clear_evals": self.clear_evals}}

    def degraded(self) -> list[dict]:
        """Non-ok objectives — the ``/readyz`` degraded detail."""
        with self._lock:
            out = []
            for obj in self.objectives:
                if self._state[obj.name] != 0:
                    out.append({
                        "objective": obj.name,
                        "state": _STATE[self._state[obj.name]],
                        "since": self._since[obj.name],
                        "burn": {k: v["burn"] for k, v
                                 in self._burns[obj.name].items()}})
            return out
