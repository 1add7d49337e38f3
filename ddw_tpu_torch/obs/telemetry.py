"""Live telemetry plane — windowed time-series over the serving fleet; the
port of ``ddw_tpu.obs.telemetry`` (host logic, copied).

The counters in :mod:`ddw_tpu_torch.serve.metrics` answer "how much, ever"; the
trace ring (:mod:`ddw_tpu_torch.obs.trace`) answers "where did THIS request's
time go". This module answers the operator's question in between: *how is
the fleet doing right now, and is it getting worse* — the live,
decision-grade feed the ROADMAP's traffic-driven autoscaling item is
blocked on (lane depths, projected wait, block occupancy, SLO attainment).

One :class:`TelemetryHub` per process component samples registered
collectors on a fixed cadence into a bounded drop-oldest ring of
``{seq, ts, name, kind, value}`` samples — the same seq-watermark drain
discipline as the trace ring, so parents poll children incrementally
(``GET /v1/telemetry?replica=R&since=N``) and truncation is counted,
never silent. Three signal kinds:

- ``counter`` — monotonic totals (sampled cumulative values; windows
  reduce them to rates via consecutive deltas, rebasing on resets);
- ``gauge``   — instantaneous levels (queue depth, free blocks);
- ``dist``    — per-event observations (one TTFT sample per completed
  request; windows reduce them to mean/max and histogram-backed
  p50/p95/p99 over a fixed geometric ladder).

Samples carry WALL-CLOCK timestamps (``time.time``), unlike trace spans'
monotonic-anchored pairs: windows from different processes must align on
one shared timeline, and a windowed rate never subtracts two clocks.
:func:`merge_feeds` fleet-merges several sources' samples into aligned
trailing windows — per-source counter deltas sum into one fleet rate
(cross-source deltas would be garbage), gauge means/maxes span every
source, dist quantiles interpolate over the merged bucket counts.
:class:`FleetTelemetry` holds the per-source caches a gateway accumulates
(dedupe by watermark, seq-reset protocol for respawned children,
``drop_replica`` for replaced ones). A dead source simply stops producing
samples: its series freezes and ages out of the windows — the merge stays
well-formed throughout.

The training side feeds the same hub through :func:`tee_run`: a
``tracking.Run`` proxy that forwards every ``log_metric`` into a hub (keys
ending ``_ms`` become ``dist`` observations), so Trainer/LMTrainer chain
boundaries produce step-time / throughput / checkpoint-write-latency
series with no trainer knowledge of the hub. See ``ddw_tpu``'s docs/observability.md.
"""

from __future__ import annotations

import bisect
import collections
import itertools
import threading
import time

__all__ = ["TelemetryHub", "FleetTelemetry", "merge_feeds", "window_stats",
           "bucket_counts", "bucket_quantile", "signal_registry", "tee_run",
           "RunTee", "DEFAULT_WIDTHS", "DIST_BUCKETS"]

# default aggregation windows (seconds): 1s (live), 10s (smoothing),
# 60s (the shortest SLO window anyone alerts on)
DEFAULT_WIDTHS = (1.0, 10.0, 60.0)

# histogram ladder for dist quantiles — the same geometric-ish 1-2.5-5
# decades as serve.metrics.LATENCY_BUCKETS_MS (most dist signals are ms);
# an implicit +Inf bucket closes the ladder
DIST_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                1000.0, 2500.0, 5000.0, 10000.0)

KINDS = ("counter", "gauge", "dist")


# -- histogram helpers (shared with serve.metrics' bounded percentiles) ------

def bucket_index(value: float, buckets=DIST_BUCKETS) -> int:
    """Ladder index whose ``le`` bound covers ``value`` (len(buckets) for
    the +Inf bucket) — ``value <= buckets[i]`` inclusive, Prometheus
    style."""
    return bisect.bisect_left(buckets, value)


def bucket_counts(values, buckets=DIST_BUCKETS) -> list[int]:
    """Fold raw observations into ladder counts (+Inf bucket last)."""
    counts = [0] * (len(buckets) + 1)
    for v in values:
        counts[bisect.bisect_left(buckets, v)] += 1
    return counts


def bucket_quantile(counts, q: float, buckets=DIST_BUCKETS) -> float:
    """Quantile (``q`` in percent) interpolated within the ladder bucket
    holding the target rank — the bounded-memory stand-in for
    ``np.percentile`` over raw values. Observations past the last finite
    bound report that bound (the ladder's honest resolution limit)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = (q / 100.0) * total
    acc = 0
    for i, c in enumerate(counts):
        if not c:
            continue
        if acc + c >= rank:
            if i >= len(buckets):
                return float(buckets[-1])
            lo = buckets[i - 1] if i > 0 else 0.0
            return float(lo + (buckets[i] - lo) * max(rank - acc, 0.0) / c)
        acc += c
    return float(buckets[-1])


# -- the per-process hub -----------------------------------------------------

class TelemetryHub:
    """Bounded-ring time-series sampler for one process component.

    ``source`` names the feed ("gateway", "replica0", "train", ...);
    ``capacity`` bounds the sample ring (drop-oldest, drops counted in
    ``samples_dropped``). Collectors registered with :meth:`add_collector`
    return ``{signal: (kind, value)}`` and are invoked every
    ``interval_s`` by the sampler thread (:meth:`start`) or explicitly via
    :meth:`collect_once` (a caller that already owns a periodic thread —
    the gateway — drives the hub without a second thread). Hot paths call
    :meth:`observe` / :meth:`record` directly — but only ever behind a
    plain-bool guard owned by the caller, so telemetry-off costs zero
    attribute touches (tests/test_telemetry.py pins it, the
    ``EngineCfg.trace`` discipline).
    """

    def __init__(self, capacity: int = 4096, interval_s: float = 0.25,
                 source: str = "proc", clock=time.time):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.interval_s = interval_s
        self.source = source
        self._clock = clock
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq = itertools.count(1)
        self._drop_lock = threading.Lock()
        self.samples_dropped = 0
        self._kinds: dict[str, str] = {}
        self._collectors: list = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- recording -----------------------------------------------------------
    def record(self, name: str, value: float, kind: str = "gauge",
               ts: float | None = None) -> None:
        """Append one sample. ``ts`` defaults to the hub clock (wall time —
        cross-process windows must align)."""
        ring = self._ring
        if len(ring) == self.capacity:
            with self._drop_lock:
                self.samples_dropped += 1
        self._kinds[name] = kind
        ring.append({"seq": next(self._seq),
                     "ts": self._clock() if ts is None else ts,
                     "name": name, "kind": kind, "value": float(value)})

    def observe(self, name: str, value: float) -> None:
        """One per-event observation (a completed request's TTFT) — the
        ``dist`` convenience the engine hot path uses."""
        self.record(name, value, kind="dist")

    def add_collector(self, fn) -> None:
        """Register ``fn() -> {signal: (kind, value)}``, sampled each
        cadence tick. A collector that raises is skipped for that tick —
        sampling must never take down the component it watches."""
        self._collectors.append(fn)

    def collect_once(self) -> None:
        ts = self._clock()
        for fn in self._collectors:
            try:
                out = fn()
            except Exception:
                continue
            for name, (kind, value) in out.items():
                self.record(name, value, kind=kind, ts=ts)

    # -- sampler thread ------------------------------------------------------
    def start(self) -> "TelemetryHub":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name=f"ddw-telemetry-{self.source}",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.collect_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- reading / draining --------------------------------------------------
    def drain(self, since: int = 0) -> dict:
        """Samples with ``seq > since``, oldest first — the incremental
        feed a parent polls with the last seq it applied."""
        samples = [s for s in list(self._ring) if s["seq"] > since]
        return {"source": self.source, "dropped": self.samples_dropped,
                "last_seq": samples[-1]["seq"] if samples else int(since),
                "samples": samples}

    def signals(self) -> dict[str, str]:
        """Every signal this hub has seen -> its kind."""
        return dict(self._kinds)

    def summary(self) -> dict:
        snap = list(self._ring)
        return {"source": self.source, "samples": len(snap),
                "dropped": self.samples_dropped, "capacity": self.capacity,
                "signals": len(self._kinds),
                "last_seq": snap[-1]["seq"] if snap else 0}

    def windows(self, widths=DEFAULT_WIDTHS, now: float | None = None
                ) -> dict:
        """This hub's own windowed aggregates (one-source view of
        :func:`merge_feeds`)."""
        return merge_feeds([self.drain(0)], widths=widths,
                           now=self._clock() if now is None else now)


# -- windowed aggregation & fleet merge --------------------------------------

def _wlabel(width: float) -> str:
    return f"{width:g}s"


def _counter_delta(samples: list, lo: float, hi: float) -> tuple[float, int]:
    """Sum of consecutive in-window increments for ONE source's cumulative
    counter series, anchored on the last sample at-or-before the window
    start so the first in-window increment is not lost. Negative jumps
    (a restarted source rebasing at zero) contribute the new absolute
    value — the same rebase rule as the engine's pool-stats mirror."""
    anchor = None
    vals = []
    for s in samples:
        if s["ts"] <= lo:
            anchor = s["value"]
        elif s["ts"] <= hi:
            vals.append(s["value"])
    if not vals:
        return 0.0, 0
    delta = 0.0
    prev = anchor
    for v in vals:
        if prev is None:
            prev = v        # no anchor: first sample is the baseline
            continue
        delta += (v - prev) if v >= prev else v     # reset rebase
        prev = v
    return delta, len(vals)


def window_stats(feed: dict, widths=DEFAULT_WIDTHS,
                 now: float | None = None) -> dict:
    """Windowed aggregates for one drained feed (see :func:`merge_feeds`
    for the multi-source form and the stats schema)."""
    return merge_feeds([feed], widths=widths, now=now)


def merge_feeds(feeds, widths=DEFAULT_WIDTHS, now: float | None = None
                ) -> dict:
    """Fleet-merge several sources' sample feeds into aligned trailing
    windows ``(now - width, now]`` — every source is cut at the SAME
    ``now``, so per-source sampling phase skew cannot split one instant
    across two windows. Per signal and width:

    - ``counter``: per-source deltas (reset-rebased) summed, ``rate`` =
      fleet delta / width;
    - ``gauge``: ``mean``/``max`` over every source's in-window samples,
      ``last_sum`` = fleet total of each source's latest level (the
      number "how deep are the queues right now" wants);
    - ``dist``: merged ladder counts -> ``p50``/``p95``/``p99`` plus
      exact ``mean``/``max``/``n``.

    A source with no in-window samples (dead, frozen, or just quiet)
    contributes nothing — the merge stays well-formed as series freeze.
    """
    if now is None:
        now = time.time()
    # split once: per (signal, source) chronological sample lists
    by_sig: dict[str, dict[str, list]] = {}
    kinds: dict[str, str] = {}
    sources: list[str] = []
    for feed in feeds:
        src = feed.get("source", f"src{len(sources)}")
        sources.append(src)
        for s in feed.get("samples", []):
            name = s["name"]
            kinds[name] = s.get("kind", "gauge")
            by_sig.setdefault(name, {}).setdefault(src, []).append(s)
    windows: dict[str, dict] = {}
    for width in widths:
        lo, hi = now - width, now
        wid = int(now // width)          # aligned window id, for labeling
        out: dict[str, dict] = {}
        for name, per_src in by_sig.items():
            kind = kinds[name]
            if kind == "counter":
                delta = 0.0
                n = 0
                for samples in per_src.values():
                    d, k = _counter_delta(samples, lo, hi)
                    delta += d
                    n += k
                if not n:
                    continue
                out[name] = {"kind": kind, "n": n,
                             "delta": round(delta, 6),
                             "rate": round(delta / width, 6)}
            else:
                vals = []
                last_sum = 0.0
                for samples in per_src.values():
                    win = [s["value"] for s in samples if lo < s["ts"] <= hi]
                    if win:
                        vals.extend(win)
                        last_sum += win[-1]
                if not vals:
                    continue
                stats = {"kind": kind, "n": len(vals),
                         "mean": round(sum(vals) / len(vals), 6),
                         "max": round(max(vals), 6)}
                if kind == "dist":
                    counts = bucket_counts(vals)
                    for q in (50, 95, 99):
                        stats[f"p{q}"] = round(bucket_quantile(counts, q), 6)
                else:
                    stats["last_sum"] = round(last_sum, 6)
                out[name] = stats
        windows[_wlabel(width)] = {"id": wid, "signals": out}
    return {"now": now, "sources": sources, "windows": windows}


class FleetTelemetry:
    """The gateway's per-source sample caches: incremental ingest with
    seq-watermark dedupe, the seq-reset protocol for respawned children
    (a fresh hub restarts at seq 1 — detected, the slot's cache is
    replaced, nothing double-counts), and :meth:`drop_replica` for
    replaced slots. :meth:`merged` is the aligned-window fleet view
    ``/v1/telemetry`` serves."""

    def __init__(self, widths=DEFAULT_WIDTHS, cache: int = 4096,
                 clock=time.time):
        self.widths = tuple(widths)
        self._cache = cache
        self._clock = clock
        self._lock = threading.Lock()
        self._caches: dict[str, collections.deque] = {}
        self._seqs: dict[str, int] = {}

    def watermark(self, source: str) -> int:
        with self._lock:
            return self._seqs.get(source, 0)

    def ingest(self, source: str, feed: dict) -> list[dict]:
        """Apply one drained feed; returns only the samples that were NEW
        for this source (the SLO monitor's budget accounting consumes
        exactly these, each event once)."""
        samples = feed.get("samples", [])
        with self._lock:
            cache = self._caches.setdefault(
                source, collections.deque(maxlen=self._cache))
            seen = self._seqs.get(source, 0)
            fresh = [s for s in samples if s.get("seq", 0) > seen]
            if (samples and not fresh and not feed.get("cached")
                    and samples[-1].get("seq", 0) < seen):
                # seq restarted below the watermark on a LIVE feed: a
                # respawned source with a fresh ring — replace the slot
                cache.clear()
                fresh = list(samples)
            if fresh:
                cache.extend(fresh)
                self._seqs[source] = max(s.get("seq", 0) for s in fresh)
            return fresh

    def drop_replica(self, source: str) -> None:
        """Forget a replaced slot's series entirely (the telemetry analog
        of the prefix index's ``drop_replica``)."""
        with self._lock:
            self._caches.pop(source, None)
            self._seqs.pop(source, None)

    def sources(self) -> list[str]:
        with self._lock:
            return sorted(self._caches)

    def feeds(self) -> list[dict]:
        with self._lock:
            return [{"source": src, "samples": list(cache)}
                    for src, cache in self._caches.items()]

    def merged(self, now: float | None = None, widths=None) -> dict:
        return merge_feeds(self.feeds(),
                           widths=self.widths if widths is None else widths,
                           now=self._clock() if now is None else now)


# -- the signal registry (the satellite-3 consistency contract) --------------

def signal_registry() -> dict[str, str]:
    """Every signal name the framework emits -> its kind. The static
    consistency test pins that any counter incremented in ``serve/`` or
    ``obs/`` source appears here AND in the Prometheus exposition — a new
    counter that skips either fails the suite, not the operator."""
    from ddw_tpu_torch.serve.metrics import _COUNTER_HELP  # lazy: no import cycle

    reg: dict[str, str] = {}
    for name, _ in _COUNTER_HELP:
        reg[f"serve.{name}"] = "counter"
    # engine dist observations (one per completed interactive request)
    for name in ("serve.queue_ms", "serve.ttft_ms", "serve.total_ms"):
        reg[name] = "dist"
    # engine load gauges
    for name in ("serve.queue_depth", "serve.interactive_depth",
                 "serve.batch_depth", "serve.busy_slots"):
        reg[name] = "gauge"
    # block-pool gauges (BlockPool.gauges() + the engine's backlog push)
    for name in ("serve.blocks_total", "serve.blocks_free",
                 "serve.blocks_cached", "serve.blocks_used",
                 "serve.block_tokens_used", "serve.block_tokens_capacity",
                 "serve.resident_streams", "serve.batch_resident_streams",
                 "serve.interactive_reserve_blocks",
                 "serve.reserve_free_blocks", "serve.prefix_cache_keys",
                 "serve.decode_bucket", "serve.batch_backlog",
                 "serve.tp_degree", "serve.spec_k_effective"):
        reg[name] = "gauge"
    # LoRA adapter pool occupancy (AdapterPool.gauges(), pushed through the
    # block-pool gauge path when EngineCfg.adapter_slots > 0)
    for name in ("serve.adapter.slots_total", "serve.adapter.slots_used",
                 "serve.adapter.slots_pinned", "serve.adapter.pins_inflight"):
        reg[name] = "gauge"
    # autoscaler convergence state (pushed on the fleet metrics each tick)
    for name in ("serve.desired_replicas", "serve.fleet_size"):
        reg[name] = "gauge"
    # gateway routing state
    for name in ("gateway.connections", "gateway.inflight",
                 "gateway.outstanding", "gateway.breaker_open",
                 "gateway.projected_wait_ms"):
        reg[name] = "gauge"
    for name in ("gateway.retried_429", "gateway.replica_failures",
                 "gateway.failed_over"):
        reg[name] = "counter"
    # trainer-side series (fed through tee_run)
    for name in ("train.chain_ms", "train.ckpt_write_ms"):
        reg[name] = "dist"
    for name in ("train.images_per_sec", "train.tokens_per_sec",
                 "train.epoch_seconds"):
        reg[name] = "gauge"
    reg["telemetry.samples_dropped"] = "counter"
    return reg


# -- the trainer-side feed ---------------------------------------------------

class RunTee:
    """A ``tracking.Run`` proxy: every ``log_metric`` lands in the wrapped
    run AND as a sample in a :class:`TelemetryHub` — keys ending ``_ms``
    become ``dist`` observations, everything else a gauge (override per
    key via ``kinds``). Everything not intercepted delegates, so a RunTee
    passes anywhere a Run does (Trainer, engine, sysmon)."""

    def __init__(self, run, hub: TelemetryHub, kinds: dict | None = None):
        self._run = run
        self.telemetry_hub = hub
        self._kinds = dict(kinds or {})

    def _kind(self, key: str) -> str:
        return self._kinds.get(key,
                               "dist" if key.endswith("_ms") else "gauge")

    def log_metric(self, key: str, value, step: int = 0) -> None:
        self._run.log_metric(key, value, step=step)
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        self.telemetry_hub.record(key, v, kind=self._kind(key))

    def log_metrics(self, metrics: dict, step: int = 0) -> None:
        self._run.log_metrics(metrics, step=step)
        for key, value in metrics.items():
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            self.telemetry_hub.record(key, v, kind=self._kind(key))

    def __getattr__(self, name):
        return getattr(self._run, name)


def tee_run(run, hub: TelemetryHub, kinds: dict | None = None) -> RunTee:
    """Wrap ``run`` so its metrics also feed ``hub`` (see :class:`RunTee`)."""
    return RunTee(run, hub, kinds=kinds)
