"""Latency-ladder helpers — the part of ``ddw_tpu.obs.telemetry`` the
serving metrics need (``serve/metrics.py``): the fixed bucket ladder's index
of a value and the quantile interpolated from ladder counts. The telemetry
hub, its windows and the SLO plane are not yet ported (``ROADMAP.md``).
"""

from __future__ import annotations

import bisect

# The ms ladder (the same 1-2.5-5 decades as the Prometheus histograms).
DIST_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                1000.0, 2500.0, 5000.0, 10000.0)


def bucket_index(value: float, buckets=DIST_BUCKETS) -> int:
    """Ladder index whose ``le`` bound covers ``value`` (len(buckets) for
    the +Inf bucket) — ``value <= buckets[i]`` inclusive, Prometheus
    style."""
    return bisect.bisect_left(buckets, value)


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
