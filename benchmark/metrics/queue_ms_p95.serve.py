"""95th percentile of the engine's queue ms (benchmark.lib.readers)."""

from benchmark.lib.readers import queue_ms_p95


def read(run):
    return queue_ms_p95(run)
