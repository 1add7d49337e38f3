"""What the per-layer metric readers share. Each returns None where the
run has nothing to read, never 0 for a share of a roofline or a peak."""

from __future__ import annotations

from benchmark.lib import flops
from benchmark.lib.traffic import percentile


def mfu(run) -> float | None:
    """Model FLOPs of the work done in the window outside the traced
    stretch, over that time, as a share of the bf16 dense peak (%)."""
    if run.untraced_s <= 0 or run.work_flops <= 0:
        return None
    return 100.0 * run.work_flops / run.untraced_s / flops.BF16_TENSOR_FLOPS


def loader_wait_ms(run) -> float | None:
    """Mean host ms per step spent in the loader's ``next()``."""
    if not run.loader_wait_s:
        return None
    return 1e3 * sum(run.loader_wait_s) / len(run.loader_wait_s)


def roofline(run, op: str) -> float | None:
    """The least time of the operation's calls in the traced stretch over
    the device time of its kernels (%)."""
    if run.trace is None or op not in run.op_bound_s:
        return None
    t = run.trace.kernel_seconds(run.bench.kernel_op(op)["patterns"])
    if t <= 0:
        return None
    return 100.0 * run.op_bound_s[op] / t


def device_idle(run) -> float | None:
    """Share of the traced stretch in which no device operation ran (%)."""
    if run.trace is None:
        return None
    s = run.trace.summary
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def tick_ms(run) -> float | None:
    """Window ms outside the traced stretch per decode tick in it."""
    if not run.ticks_untraced:
        return None
    return 1e3 * run.untraced_s / run.ticks_untraced


def queue_ms_p95(run) -> float | None:
    """95th percentile of the engine's queue ms of the window's requests."""
    if not run.queue_ms:
        return None
    return percentile(run.queue_ms, 95)
