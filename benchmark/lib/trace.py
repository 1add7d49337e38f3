"""The device trace of a ``--trace 1`` run.

``torch.profiler`` (CPU and CUDA activity) records a stretch of the
window, bracketed by device synchronisations and marked by a
``bench_window`` annotation. The Chrome trace it exports (into the run's
temporary directory) is reduced to: the window's length; the seconds in
which some device operation ran (the union of kernel, copy and set
intervals); each kernel name's seconds; the device operations that took
most time; and the device's idle gaps, summed by what the host was doing in
them (the innermost host operation around each gap's middle).
"""

from __future__ import annotations

import bisect
import json
import os
import re

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
MARK = "bench_window"


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and signature."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def _union(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events: list[dict]) -> dict:
    """Reduce a Chrome trace's events (``ts``/``dur`` in microseconds)."""
    marks = [e for e in events if e.get("name") == MARK and e.get("ph") == "X"
             and e.get("cat") in _HOST_CATS]
    if not marks:
        raise ValueError("the trace holds no bench_window annotation")
    w0 = marks[0]["ts"]
    w1 = w0 + marks[0]["dur"]
    dev = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS:
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if b > a:
                dev.append((a, b, e["name"]))
    busy = _union((a, b) for a, b, _ in dev)
    per_kernel: dict[str, float] = {}
    for a, b, name in dev:
        per_kernel[name] = per_kernel.get(name, 0.0) + (b - a) * 1e-6
    hosts = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in _HOST_CATS
                   and e.get("name") != MARK)
    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    starts = [h[0] for h in hosts]
    by_host: dict[str, list] = {}
    for a, b in gaps:
        # the innermost host operation around the middle: of those that
        # contain it, the one that started last
        mid, key = (a + b) / 2, "no host operation"
        for j in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 5001), -1):
            if hosts[j][1] >= mid:
                key = hosts[j][2]
                break
        slot = by_host.setdefault(key, [0.0, 0])
        slot[0] += (b - a) * 1e-6
        slot[1] += 1
    by_short: dict[str, float] = {}
    for name, s in per_kernel.items():
        k = short_name(name)
        by_short[k] = by_short.get(k, 0.0) + s
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernel_s": per_kernel,
        "device_ops": sorted(([k, v] for k, v in by_short.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([f"{k} (x{n})", s] for k, (s, n) in by_host.items()),
                            key=lambda kv: -kv[1])[:10],
    }


class TraceWindow:
    """Profile a stretch of the window: ``start`` and ``stop`` inside it,
    ``collect`` (export and reduce) once the window has closed."""

    def __init__(self, tmpdir: str, cuda: bool = True):
        self.tmpdir, self.cuda = tmpdir, cuda
        self.state = "idle"            # "idle" -> "on" -> "off"
        self.summary: dict | None = None
        self._prof = self._mark = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._mark = record_function(MARK)
        self._mark.__enter__()
        self.state = "on"

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.state = "off"

    def collect(self) -> dict:
        path = os.path.join(self.tmpdir, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        try:
            with open(path) as f:
                self.summary = summarize(json.load(f)["traceEvents"])
        finally:
            os.remove(path)
        return self.summary

    def kernel_seconds(self, patterns: list[str]) -> float:
        """Device seconds of the kernels whose names match any pattern."""
        rx = [re.compile(p) for p in patterns]
        return sum(s for name, s in self.summary["kernel_s"].items()
                   if any(r.search(name) for r in rx))
