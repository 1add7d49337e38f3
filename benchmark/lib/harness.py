"""One run of one cell: set-up, the measured window, the program freed, the
comparison with the plain reference, the metrics.

The result is the dict that ``run.py`` prints as its last line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
a trace ``breakdown`` and the kernels' launches by variant, and last
``checks``: each number compared with its limit.
"""

from __future__ import annotations

import math
import shutil
import sys
import tempfile
import time

import torch

from benchmark.lib.drivers import DRIVERS
from benchmark.lib.manifest import Bench
from benchmark.lib.trace import TraceWindow


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when none passes
    its limit and every limited number was read."""
    checks, ok = {}, True
    for name, spec in limits.items():
        value = numbers.get(name)
        if value is not None and not math.isfinite(value):
            value = None
        checks[name] = {"value": value, "limit": spec["limit"]}
        ok = ok and value is not None and value <= spec["limit"]
    return ok, checks


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device, t_proc: float, *, extra: tuple = (),
             hooks: dict | None = None,
             config_changes: dict | None = None) -> dict:
    """Run ``workload`` once and return its result. ``extra`` names
    readings that only the calibration takes (``"control"``,
    ``"half_batch"``, ``"witness"``), and ``config_changes`` keys of the
    configuration it tries."""
    bench = Bench(root)
    cell = bench.workload(workload)
    cfg = dict(bench.config(cell["config"]), **(config_changes or {}))
    mix = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)["checks"]
    device = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="bench-")
    try:
        drv = DRIVERS[mix["kind"]](bench, cfg, mix, seed, device, tmp, hooks)
        drv.setup()
        setup_s = time.perf_counter() - t_proc
        tw = TraceWindow(tmp, device.type == "cuda") if trace else None
        rec = drv.window(seconds, tw)
        if tw is not None:
            tw.collect()
            rec.trace = tw
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        drv.release()
        t_check = time.perf_counter()
        numbers = drv.check(extra)
        numbers["_check_s"] = time.perf_counter() - t_check
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    correct, checks = judge(numbers, limits)
    metrics = {}
    if trace:
        for m in bench.metrics_of(workload, "per_layer"):
            value = bench.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(rec.e2e, setup_s=setup_s)
        for m in bench.metrics_of(workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": rec.attempted,
              "failed": rec.failed, "metrics": metrics, "device": dev}
    if trace:
        s = rec.trace.summary
        dev["busy_s"], dev["window_s"] = s["busy_s"], s["window_s"]
        result["breakdown"] = {"device_ops": s["device_ops"],
                               "idle_gaps": s["idle_gaps"]}
        if rec.launches is not None:
            result["launches"] = rec.launches
    result["details"] = {k: v for k, v in numbers.items()
                         if k.startswith("_") or k not in limits}
    result["checks"] = checks
    return result


def print_checks(checks: dict, stream=sys.stderr) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=stream)
