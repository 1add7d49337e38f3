"""Host/device utilization sampler — the port of ``ddw_tpu.utils.sysmon``.

An in-process background sampler that records host CPU / RAM and the card's
memory use as ``sys.*`` metric series into the tracker run, so utilization
lives next to the training curves.

Host keys come from ``psutil`` when it imports (it is optional, as in
``ddw_tpu``: without it the ``sys.host_*`` / ``sys.proc_rss_gb`` keys are
absent, never faked). Device keys come from PyTorch's caching allocator and
the CUDA runtime, where ``ddw_tpu`` reads PJRT ``memory_stats``:
``sys.device_hbm_used_gb`` is ``torch.cuda.memory_allocated`` (what the
caching allocator has handed out, ``memory_stats``' ``bytes_in_use``) and
``sys.device_hbm_limit_gb`` the card's total from ``torch.cuda.mem_get_info``;
``sys.device_hbm_percent`` is used over limit. A CPU device reports no
device keys (as JAX's CPU backend reports no memory statistics). None of
these reads touches a device tensor, so the sampler thread adds no sync to
the loop it watches. Used by the trainers when ``monitor_interval_s > 0``
(process 0 only) and by the serving engine.
"""

from __future__ import annotations

import threading

import torch

try:
    import psutil

    # psutil.cpu_percent(interval=None) returns 0.0 on its first call in a
    # process (no prior sample to diff against); prime it so real samples
    # never report that placeholder.
    psutil.cpu_percent(interval=None)
except ImportError:
    psutil = None


def host_keys_available() -> bool:
    """Whether :func:`sample_system` reports the ``sys.host_*`` keys (i.e.
    ``psutil`` imports here)."""
    return psutil is not None


def sample_system(device=None) -> dict[str, float]:
    """One utilization snapshot. Keys are stable; device entries appear only
    for a CUDA device (``device`` defaults to the current card when one is
    present, else none)."""
    out: dict[str, float] = {}
    if psutil is not None:
        out["sys.host_cpu_percent"] = float(psutil.cpu_percent(interval=None))
        vm = psutil.virtual_memory()
        out["sys.host_mem_percent"] = float(vm.percent)
        out["sys.host_mem_used_gb"] = vm.used / 2**30
        out["sys.proc_rss_gb"] = psutil.Process().memory_info().rss / 2**30
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None:
        device = torch.device(device)
    if device is not None and device.type == "cuda":
        used = torch.cuda.memory_allocated(device)
        _, total = torch.cuda.mem_get_info(device)
        out["sys.device_hbm_used_gb"] = used / 2**30
        out["sys.device_hbm_limit_gb"] = total / 2**30
        if total:
            out["sys.device_hbm_percent"] = 100.0 * used / total
    return out


class SystemMonitor:
    """Background thread logging ``sample_system()`` into a tracker run every
    ``interval_s`` seconds. Use as a context manager around the training
    loop."""

    def __init__(self, run, interval_s: float = 10.0, device=None):
        self.run = run
        self.interval_s = interval_s
        self.device = device
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._n = 0

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                metrics = sample_system(self.device)
                if self.run is not None and metrics:
                    self.run.log_metrics(metrics, step=self._n)
                self._n += 1
            except Exception:
                pass  # sampling must never take down training
            self._stop.wait(self.interval_s)

    def start(self) -> "SystemMonitor":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="ddw-sysmon", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if not self._thread.is_alive():
                self._thread = None
            # else: keep the handle so a restart can't spawn a second
            # concurrent sampler double-logging into the run

    def __enter__(self) -> "SystemMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
