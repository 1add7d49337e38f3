"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``.cu`` under ``ops/csrc`` exposes a plain C interface and is compiled on
its own into a shared library (``nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -shared -Xcompiler -fPIC``), loaded with ``ctypes``. Libraries land in
``ops/build/`` (git-ignored), named by a hash of the source and the flags, so
an edited source rebuilds and an unchanged one is reused. There is no fallback:
a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
_NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), _NVCC_FALLBACK):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the port's CUDA kernels are "
                       "built from source at first use")


def library_path(source: str) -> str:
    """Where the library built from ``csrc/<source>`` lives."""
    with open(os.path.join(CSRC, source), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build(source: str) -> tuple[str, float, str]:
    """Compile ``csrc/<source>`` unless its library exists. Returns the
    library path, the seconds spent compiling (0.0 when reused) and the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)."""
    out = library_path(source)
    log = out + ".log"
    if os.path.exists(out):
        with open(log) as f:
            return out, 0.0, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{source}:\n{' '.join(cmd)}\n{report}")
    with open(log, "w") as f:
        f.write(report)
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out, seconds, report


def load(source: str) -> ctypes.CDLL:
    """Build if needed, then load the library of ``csrc/<source>``."""
    path, _, _ = build(source)
    return ctypes.CDLL(path)
