"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``.cu`` under ``ops/csrc`` exposes a plain C interface and is compiled on
its own into a shared library (``nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -shared -Xcompiler -fPIC``), loaded with ``ctypes``; sources may share
``.cuh`` headers of the same directory. Libraries land in ``ops/build/``
(git-ignored), named by a hash of the source, the headers it includes and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. A source that declares ``// nvcc parts: N`` is compiled N times at
once, with ``-DDDW_PART=p``, into objects linked into its one library (each
part instantiates a share of its kernels; see ``csrc/flash_common.cuh``).
There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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


def local_headers(source: str) -> list[str]:
    """The ``csrc`` headers ``csrc/<source>`` includes by ``#include "..."``
    (one level: the headers include none of their own)."""
    with open(os.path.join(CSRC, source)) as f:
        return re.findall(r'^#include "([^"]+)"', f.read(), re.M)


def parts(source: str) -> int:
    """How many translation units ``csrc/<source>`` is compiled as."""
    with open(os.path.join(CSRC, source)) as f:
        m = re.search(r"^// nvcc parts: (\d+)$", f.read(), re.M)
    return int(m.group(1)) if m else 1


def library_path(source: str) -> str:
    """Where the library built from ``csrc/<source>`` lives."""
    h = hashlib.sha256()
    for name in (source, *local_headers(source)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
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
    nvcc, src, n = find_nvcc(), os.path.join(CSRC, source), parts(source)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = os.path.join(work, "lib.so")
        t0 = time.perf_counter()
        if n == 1:
            report = _run([nvcc, *NVCC_FLAGS, "-o", tmp, src], source)
        else:
            flags = ["-c" if f == "-shared" else f for f in NVCC_FLAGS]
            objs = [os.path.join(work, f"part{p}.o") for p in range(n)]
            with ThreadPoolExecutor(max_workers=n) as pool:
                reports = list(pool.map(lambda p: _run(
                    [nvcc, *flags, f"-DDDW_PART={p}", "-o", objs[p], src],
                    source), range(n)))
            report = "".join(reports) + _run(
                [nvcc, "-shared", "-o", tmp, *objs], source)
        seconds = time.perf_counter() - t0
        with open(log, "w") as f:
            f.write(report)
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
    return out, seconds, report


def _run(cmd: list, source: str) -> str:
    """One nvcc command; its output, or a raise naming the source."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{source}:\n{' '.join(cmd)}\n{report}")
    return report


def load(source: str) -> ctypes.CDLL:
    """Build if needed, then load the library of ``csrc/<source>``."""
    path, _, _ = build(source)
    return ctypes.CDLL(path)
