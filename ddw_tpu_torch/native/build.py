"""Lazy g++ build and load of the port's host libraries (the shard codec and
the JPEG decode pipeline) — the port of ``ddw_tpu.native.build``.

Each source under ``native/`` has a plain C interface, loaded with ``ctypes``.
It is built with g++ at first use into ``native/build/`` (git-ignored; the
JAX package builds next to its sources). A failed build latches, and callers
fall back to the pure-Python paths: native code is a host performance tier,
not a correctness dependency. :attr:`LazyLibrary.error` keeps the reason, so
a caller can report why the fallback was taken.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "build")


class LazyLibrary:
    """Builds ``native/<source>`` into ``native/build/`` with g++ on first
    use (when the library is missing or older than its source), then loads
    it.

    ``configure(cdll)`` sets restype/argtypes once after the load.
    Thread-safe; processes that build at the same time write to a per-pid
    temporary file and ``os.replace`` it, so no process loads a half-written
    library."""

    def __init__(self, source: str, extra_flags: tuple[str, ...] = (),
                 configure=None):
        self.src = os.path.join(_HERE, source)
        self.lib_path = os.path.join(
            BUILD_DIR, f"lib{os.path.splitext(source)[0]}.so")
        self.extra_flags = tuple(extra_flags)
        self.configure = configure
        self.error: str | None = None
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._failed = False

    def _build(self) -> bool:
        tmp = f"{self.lib_path}.{os.getpid()}.tmp"
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", self.src,
                 "-o", tmp, *self.extra_flags],
                check=True, capture_output=True, text=True, timeout=120)
            os.replace(tmp, self.lib_path)
            return True
        except subprocess.CalledProcessError as e:
            self.error = f"g++ failed: {e.stderr.strip()[-2000:]}"
        except Exception as e:  # no g++, a timeout, an unwritable directory
            self.error = f"{type(e).__name__}: {e}"
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False

    def load(self) -> ctypes.CDLL | None:
        with self._lock:
            if self._lib is not None or self._failed:
                return self._lib
            try:
                stale = (not os.path.exists(self.lib_path)
                         or os.path.getmtime(self.lib_path)
                         < os.path.getmtime(self.src))
            except OSError:
                # source missing (a deployment shipping only the built
                # library): use it if present, else latch the failure
                stale = not os.path.exists(self.lib_path)
            if stale and not self._build():
                self._failed = True
                return None
            try:
                lib = ctypes.CDLL(self.lib_path)
                if self.configure is not None:
                    self.configure(lib)
                self._lib = lib
            except Exception as e:
                self.error = f"loading {self.lib_path}: {e}"
                self._failed = True
        return self._lib

    def available(self) -> bool:
        return self.load() is not None
