"""ctypes bindings of the native JPEG decode pipeline (``pipeline.cpp``) —
the port of ``ddw_tpu.native.decode``.

JPEG -> RGB -> bilinear resize -> [-1, 1] f32, for one image or a whole
batch on a C++ thread pool (one GIL release per batch). The source is
``ddw_tpu``'s, so both packages give the same pixels bit for bit. Callers
fall back to PIL where libjpeg or g++ is missing (:func:`build_error` says
why) or an image fails to decode; training and serving go through the same
dispatch (:func:`ddw_tpu_torch.data.loader.preprocess_image`), so they agree.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ddw_tpu_torch.native.build import LazyLibrary


def _configure(lib: ctypes.CDLL) -> None:
    lib.ddws_decode_one.restype = ctypes.c_int
    lib.ddws_decode_one.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.ddws_decode_batch.restype = ctypes.c_long
    lib.ddws_decode_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_ubyte)]


_library = LazyLibrary("pipeline.cpp", extra_flags=("-ljpeg",),
                       configure=_configure)


def native_available() -> bool:
    return _library.available()


def build_error() -> str | None:
    """Why the pipeline did not build or load here (None when it did, or
    before the first use)."""
    return _library.error


def decode_one_native(content: bytes, height: int,
                      width: int) -> np.ndarray | None:
    """Decode one JPEG to float32 [H, W, 3] in [-1, 1]; None on failure."""
    lib = _library.load()
    if lib is None:
        return None
    out = np.empty((height, width, 3), np.float32)
    rc = lib.ddws_decode_one(
        content, len(content), height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def decode_batch_native(
    contents: list[bytes], height: int, width: int, threads: int = 4,
    out: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Decode a batch of JPEGs on the C++ thread pool.

    Returns ``(images [N, H, W, 3] f32, ok [N] bool)`` — failed slots are
    left uninitialised and flagged False (callers re-decode them with PIL) —
    or None where the library is unavailable. ``out`` reuses a caller
    buffer, which must be a writeable C-contiguous float32 ``[N, H, W, 3]``
    array: the library writes through its raw pointer."""
    lib = _library.load()
    if lib is None:
        return None
    n = len(contents)
    if out is None:
        out = np.empty((n, height, width, 3), np.float32)
    else:
        if out.dtype != np.float32:
            raise ValueError(f"out must be float32, got {out.dtype}")
        if out.shape != (n, height, width, 3):
            raise ValueError(
                f"out shape {out.shape} != {(n, height, width, 3)}")
        if not out.flags.c_contiguous:
            raise ValueError("out must be C-contiguous")
        if not out.flags.writeable:
            raise ValueError("out must be writeable")
    ok = np.zeros((n,), np.uint8)
    if n == 0:
        return out, ok.astype(bool)
    offsets = np.zeros((n + 1,), np.int64)
    np.cumsum([len(c) for c in contents], out=offsets[1:])
    blob = b"".join(contents)
    lib.ddws_decode_batch(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n,
        height, width, threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return out, ok.astype(bool)
