"""ctypes bindings of the C++ shard codec (``codec.cpp``) — the port of
``ddw_tpu.native.codec``.

One index pass in C++ over a whole shard buffer; Python slices the buffer.
Where the library does not build or load, :mod:`ddw_tpu_torch.data.store`
reads shards with its pure-Python framing instead (``DDW_NATIVE_CODEC=0``
forces that); both give the same records.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ddw_tpu_torch.data.store import Record
from ddw_tpu_torch.native.build import LazyLibrary


class _RecordIndex(ctypes.Structure):
    _fields_ = [
        ("path_off", ctypes.c_int64), ("path_len", ctypes.c_int64),
        ("content_off", ctypes.c_int64), ("content_len", ctypes.c_int64),
        ("label_off", ctypes.c_int64), ("label_len", ctypes.c_int64),
        ("label_idx", ctypes.c_int32), ("_pad", ctypes.c_int32),
    ]


def _configure(lib: ctypes.CDLL) -> None:
    lib.ddws_index_shard.restype = ctypes.c_int64
    lib.ddws_index_shard.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(_RecordIndex), ctypes.c_int64]
    lib.ddws_count_records.restype = ctypes.c_int64
    lib.ddws_count_records.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.ddws_validate.restype = ctypes.c_int64
    lib.ddws_validate.argtypes = [ctypes.c_char_p, ctypes.c_int64]


_library = LazyLibrary("codec.cpp", configure=_configure)


def native_available() -> bool:
    return _library.available()


def _index(path: str):
    lib = _library.load()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    with open(path, "rb") as f:
        buf = f.read()
    n = lib.ddws_count_records(buf, len(buf))
    if n < 0:
        raise RuntimeError(f"{path}: native codec header error {n}")
    # The header's count is untrusted until the framing walk validates it:
    # a record is at least 16 bytes (3 length prefixes + label_idx).
    if n > (len(buf) - 12) // 16:
        raise RuntimeError(f"{path}: native codec header error "
                           f"(implausible count {n})")
    idx = (_RecordIndex * n)()
    rc = lib.ddws_index_shard(buf, len(buf), idx, n)
    if rc < 0:
        raise RuntimeError(f"{path}: native codec parse error {rc}")
    arr = np.ctypeslib.as_array(
        ctypes.cast(idx, ctypes.POINTER(ctypes.c_int64)), shape=(n, 7))
    return buf, arr


def read_shard_contents_native(path: str) -> list[tuple[bytes, int]]:
    """The loader's hot path: ``(content, label_idx)`` only, no path/label
    decoding and no ``Record``s."""
    buf, arr = _index(path)
    co = arr[:, 2].tolist()
    cl = arr[:, 3].tolist()
    li = (arr[:, 6] & 0xFFFFFFFF).astype("int32").tolist()
    return [(buf[o:o + n], i) for o, n, i in zip(co, cl, li)]


def read_shard_native(path: str) -> list[Record]:
    """A whole shard through the C++ index pass. Raises RuntimeError on
    codec errors, and where the library is unavailable."""
    buf, arr = _index(path)
    out = []
    for po, pl_, co, cl, lo, ll, packed in arr.tolist():
        out.append(Record(
            path=buf[po:po + pl_].decode(),
            content=buf[co:co + cl],
            label=buf[lo:lo + ll].decode(),
            label_idx=ctypes.c_int32(packed & 0xFFFFFFFF).value,
        ))
    return out
