"""A minimal msgpack codec for the subset ``flax.serialization`` writes.

Packages store their weights as ``flax.serialization.to_bytes(tree)``: maps
with str keys, nested down to numpy arrays. This module encodes and decodes
that subset without the ``msgpack`` package, byte for byte as
``msgpack.packb`` does (smallest encoding of each value):

- nil, bools, ints, floats (float64 out; float32 and float64 in), str, bin,
  arrays (lists/tuples), maps;
- ext type 1, a numpy ndarray: ``packb((shape, dtype_name, C-order bytes))``;
- ext type 3, a numpy scalar, encoded as a 0-d ndarray.

A ``bfloat16`` array (a dtype numpy lacks) decodes losslessly to float32.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, fix_base: int, fix_max: int, codes: tuple, out) -> None:
    """Header of a length-prefixed family (fix form, then 8/16/32-bit)."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object too large ({n})")


def _ndarray_body(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return packb((tuple(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack_ext(code: int, data: bytes, out) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n < 1 << 8:
        out += bytes((0xC7, n))
    elif n < 1 << 16:
        out.append(0xC8)
        out += struct.pack(">H", n)
    else:
        out.append(0xC9)
        out += struct.pack(">I", n)
    out.append(code)
    out += data


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        b = obj.encode()
        _pack_len(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += b
    elif type(obj) in (bytes, bytearray):
        _pack_len(len(obj), None, -1, (0xC4, 0xC5, 0xC6), out)
        out += obj
    elif type(obj) in (list, tuple):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_body(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_body(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, bound in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < bound:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"int {n} too large for msgpack")
    else:
        for code, fmt, bound in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if n >= -bound:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"int {n} too small for msgpack")


def unpackb(data: bytes):
    obj, pos = _unpack(memoryview(data), 0, raw=False)
    if pos != len(data):
        raise ValueError(f"trailing bytes after msgpack object ({pos} of "
                         f"{len(data)})")
    return obj


def _ndarray_from(body) -> np.ndarray:
    (shape, name, buf), _ = _unpack(body, 0, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}


def _unpack(buf: memoryview, pos: int, raw: bool):
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, pos, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(buf, pos, b & 0x0F, raw)
    if 0xA0 <= b <= 0xBF:
        return _unpack_str(buf, pos, b & 0x1F, raw)
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _FIXED:
        fmt = _FIXED[b]
        n = struct.calcsize(fmt)
        return struct.unpack(fmt, buf[pos:pos + n])[0], pos + n
    lens = {0xC4: 1, 0xC5: 2, 0xC6: 4, 0xD9: 1, 0xDA: 2, 0xDB: 4,
            0xDC: 2, 0xDD: 4, 0xDE: 2, 0xDF: 4, 0xC7: 1, 0xC8: 2, 0xC9: 4}
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in lens:
        w = lens[b]
        n = int.from_bytes(buf[pos:pos + w], "big")
        pos += w
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(buf[pos:pos + n]), pos + n
        if b in (0xD9, 0xDA, 0xDB):
            return _unpack_str(buf, pos, n, raw)
        if b in (0xDC, 0xDD):
            return _unpack_array(buf, pos, n, raw)
        if b in (0xDE, 0xDF):
            return _unpack_map(buf, pos, n, raw)
        return _unpack_ext(buf, pos, n)
    if b in fixext:
        return _unpack_ext(buf, pos, fixext[b])
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _unpack_str(buf, pos, n, raw):
    s = bytes(buf[pos:pos + n])
    return (s if raw else s.decode()), pos + n


def _unpack_array(buf, pos, n, raw):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos, raw)
        out.append(v)
    return out, pos


def _unpack_map(buf, pos, n, raw):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos, raw)
        v, pos = _unpack(buf, pos, raw)
        out[k] = v
    return out, pos


def _unpack_ext(buf, pos, n):
    code = buf[pos]
    body = buf[pos + 1:pos + 1 + n]
    pos += 1 + n
    if code == _EXT_NDARRAY:
        return _ndarray_from(body), pos
    if code == _EXT_NPSCALAR:
        return _ndarray_from(body)[()], pos
    raise ValueError(f"unsupported msgpack ext type {code}")
