"""A small msgpack reader and writer for flax weight blobs.

The JAX package stores weights as ``flax.serialization.to_bytes`` of the
``{"params", "batch_stats"}`` tree: msgpack maps of str keys whose leaves
are numpy arrays packed as ext type 1, the payload being the msgpack of
``(shape, dtype_name, raw C-order bytes)``. This module reads and writes
that layout with the standard library and numpy alone, so loading an
archive needs no ``msgpack`` package.

Covered: maps, arrays, str, bin, bool, ints, floats, nil, ext type 1
(ndarray) and ext type 3 (numpy scalar). Not covered: flax's chunked-array
maps, which it writes only for leaves above 1 GiB (the largest leaf at the
app config holds 262,144 floats).
"""

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray_from_payload(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 leaves are not supported by this reader")
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data truncated")
        out = self.data[self.pos : self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack_fmt(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def ext(self, size: int) -> Any:
        code = self.unpack_fmt(">b")
        payload = self.take(size)
        if code == _EXT_NDARRAY:
            return _ndarray_from_payload(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_payload(payload)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack_fmt(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "ext":
                return self.ext(n)
            return self.array(n) if kind == "array" else self.map(n)
        scalars = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in scalars:
            return self.unpack_fmt(scalars[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (the whole of ``data``)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def msgpack_restore(data: bytes) -> Any:
    """Decode a flax msgpack blob into nested dicts of numpy arrays (the
    counterpart of ``flax.serialization.msgpack_restore``)."""
    return unpackb(data)


def _pack_len(n: int, fix: Tuple[int, int], codes: Tuple[int, int, int]) -> bytes:
    fix_base, fix_max = fix
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    if codes[0] is not None and n < 1 << 8:
        return bytes([codes[0]]) + struct.pack(">B", n)
    if n < 1 << 16:
        return bytes([codes[1]]) + struct.pack(">H", n)
    return bytes([codes[2]]) + struct.pack(">I", n)


def _pack_int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                return bytes([code]) + struct.pack(fmt, v)
    for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                           (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
        if -lim <= v:
            return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(v)


def _pack_ext(code: int, payload: bytes) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    if n in fixext:
        head = bytes([fixext[n]])
    else:
        head = _pack_len(n, (None, -1), (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + payload


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        # (not np.ascontiguousarray: it makes a 0-d array 1-d)
        payload = packb([list(obj.shape), obj.dtype.name, obj.tobytes("C")])
        out.append(_pack_ext(_EXT_NDARRAY, payload))
    elif isinstance(obj, np.generic):
        payload = packb([[], obj.dtype.name, np.asarray(obj).tobytes("C")])
        out.append(_pack_ext(_EXT_NPSCALAR, payload))
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode()
        out.append(_pack_len(len(raw), (0xA0, 31), (0xD9, 0xDA, 0xDB)) + raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_pack_len(len(obj), (None, -1), (0xC4, 0xC5, 0xC6)) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_len(len(obj), (0x90, 15), (None, 0xDC, 0xDD)))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_pack_len(len(obj), (0x80, 15), (None, 0xDE, 0xDF)))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode ``obj`` as msgpack, numpy arrays as flax's ext type 1 (so
    ``flax.serialization.msgpack_restore`` reads the result)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)
