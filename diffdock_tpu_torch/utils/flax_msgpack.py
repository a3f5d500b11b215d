"""The msgpack layout of ``flax.serialization.to_bytes``, without msgpack or flax.

A flax checkpoint is one msgpack map: string keys, nested maps, and array
leaves stored as msgpack ext type 1 (``ndarray``) whose payload is itself
msgpack ``[shape, dtype name, raw C-order bytes]``; numpy scalars are ext
type 3 (``npscalar``, the same payload) and Python complex numbers ext
type 2 (``native_complex``, ``[real, imag]``). :func:`to_bytes` writes
exactly the bytes ``flax.serialization.to_bytes`` writes for a tree of
dicts and numpy arrays (``msgpack.packb(..., strict_types=True)``, bin type
on), and :func:`msgpack_restore` reads them back as
``flax.serialization.msgpack_restore`` does. Arrays larger than flax's
chunk size (1 GiB) are stored by flax in chunks; both directions refuse
them.
"""

from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np

EXT_NDARRAY, EXT_NATIVE_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE, in bytes


# ----------------------------------------------------------------- encoder


def _pack_int(out: bytearray, v: int) -> None:
    if -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0 <= v < 0x80:
        out += struct.pack("B", v)
    elif -0x80 <= v < 0:
        out += b"\xd0" + struct.pack("b", v)
    elif 0x80 <= v <= 0xFF:
        out += b"\xcc" + struct.pack("B", v)
    elif -0x8000 <= v < 0:
        out += b"\xd1" + struct.pack(">h", v)
    elif 0xFF < v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif -0x80000000 <= v < 0:
        out += b"\xd2" + struct.pack(">i", v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x8000000000000000 <= v < 0:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int, codes) -> None:
    """A length header: the fix form up to ``fix_max``, else the 8-, 16- or
    32-bit form of ``codes`` (None where the type has no such form)."""
    c8, c16, c32 = codes
    if n <= fix_max:
        out.append(fix_base | n)
    elif c8 is not None and n <= 0xFF:
        out += bytes([c8]) + struct.pack("B", n)
    elif n <= 0xFFFF:
        out += bytes([c16]) + struct.pack(">H", n)
    else:
        out += bytes([c32]) + struct.pack(">I", n)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += b"\xc7" + struct.pack("B", n)
    elif n <= 0xFFFF:
        out += b"\xc8" + struct.pack(">H", n)
    else:
        out += b"\xc9" + struct.pack(">I", n)
    out += struct.pack("b", code) + data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of ndarrays.")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, obj: Any, strict: bool) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(out, obj)
    elif t is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif t is str:
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif t is bytes:
        _pack_len(out, len(obj), 0, -1, (0xC4, 0xC5, 0xC6))
        out += obj
    elif t is list or (t is tuple and not strict):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v, strict)
    elif t is dict:
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k, strict)
            _pack(out, v, strict)
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > MAX_CHUNK_SIZE:
            raise ValueError(f"array of {obj.nbytes} bytes: flax stores it in chunks, which this writer does not")
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    elif t is complex:
        _pack_ext(out, EXT_NATIVE_COMPLEX, packb([obj.real, obj.imag]))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for None, bool, int,
    float, str, bytes, lists and tuples (as arrays) and dicts."""
    out = bytearray()
    _pack(out, obj, strict=False)
    return bytes(out)


def to_bytes(tree: Mapping) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for ``tree``, a
    nested dict with string keys and numpy array (or scalar) leaves."""
    out = bytearray()
    _pack(out, _plain(tree), strict=True)
    return bytes(out)


def _plain(tree):
    """Mappings as dicts with string keys (flax's state dict of a mapping)."""
    if isinstance(tree, Mapping):
        return {str(k): _plain(v) for k, v in tree.items()}
    return tree


# ----------------------------------------------------------------- decoder


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_or_raw(self, n: int):
        raw = self.take(n)
        return raw if self.raw else raw.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        if code == EXT_NATIVE_COMPLEX:
            re, im = unpackb(data)
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not one flax writes")

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_or_raw(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xC7: ("B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
                 0xD9: ("B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "ext":
                return self.ext(n)
            if kind == "str":
                return self.str_or_raw(n)
            if kind == "array":
                return [self.obj() for _ in range(n)]
            return self.map(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"byte 0x{b:02x} at offset {self.pos - 1} is not a msgpack type")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays need ml_dtypes; the port reads float32 checkpoints")
    return np.frombuffer(buffer, dtype=np.dtype(name), count=-1, offset=0).reshape(shape, order="C")


def unpackb(data: bytes, raw: bool = False):
    """One msgpack object (``msgpack.unpackb``, with flax's ext types)."""
    reader = _Reader(data, raw)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes left after the msgpack object")
    return out


def msgpack_restore(data: bytes):
    """The nested dict ``flax.serialization.msgpack_restore`` returns:
    arrays as read-only numpy views of ``data``."""
    tree = unpackb(data)
    _refuse_chunks(tree)
    return tree


def _refuse_chunks(tree) -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError("chunked arrays (over 1 GiB) are not read by the port")
        for v in tree.values():
            _refuse_chunks(v)
