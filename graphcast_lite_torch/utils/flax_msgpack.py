"""Reader of the bytes ``flax.serialization.to_bytes`` writes, in plain
Python and NumPy (the counterpart of ``flax.serialization.msgpack_restore``
for a machine without ``msgpack`` or ``flax``).

``msgpack_restore(data)`` decodes the msgpack types flax emits (nil, bool,
int, float, str, bin, array, map and ext) and flax's three ext types:

* 1, ndarray: a nested msgpack array ``(shape, dtype name, C-order bytes)``;
* 2, native complex: a nested msgpack array ``(real, imag)``;
* 3, NumPy scalar: an ndarray payload of shape ``()``.

It then joins the arrays that flax split over ``MAX_CHUNK_SIZE`` (the
``__msgpack_chunked_array__`` dicts) and returns nested dicts (and lists)
of NumPy arrays and Python scalars.  NumPy has no bfloat16, so bfloat16
arrays come back as float32 (every bfloat16 value is exact in float32).
Anything flax does not write (other ext codes, the reserved byte 0xc1,
trailing bytes) raises ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

__all__ = ["msgpack_restore", "load_msgpack"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """msgpack decoder over one buffer.  ``raw`` keeps str payloads as
    bytes (how flax decodes the nested ndarray tuples)."""

    def __init__(self, data, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        decode = _TYPES.get(b)
        if decode is None:
            raise ValueError(f"byte 0x{b:02x} is not a msgpack type")
        return decode(self)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


# Decoders of the msgpack type bytes outside the fixed ranges.
_TYPES = {
    0xC0: lambda r: None, 0xC2: lambda r: False, 0xC3: lambda r: True,
    0xC4: lambda r: bytes(r.take(r.unpack(">B"))),
    0xC5: lambda r: bytes(r.take(r.unpack(">H"))),
    0xC6: lambda r: bytes(r.take(r.unpack(">I"))),
    0xC7: lambda r: r.ext(r.unpack(">B")),
    0xC8: lambda r: r.ext(r.unpack(">H")),
    0xC9: lambda r: r.ext(r.unpack(">I")),
    0xCA: lambda r: r.unpack(">f"),
    0xCB: lambda r: r.unpack(">d"),
    0xCC: lambda r: r.unpack(">B"),
    0xCD: lambda r: r.unpack(">H"),
    0xCE: lambda r: r.unpack(">I"),
    0xCF: lambda r: r.unpack(">Q"),
    0xD0: lambda r: r.unpack(">b"),
    0xD1: lambda r: r.unpack(">h"),
    0xD2: lambda r: r.unpack(">i"),
    0xD3: lambda r: r.unpack(">q"),
    0xD4: lambda r: r.ext(1),
    0xD5: lambda r: r.ext(2),
    0xD6: lambda r: r.ext(4),
    0xD7: lambda r: r.ext(8),
    0xD8: lambda r: r.ext(16),
    0xD9: lambda r: r.str_(r.unpack(">B")),
    0xDA: lambda r: r.str_(r.unpack(">H")),
    0xDB: lambda r: r.str_(r.unpack(">I")),
    0xDC: lambda r: r.array(r.unpack(">H")),
    0xDD: lambda r: r.array(r.unpack(">I")),
    0xDE: lambda r: r.map_(r.unpack(">H")),
    0xDF: lambda r: r.map_(r.unpack(">I")),
}


def _decode(data, raw: bool = False) -> Any:
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the "
                         "msgpack object")
    return out


def _ndarray(payload) -> np.ndarray:
    shape, name, buffer = _decode(payload, raw=True)
    name = name.decode("ascii")
    if name == "bfloat16":
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"unknown array dtype {name!r}") from None
    if dtype.hasobject or dtype.fields is not None:
        raise ValueError(f"flax writes no arrays of dtype {name!r}")
    return np.frombuffer(buffer, dtype).reshape(shape).copy()


def _ext(code: int, payload) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == _EXT_COMPLEX:
        real, imag = _decode(payload)
        return complex(real, imag)
    raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _indexed(d: dict) -> Tuple:
    """flax's tuple-as-dict ``{"0": a, "1": b, ...}`` -> (a, b, ...)."""
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = _indexed(tree["shape"])
            return np.concatenate(_indexed(tree["chunks"])).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def msgpack_restore(data) -> Any:
    """The tree ``flax.serialization.to_bytes`` wrote into ``data``."""
    return _unchunk(_decode(data))


def load_msgpack(path: str) -> Any:
    """``msgpack_restore`` of a file's bytes."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
