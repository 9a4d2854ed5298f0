"""Read the msgpack files the JAX package's checkpoints are (flax's
``serialization.to_bytes`` of its ``TrainState``), with the standard library
and numpy only.

The decoder covers what flax writes: nil, booleans, integers, floats,
strings, binaries, arrays, maps and flax's extension types (1 ndarray,
2 complex, 3 numpy scalar), and joins the chunked form flax gives arrays
above 2**30 bytes.  An ndarray extension holds the msgpack triple (shape,
dtype name, C-order bytes); bfloat16 arrays are widened to float32 (numpy
has no bfloat16).
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.at = 0

    def take(self, n: int) -> bytes:
        if self.at + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.at:self.at + n].tobytes()
        self.at += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
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
            return self.take(b & 0x1F).decode("utf-8")
        if b in _FIXED:
            return _FIXED[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "bin":
                return self.take(n)
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray(data)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            re, im = unpackb(data)
            return complex(re, im)
        raise ValueError(f"msgpack: unknown extension type {code}")


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
            0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
_SIZED = {0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
          0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
          0xDC: ("array", "H"), 0xDD: ("array", "I"),
          0xDE: ("map", "H"), 0xDF: ("map", "I"),
          0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _unchunk(node):
    """Join flax's chunked arrays (``__msgpack_chunked_array__`` dicts)."""
    if not isinstance(node, dict):
        return node
    if node.get("__msgpack_chunked_array__"):
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def unpackb(data: bytes):
    """One msgpack value from ``data`` (which must hold nothing else)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.at != len(reader.data):
        raise ValueError("msgpack: trailing bytes")
    return out


def restore(data: bytes):
    """flax's ``msgpack_restore``: the nested dict of numpy arrays and
    Python values a ``to_bytes`` blob holds."""
    return _unchunk(unpackb(data))
