"""Reader of the JAX package's ``.ckpt`` files: flax's msgpack encoding of
a parameter tree (``flax.serialization.to_bytes``), in plain Python.

The port does not depend on ``msgpack`` or flax. A ``.ckpt`` is one msgpack
map of maps whose leaves are ndarrays in flax's extension type 1: a packed
(shape, dtype name, C-order buffer) triple. Type 3 (a numpy scalar, the
same triple with shape ()) is read too. The decoder covers the msgpack
types such a file holds: nil, booleans, integers, floats, strings, bin,
arrays, maps and ext. Arrays above 2 GiB, which flax splits into chunks,
are refused.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return bytes(self.take(self.unpack(sizes[b - 0xC4])))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return self.str(self.unpack(sizes[b - 0xD9]))
        if b in (0xDC, 0xDD):  # array 16/32
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (b - 0xD4))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            return self.ext(self.unpack(sizes[b - 0xC7]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unknown extension type {code}")
        arr = _ndarray(payload)
        return arr if code == _EXT_NDARRAY else arr[()]


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype, buf = unpackb(payload)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        raise ValueError("msgpack: bfloat16 arrays are not read (the JAX "
                         "package saves float32 parameters)")
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """Decode one msgpack value that spans all of ``data``."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes after the value")
    return out


def restore(data: bytes) -> dict:
    """The parameter tree of ``flax.serialization.to_bytes(tree)``: nested
    dicts of numpy arrays (flax's ``msgpack_restore``)."""
    tree = unpackb(data)

    def check(node: Any) -> None:
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError("msgpack: chunked arrays (> 2 GiB) are not "
                                 "read")
            for v in node.values():
                check(v)

    check(tree)
    return tree

