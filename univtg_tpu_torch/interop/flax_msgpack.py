"""Reader of the JAX package's checkpoints: the msgpack subset that flax's
``serialization.to_bytes`` writes, in plain Python over ``struct`` and numpy
(no ``msgpack`` package).

The subset: maps, arrays, str, bin, ints, floats, nil and bool; ext 1 (an
ndarray, itself a packed ``(shape, dtype name, bytes)``) and ext 3 (a numpy
scalar, packed as a 0-d ndarray); flax's ``__msgpack_chunked_array__`` maps,
which split a leaf over 2**30 bytes, joined back. ``bfloat16`` arrays are
read from their raw bytes and widened to float32, exactly (a bfloat16 is
the high half of a float32). Any other type code or dtype raises
ValueError. ``read(path)`` returns what flax's ``msgpack_restore`` returns:
nested dicts (msgpack arrays as lists) with numpy leaves.
"""
from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


def is_msgpack_map(head: bytes) -> bool:
    """Whether a file's first byte opens a msgpack map (fixmap, map16 or
    map32), as a flax checkpoint's does; a torch zip starts with ``PK``."""
    return len(head) > 0 and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def _dtype(name: str):
    if name == "bfloat16":
        return "bfloat16"
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"flax msgpack: unknown dtype {name!r}") from None
    if dt.hasobject:
        raise ValueError(f"flax msgpack: object dtype {name!r}")
    return dt


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buf = _Unpacker(payload, raw=True).unpack_all()
    name = name.decode() if isinstance(name, bytes) else name
    dt = _dtype(name)
    if dt == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=dt).reshape(shape).copy()


class _Unpacker:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax packs an ndarray's dtype name so)

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("flax msgpack: truncated data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def unpack_all(self):
        out = self.unpack()
        if self.pos != len(self.data):
            raise ValueError("flax msgpack: trailing bytes")
        return out

    def unpack(self):
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self.str(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        sized = {  # code -> (length format, reader)
            0xC4: (">B", self.take), 0xC5: (">H", self.take), 0xC6: (">I", self.take),
            0xD9: (">B", self.str), 0xDA: (">H", self.str), 0xDB: (">I", self.str),
            0xDC: (">H", self.array), 0xDD: (">I", self.array),
            0xDE: (">H", self.map), 0xDF: (">I", self.map),
        }
        if c in sized:
            fmt, read = sized[c]
            return read(self.num(fmt))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in scalars:
            return self.num(scalars[c])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self.ext(fixext[c])
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if c in ext:
            return self.ext(self.num(ext[c]))
        raise ValueError(f"flax msgpack: unsupported type code 0x{c:02x}")

    def str(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def array(self, n: int):
        return [self.unpack() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.unpack()
            out[k] = self.unpack()
        return out

    def ext(self, n: int):
        code = self.num(">b")
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"flax msgpack: unsupported ext type {code}")


def _unchunk(tree):
    """flax's chunked-array maps back to arrays, everywhere in the tree."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def loads(data: bytes):
    """msgpack_restore of ``data``."""
    return _unchunk(_Unpacker(data).unpack_all())


def read(path: str):
    """msgpack_restore of a file's bytes."""
    with open(path, "rb") as f:
        return loads(f.read())
