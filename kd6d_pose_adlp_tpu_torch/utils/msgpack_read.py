"""A reader of the JAX package's checkpoint files, flax msgpack, with the
standard library and numpy only (no `msgpack` package is needed).

`flax.serialization.to_bytes` writes a msgpack map of nested maps whose
leaves are arrays, strings, numbers, booleans or nil. Arrays are msgpack
ext type 1: a packed `(shape, dtype name, C-order bytes)` tuple; numpy
scalars are ext type 3, the same tuple of a 0-d array. `read_msgpack`
decodes that subset into nested dicts of numpy arrays, as
`flax.serialization.msgpack_restore` does.

Two forms are refused, each with the reason in the message: chunked leaves
(`__msgpack_chunked_array__`, which flax writes for an array of 1 GiB or
more) and bfloat16 arrays (numpy has no such dtype). Neither occurs in this
package's models: their largest leaf is darknet53's 18 MiB 3x3 kernel, and
they keep their parameters in float32.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"


def is_msgpack_map(head: bytes) -> bool:
    """True if `head` (a file's first byte or more) starts a msgpack map:
    fixmap 0x80-0x8f, map16 0xde or map32 0xdf. A `torch.save` file starts
    with a zip header ("PK", 0x50), never one of these."""
    return len(head) > 0 and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf))


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data ends early (at byte {self.pos} of "
                             f"{len(self.buf)}, {n} more needed)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Tuple:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b == 0xc2:
            return False
        if b == 0xc3:
            return True
        if b in (0xc4, 0xc5, 0xc6):
            (n,) = self.unpack(">" + "BHI"[b - 0xc4])
            return bytes(self.take(n))
        if b in (0xc7, 0xc8, 0xc9):
            (n,) = self.unpack(">" + "BHI"[b - 0xc7])
            (code,) = self.unpack(">b")
            return self.ext(code, self.take(n))
        if b == 0xca:
            return self.unpack(">f")[0]
        if b == 0xcb:
            return self.unpack(">d")[0]
        if 0xcc <= b <= 0xcf:
            return self.unpack(">" + "BHIQ"[b - 0xcc])[0]
        if 0xd0 <= b <= 0xd3:
            return self.unpack(">" + "bhiq"[b - 0xd0])[0]
        if 0xd4 <= b <= 0xd8:
            (code,) = self.unpack(">b")
            return self.ext(code, self.take(1 << (b - 0xd4)))
        if 0xd9 <= b <= 0xdb:
            (n,) = self.unpack(">" + "BHI"[b - 0xd9])
            return self.str(n)
        if b in (0xdc, 0xdd):
            (n,) = self.unpack(">" + "HI"[b - 0xdc])
            return self.array(n)
        if b in (0xde, 0xdf):
            (n,) = self.unpack(">" + "HI"[b - 0xde])
            return self.map(n)
        raise ValueError(f"msgpack type byte 0x{b:02x} at {self.pos - 1} is not "
                         "part of what flax.serialization writes")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        if CHUNKED_KEY in out:
            raise ValueError(
                "chunked array leaf (__msgpack_chunked_array__): flax splits only "
                "arrays of 1 GiB or more, and no model of this package has one "
                "(darknet53's largest leaf is 18 MiB); this reader does not "
                "join chunks")
        return out

    def ext(self, code: int, payload: memoryview):
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code}: only flax's ndarray (1) "
                             "and numpy scalar (3) are read")
        inner = _Reader(payload)
        shape, dtype_name, data = inner.obj()
        if dtype_name == "bfloat16":
            raise ValueError(
                "bfloat16 array leaf: numpy has no bfloat16 dtype, and this "
                "package's models keep their parameters and statistics in float32")
        arr = np.frombuffer(data, dtype=np.dtype(dtype_name)).reshape(tuple(shape))
        return arr[()] if code == EXT_NPSCALAR else arr


def read_msgpack(data: bytes) -> Any:
    """Decode flax msgpack bytes into nested dicts of numpy arrays
    (read-only, as flax's are)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after the msgpack object")
    return out


def read_msgpack_file(path: str) -> Any:
    with open(path, "rb") as f:
        return read_msgpack(f.read())
