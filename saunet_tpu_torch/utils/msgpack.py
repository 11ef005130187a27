"""Reader of the msgpack that `flax.serialization.to_bytes` writes: the JAX
package's checkpoints (saunet_tpu/train/checkpoint.py). It needs neither
flax nor the msgpack package.

msgpack types: nil, bool, ints and floats of every width, str, bin, array
and map in their fix/8/16/32 forms, and ext. flax's ext codes:

  1  ndarray: the payload is msgpack of (shape, dtype name, C-order bytes)
  2  a native complex: msgpack of (real, imag)
  3  a numpy scalar: an ndarray of shape (), returned as `arr[()]`

An array is `np.frombuffer` on a memoryview of the input, so a leaf is a
read-only view of the buffer, not a copy. numpy has no bfloat16: such an
array becomes a `torch.bfloat16` tensor (a copy, through a uint16 view).
flax writes an array above 2**30 bytes as a map
`{'__msgpack_chunked_array__': True, 'shape': {'0': ..}, 'chunks': {'0':
..}}`; such a map is joined back into one array. A type byte or ext code
not listed here, a truncated input and trailing bytes raise ValueError with
the offset.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

# type byte -> struct format of a fixed-width scalar
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# type byte -> (kind, struct format of its length or count)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
# fixext type byte -> payload length
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    """One pass over `view` from `base` (the view's offset in the whole
    input, for error messages). `bin_views` returns bin as memoryviews (the
    ndarray payload's data) instead of bytes."""

    def __init__(self, view: memoryview, base: int = 0,
                 bin_views: bool = False):
        self.view, self.pos, self.base = view, 0, base
        self.bin_views = bin_views

    def fail(self, msg: str, at: int):
        raise ValueError(f"msgpack: {msg} at offset {self.base + at}")

    def take(self, n: int) -> memoryview:
        start = self.pos
        if start + n > len(self.view):
            self.fail(f"truncated input (need {n} bytes)", start)
        self.pos = start + n
        return self.view[start:start + n]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0x8f:
            return self.mapping(b & 0x0f)
        if b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if b <= 0xbf:
            return self.text(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _FIXEXT:
            return self.ext(self.unpack(">b"), _FIXEXT[b], at)
        if b not in _SIZED:
            self.fail(f"unknown type byte 0x{b:02x}", at)
        kind, fmt = _SIZED[b]
        n = self.unpack(fmt)
        if kind == "bin":
            data = self.take(n)
            return data if self.bin_views else bytes(data)
        if kind == "str":
            return self.text(n)
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "map":
            return self.mapping(n)
        return self.ext(self.unpack(">b"), n, at)

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def mapping(self, n: int):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return _unchunk(out) if CHUNKED in out else out

    def ext(self, code: int, n: int, at: int):
        base = self.base + self.pos
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload, base)
        if code == EXT_NPSCALAR:
            return _ndarray(payload, base)[()]
        if code == EXT_COMPLEX:
            real, imag = _Reader(payload, base).read()
            return complex(real, imag)
        self.fail(f"unknown ext code {code}", at)


def _ndarray(payload: memoryview, base: int):
    shape, name, data = _Reader(payload, base, bin_views=True).read()
    if isinstance(name, (bytes, memoryview)):
        name = str(name, "ascii")
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(data, np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"msgpack: unknown ndarray dtype {name!r} at "
                         f"offset {base}") from None
    return np.frombuffer(data, dtype).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def loads(data) -> Any:
    """Decode one msgpack object from `data` (bytes, bytearray or a
    memoryview of bytes); the whole input must be that object."""
    reader = _Reader(memoryview(data).cast("B"))
    out = reader.read()
    if reader.pos != len(reader.view):
        reader.fail("trailing bytes", reader.pos)
    return out


def load(path: str) -> Any:
    """Decode the msgpack file at `path` (its arrays are views of one
    buffer holding the file)."""
    with open(path, "rb") as f:
        data = f.read()
    return loads(data)
