"""Flax's msgpack checkpoint format, read and written in the port's own
Python (no ``msgpack``, ``flax`` or ``jax``).

``packb(tree)`` gives the bytes of ``flax.serialization.msgpack_serialize``
and ``unpackb(data)`` the tree of ``flax.serialization.msgpack_restore``
(what the JAX package's ``utils/checkpoint.py`` ``save_params`` /
``load_params`` write and read):

* the tree is dicts (string keys, written in sorted order, as a JAX tree
  map rebuilds them), lists, ``None``, bools, ints, floats (float64),
  strings (str 8/16/32 with the bin type on), bytes (bin 8/16/32) and array
  leaves;
* an array is msgpack ext type 1 holding the msgpack tuple (shape, dtype
  name, C-order bytes); a numpy scalar is ext type 3 holding the same for a
  0-d array; a Python complex ext type 2 holding (real, imag). Ext
  payloads use fixext 1/2/4/8/16 where their length fits, else ext
  8/16/32;
* an array leaf of a dict over ``MAX_CHUNK_SIZE`` bytes is stored as the
  dict ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
  "chunks": {"0": flat chunk, ...}}`` and joined back on reading.

Array leaves read back as numpy arrays, except ``bfloat16`` (which numpy
lacks): a ``torch.bfloat16`` tensor. The writer takes numpy arrays and
scalars and torch tensors (a bfloat16 tensor is written with the dtype
name ``bfloat16``, as a JAX bfloat16 array is).
"""

from __future__ import annotations

import struct
from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class ExtType(NamedTuple):
    """An ext payload of a type code this format does not define."""

    code: int
    data: bytes


# ---------------------------------------------------------------- writing


def _pack_int(out: bytearray, v: int) -> None:
    if v > 0:  # msgpack's unsigned forms
        if v < 0x80:
            out.append(v)
        elif v < 0x100:
            out += b"\xcc" + struct.pack(">B", v)
        elif v < 0x10000:
            out += b"\xcd" + struct.pack(">H", v)
        elif v < 0x100000000:
            out += b"\xce" + struct.pack(">I", v)
        else:
            out += b"\xcf" + struct.pack(">Q", v)
    elif v >= -32:
        out += struct.pack(">b", v)
    elif v >= -0x80:
        out += b"\xd0" + struct.pack(">b", v)
    elif v >= -0x8000:
        out += b"\xd1" + struct.pack(">h", v)
    elif v >= -0x80000000:
        out += b"\xd2" + struct.pack(">i", v)
    else:
        out += b"\xd3" + struct.pack(">q", v)


def _pack_len(out: bytearray, n: int, small: Tuple[int, int], forms: Tuple[int, ...]) -> None:
    """A length header: the fix form ``base | n`` below ``small``'s bound
    (a bound of 0: no fix form), else the 8-, 16- and 32-bit forms of
    ``forms`` (an 8-bit form of 0: none)."""
    bound, base = small
    if bound and n < bound:
        out.append(base | n)
    elif forms[0] and n < 0x100:
        out += bytes([forms[0], n])
    elif n < 0x10000:
        out += bytes([forms[1]]) + struct.pack(">H", n)
    else:
        out += bytes([forms[2]]) + struct.pack(">I", n)


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    _pack_len(out, len(b), (32, 0xA0), (0xD9, 0xDA, 0xDB))
    out += b


def _pack_bin(out: bytearray, b: bytes) -> None:
    _pack_len(out, len(b), (0, 0), (0xC4, 0xC5, 0xC6))
    out += b


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(fixed[n])
    elif n < 0x100:
        out += bytes([0xC7, n])
    elif n < 0x10000:
        out += b"\xc8" + struct.pack(">H", n)
    else:
        out += b"\xc9" + struct.pack(">I", n)
    out += struct.pack(">b", code) + data


def _array_parts(a) -> Tuple[Tuple[int, ...], str, bytes]:
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        a = t.numpy()
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of ndarrays.")
    return tuple(int(s) for s in a.shape), a.dtype.name, a.tobytes("C")


def _ndarray_bytes(a) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes)."""
    shape, name, buf = _array_parts(a)
    out = bytearray()
    out.append(0x93)
    _pack_len(out, len(shape), (16, 0x90), (0, 0xDC, 0xDD))
    for s in shape:
        _pack_int(out, s)
    _pack_str(out, name)
    _pack_bin(out, buf)
    return bytes(out)


def _pack(out: bytearray, x: Any) -> None:
    """msgpack with ``strict_types=True`` and flax's ext hook."""
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out += b"\xcb" + struct.pack(">d", x)
    elif type(x) is str:
        _pack_str(out, x)
    elif type(x) is bytes:
        _pack_bin(out, x)
    elif type(x) is dict:
        _pack_len(out, len(x), (16, 0x80), (0, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif type(x) is list:
        _pack_len(out, len(x), (16, 0x90), (0, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif type(x) is complex:
        inner = bytearray(b"\x92")
        for part in (x.real, x.imag):
            inner += b"\xcb" + struct.pack(">d", part)
        _pack_ext(out, EXT_COMPLEX, bytes(inner))
    else:
        raise TypeError(f"can not serialize {type(x).__name__!r} object")


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.size * a.dtype.itemsize


def _chunk(a) -> dict:
    """flax's ``_chunk``: a flat array cut into ``MAX_CHUNK_SIZE``-byte pieces."""
    itemsize = a.element_size() if isinstance(a, torch.Tensor) else a.dtype.itemsize
    size = a.numel() if isinstance(a, torch.Tensor) else a.size
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = a.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(a.shape)},
            "chunks": {str(i): flat[s: s + step] for i, s in enumerate(range(0, size, step))}}


def _prepare(x: Any, top: bool = True) -> Any:
    """Dict keys in sorted order (a JAX tree map's), the oversized array
    leaves of dicts (and a top-level array) chunked."""
    if type(x) is dict:
        out = {}
        for k in sorted(x):
            v = x[k]
            if isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE:
                out[k] = _chunk(v)
            else:
                out[k] = _prepare(v, False)
        return out
    if type(x) is list:
        return [_prepare(v, False) for v in x]
    if top and isinstance(x, (np.ndarray, torch.Tensor)) and _nbytes(x) > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def packb(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree)`` gives."""
    out = bytearray()
    _pack(out, _prepare(tree))
    return bytes(out)


# ---------------------------------------------------------------- reading


class _Reader:
    def __init__(self, data: bytes, raw: bool) -> None:
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos: self.pos + n].tobytes()
        self.pos += n
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.num(">b")
        return _ext(code, self.take(n))

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i",
                 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in fixed:
            return self.num(fixed[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return self.take(self.num(lengths[b]))
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lengths:
            return self.text(self.num(lengths[b]))
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.num(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.num(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lengths:
            return self.ext(self.num(lengths[b]))
        raise ValueError(f"msgpack format byte 0x{b:02x} is not defined")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"{type(k).__name__} is not allowed for map key")
            out[k] = self.value()
        return out


def _unpack(data: bytes, raw: bool = False) -> Any:
    r = _Reader(data, raw)
    v = r.value()
    if r.pos != len(r.data):
        raise ValueError("extra data after the msgpack object")
    return v


def _ndarray_from_bytes(data: bytes):
    shape, name, buf = _unpack(data, raw=True)
    if name == b"bfloat16":
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).reshape(tuple(shape))
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape, order="C")


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_COMPLEX:
        re, im = _unpack(data)
        return complex(re, im)
    if code == EXT_NPSCALAR:
        a = _ndarray_from_bytes(data)
        return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
    return ExtType(code, data)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks: List = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and CHUNKED in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_leaves(v)
    return d


def unpackb(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore(data)`` gives."""
    return _unchunk_leaves(_unpack(bytes(data)))
