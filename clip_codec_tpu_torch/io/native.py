"""ctypes binding of the native store codec (``csrc/store_codec.cpp``), the
port of ``clip_codec_tpu/io/native.py``.

The library is host C++ over the system's ``libzstd.so.1``, built with the
system C++ compiler at first use into ``build/native/`` (``ops/_build.py``
``build_host``) and loaded once per process, with ``RTLD_DEEPBIND``: its
``ZSTD_*`` calls go to the ``libzstd.so.1`` it links even where a library
loaded earlier with ``RTLD_GLOBAL`` exports zstd symbols of another version
(TensorFlow's, which ``torch.utils.tensorboard`` imports where TensorFlow is
installed), so its frames do not depend on what the process imported
before it. It needs neither the
``zstandard`` binding nor ``zstd.h``, so it frames real ``.clp`` records on
a machine that has only the shared library.

``NativeCodec.load()`` returns the codec or raises ``RuntimeError`` with
the compiler's or loader's message; :func:`codec` caches that outcome, and
``io/bitstream.py`` decides from it which engine frames.

Frames must not depend on which engine wrote them. Where ``zstandard`` is
installed, the native engine writes frames only if it passes
:meth:`NativeCodec.matches_zstandard` (the JAX package's self-check, on the
same probe: a libzstd of another version may choose another encoding at
level 22), and reads in every case (decoding does not depend on the
version).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Union

import numpy as np

LIBZSTD = "-l:libzstd.so.1"
LOAD_MODE = ctypes.RTLD_LOCAL | getattr(os, "RTLD_DEEPBIND", 0)  # the library's own libzstd first
LEVEL = 22
# ZSTD_getFrameContentSize's two sentinels.
CONTENTSIZE_UNKNOWN = (1 << 64) - 1
CONTENTSIZE_ERROR = (1 << 64) - 2

_sz = ctypes.c_size_t
_u8p = ctypes.POINTER(ctypes.c_uint8)
_szp = ctypes.POINTER(_sz)


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p)


def _szptr(arr: np.ndarray):
    return arr.ctypes.data_as(_szp)


class NativeCodec:
    """The loaded library's five C entry points of the JAX engine
    (``clp_frame_bound``, ``clp_compress_frame``, ``clp_decompress_frame``,
    ``clp_compress_batch``, ``clp_decompress_batch``) plus
    ``clp_payload_content_size`` (the decompression-bomb guard) and
    ``clp_zstd_version``."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        lib.clp_zstd_version.restype = ctypes.c_uint
        lib.clp_zstd_version.argtypes = []
        lib.clp_frame_bound.restype = _sz
        lib.clp_frame_bound.argtypes = [_sz]
        lib.clp_payload_content_size.restype = ctypes.c_ulonglong
        lib.clp_payload_content_size.argtypes = [_u8p, _sz]
        lib.clp_compress_frame.restype = _sz
        lib.clp_compress_frame.argtypes = [_u8p, _sz, _u8p, _sz, ctypes.c_int]
        lib.clp_decompress_frame.restype = _sz
        lib.clp_decompress_frame.argtypes = [_u8p, _sz, _u8p, _sz]
        lib.clp_compress_batch.restype = _sz
        lib.clp_compress_batch.argtypes = [_u8p, _sz, _sz, _u8p, _sz, _szp, _szp, ctypes.c_int]
        lib.clp_decompress_batch.restype = _sz
        lib.clp_decompress_batch.argtypes = [_u8p, _szp, _szp, _sz, _sz, _u8p]
        self.lib = lib

    @classmethod
    def load(cls) -> "NativeCodec":
        """Build (once per source) and load the library; ``RuntimeError``
        when the compiler or the loader fails."""
        from ..ops import _build

        path = _build.build_host("store_codec", (LIBZSTD,))
        try:
            return cls(ctypes.CDLL(str(path), mode=LOAD_MODE))
        except OSError as e:
            raise RuntimeError(f"loading {path} failed: {e}") from e

    @property
    def zstd_version(self) -> str:
        v = int(self.lib.clp_zstd_version())
        return f"{v // 10000}.{v // 100 % 100}.{v % 100}"

    def compress_frame(self, q_bytes: bytes) -> bytes:
        """One framed record of ``q_bytes``."""
        src = np.frombuffer(bytes(q_bytes), dtype=np.uint8)
        out = np.empty(int(self.lib.clp_frame_bound(src.size)), dtype=np.uint8)
        n = int(self.lib.clp_compress_frame(_u8(src), src.size, _u8(out), out.size, LEVEL))
        if n == 0:
            raise RuntimeError(f"native zstd failed to frame {src.size} bytes")
        return out[:n].tobytes()

    def content_size(self, payload: bytes) -> int:
        """What a zstd payload declares it decodes to, or one of the two
        ``CONTENTSIZE_*`` sentinels."""
        buf = np.frombuffer(payload, dtype=np.uint8)
        return int(self.lib.clp_payload_content_size(_u8(buf), buf.size))

    def decompress_frame(self, data: bytes, out_cap: int) -> Optional[np.ndarray]:
        """The payload of one frame, decoded into at most ``out_cap`` bytes;
        None where libzstd refuses it (the caller has checked the header)."""
        src = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(max(int(out_cap), 1), dtype=np.uint8)
        n = int(self.lib.clp_decompress_frame(_u8(src), src.size, _u8(out), out_cap))
        return out[:n] if n > 0 else None

    def compress_batch(self, q: np.ndarray) -> List[bytes]:
        """(N, D) uint8 -> N framed records, one compression context."""
        q = np.ascontiguousarray(q, dtype=np.uint8)
        n, d = q.shape
        out = np.empty(max(n * int(self.lib.clp_frame_bound(d)), 1), dtype=np.uint8)
        offsets = np.empty(n, dtype=np.uintp)
        sizes = np.empty(n, dtype=np.uintp)
        total = self.lib.clp_compress_batch(_u8(q), n, d, _u8(out), out.size, _szptr(offsets), _szptr(sizes),
                                            LEVEL)
        if n and total == 0:
            raise RuntimeError(f"native zstd failed to frame a ({n}, {d}) batch")
        return [out[int(o): int(o) + int(s)].tobytes() for o, s in zip(offsets, sizes)]

    def decompress_batch(self, frames: Sequence[bytes], dim: int) -> Union[np.ndarray, int]:
        """N framed records, each decoding to ``dim`` bytes, -> (N, dim)
        uint8; or the index of the first record that does not decode to
        exactly ``dim`` bytes (one decompression context; the output is
        bounded by ``dim`` a record, so no record can make it allocate)."""
        n = len(frames)
        blob = np.frombuffer(b"".join(frames), dtype=np.uint8)
        sizes = np.array([len(f) for f in frames], dtype=np.uintp)
        offsets = np.zeros(n, dtype=np.uintp)
        if n > 1:
            offsets[1:] = np.cumsum(sizes)[:-1]
        out = np.empty((n, dim), dtype=np.uint8)
        ok = int(self.lib.clp_decompress_batch(_u8(blob) if blob.size else _u8(np.zeros(1, np.uint8)),
                                               _szptr(offsets), _szptr(sizes), n, dim, _u8(out)))
        return out if ok == n else ok

    def matches_zstandard(self) -> bool:
        """Whether this engine frames the JAX package's self-check probe
        byte for byte as the installed ``zstandard`` does."""
        import zstandard

        probe = (np.arange(512, dtype=np.uint64) * 2654435761 % 256).astype(np.uint8).tobytes()
        want = zstandard.ZstdCompressor(level=LEVEL).compress(probe)
        return self.compress_frame(probe)[8:] == want


_CODEC: Optional[NativeCodec] = None
_ERROR: Optional[str] = None


def codec() -> Optional[NativeCodec]:
    """The process's native codec, built and loaded at the first call;
    None when that failed (:func:`load_error` says why)."""
    global _CODEC, _ERROR
    if _CODEC is None and _ERROR is None:
        try:
            _CODEC = NativeCodec.load()
        except (RuntimeError, OSError) as e:  # a compiler that fails or is missing
            _ERROR = str(e)
    return _CODEC


def load_error() -> Optional[str]:
    """Why :func:`codec` returned None, once it has."""
    return _ERROR
