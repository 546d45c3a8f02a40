"""``.clp`` bitstream framing, byte-identical to ``clip_codec_tpu/io/bitstream.py``.

A frame is 4 bytes of magic ``b"CLPF"``, a ``<I`` little-endian payload
length, and zstd(level=22) of the raw uint8 vector bytes. The vector
dimension is never serialized (it travels in ``codec_meta.npz``).

Two zstd engines, as in the JAX package (``io/bitstream.py`` and
``io/native.py``): the ``zstandard`` binding and the native library
(``io/native.py``, ``csrc/store_codec.cpp`` over the system's libzstd).

* Single frames (``compress_frame``, ``decompress_frame``) use
  ``zstandard`` where it is installed, else the native engine.
* Batches (``compress_frames``, ``decompress_frames``: the store and
  ``ClipCodec``) use the native engine's batch entry points where its
  library builds: for reading always, for writing where ``zstandard`` is
  missing or the native engine frames as it does
  (``NativeCodec.matches_zstandard``), else frame by frame.

``zstd_engine()`` names the engine that frames a batch. Nothing is built
or imported at import time.
"""

from __future__ import annotations

import functools
import importlib.util
import struct
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from . import native

MAGIC = b"CLPF"
VERSION = 1
_ZSTD_LEVEL = 22
# Bound on what a crafted frame can make the host allocate (a zstd header
# may declare gigabytes); real frames hold 512-768 bytes.
MAX_FRAME_BYTES = 16 << 20

PathLike = Union[str, Path]


class FrameError(ValueError):
    """A frame's zstd payload that the native engine refuses: corrupt, or
    over the decompression-bomb guard (``zstandard.ZstdError`` in the
    ``zstandard`` engine)."""


@functools.lru_cache(maxsize=None)
def _have_zstandard() -> bool:
    # a search of sys.path: ~0.8 ms, too slow to repeat per frame
    return importlib.util.find_spec("zstandard") is not None


@functools.lru_cache(maxsize=None)
def _frames_like_zstandard(nc: native.NativeCodec) -> bool:
    return nc.matches_zstandard()


def _native_writes() -> Optional[native.NativeCodec]:
    nc = native.codec()
    if nc is None or not _have_zstandard() or _frames_like_zstandard(nc):
        return nc
    return None


def _single_engine() -> str:
    if _have_zstandard():
        return "zstandard"
    if native.codec() is None:
        raise RuntimeError("no zstd engine: the zstandard package is not installed and the native codec "
                           f"did not build or load ({native.load_error()})")
    return "native"


def zstd_engine() -> Optional[str]:
    """``"native"``, ``"zstandard"`` or None: the engine that frames a batch
    (store writes, ``ClipCodec.compress``) on this machine."""
    if _native_writes() is not None:
        return "native"
    if _have_zstandard():
        return "zstandard"
    return None


def compress_frame(q_bytes: bytes) -> bytes:
    """One framed ``.clp`` record: magic + length + zstd payload."""
    if _single_engine() == "native":
        return native.codec().compress_frame(q_bytes)
    import zstandard as zstd

    comp = zstd.ZstdCompressor(level=_ZSTD_LEVEL).compress(q_bytes)
    return MAGIC + struct.pack("<I", len(comp)) + comp


def decompress_frame(data: bytes, max_output: int = MAX_FRAME_BYTES) -> np.ndarray:
    """Parse one ``.clp`` record into a uint8 vector.

    Raises ``ValueError`` on bad magic or a truncated header; on a corrupt
    payload or one that declares or decompresses past ``max_output`` bytes,
    ``zstandard.ZstdError`` (the ``zstandard`` engine) or ``FrameError``
    (native)."""
    if data[:4] != MAGIC:
        raise ValueError("Bad magic")
    if len(data) < 8:
        raise ValueError("Truncated frame header")
    (ln,) = struct.unpack("<I", data[4:8])
    payload = data[8 : 8 + ln]
    if _single_engine() == "native":
        return _native_decompress(native.codec(), data, payload, max_output)
    import zstandard as zstd

    try:
        declared = zstd.get_frame_parameters(payload).content_size
    except zstd.ZstdError:
        declared = 0  # not a zstd frame: decompress() raises below
    if declared > max_output:
        raise zstd.ZstdError(
            f"frame declares {declared} bytes, over the {max_output}-byte "
            f"decompression-bomb guard")
    raw = zstd.ZstdDecompressor().decompress(payload, max_output_size=max_output)
    return np.frombuffer(raw, dtype=np.uint8)


def _native_decompress(nc: native.NativeCodec, data: bytes, payload: bytes, max_output: int) -> np.ndarray:
    declared = nc.content_size(payload)
    if declared == native.CONTENTSIZE_ERROR:
        raise FrameError("corrupt frame: the payload is not a zstd frame")
    if declared != native.CONTENTSIZE_UNKNOWN and declared > max_output:
        raise FrameError(f"frame declares {declared} bytes, over the {max_output}-byte "
                         f"decompression-bomb guard")
    if declared == 0:
        return np.zeros(0, np.uint8)
    out = nc.decompress_frame(data, max_output if declared == native.CONTENTSIZE_UNKNOWN else declared)
    if out is None:
        raise FrameError("corrupt frame: zstd refused the payload")
    return out


def _check_dim(i: int, got: int, dim: int) -> None:
    if got != dim:
        raise ValueError(f"frame {i} is {got}-d but the codes are {dim}-d: it belongs to a different store")


def compress_frames(q: np.ndarray) -> List[bytes]:
    """(N, D) uint8 codes -> N framed records (the native batch entry point
    where it frames, else ``compress_frame`` row by row)."""
    q = np.ascontiguousarray(np.asarray(q, dtype=np.uint8))
    nc = _native_writes()
    if nc is not None:
        return nc.compress_batch(q)
    return [compress_frame(row.tobytes()) for row in q]


def decompress_frames(frames: Sequence[bytes], dim: int) -> np.ndarray:
    """N framed records -> (N, dim) uint8 codes. A record that does not
    parse raises ``decompress_frame``'s error; one of another length a
    ``ValueError`` naming it."""
    if len(frames) == 0:
        return np.zeros((0, dim), np.uint8)
    nc = native.codec()
    if nc is not None:
        got = nc.decompress_batch(frames, dim)
        if isinstance(got, np.ndarray):
            return got
        bad = decompress_frame(frames[got])  # raises for a record that does not parse
        _check_dim(got, bad.size, dim)
        raise FrameError(f"frame {got}: the native engine refused a record that parses alone")
    rows = [decompress_frame(f) for f in frames]
    for i, r in enumerate(rows):
        _check_dim(i, r.size, dim)
    return np.stack(rows)


def write_bitstream(q_bytes: bytes, dim: int, out_path: PathLike) -> None:
    """Write one quantized vector as a ``.clp`` file (``dim`` is not stored)."""
    del dim
    Path(out_path).write_bytes(compress_frame(q_bytes))


def read_bitstream(in_path: PathLike) -> np.ndarray:
    """Read one ``.clp`` file back into a uint8 vector."""
    return decompress_frame(Path(in_path).read_bytes())
