"""``.clp`` bitstream framing, byte-identical to ``clip_codec_tpu/io/bitstream.py``.

A frame is 4 bytes of magic ``b"CLPF"``, a ``<I`` little-endian payload
length, and zstd(level=22) of the raw uint8 vector bytes. The vector
dimension is never serialized (it travels in ``codec_meta.npz``).

``zstandard`` is imported only where a frame is built or parsed, so the
package imports without it.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Union

import numpy as np

MAGIC = b"CLPF"
VERSION = 1
_ZSTD_LEVEL = 22
# Bound on what a crafted frame can make the host allocate (a zstd header
# may declare gigabytes); real frames hold 512-768 bytes.
MAX_FRAME_BYTES = 16 << 20

PathLike = Union[str, Path]


def compress_frame(q_bytes: bytes) -> bytes:
    """One framed ``.clp`` record: magic + length + zstd payload."""
    import zstandard as zstd

    comp = zstd.ZstdCompressor(level=_ZSTD_LEVEL).compress(q_bytes)
    return MAGIC + struct.pack("<I", len(comp)) + comp


def decompress_frame(data: bytes, max_output: int = MAX_FRAME_BYTES) -> np.ndarray:
    """Parse one ``.clp`` record into a uint8 vector.

    Raises ``ValueError`` on bad magic or a truncated header and
    ``zstandard.ZstdError`` on a corrupt payload or one that declares or
    decompresses past ``max_output`` bytes."""
    import zstandard as zstd

    if data[:4] != MAGIC:
        raise ValueError("Bad magic")
    if len(data) < 8:
        raise ValueError("Truncated frame header")
    (ln,) = struct.unpack("<I", data[4:8])
    payload = data[8 : 8 + ln]
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


def write_bitstream(q_bytes: bytes, dim: int, out_path: PathLike) -> None:
    """Write one quantized vector as a ``.clp`` file (``dim`` is not stored)."""
    del dim
    Path(out_path).write_bytes(compress_frame(q_bytes))


def read_bitstream(in_path: PathLike) -> np.ndarray:
    """Read one ``.clp`` file back into a uint8 vector."""
    return decompress_frame(Path(in_path).read_bytes())
