"""Read side of the on-disk store — the port of ``clip_codec_tpu/io/store.py``.

A store directory holds ``manifest.json`` (``{"image", "bitstream"}``
records), ``codec_meta.npz`` (``scale``, ``zero``, ``dim``) and one ``.clp``
frame per image; the SD latent path adds ``latents/<stem>.npz`` (key
``lat``, fp16 CHW) and ``manifest_latents.json`` (records with a
``latent`` field). ``read_codes`` reads frames one by one in Python, the
path the JAX package falls back to without its native batch codec.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from .bitstream import read_bitstream

PathLike = Union[str, Path]


def l2_normalize_np(x: np.ndarray, axis: int = -1, eps: float = 1e-9) -> np.ndarray:
    """Host-side L2 normalization."""
    n = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / np.maximum(n, eps)


@dataclass
class Store:
    """Read-side view of a store directory."""

    store_dir: Path
    manifest: List[Dict[str, str]]
    scale: np.ndarray  # (D,) float32
    zero: np.ndarray  # (D,) float32
    dim: int

    @classmethod
    def open(cls, store_dir: PathLike, manifest_name: str = "manifest.json") -> "Store":
        store_dir = Path(store_dir)
        manifest = json.loads((store_dir / manifest_name).read_text(encoding="utf-8"))
        meta = np.load(store_dir / "codec_meta.npz")
        scale = meta["scale"].astype("float32")
        zero = meta["zero"].astype("float32")
        dim = int(meta["dim"]) if "dim" in meta else int(scale.shape[0])
        return cls(store_dir=store_dir, manifest=manifest, scale=scale, zero=zero, dim=dim)

    def __len__(self) -> int:
        return len(self.manifest)

    def decode_vector(self, i: int, renormalize: bool = True) -> np.ndarray:
        """Read record *i*'s bitstream and dequantize (optionally L2-renorm)."""
        q = read_bitstream(self.manifest[i]["bitstream"])
        z = q.astype(np.float32) * self.scale + self.zero
        if renormalize:
            z = l2_normalize_np(z[None, :]).astype(np.float32)[0]
        return z

    def read_codes(self) -> np.ndarray:
        """Every record's raw quantized codes as an ``(N, D)`` uint8 matrix."""
        if not self.manifest:
            return np.zeros((0, self.dim), dtype=np.uint8)
        return np.stack([read_bitstream(rec["bitstream"]) for rec in self.manifest])

    def decode_all(self, renormalize: bool = True) -> np.ndarray:
        """Dequantize every record into an ``(N, D)`` float32 matrix."""
        if not self.manifest:
            return np.zeros((0, self.dim), dtype=np.float32)
        z = self.read_codes().astype(np.float32) * self.scale + self.zero
        if renormalize:
            z = l2_normalize_np(z)
        return z


def dedupe_stems(paths: List[str], used: Optional[set] = None) -> List[str]:
    """Collision-safe per-path file stems: unique stems stay the bare image
    stem, duplicates get a deterministic ``__{k}`` suffix. ``used``
    pre-seeds the taken stems."""
    used = set() if used is None else set(used)
    stems: List[str] = []
    for p in paths:
        base = Path(p).stem
        cand, k = base, 0
        while cand in used:
            k += 1
            cand = f"{base}__{k}"
        used.add(cand)
        stems.append(cand)
    return stems
