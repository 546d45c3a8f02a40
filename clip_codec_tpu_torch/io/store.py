"""The on-disk store — the port of ``clip_codec_tpu/io/store.py``.

A store directory holds ``manifest.json`` (``{"image", "bitstream"}``
records), ``codec_meta.npz`` (``scale``, ``zero``, ``dim``) and one ``.clp``
frame per image; the SD latent path adds ``latents/<stem>.npz`` (key
``lat``, fp16 CHW) and ``manifest_latents.json`` (records with a
``latent`` field). ``write_store`` and ``append_store`` write it;
``read_codes`` reads it. Frames are built and read as a batch
(``bitstream.compress_frames`` / ``decompress_frames``: the native batch
codec where its library builds, as the JAX store does, else frame by
frame); which engine ran never changes the stored bytes.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from . import bitstream
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
        return bitstream.decompress_frames([Path(rec["bitstream"]).read_bytes() for rec in self.manifest],
                                           self.dim)

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


def write_store(
    out_dir: PathLike,
    feats: np.ndarray,
    image_paths: List[str],
    scale: np.ndarray,
    zero: np.ndarray,
    quantized: np.ndarray,
    dim_dtype: str = "int32",
) -> List[Dict[str, str]]:
    """Write a whole store: ``codec_meta.npz``, one ``.clp`` per image and
    the manifest. ``dim`` is saved as the reference's two writers save it:
    ``int32`` for the CLIP path, an ``int64`` scalar array for the DINO path
    (``cli/encode_images_dino.py``)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    D = int(feats.shape[1])
    dim = np.int32(D) if dim_dtype == "int32" else np.array(D, dtype=np.int64)
    np.savez(out / "codec_meta.npz", scale=np.asarray(scale, dtype="float32"),
             zero=np.asarray(zero, dtype="float32"), dim=dim)
    manifest = _write_frames(out, image_paths, quantized, dedupe_stems(image_paths))
    _dump_manifest(out, manifest)
    return manifest


def _dump_manifest(out: Path, manifest: List[Dict[str, str]]) -> None:
    """Write the manifest to a temporary file and rename it over the old
    one: the manifest is the only image -> frame mapping, so a crash while
    writing must not leave it truncated."""
    tmp = out / "manifest.json.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, ensure_ascii=False, indent=2)
    os.replace(tmp, out / "manifest.json")


def _write_frames(out: Path, image_paths: List[str], quantized: np.ndarray,
                  stems: List[str]) -> List[Dict[str, str]]:
    frames = bitstream.compress_frames(np.asarray(quantized, dtype=np.uint8)) if image_paths else []
    manifest: List[Dict[str, str]] = []
    for i, p in enumerate(image_paths):
        out_path = out / (stems[i] + ".clp")
        out_path.write_bytes(frames[i])
        manifest.append({"image": str(p), "bitstream": str(out_path)})
    return manifest


def append_store(
    store_dir: PathLike,
    feats: Union[np.ndarray, torch.Tensor],
    image_paths: List[str],
) -> List[Dict[str, str]]:
    """Add vectors to an existing store, quantized (on feats' device)
    against its ``codec_meta.npz``: every old frame stays byte-identical and
    a component outside the fitted range clamps to 0 or 255. New stems
    dedupe against the manifest's, so no frame is overwritten. A
    ``decoded.npy`` cache is deleted before the manifest grows, so a crash
    cannot leave a shorter cache beside a longer store. SD latent files are
    not touched (a warning says to rerun ``cli.precompute_latents`` when
    ``manifest_latents.json`` exists). Returns the new records."""
    from ..codecs.quantizer import quantize

    st = Store.open(store_dir)
    feats = torch.as_tensor(feats, dtype=torch.float32)
    if feats.dim() != 2 or feats.shape[1] != st.dim:
        raise ValueError(f"appending {tuple(feats.shape)}-shaped features to a {st.dim}-d store")
    if feats.shape[0] != len(image_paths):
        raise ValueError(f"{feats.shape[0]} feature rows but {len(image_paths)} image paths")
    q = quantize(feats, st.scale, st.zero).cpu().numpy()
    stems = dedupe_stems(image_paths, used={Path(rec["bitstream"]).stem for rec in st.manifest})
    out = Path(store_dir)
    cache = out / "decoded.npy"
    if cache.exists():
        cache.unlink()
    new_records = _write_frames(out, image_paths, q, stems)
    _dump_manifest(out, st.manifest + new_records)
    if (out / "manifest_latents.json").exists():
        print(f"[append_store] {out / 'manifest_latents.json'} does not cover the appended rows — "
              f"re-run cli.precompute_latents", file=sys.stderr)
    return new_records
