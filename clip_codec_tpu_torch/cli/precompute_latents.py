"""Precompute SD VAE latents for every store image (the SD training path's first step).

    CLIP_CODEC_SD_VAE_WEIGHTS=vae/diffusion_pytorch_model.bin \\
    python -m clip_codec_tpu_torch.cli.precompute_latents --store_dir STORE --device cuda

Flags and file format as the JAX CLI (``clip_codec_tpu/cli/precompute_latents.py``):
per manifest image, a 512px BICUBIC resize, the VAE's moments, a latent
sampled from them, x0.18215, saved as fp16 ``(4, H/8, W/8)`` CHW under
``latents/<stem>.npz`` key ``lat``; then ``manifest_latents.json``, the
manifest with a ``latent`` field per record. The VAE is a diffusers
checkpoint (``--vae_weights`` or ``$CLIP_CODEC_SD_VAE_WEIGHTS``) computing in
bf16; the sampling noise comes from a ``torch.Generator`` seeded with
``--seed``, so the latents differ from the JAX CLI's (another generator) but
not the moments. ``--device`` is ``cpu`` or ``cuda`` (the default).
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..models.sd import SD_SCALING_FACTOR, AutoencoderKL
from ..train.data import load_image_u8, scale_m11_u8

PathLike = Union[str, Path]


def encode_latents(vae: AutoencoderKL, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[-1, 1] images (B, H, W, 3) -> scaled fp32 latents (B, H/8, W/8, 4):
    ``encode_moments``, ``sample_latents`` (noise from ``generator`` unless
    given), then x0.18215."""
    moments = vae.encode_moments(x)
    return AutoencoderKL.sample_latents(moments, generator, noise).float() * SD_SCALING_FACTOR


@torch.no_grad()
def precompute_latents(store_dir: PathLike, vae: AutoencoderKL, size: int = 512, batch_size: int = 4,
                       generator: Optional[torch.Generator] = None) -> List[dict]:
    """Write every manifest image's latent and ``manifest_latents.json``;
    returns the records. Images are loaded as uint8 on the host and scaled
    to [-1, 1] on the VAE's device (bit-identical to the host's scaling)."""
    from ..io.store import dedupe_stems
    from ..utils.batching import pad_rows

    store = Path(store_dir)
    meta = json.loads((store / "manifest.json").read_text())
    stems = dedupe_stems([r["image"] for r in meta])
    out_dir = store / "latents"
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = next(vae.parameters()).device
    for s in range(0, len(meta), batch_size):
        recs = meta[s:s + batch_size]
        x = pad_rows(np.stack([load_image_u8(r["image"], size) for r in recs]), batch_size)
        lats = encode_latents(vae, scale_m11_u8(torch.from_numpy(x).to(dev)), generator)
        for j, (r, lat) in enumerate(zip(recs, lats[:len(recs)].cpu().numpy())):
            lat_path = out_dir / (stems[s + j] + ".npz")
            np.savez_compressed(lat_path, lat=lat.transpose(2, 0, 1).astype(np.float16))
            r["latent"] = str(lat_path)
    (store / "manifest_latents.json").write_text(json.dumps(meta, indent=2))
    return meta


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Precompute SD VAE latents for every store image.")
    ap.add_argument("--store_dir", type=Path, required=True)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--device", type=str, default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--vae_weights", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    vae_path = args.vae_weights or os.environ.get("CLIP_CODEC_SD_VAE_WEIGHTS")
    if not vae_path or not Path(vae_path).exists():
        raise RuntimeError("SD VAE weights not found. Pass --vae_weights or set "
                           "CLIP_CODEC_SD_VAE_WEIGHTS to a diffusers AutoencoderKL checkpoint.")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use --device cpu)")

    from ..weights import sd_checkpoint as ckpt

    vsd = ckpt.load_vae(vae_path)
    with torch.device(args.device):
        vae = AutoencoderKL(ckpt.vae_config(vsd), dtype=torch.bfloat16)
    vae.load_state_dict(vsd, strict=True)
    meta = precompute_latents(args.store_dir, vae.eval(), args.size, args.batch_size,
                              torch.Generator(device=args.device).manual_seed(args.seed))
    print(f"Wrote {len(meta)} latents to {args.store_dir / 'latents'}")


if __name__ == "__main__":
    main()
