"""Encode a directory of images to DINOv2 embeddings -> a quantized ``.clp`` store.

    CLIP_CODEC_DINO_WEIGHTS=dinov2_base.bin \\
    python -m clip_codec_tpu_torch.cli.encode_images_dino --img_dir D --out_dir S [--device cuda]

Flags as the JAX CLI (``clip_codec_tpu/cli/encode_images_dino.py``):
``--img_dir --out_dir --model_name --device --weights``. The checkpoint is a
HuggingFace ``Dinov2Model`` state dict from ``--weights`` or
``CLIP_CODEC_DINO_WEIGHTS``; only ``vit_base_patch14_dinov2`` is built in.
``--device`` is ``cuda`` (the default; without a card it exits with an
error) or ``cpu``. As the reference's DINO writer: the directory is listed
without recursion, sorted, over ``DINO_EXTS`` (with ``.gif``); the tower
runs in bf16 in batches of 16 (the last one padded); the codebook is fit
with eps 1e-6; ``dim`` is saved as an int64 scalar. ``--data_parallel`` as
``cli/encode_images.py``'s: rank 0 writes the store.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from ._common import add_parallel_flags

DINO_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".gif"}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Encode images into DINOv2 feature bitstreams.")
    ap.add_argument("--img_dir", type=Path, required=True, help="Directory of input images")
    ap.add_argument("--out_dir", type=Path, required=True, help="Directory to write bitstreams and metadata")
    ap.add_argument("--model_name", type=str, default="vit_base_patch14_dinov2.lvd142m",
                    help="DINOv2 variant (only the ViT-B/14 config is built in)")
    ap.add_argument("--device", type=str, default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--weights", type=str, default=None,
                    help="Dinov2 checkpoint path (else $CLIP_CODEC_DINO_WEIGHTS)")
    add_parallel_flags(ap, distributed=False)
    args = ap.parse_args(argv)

    import torch

    from .. import encoders
    from ..codecs.quantizer import fit_affine, quantize
    from ..io.store import write_store
    from ..parallel.mesh import barrier, is_main
    from ._common import make_mesh_from_flags

    if "vit_base_patch14_dinov2" not in args.model_name:
        raise SystemExit(f"Only vit_base_patch14_dinov2 is built in (got {args.model_name}).")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use --device cpu)")

    img_paths = [p for p in sorted(args.img_dir.iterdir()) if p.suffix.lower() in DINO_EXTS]
    if not img_paths:
        raise ValueError(f"No supported image files found in {args.img_dir}")

    mesh = make_mesh_from_flags(args)
    encoder = encoders.DinoEncoder(weights_path=args.weights, device=args.device, mesh=mesh)
    feats, kept = encoder.encode_images([str(p) for p in img_paths])
    if feats.size == 0:
        raise SystemExit("No images encoded.")
    if is_main(mesh):  # every rank holds the gathered embeddings; rank 0 writes
        z = torch.from_numpy(feats).to(encoder.device)
        scale, zero = fit_affine(z, eps=1e-6)  # the reference DINO writer's eps
        q = quantize(z, scale, zero).cpu().numpy()
        write_store(args.out_dir, feats, kept, scale, zero, q, dim_dtype="int64")
        print(f"Encoded {len(kept)} images to {args.out_dir}")
    barrier(mesh)


if __name__ == "__main__":
    main()
