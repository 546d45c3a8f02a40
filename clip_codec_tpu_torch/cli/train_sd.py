"""Train the Stable-Diffusion CLIP adapter from the command line.

    CLIP_CODEC_SD_UNET_WEIGHTS=unet/diffusion_pytorch_model.bin \\
    CLIP_CODEC_SD_VAE_WEIGHTS=vae/diffusion_pytorch_model.bin \\
    python -m clip_codec_tpu_torch.cli.train_sd --store_dir STORE --epochs 20 --device cuda

The store needs ``manifest_latents.json`` (``cli/precompute_latents``).
Flags and defaults as the JAX CLI (``clip_codec_tpu/cli/train_sd.py``);
``--device`` is ``cpu`` or ``cuda`` (the default). The frozen UNet and VAE
are diffusers checkpoints loaded as they are and compute in bf16; the
adapter starts from fresh parameters drawn from ``--seed``. Writes
``sd_adapter_ep{N}.pt``, ``sd_adapter_final.pt`` (and, with
``--ema_decay``, ``sd_adapter_ema_final.pt``) to ``--save_dir`` (default
the store), readable by ``cli/reconstruct_sd_diffusion --adapter``;
``--resume`` continues from the last full-state checkpoint there.

As in the JAX CLI, the ``--clip_w`` DINO-alignment term is on when
``--clip_w`` > 0 and ``$CLIP_CODEC_DINO_WEIGHTS`` is set (the DINOv2
ViT-B/14 tower, bf16, frozen), and the ``--perc_w`` LPIPS term when
``--perc_w`` > 0 and ``$CLIP_CODEC_LPIPS_WEIGHTS`` is set (VGG16, fp32, on
every ``--perc_every``-th step); both compare against the records' images
loaded at ``--out_size``. ``--data_parallel`` and ``--distributed`` as
``cli/train.py``'s: the adapter trains data-parallel over the launcher's
ranks, the frozen UNet and VAE loaded on every rank's card; rank 0 writes.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Optional, Sequence

import torch

from ._common import add_parallel_flags, make_mesh_from_flags


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Train StableDiffusionDecoder's CLIP adapter on a store.")
    ap.add_argument("--store_dir", type=str, required=True)
    ap.add_argument("--model_name", type=str, default="runwayml/stable-diffusion-v1-5")
    ap.add_argument("--out_size", type=int, default=256, help="GT size of the DINO/LPIPS terms")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--timesteps", type=int, default=1000)
    ap.add_argument("--recon_w", type=float, default=0.05)
    ap.add_argument("--clip_w", type=float, default=0.1, help="DINO-alignment weight (the reference's name for it)")
    ap.add_argument("--tv_w", type=float, default=1e-4)
    ap.add_argument("--perc_w", type=float, default=0.1, help="LPIPS weight")
    ap.add_argument("--device", type=str, default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--save_dir", type=str, default=None)
    ap.add_argument("--perc_every", type=int, default=10, help="LPIPS every this many steps")
    ap.add_argument("--n_tokens", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8,
                    help="UNet attention heads (not recoverable from the weight shapes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=0)
    ap.add_argument("--resume", action="store_true", help="continue from the latest full-state checkpoint")
    ap.add_argument("--ema_decay", type=float, default=0.0,
                    help="EMA of the adapter (0 = off); also writes sd_adapter_ema_final.pt")
    ap.add_argument("--data_workers", type=int, default=0,
                    help="accepted for the JAX CLI's flags; the latents load on one prefetch thread")
    add_parallel_flags(ap)
    args = ap.parse_args(argv)

    from ..parallel.mesh import is_main, rank_device
    from ..train.sd_diffusion_train import SDTrainConfig, train_sd_diffusion

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use --device cpu)")
    mesh = make_mesh_from_flags(args)
    device = rank_device(mesh) if mesh is not None else torch.device(args.device)

    from ..io.store import Store
    from ..models import init_params
    from ..models.sd import SDClipAdapter, StableDiffusionDecoder
    from ..weights.sd_checkpoint import require_sd_weight_paths
    from .reconstruct_sd_diffusion import load_frozen

    unet_path, vae_path = require_sd_weight_paths(args.model_name)
    unet, vae = load_frozen(unet_path, vae_path, device, heads=args.heads)
    store = Store.open(args.store_dir, manifest_name="manifest_latents.json")
    with torch.device(device):
        adapter = SDClipAdapter(store.dim, unet.cfg.cross_dim, n_tokens=args.n_tokens)
    init_params(adapter, torch.Generator(device=device).manual_seed(args.seed))
    decoder = StableDiffusionDecoder(unet, vae, adapter)

    dino = None
    if args.clip_w > 0 and os.environ.get("CLIP_CODEC_DINO_WEIGHTS"):
        from ..encoders import DinoEncoder

        dino = DinoEncoder(device=device).model
    lpips_model = None
    if args.perc_w > 0:
        from ..eval.lpips import LPIPSModel

        scorer = LPIPSModel.from_env(device)  # None without weights
        lpips_model = None if scorer is None else scorer.model

    cfg = SDTrainConfig(
        out_size=args.out_size, epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        timesteps=args.timesteps, recon_w=args.recon_w, clip_w=args.clip_w, perc_w=args.perc_w,
        tv_w=args.tv_w, perc_every=args.perc_every, seed=args.seed, log_every=args.log_every,
        ema_decay=args.ema_decay, data_workers=args.data_workers,
    )
    final = train_sd_diffusion(Path(args.store_dir), decoder,
                               save_dir=Path(args.save_dir) if args.save_dir else None,
                               dino=dino, lpips_model=lpips_model, config=cfg, mesh=mesh, resume=args.resume)
    if is_main(mesh):
        print(f"Saved final adapter to {final}")


if __name__ == "__main__":
    main()
