"""Train the pixel-space diffusion decoder from the command line.

    python -m clip_codec_tpu_torch.cli.train --store_dir STORE [--epochs 40] [--device cuda]

Flags and defaults as the JAX CLI (``clip_codec_tpu/cli/train.py``);
``--device`` is ``cpu`` or ``cuda`` (the default; without a card it exits
with an error). The store needs ``manifest.json`` (``image`` and
``bitstream`` per record) and ``codec_meta.npz``. Writes
``model_config.json``, ``diffusion_unet_ep{N}.pt`` and
``diffusion_unet_final.pt`` (and, with ``--ema_decay``,
``diffusion_unet_ema_final.pt``) to ``--save_dir`` (default the store),
which ``ClipCodec.load`` and ``cli/reconstruct_diffusion --weights`` read;
``--resume`` continues from the last full-state checkpoint under
``<save_dir>/state/``.

``--clip_weights`` (a CLIP checkpoint) turns on the CLIP-alignment term:
the image tower in bf16 on ``--device``, fed the clamped x0-prediction
resized to 224 with no mean/std, on even epochs, without a gradient (the
reference's quirk).

``--data_parallel`` trains data-parallel over every rank of the launcher
(one rank per card: ``torchrun --nproc_per_node N -m
clip_codec_tpu_torch.cli.train --data_parallel ...``; without a launcher, a
world of one); ``--batch_size`` is then the global batch and must divide by
the rank count. ``--distributed`` joins the launcher's process group before
anything touches a device and implies ``--data_parallel``; without the
launcher's environment it stops. Rank 0 writes the files.

``--spatial_shard k`` (k > 1) also splits each image's height over k ranks
(``train_diffusion(spatial=True)`` on the ``(world / k, k)`` mesh, JAX's
``make_mesh(model_parallel=k)``): ``torchrun --nproc_per_node N -m
clip_codec_tpu_torch.cli.train --spatial_shard k ...``, N a multiple of k,
``--out_size`` divisible by k (and every U-Net level's rows into an even
count a rank); without the launcher's environment it stops.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ._common import add_parallel_flags, make_mesh_from_flags

def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Train the CLIP-conditioned diffusion decoder on a store.")
    ap.add_argument("--store_dir", type=str, required=True)
    ap.add_argument("--out_size", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--timesteps", type=int, default=1000)
    ap.add_argument("--schedule", type=str, default="cosine", choices=["cosine", "linear"])
    ap.add_argument("--recon_w", type=float, default=0.05)
    ap.add_argument("--clip_w", type=float, default=0.1)
    ap.add_argument("--tv_w", type=float, default=1e-4)
    ap.add_argument("--save_dir", type=str, default=None)
    ap.add_argument("--base", type=int, default=128)
    ap.add_argument("--ch_mult", type=str, default="1,2,2")
    ap.add_argument("--no_bf16", action="store_true")
    ap.add_argument("--resume", action="store_true", help="continue from the latest full-state checkpoint")
    ap.add_argument("--ema_decay", type=float, default=0.0,
                    help="EMA of params (0=off, reference behavior; 0.9999 typical); "
                         "also writes diffusion_unet_ema_final.pt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--clip_weights", type=str, default=None,
                    help="CLIP checkpoint for the CLIP-alignment term (off without it)")
    ap.add_argument("--data_workers", type=int, default=0,
                    help="host threads decoding each batch's images (0 = synchronous)")
    ap.add_argument("--cache_images", action="store_true",
                    help="cache decoded images as resized uint8 in RAM so epochs after the first skip decoding")
    ap.add_argument("--remat", action="store_true",
                    help="recompute ResBlocks in the backward pass (more FLOPs, less activation memory)")
    ap.add_argument("--spatial_shard", type=int, default=1,
                    help="also shard image height over K ranks of the launcher (memory lever for 512px+; "
                         "out_size must divide by K)")
    add_parallel_flags(ap)
    args = ap.parse_args(argv)

    import torch

    from ..parallel.mesh import is_main, rank_device
    from ..train.diffusion_train import DiffusionTrainConfig, train_diffusion

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use --device cpu)")
    spatial = args.spatial_shard > 1
    mesh = make_mesh_from_flags(args, model_parallel=args.spatial_shard if spatial else 1)
    device = rank_device(mesh) if mesh is not None else args.device

    clip_embed_fn = None
    if args.clip_weights:
        from ..encoders import ClipEncoder
        from ..encoders.clip import embed_m11_images

        enc = ClipEncoder(weights_path=args.clip_weights, dtype=torch.bfloat16, device=device)
        clip_embed_fn = lambda _params, imgs: embed_m11_images(enc.model, imgs)

    cfg = DiffusionTrainConfig(
        out_size=args.out_size, epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        timesteps=args.timesteps, schedule=args.schedule, recon_w=args.recon_w,
        clip_w=args.clip_w, tv_w=args.tv_w, base=args.base,
        ch_mult=tuple(int(c) for c in args.ch_mult.split(",")),
        bf16=not args.no_bf16, seed=args.seed, log_every=args.log_every,
        ema_decay=args.ema_decay, remat=args.remat,
        data_workers=args.data_workers, cache_images=args.cache_images,
    )
    ckpt = train_diffusion(args.store_dir, config=cfg, save_dir=args.save_dir, resume=args.resume,
                           clip_embed_fn=clip_embed_fn, mesh=mesh, spatial=spatial, device=device)
    if is_main(mesh):
        print(f"Final checkpoint: {ckpt}")


if __name__ == "__main__":
    main()
