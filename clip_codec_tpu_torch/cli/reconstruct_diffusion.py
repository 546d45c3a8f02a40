"""Reconstruct an image from a ``.clp`` bitstream via DDIM sampling.

    python -m clip_codec_tpu_torch.cli.reconstruct_diffusion --store_dir STORE \\
        --bitstream img.clp --weights STORE/diffusion_unet_final.pt --out recon.png

Flags as the JAX CLI (``clip_codec_tpu/cli/reconstruct_diffusion.py``);
``--device`` defaults to ``cuda``, ``--sampler`` is ``ddim``, ``ddim_std`` or
``dpmpp``. ``--weights`` is a ``.pt`` state dict or the JAX trainer's ``.msgpack``;
the ``model_config.json`` beside it, if any, gives the architecture and schedule. ``--int8`` samples
with the static-int8 U-Net (``ops/int8.py``), its activation scales
calibrated here first (``calibrate_unet`` over the schedule's length).
"""

from __future__ import annotations

import argparse
from dataclasses import replace
from typing import Optional, Sequence

from ..train.train_decoder import decode_embedding, to_pil
from ._common import add_int8_flag, apply_int8_flag


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Reconstruct an image from a .clp bitstream via DDIM sampling.")
    ap.add_argument("--store_dir", type=str, required=True)
    ap.add_argument("--bitstream", type=str, required=True)
    ap.add_argument("--weights", type=str, required=True)
    ap.add_argument("--out", type=str, default="recon.png")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--base", type=int, default=None,
                    help="U-Net base width (default: model_config.json next to --weights, "
                         "else inferred from the checkpoint)")
    ap.add_argument("--ch_mult", type=str, default=None, help="U-Net channel multipliers, e.g. 1,2,2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sampler", type=str, default="ddim", choices=("ddim", "ddim_std", "dpmpp"),
                    help="ddim (reference parity), ddim_std (textbook strided DDIM) or dpmpp "
                         "(DPM-Solver++(2M))")
    add_int8_flag(ap)
    args = ap.parse_args(argv)
    apply_int8_flag(args)

    import torch

    from ..diffusion import NoiseSchedule, make_sampler
    from ..models import CLIPCondUNet
    from ..ops.int8 import calibrate_unet, load_quant
    from ..utils.checkpoint import load_unet_checkpoint
    from ..utils.config import ModelConfig

    device = torch.device(args.device)
    sd = load_unet_checkpoint(args.weights)
    mc = ModelConfig.find_for_checkpoint(args.weights) or ModelConfig.infer_from_state_dict(sd)
    if args.base is not None:
        mc = replace(mc, base=args.base)
    if args.ch_mult is not None:
        mc = replace(mc, ch_mult=tuple(int(c) for c in args.ch_mult.split(",")))
    z = torch.from_numpy(decode_embedding(args.bitstream, args.store_dir)).to(device)
    net = CLIPCondUNet(z_dim=z.shape[1], base=mc.base, ch_mult=mc.ch_mult, time_dim=mc.time_dim,
                       img_ch=3, dtype=torch.bfloat16, int8=True if args.int8 else None)
    net.load_state_dict(sd, strict=True)
    net = net.to(device).eval()
    if args.int8:
        # static activation scales: no per-conv absmax pass
        load_quant(net, calibrate_unet(net, args.size, z.shape[1], timesteps=mc.timesteps))
    sched = NoiseSchedule.create(mc.timesteps, mc.schedule, device=device)
    sampler = make_sampler(args.sampler, sched, eta=args.eta)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    x = sampler.sample(net, z, (1, args.size, args.size, 3), steps=args.steps, generator=gen)
    to_pil(torch.clamp(x[0], -1.0, 1.0).cpu().numpy()).save(args.out)
    print(f"Saved to {args.out}")


if __name__ == "__main__":
    main()
