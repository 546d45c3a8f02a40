"""Reconstruct an image from a ``.clp`` bitstream via DDIM sampling.

    python -m clip_codec_tpu_torch.cli.reconstruct_diffusion --store_dir STORE \\
        --bitstream img.clp --weights STORE/diffusion_unet_final.pt --out recon.png

Flags as the JAX CLI (``clip_codec_tpu/cli/reconstruct_diffusion.py``) except
``--int8``; ``--device`` defaults to ``cuda``, ``--sampler`` is ``ddim``,
``ddim_std`` or ``dpmpp``. ``--weights`` is a ``.pt`` state dict; the ``model_config.json``
beside it, if any, gives the architecture and schedule.
"""

from __future__ import annotations

import argparse
from dataclasses import replace
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

PathLike = Union[str, Path]


def decode_embedding(bit_path: PathLike, store_dir: PathLike) -> np.ndarray:
    """.clp file -> dequantized, L2-normalized (1, D) fp32 embedding."""
    from ..codecs.quantizer import dequantize_l2norm_host
    from ..io.bitstream import read_bitstream

    meta = np.load(Path(store_dir) / "codec_meta.npz")
    q = read_bitstream(bit_path)
    return dequantize_l2norm_host(q[None, :], meta["scale"].astype(np.float32),
                                  meta["zero"].astype(np.float32)).astype(np.float32)


def to_pil(img_m11: np.ndarray):
    """(H, W, 3) float in [-1, 1] -> PIL uint8 image."""
    from PIL import Image

    arr = np.clip(np.asarray(img_m11), -1.0, 1.0)
    return Image.fromarray(((arr + 1.0) * 127.5).astype(np.uint8))


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
    args = ap.parse_args(argv)

    import torch

    from ..diffusion import NoiseSchedule, make_sampler
    from ..models import CLIPCondUNet
    from ..utils.checkpoint import load_state_dict
    from ..utils.config import ModelConfig

    device = torch.device(args.device)
    sd = load_state_dict(args.weights)
    mc = ModelConfig.find_for_checkpoint(args.weights) or ModelConfig.infer_from_state_dict(sd)
    if args.base is not None:
        mc = replace(mc, base=args.base)
    if args.ch_mult is not None:
        mc = replace(mc, ch_mult=tuple(int(c) for c in args.ch_mult.split(",")))
    z = torch.from_numpy(decode_embedding(args.bitstream, args.store_dir)).to(device)
    net = CLIPCondUNet(z_dim=z.shape[1], base=mc.base, ch_mult=mc.ch_mult, time_dim=mc.time_dim,
                       img_ch=3, dtype=torch.bfloat16)
    net.load_state_dict(sd, strict=True)
    net = net.to(device).eval()
    sched = NoiseSchedule.create(mc.timesteps, mc.schedule, device=device)
    sampler = make_sampler(args.sampler, sched, eta=args.eta)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    x = sampler.sample(net, z, (1, args.size, args.size, 3), steps=args.steps, generator=gen)
    to_pil(torch.clamp(x[0], -1.0, 1.0).cpu().numpy()).save(args.out)
    print(f"Saved to {args.out}")


if __name__ == "__main__":
    main()
