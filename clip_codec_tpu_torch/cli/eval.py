"""Evaluate reconstruction quality over a whole store: PSNR, SSIM, LPIPS and
CLIP similarity of every image against its reconstruction from its frame.

    CLIP_CODEC_LPIPS_WEIGHTS=lpips_vgg.pt CLIP_CODEC_CLIP_WEIGHTS=ViT-B-32.pt \\
    python -m clip_codec_tpu_torch.cli.eval --store_dir STORE \\
        --weights STORE/diffusion_unet_final.pt --out_json metrics.json

Flags, the four stdout lines, the NaN-skipping means and the ``--out_json``
records as the JAX CLI (``clip_codec_tpu/cli/eval.py``). Reconstruction runs
``--batch_size`` frames at a time (the last batch zero-padded) through the
pixel U-Net in its serving form (bf16) and the sampler of ``--sampler``, the
initial noise of every batch drawn in turn from one generator seeded with
``--seed``; PSNR and SSIM are computed on the device, LPIPS and CLIP
similarity by scorers loaded once (NaN where ``$CLIP_CODEC_LPIPS_WEIGHTS`` or
``$CLIP_CODEC_CLIP_WEIGHTS`` is unset). ``--weights`` is a ``.pt`` state dict
or the JAX trainer's ``.msgpack``; the ``model_config.json`` beside it, if any, gives the architecture and
schedule (else ``--base``, ``--ch_mult`` and a 1000-step cosine schedule).
``--device`` is ``cuda`` (the default) or ``cpu``. ``--int8`` evaluates the
static-int8 U-Net (``ops/int8.py``), calibrated first as JAX's CLI does.

``--data_parallel`` (as JAX's) splits each reconstruction batch over the
launcher's ranks through ``parallel.sample_sharded``, the reference-parity
DDIM (``--batch_size`` must divide by the rank count; another ``--sampler``
is refused, where JAX's CLI runs DDIM whatever it names); the initial noise
is drawn for the whole batch from the same generator, so the images are a
one-rank run's. Rank 0 computes the four metrics on the gathered images and
prints them.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..eval.metrics import (_default_clip_encoder, _default_lpips, clip_similarity_batch, lpips_batch,
                            psnr_batch, ssim_batch)
from ._common import add_int8_flag, add_parallel_flags, apply_int8_flag, make_mesh_from_flags


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Evaluate reconstruction quality on a store of images.")
    ap.add_argument("--store_dir", type=str, required=True)
    ap.add_argument("--weights", type=str, required=True)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--sampler", type=str, default="ddim", choices=("ddim", "ddim_std", "dpmpp"),
                    help="ddim (reference-parity), ddim_std (textbook strided DDIM), "
                         "or dpmpp (DPM-Solver++(2M), eta=0 only)")
    ap.add_argument("--device", type=str, default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--out_json", type=str, default=None)
    ap.add_argument("--batch_size", type=int, default=8, help="DDIM reconstruction batch")
    ap.add_argument("--base", type=int, default=None,
                    help="U-Net base width (default: model_config.json next to --weights, else 128)")
    ap.add_argument("--ch_mult", type=str, default=None, help="U-Net channel multipliers")
    ap.add_argument("--seed", type=int, default=0)
    add_int8_flag(ap)
    add_parallel_flags(ap, distributed=False)
    args = ap.parse_args(argv)
    if args.data_parallel and args.sampler != "ddim":
        raise SystemExit(f"--data_parallel samples with the reference-parity ddim (parallel.sample_sharded), "
                         f"not --sampler {args.sampler}")
    apply_int8_flag(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use --device cpu)")

    from ..diffusion import NoiseSchedule, make_sampler
    from ..io.store import Store
    from ..models import CLIPCondUNet
    from ..ops.int8 import calibrate_unet, load_quant
    from ..parallel import sample_sharded
    from ..parallel.mesh import axis_size, barrier, is_main, rank_device
    from ..train.data import load_image_m11
    from ..utils.batching import pad_rows
    from ..utils.checkpoint import load_unet_checkpoint
    from ..utils.config import ModelConfig

    mesh = make_mesh_from_flags(args)
    if mesh is not None and args.batch_size % axis_size(mesh):
        raise ValueError(f"batch_size={args.batch_size} not divisible by the data-axis size {axis_size(mesh)}")
    main = is_main(mesh)
    device = rank_device(mesh) if mesh is not None else torch.device(args.device)
    store = Store.open(args.store_dir)
    mc = ModelConfig.find_for_checkpoint(args.weights)
    base = args.base if args.base is not None else (mc.base if mc else 128)
    ch_mult = (tuple(int(c) for c in args.ch_mult.split(","))
               if args.ch_mult is not None else (mc.ch_mult if mc else (1, 2, 2)))
    net = CLIPCondUNet(z_dim=store.dim, base=base, ch_mult=ch_mult, time_dim=mc.time_dim if mc else 256,
                       img_ch=3, dtype=torch.bfloat16, int8=True if args.int8 else None)
    net.load_state_dict(load_unet_checkpoint(args.weights), strict=True)
    net = net.to(device).eval()
    sched = (NoiseSchedule.create(mc.timesteps, mc.schedule, device=device) if mc
             else NoiseSchedule.create(1000, "cosine", device=device))
    if args.int8:
        # static activation scales (ops/int8.py calibrate_unet)
        load_quant(net, calibrate_unet(net, args.size, store.dim, timesteps=sched.timesteps))
    sampler = make_sampler(args.sampler, sched, eta=args.eta)
    lpips_model = _default_lpips(device) if main else None
    clip_enc = _default_clip_encoder(device) if main else None

    metrics = []
    B = args.batch_size
    n = len(store)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for s in range(0, n, B):
        idx = list(range(s, min(s + B, n)))
        zb = pad_rows(np.stack([store.decode_vector(i) for i in idx]), B)
        if mesh is not None:
            x = torch.from_numpy(sample_sharded(mesh, net, sched, zb, args.size, args.steps, args.eta,
                                                generator=gen)).to(device)
            if not main:  # rank 0 scores the gathered images
                continue
        else:
            x = sampler.sample(net, torch.from_numpy(zb).to(device), (B, args.size, args.size, 3),
                               steps=args.steps, generator=gen)
        recon = torch.clamp(x[: len(idx)].float(), -1.0, 1.0)
        orig = torch.from_numpy(np.stack([load_image_m11(store.manifest[i]["image"], args.size)
                                          for i in idx])).to(device)
        ps = psnr_batch(orig, recon).cpu().numpy()
        ss = ssim_batch(orig, recon).cpu().numpy()
        lp = lpips_batch(orig, recon, lpips_model=lpips_model, device=device)
        cs = clip_similarity_batch(orig.cpu().numpy(), recon.cpu().numpy(), encoder=clip_enc, device=device)
        for j, i in enumerate(idx):
            metrics.append({
                "image": store.manifest[i]["image"],
                "psnr": float(ps[j]),
                "ssim": float(ss[j]),
                "lpips": float(lp[j]),
                "clip_sim": float(cs[j]),
            })

    def _agg(key):
        vals = [m[key] for m in metrics if not np.isnan(m[key])]
        return float(np.mean(vals)) if vals else float("nan")

    if main:
        print(f"Average PSNR: {_agg('psnr'):.2f} dB")
        print(f"Average SSIM: {_agg('ssim'):.4f}")
        print(f"Average LPIPS: {_agg('lpips'):.4f}")
        print(f"Average CLIP similarity: {_agg('clip_sim'):.4f}")
        if args.out_json:
            with open(args.out_json, "w", encoding="utf-8") as f:
                json.dump(metrics, f, ensure_ascii=False, indent=2)
    barrier(mesh)


if __name__ == "__main__":
    main()
