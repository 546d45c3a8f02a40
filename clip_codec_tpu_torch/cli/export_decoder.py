"""Export a decompress program as a serving artifact: the port of
``clip_codec_tpu/cli/export_decoder.py``.

    python -m clip_codec_tpu_torch.cli.export_decoder \\
        --weights store/diffusion_unet_final.pt --out decoder.torchprog \\
        --size 256 --steps 50 --batch_size 16 --output uint8

    CLIP_CODEC_SD_UNET_WEIGHTS=unet.bin CLIP_CODEC_SD_VAE_WEIGHTS=vae.bin \\
    python -m clip_codec_tpu_torch.cli.export_decoder --sd --adapter adapter.pt --out sd.torchprog

The artifact (``deploy.py``) records the statics and the architecture; the
weights stay call-time arguments, so ``serve --artifact`` loads the same
checkpoint again. The pixel checkpoint is the port's ``.pt`` with its
``model_config.json`` (``--base``/``--ch_mult``/``--z_dim`` override it or,
without one, the state dict's own shapes); the SD UNet and VAE come from
``$CLIP_CODEC_SD_UNET_WEIGHTS``/``$CLIP_CODEC_SD_VAE_WEIGHTS`` (diffusers
files, the head count from ``--heads``), the adapter from ``--adapter``.
Defaults as JAX's: 256px, 50 steps, batch 16 (pixel); 512px, 30 steps,
batch 1 (SD). ``--platforms`` names the device kinds the artifact may load
on (``cuda``, ``cpu``; default ``--device``'s). ``--int8`` is refused: int8
serving waits for ``ops/int8.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Optional, Sequence

from ..deploy import PLATFORMS


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Export the decompress program as a serving artifact.")
    ap.add_argument("--weights", type=str, default=None, help="pixel path: the decoder's .pt state dict")
    ap.add_argument("--sd", action="store_true",
                    help="export the SD latent path instead (frozen UNet/VAE from "
                         "$CLIP_CODEC_SD_UNET_WEIGHTS/$CLIP_CODEC_SD_VAE_WEIGHTS + --adapter)")
    ap.add_argument("--adapter", type=str, default=None, help="trained SD adapter checkpoint (with --sd)")
    ap.add_argument("--out", type=str, default="decoder.torchprog")
    ap.add_argument("--size", type=int, default=None, help="output resolution (default: 256 pixel / 512 sd)")
    ap.add_argument("--steps", type=int, default=None, help="sampling steps (default: 50 pixel / 30 sd)")
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--batch_size", type=int, default=None,
                    help="static serving batch baked into the artifact (default: 16 pixel / 1 sd)")
    ap.add_argument("--sampler", type=str, default="ddim", choices=("ddim", "ddim_std", "dpmpp"))
    ap.add_argument("--platforms", type=str, default=None,
                    help=f"comma-separated device kinds the artifact may load on, of {PLATFORMS} "
                         "(default: --device's)")
    ap.add_argument("--device", type=str, default="cuda", choices=PLATFORMS)
    ap.add_argument("--base", type=int, default=None)
    ap.add_argument("--ch_mult", type=str, default=None)
    ap.add_argument("--z_dim", type=int, default=None, help="override the z_dim inferred from the checkpoint")
    ap.add_argument("--heads", type=int, default=8,
                    help="SD UNet attention heads (not recoverable from the weight shapes)")
    ap.add_argument("--int8", action="store_true", help="int8 serving program (not ported)")
    ap.add_argument("--output", type=str, default="float32", choices=("float32", "uint8"),
                    help="pixel path: uint8 folds the PNG-prep conversion into the program "
                         "(4x smaller device-to-host copy)")
    args = ap.parse_args(argv)
    if args.int8:
        raise SystemExit("--int8 is not ported to the PyTorch package yet (ops/int8.py)")
    platforms = args.platforms.split(",") if args.platforms else [args.device]
    if args.sd:
        _export_sd(args, platforms)
        return
    if args.weights is None:
        ap.error("--weights is required (or pass --sd --adapter for the SD path)")
    size = 256 if args.size is None else args.size
    steps = 50 if args.steps is None else args.steps
    batch = 16 if args.batch_size is None else args.batch_size

    from ..deploy import export_decompressor
    from ..utils.checkpoint import load_state_dict
    from ..utils.config import ModelConfig

    sd = load_state_dict(args.weights)
    overrides = {}
    if args.z_dim is not None:
        overrides["z_dim"] = args.z_dim
    if args.base is not None:
        overrides["base"] = args.base
    if args.ch_mult is not None:
        overrides["ch_mult"] = tuple(int(c) for c in args.ch_mult.split(","))
    mc = ModelConfig.find_for_checkpoint(args.weights)
    if mc is None:
        mc = ModelConfig.infer_from_state_dict(sd, **overrides)
    elif overrides:  # explicit flags beat the config file, as in the reconstruct/eval CLIs
        mc = dataclasses.replace(mc, **overrides)
    path = export_decompressor(sd, mc, args.out, size=size, steps=steps, sampler=args.sampler, eta=args.eta,
                               batch_size=batch, output=args.output, platforms=platforms)
    print(f"Exported {path} ({path.stat().st_size / 1024:.1f} KiB, sampler={args.sampler}, steps={steps}, "
          f"size={size}, batch={batch}, int8=False)")


def _export_sd(args, platforms) -> None:
    if args.adapter is None:
        raise SystemExit("--sd requires --adapter <trained adapter checkpoint>")
    from ..deploy import export_sd_decompressor
    from ..weights import sd_checkpoint as ckpt

    unet_path, vae_path = ckpt.require_sd_weight_paths()
    size = 512 if args.size is None else args.size
    steps = 30 if args.steps is None else args.steps
    batch = 1 if args.batch_size is None else args.batch_size
    usd = ckpt.unet_state_dict(ckpt.read_checkpoint(unet_path))
    vsd = ckpt.vae_state_dict(ckpt.read_checkpoint(vae_path))
    asd = ckpt.adapter_state_dict(ckpt.read_checkpoint(Path(args.adapter)))
    path = export_sd_decompressor(
        usd, vsd, asd, args.out, unet_cfg=ckpt.unet_config(usd, heads=args.heads), vae_cfg=ckpt.vae_config(vsd),
        clip_dim=args.z_dim, size=size, steps=steps, sampler=args.sampler, eta=args.eta, batch_size=batch,
        platforms=platforms)
    print(f"Exported {path} ({path.stat().st_size / 1024:.1f} KiB, sd path, sampler={args.sampler}, "
          f"steps={steps}, size={size}, batch={batch}, int8=False)")


if __name__ == "__main__":
    main()
