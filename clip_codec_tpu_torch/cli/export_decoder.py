"""Export a decompress program as a serving artifact: the port of
``clip_codec_tpu/cli/export_decoder.py``.

    python -m clip_codec_tpu_torch.cli.export_decoder \\
        --weights store/diffusion_unet_final.pt --out decoder.torchprog \\
        --size 256 --steps 50 --batch_size 16 --output uint8

    CLIP_CODEC_SD_UNET_WEIGHTS=unet.bin CLIP_CODEC_SD_VAE_WEIGHTS=vae.bin \\
    python -m clip_codec_tpu_torch.cli.export_decoder --sd --adapter adapter.pt --out sd.torchprog

The artifact (``deploy.py``) records the statics and the architecture; the
weights stay call-time arguments, so ``serve --artifact`` loads the same
checkpoint again. The pixel checkpoint is the port's ``.pt`` (or the JAX trainer's
``.msgpack``) with its
``model_config.json`` (``--base``/``--ch_mult``/``--z_dim`` override it or,
without one, the state dict's own shapes); the SD UNet and VAE come from
``$CLIP_CODEC_SD_UNET_WEIGHTS``/``$CLIP_CODEC_SD_VAE_WEIGHTS`` (diffusers
files, the head count from ``--heads``), the adapter from ``--adapter``.
Defaults as JAX's: 256px, 50 steps, batch 16 (pixel); 512px, 30 steps,
batch 1 (SD). ``--platforms`` names the device kinds the artifact may load
on (``cuda``, ``cpu``; default ``--device``'s). ``--int8`` exports the
static-int8 program: the U-Net's activation scales are calibrated here, on
``--device`` with the real weights (pixel: ``ops.int8.calibrate_unet`` at
the artifact's size over the schedule's length; SD:
``calibrate_int8_scales`` on both CFG branches, for a random unit
embedding from ``default_rng(0)``), and written, once the artifact is, to
``<out>.quant.pt`` (``torch.save`` of the quant dict; JAX writes
``.quant.msgpack``), which serving passes back in.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Optional, Sequence

from ..deploy import PLATFORMS


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Export the decompress program as a serving artifact.")
    ap.add_argument("--weights", type=str, default=None, help="pixel path: the decoder's .pt state dict or JAX .msgpack")
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
    ap.add_argument("--int8", action="store_true",
                    help="static-int8 serving program; calibrates here and writes <out>.quant.pt for serve boxes")
    ap.add_argument("--output", type=str, default="float32", choices=("float32", "uint8"),
                    help="pixel path: uint8 folds the PNG-prep conversion into the program "
                         "(4x smaller device-to-host copy)")
    args = ap.parse_args(argv)
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
    from ..utils.checkpoint import load_unet_checkpoint
    from ..utils.config import ModelConfig

    sd = load_unet_checkpoint(args.weights)
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
    quant = None
    if args.int8:
        # calibrate on the build box (the real weights are here) and ship the
        # quant dict as a sidecar the serving box passes back in
        import torch

        from ..models import CLIPCondUNet
        from ..ops.int8 import calibrate_unet

        with torch.device(args.device):
            net = CLIPCondUNet(z_dim=mc.z_dim, base=mc.base, ch_mult=mc.ch_mult, time_dim=mc.time_dim,
                               img_ch=mc.img_ch, dtype=torch.bfloat16, int8=True)
        net.load_state_dict(sd, strict=True)
        quant = calibrate_unet(net.eval(), size, mc.z_dim, timesteps=mc.timesteps)
    path = export_decompressor(sd, mc, args.out, size=size, steps=steps, sampler=args.sampler, eta=args.eta,
                               batch_size=batch, quant=quant, output=args.output, platforms=platforms)
    print(f"Exported {path} ({path.stat().st_size / 1024:.1f} KiB, sampler={args.sampler}, steps={steps}, "
          f"size={size}, batch={batch}, int8={args.int8}){_write_sidecar(path, quant)}")


def _write_sidecar(path: Path, quant) -> str:
    """Write ``<artifact>.quant.pt`` (only after the export succeeded: a
    stale sidecar beside an old artifact would mis-scale a later serve)."""
    if quant is None:
        return ""
    from ..deploy import QUANT_SUFFIX
    from ..ops.int8 import save_quant

    sidecar = Path(str(path) + QUANT_SUFFIX)
    save_quant(quant, sidecar)
    return f" + {sidecar}"


def _export_sd(args, platforms) -> None:
    if args.adapter is None:
        raise SystemExit("--sd requires --adapter <trained adapter checkpoint>")
    from ..deploy import export_sd_decompressor
    from ..weights import sd_checkpoint as ckpt

    unet_path, vae_path = ckpt.require_sd_weight_paths()
    size = 512 if args.size is None else args.size
    steps = 30 if args.steps is None else args.steps
    batch = 1 if args.batch_size is None else args.batch_size
    usd = ckpt.load_unet(unet_path)
    vsd = ckpt.load_vae(vae_path)
    asd = ckpt.load_adapter(Path(args.adapter))
    ucfg, vcfg = ckpt.unet_config(usd, heads=args.heads), ckpt.vae_config(vsd)
    quant = None
    if args.int8:
        quant = _calibrate_sd(args, usd, vsd, asd, ucfg, vcfg, size, batch)
    path = export_sd_decompressor(
        usd, vsd, asd, args.out, unet_cfg=ucfg, vae_cfg=vcfg, clip_dim=args.z_dim, size=size, steps=steps,
        sampler=args.sampler, eta=args.eta, batch_size=batch, quant=quant, platforms=platforms)
    print(f"Exported {path} ({path.stat().st_size / 1024:.1f} KiB, sd path, sampler={args.sampler}, "
          f"steps={steps}, size={size}, batch={batch}, int8={args.int8}){_write_sidecar(path, quant)}")


def _calibrate_sd(args, usd, vsd, asd, ucfg, vcfg, size: int, batch: int):
    """The SD UNet's quant dict, calibrated as JAX's export CLI does: a
    decoder with the int8 UNet, a random unit embedding per batch row from
    ``default_rng(0)``, both CFG branches at the artifact's latent shape."""
    import numpy as np
    import torch

    from ..models.sd import AutoencoderKL, SDClipAdapter, SDUNet, StableDiffusionDecoder
    from ..weights.sd_checkpoint import adapter_dims

    clip_dim, hidden = adapter_dims(asd)
    with torch.device(args.device):
        unet = SDUNet(ucfg, dtype=torch.bfloat16, int8=True)
        vae = AutoencoderKL(vcfg, dtype=torch.bfloat16)
        adapter = SDClipAdapter(clip_dim, ucfg.cross_dim, hidden,
                                int(asd["proj.3.weight"].shape[0]) // ucfg.cross_dim)
    for mod, state in ((unet, usd), (vae, vsd), (adapter, asd)):
        mod.load_state_dict(state, strict=True)
    dec = StableDiffusionDecoder(unet, vae, adapter)
    f = 2 ** (len(vcfg.block_out) - 1)
    r = np.random.default_rng(0).standard_normal((batch, clip_dim))
    z = torch.from_numpy((r / (np.linalg.norm(r, axis=1, keepdims=True) + 1e-9)).astype(np.float32))
    dec.calibrate_int8_scales(z.to(args.device), (batch, size // f, size // f, vcfg.latent_ch))
    return dec.unet_quant


if __name__ == "__main__":
    main()
