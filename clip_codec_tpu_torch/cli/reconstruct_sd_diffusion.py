"""Reconstruct an image from a ``.clp`` bitstream through the frozen SD-1.5
UNet and VAE and a trained CLIP adapter, with classifier-free guidance and
feature-inversion guidance.

    CLIP_CODEC_SD_UNET_WEIGHTS=unet/diffusion_pytorch_model.bin \\
    CLIP_CODEC_SD_VAE_WEIGHTS=vae/diffusion_pytorch_model.bin \\
    CLIP_CODEC_CLIP_WEIGHTS=ViT-B-32.pt \\
    python -m clip_codec_tpu_torch.cli.reconstruct_sd_diffusion --store_dir STORE \\
        --bitstream img.clp --adapter adapter.pt --device cuda

Flags as the JAX CLI (``clip_codec_tpu/cli/reconstruct_sd_diffusion.py``).
The UNet and VAE are diffusers checkpoints (``.bin``/``.pt``, or
``.safetensors`` where the safetensors package is installed) and the adapter
a ``.pt``; all load as they are. Each may instead be the JAX package's
``.msgpack`` tree (its converted UNet/VAE, its ``sd_adapter_*.msgpack``),
read and mapped in the port's own code (no jax or msgpack needed). The architecture is read off the weight shapes except
the head count (``--heads``). ``--device`` is ``cpu`` or ``cuda``; ``cuda``
without a card is an error.

Inversion (``--inv_weight`` > 0, 1.0 by default) steers every
``--inv_every``-th step towards the bitstream's own embedding through an
image tower: ``--inv_backend auto`` picks the CLIP ViT-B/32 tower
(``$CLIP_CODEC_CLIP_WEIGHTS``) at dim 512 and the DINOv2 ViT-B/14 tower
(``$CLIP_CODEC_DINO_WEIGHTS``) at any other dim; ``clip`` at another dim
raises, as in JAX. ``--inv_clip_arch``, ``--inv_clip_ckpt`` and
``--inv_dino_model`` are accepted and unused, as in the JAX CLI.
``--int8`` (with ``--inv_weight 0``: JAX refuses it with inversion, and so
does this CLI) samples with the static-int8 UNet (``ops/int8.py``), its
scales calibrated first on both CFG branches (``calibrate_int8_scales``).
The default output name is ``<stem>-<steps>-<guidance>-<inv_weight>.png``
beside the bitstream.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..encoders.clip import CLIP_MEAN, CLIP_STD, CLIPModel
from ..encoders.dino import DinoV2, embed_m11_images_dino
from ..models.sd import AutoencoderKL, SDClipAdapter, SDUNet, StableDiffusionDecoder
from ..models.sd.decoder import EmbedFn, clip_m11
from ..weights import sd_checkpoint as ckpt
from ._common import add_int8_flag, apply_int8_flag

PathLike = Union[str, Path]
N_TOKENS = 8


def load_frozen(unet_path: PathLike, vae_path: PathLike, device: Union[str, torch.device],
                heads: int = 8, int8: Optional[bool] = None) -> Tuple[SDUNet, AutoencoderKL]:
    """The UNet and VAE from diffusers files, loaded with ``strict=True``
    into modules built on ``device`` with fp32 parameters that compute in
    bf16, as the JAX CLIs' decoder does; ``int8`` is the UNet's setting."""
    usd = ckpt.load_unet(unet_path)
    vsd = ckpt.load_vae(vae_path)
    with torch.device(device):
        unet = SDUNet(ckpt.unet_config(usd, heads=heads), dtype=torch.bfloat16, int8=int8)
        vae = AutoencoderKL(ckpt.vae_config(vsd), dtype=torch.bfloat16)
    unet.load_state_dict(usd, strict=True)
    vae.load_state_dict(vsd, strict=True)
    return unet, vae


def load_decoder(unet_path: PathLike, vae_path: PathLike, adapter_path: PathLike,
                 device: Union[str, torch.device], heads: int = 8, int8: Optional[bool] = None
                 ) -> StableDiffusionDecoder:
    """The SD decoder from diffusers UNet/VAE files and a reference adapter
    file (``load_frozen``; the adapter is fp32, ``strict=True``)."""
    unet, vae = load_frozen(unet_path, vae_path, device, heads, int8)
    asd = ckpt.load_adapter(adapter_path)
    in_dim, hidden = ckpt.adapter_dims(asd)
    with torch.device(device):
        adapter = SDClipAdapter(in_dim, unet.cfg.cross_dim, hidden, N_TOKENS)
    adapter.load_state_dict(asd, strict=True)
    return StableDiffusionDecoder(unet, vae, adapter)


def sample_images(dec: StableDiffusionDecoder, z: np.ndarray, size: int, steps: int = 30,
                  sampler: str = "ddim", eta: float = 0.0, guidance: float = 5.0,
                  seed: int = 0, inv_weight: float = 0.0, inv_every: int = 1,
                  embed_fn: Optional[EmbedFn] = None) -> torch.Tensor:
    """(B, D) embeddings -> (B, size, size, 3) images in [-1, 1] (the VAE's
    dtype), the initial latents drawn from a generator seeded with ``seed``;
    with ``inv_weight > 0``, guided towards ``z`` itself through ``embed_fn``."""
    vcfg = dec.vae.cfg
    f = 2 ** (len(vcfg.block_out) - 1)
    dev = next(dec.unet.parameters()).device
    shape = (z.shape[0], size // f, size // f, vcfg.latent_ch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    zt = torch.from_numpy(np.asarray(z, np.float32)).to(dev)
    return dec.sample_with_inversion(zt, zt, embed_fn, shape, steps=steps, eta=eta, guidance_scale=guidance,
                                     inv_weight=inv_weight, inv_every=inv_every, generator=gen,
                                     sampler=sampler)


def clip_embed_fn(model: CLIPModel) -> EmbedFn:
    """The inversion encoder on a CLIP tower, as the JAX CLI builds it:
    [-1, 1] NHWC images clipped, mapped to [0, 1], resized bilinear (no
    antialias) to 224, CLIP mean/std normalized in fp32, then the image
    tower's unnormalized features in fp32. Differentiable in the images."""
    mean, std = (torch.from_numpy(a) for a in (CLIP_MEAN, CLIP_STD))

    def embed(x_m11: torch.Tensor) -> torch.Tensor:
        x = (clip_m11(x_m11) + 1.0) / 2.0
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(224, 224), mode="bilinear", align_corners=False,
                          antialias=False).permute(0, 2, 3, 1)
        x = (x - mean.to(x.device)) / std.to(x.device)
        return model.encode_image(x).float()

    return embed


def dino_embed_fn(model: DinoV2) -> EmbedFn:
    """The inversion encoder on a DINOv2 tower, as the JAX CLI builds it:
    [-1, 1] NHWC images clipped, mapped to [0, 1], resized bilinear (no
    antialias) to the tower's image size, ImageNet-normalized, then the
    tower's unnormalized CLS in fp32 (``embed_m11_images_dino``).
    Differentiable in the images."""
    return lambda x_m11: embed_m11_images_dino(model, x_m11, model.cfg.image_size)


def resolve_backend(backend: str, dim: int) -> str:
    """``--inv_backend`` against the bitstream's dim: ``auto`` is ``clip``
    at 512 and ``dino`` otherwise; ``clip`` at another dim raises, as in JAX."""
    if backend == "auto":
        backend = "clip" if dim == 512 else "dino"
    if backend == "clip" and dim != 512:
        raise ValueError(f"inv_backend=clip but bitstream dim is {dim}; use --inv_backend dino (or auto)")
    return backend


def _fmt_num(x: float) -> str:
    return f"{x:g}"


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Reconstruct an image from a .clp bitstream via SD-1.5 + CFG.")
    ap.add_argument("--store_dir", type=Path, required=True)
    ap.add_argument("--bitstream", type=Path, required=True)
    ap.add_argument("--adapter", type=Path, required=True, help="trained adapter checkpoint (.pt, or a JAX sd_adapter_*.msgpack)")
    ap.add_argument("--model_name", type=str, default="runwayml/stable-diffusion-v1-5")
    ap.add_argument("--out", type=Path, default=Path("recon.png"))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--sampler", type=str, default="ddim", choices=("ddim", "dpmpp"))
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--guidance", type=float, default=5.0)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", type=str, default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--inv_weight", type=float, default=1.0)
    ap.add_argument("--inv_every", type=int, default=1)
    ap.add_argument("--inv_clip_arch", type=str, default="ViT-B-32")
    ap.add_argument("--inv_clip_ckpt", type=str, default="openai")
    ap.add_argument("--inv_backend", type=str, default="auto", choices=["auto", "dino", "clip"])
    ap.add_argument("--inv_dino_model", type=str, default="vit_base_patch14_dinov2.lvd142m")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--heads", type=int, default=8,
                    help="UNet attention heads (not recoverable from the weight shapes)")
    add_int8_flag(ap)
    args = ap.parse_args(argv)
    inv_use = args.inv_weight > 0
    if args.int8 and inv_use:
        raise SystemExit(
            "--int8 is incompatible with inversion guidance (round() has zero "
            "gradient, so the latent gradient through int8 convs vanishes); "
            "pass --inv_weight 0"
        )
    apply_int8_flag(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use --device cpu)")

    from ..train.train_decoder import decode_embedding, to_pil

    unet_path, vae_path = ckpt.require_sd_weight_paths(args.model_name)
    z = decode_embedding(args.bitstream, args.store_dir)  # (1, dim), L2-normalized
    backend = resolve_backend(args.inv_backend, z.shape[1]) if inv_use else None
    dec = load_decoder(unet_path, vae_path, args.adapter, args.device, heads=args.heads,
                       int8=True if args.int8 else None)
    if args.int8:
        # static activation scales, both CFG branches
        f = 2 ** (len(dec.vae.cfg.block_out) - 1)
        dec.calibrate_int8_scales(torch.from_numpy(z).to(args.device),
                                  (1, args.size // f, args.size // f, dec.vae.cfg.latent_ch))
    embed_fn = None
    if backend == "clip":
        from ..encoders import ClipEncoder

        embed_fn = clip_embed_fn(ClipEncoder(device=args.device).model)
    elif backend == "dino":
        from ..encoders import DinoEncoder

        embed_fn = dino_embed_fn(DinoEncoder(device=args.device).model)
    img = sample_images(dec, z, args.size, args.steps, args.sampler, args.eta, args.guidance, args.seed,
                        inv_weight=args.inv_weight, inv_every=args.inv_every, embed_fn=embed_fn)
    if args.out == Path("recon.png"):  # the default is detected by value, as in the JAX CLI
        out_path = args.bitstream.with_name(f"{args.bitstream.stem}-{args.steps}-{_fmt_num(args.guidance)}-"
                                            f"{_fmt_num(args.inv_weight)}.png")
    else:
        out_path = args.out
    to_pil(img[0].float().cpu().numpy()).save(out_path)
    print("Saved to", out_path)


if __name__ == "__main__":
    main()
