"""Reconstruction-quality metrics: PSNR, SSIM, LPIPS-VGG and CLIP similarity
— the port of ``clip_codec_tpu/eval``."""

from .metrics import (
    _to_uint8,
    clip_similarity,
    lpips_distance,
    psnr,
    psnr_batch,
    ssim,
    ssim_batch,
    to_uint8,
)

__all__ = [
    "_to_uint8", "to_uint8", "psnr", "psnr_batch", "ssim", "ssim_batch",
    "lpips_distance", "clip_similarity",
]
