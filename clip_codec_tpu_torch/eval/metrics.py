"""Reconstruction-quality metrics — the port of ``clip_codec_tpu/eval/metrics.py``.

The scalar functions take [-1, 1] float arrays shaped (C, H, W) or
(H, W, C), as the reference's do; the batched ones take (B, H, W, C) [-1, 1]
tensors and compute on the tensors' device:

* ``to_uint8`` truncates (clip then cast, no rounding), as the reference's
  ``_to_uint8``; PSNR and SSIM are taken on the uint8-quantized images, in
  fp32;
* SSIM has skimage's ``structural_similarity(data_range=255,
  channel_axis=-1)`` defaults: 7x7 uniform window, sample covariance
  (N / (N - 1)), K1 = 0.01, K2 = 0.03, the mean over the edge-cropped
  (VALID) map. The window sums of uint8 values and their products are
  integers below 2^24, so they are exact in fp32 in any order;
* LPIPS (``eval/lpips.py``) and CLIP similarity (``encoders.ClipEncoder``)
  load their weights once per device, from ``$CLIP_CODEC_LPIPS_WEIGHTS`` and
  ``$CLIP_CODEC_CLIP_WEIGHTS``. A metric reads NaN where its variable is
  unset; a file that is set but does not load raises (the JAX package reads
  NaN for it too).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

Device = Union[str, torch.device]


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8 on the host: clip, then truncate."""
    return (((np.asarray(img) + 1.0) * 127.5).clip(0, 255)).astype(np.uint8)


_to_uint8 = to_uint8  # reference-name alias


def _hwc(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        return img.transpose(1, 2, 0)
    return img


def _u8_float(x_m11: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8-quantized fp32 values, as ``to_uint8`` on the device."""
    return ((x_m11.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).float()


# ------------------------------------------------------------------- PSNR


def psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR on uint8-quantized images, 255 peak; inf for equal images."""
    x1 = to_uint8(img1).astype(np.float32)
    x2 = to_uint8(img2).astype(np.float32)
    mse = float(np.mean((x1 - x2) ** 2))
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(255.0 / np.sqrt(mse)))


def psnr_batch(a_m11: torch.Tensor, b_m11: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) pairs -> (B,) fp32 PSNR on uint8-quantized images; inf
    where a pair quantizes equal."""
    qa, qb = _u8_float(a_m11), _u8_float(b_m11)
    mse = ((qa - qb) ** 2).mean(dim=(1, 2, 3))
    out = 20.0 * torch.log10(255.0 / torch.sqrt(mse.clamp_min(1e-12)))
    return torch.where(mse == 0, torch.full_like(out, float("inf")), out)


# ------------------------------------------------------------------- SSIM


def _uniform_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, C, H, W) -> the VALID ``win`` x ``win`` window mean: the exact sum,
    then one division."""
    return F.avg_pool2d(x, win, stride=1, divisor_override=1) / (win * win)


def ssim_batch(a_m11: torch.Tensor, b_m11: torch.Tensor, win: int = 7, data_range: float = 255.0) -> torch.Tensor:
    """(B, H, W, C) [-1, 1] pairs -> (B,) fp32 SSIM, skimage's defaults."""
    x = _u8_float(a_m11).permute(0, 3, 1, 2)
    y = _u8_float(b_m11).permute(0, 3, 1, 2)
    np_ = win * win
    cov_norm = np_ / (np_ - 1.0)
    ux, uy = _uniform_valid(x, win), _uniform_valid(y, win)
    uxx, uyy, uxy = _uniform_valid(x * x, win), _uniform_valid(y * y, win), _uniform_valid(x * y, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2, 3))


def ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """Scalar SSIM of (C, H, W) or (H, W, C) [-1, 1] images."""
    return float(ssim_batch(torch.as_tensor(_hwc(img1)[None]), torch.as_tensor(_hwc(img2)[None]))[0])


# ------------------------------------------------------- loaded-once scorers

_SCORERS: Dict[Tuple[str, str, str], object] = {}


def _scorer(kind: str, env: str, device: Device, load):
    """The ``kind`` scorer from the file ``$env`` names, on ``device``, loaded
    once; None while ``env`` is unset."""
    path = os.environ.get(env)
    if not path:
        return None
    key = (kind, path, str(torch.device(device)))
    if key not in _SCORERS:
        _SCORERS[key] = load(torch.device(device))
    return _SCORERS[key]


def _default_lpips(device: Device = "cuda"):
    """``LPIPSModel.from_env`` on ``device``, once; None without ``$CLIP_CODEC_LPIPS_WEIGHTS``."""
    from .lpips import ENV, LPIPSModel

    return _scorer("lpips", ENV, device, lambda d: LPIPSModel.from_env(d))


def _default_clip_encoder(device: Device = "cuda"):
    """``ClipEncoder`` (ViT-B/32, bf16) on ``device``, once; None without ``$CLIP_CODEC_CLIP_WEIGHTS``."""
    from ..encoders import ClipEncoder

    return _scorer("clip", "CLIP_CODEC_CLIP_WEIGHTS", device, lambda d: ClipEncoder(device=d))


# ------------------------------------------------------------------- LPIPS


def lpips_batch(orig_hwc, recon_hwc, lpips_model=None, device: Device = "cuda") -> np.ndarray:
    """(B, H, W, C) [-1, 1] pairs -> (B,) LPIPS as fp32 numpy, one VGG pass
    on the scorer's device; NaN without weights."""
    model = lpips_model or _default_lpips(device)
    if model is None:
        return np.full((orig_hwc.shape[0],), np.nan, np.float32)
    return model.distance(torch.as_tensor(orig_hwc), torch.as_tensor(recon_hwc)).cpu().numpy()


def lpips_distance(img1: np.ndarray, img2: np.ndarray, lpips_model=None, device: Device = "cuda") -> float:
    """LPIPS (VGG backbone) of two images; NaN without weights."""
    return float(lpips_batch(_hwc(img1)[None], _hwc(img2)[None], lpips_model, device)[0])


# ------------------------------------------------------------- CLIP similarity


def _clip_inputs(images, image_size: int) -> np.ndarray:
    """[-1, 1] images -> the CLIP preprocess of their uint8 PIL form, uint8
    (N, S, S, 3), as the reference's per-image PIL path."""
    from ..encoders.clip import preprocess_pil_u8

    return np.stack([preprocess_pil_u8(Image.fromarray(to_uint8(img)), image_size) for img in images])


def clip_similarity_batch(orig_hwc, recon_hwc, encoder=None, device: Device = "cuda") -> np.ndarray:
    """(B, H, W, C) [-1, 1] pairs -> (B,) cosine of their CLIP embeddings:
    the full CLIP preprocess on the host, then one tower pass per side
    (uint8 normalized on the encoder's device); NaN without weights."""
    enc = encoder or _default_clip_encoder(device)
    if enc is None:
        return np.full((len(orig_hwc),), np.nan, np.float32)
    f1 = enc.encode_image_array(_clip_inputs(np.asarray(orig_hwc), enc.cfg.image_size))
    f2 = enc.encode_image_array(_clip_inputs(np.asarray(recon_hwc), enc.cfg.image_size))
    return np.sum(f1 * f2, axis=-1)


def clip_similarity(img1: np.ndarray, img2: np.ndarray, encoder=None, device: Device = "cuda") -> float:
    """Cosine similarity of two images' CLIP embeddings; NaN without weights."""
    return float(clip_similarity_batch(_hwc(img1)[None], _hwc(img2)[None], encoder, device)[0])
