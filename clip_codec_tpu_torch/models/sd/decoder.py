"""Stable-Diffusion latent decoder — the port of ``clip_codec_tpu/models/sd/decoder.py``.

* :class:`SDClipAdapter`: LayerNorm (eps 1e-6) -> Linear -> SiLU -> Linear
  from a CLIP embedding to ``n_tokens`` cross-attention tokens, fp32, under
  the reference ``proj.0/1/3`` state-dict names;
* the SD-1.5 DDIM scheduler tables (scaled-linear betas 0.00085 -> 0.012,
  "leading" spacing with steps_offset=1, ``set_alpha_to_one=False``), host
  numpy, bit-equal to the JAX ones;
* :class:`StableDiffusionDecoder`: the frozen UNet and VAE with the
  adapter; ``decode``, ``forward`` and ``sample`` with classifier-free
  guidance, ``adapter(0)`` as the null embedding, ``sampler="ddim"`` or
  ``"dpmpp"`` (whose final target is alpha-bar 1).

Sampling is a Python loop over fp32 per-step coefficients precomputed on the
host; the update runs in fp32 on the device while the UNet computes in its
own dtype. Feature-inversion guidance (the JAX ``sample_with_inversion``
with ``inv_weight > 0``) and int8 are not ported; see ``ROADMAP.md``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...diffusion.dpm import dpmpp_coefficients
from .layers import LN_EPS, layer_norm
from .unet import SDUNet
from .vae import AutoencoderKL

SD_SCALING_FACTOR = 0.18215
SD_TIMESTEPS = 1000  # the SD-1.5 training schedule's length
SAMPLERS = ("ddim", "dpmpp")


class SDClipAdapter(nn.Module):
    """CLIP embedding (B, in_dim) -> (B, n_tokens, ctx_dim) tokens, fp32."""

    def __init__(self, in_dim: int = 512, ctx_dim: int = 768, hidden: int = 1024,
                 n_tokens: int = 4) -> None:
        super().__init__()
        self.ctx_dim, self.n_tokens = ctx_dim, n_tokens
        self.proj = nn.Sequential(nn.LayerNorm(in_dim, eps=LN_EPS), nn.Linear(in_dim, hidden), nn.SiLU(),
                                  nn.Linear(hidden, ctx_dim * n_tokens))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        ln, fc1, _, fc2 = self.proj
        h = fc2(F.silu(fc1(layer_norm(ln, z, torch.float32))))
        return h.reshape(z.shape[0], self.n_tokens, self.ctx_dim)


# ------------------------------------------------------- SD DDIM scheduler


def sd_alphas_cumprod(timesteps: int = 1000) -> np.ndarray:
    """Scaled-linear schedule: betas = linspace(sqrt(b0), sqrt(b1), T)^2."""
    betas = np.linspace(0.00085**0.5, 0.012**0.5, timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def sd_ddim_timesteps(steps: int, timesteps: int = 1000, steps_offset: int = 1) -> np.ndarray:
    """diffusers "leading" spacing: arange(steps) * (T // steps) + offset, descending."""
    ratio = timesteps // steps
    ts = (np.arange(steps) * ratio).round().astype(np.int64) + steps_offset
    return ts[::-1].copy()


@dataclass
class SDSchedulerTables:
    alphas_cumprod: np.ndarray
    final_alpha_cumprod: float  # set_alpha_to_one=False -> alphas_cumprod[0]

    @classmethod
    def create(cls, timesteps: int = 1000) -> "SDSchedulerTables":
        ac = sd_alphas_cumprod(timesteps)
        return cls(alphas_cumprod=ac, final_alpha_cumprod=float(ac[0]))


def sd_step_coefficients(steps: int, timesteps: int = 1000, sampler: str = "ddim",
                         eta: float = 0.0) -> Tuple[np.ndarray, dict]:
    """The timesteps and the fp32 per-step coefficients of the CFG sampler:
    ``c_noise = sqrt(1 - abar_t)`` and ``c_x0 = sqrt(abar_t)`` for the
    x0-prediction, then for ddim ``c_prev``, ``c_dir`` and ``sigma`` of
    ``x <- c_prev x0 + c_dir eps + sigma noise``, and for dpmpp the 2M
    ``c_skip``, ``c0``, ``c1``."""
    one = np.float32(1.0)
    tables = SDSchedulerTables.create(timesteps)
    ts = sd_ddim_timesteps(steps, timesteps)
    ac = tables.alphas_cumprod
    abt = ac[ts].astype(np.float32)
    co = {"c_noise": np.sqrt(one - abt), "c_x0": np.sqrt(abt)}
    if sampler == "dpmpp":
        ab_tgt = np.concatenate([abt[1:], np.ones(1, np.float32)])
        co["c_skip"], co["c0"], co["c1"] = dpmpp_coefficients(abt, ab_tgt)
    else:
        prev_ts = ts - timesteps // steps
        ab_prev = np.where(prev_ts >= 0, ac[np.maximum(prev_ts, 0)],
                           np.float32(tables.final_alpha_cumprod)).astype(np.float32)
        sigma = np.float32(eta) * np.sqrt((one - ab_prev) / (one - abt)) * np.sqrt(one - abt / ab_prev)
        co.update(c_prev=np.sqrt(ab_prev), c_dir=np.sqrt(one - ab_prev - sigma**2), sigma=sigma)
    return ts, {k: np.asarray(v, np.float32) for k, v in co.items()}


class StableDiffusionDecoder:
    """Frozen SD-1.5 UNet and VAE with the CLIP adapter, all on one device.

    ``unet`` and ``vae`` compute in their own dtype (bf16 on the card); the
    adapter and the sampler's update are fp32. ``decode``, ``forward`` and
    ``sample`` serve under ``torch.no_grad``; the trainer
    (``train/sd_diffusion_train.py``) calls ``unet``, ``vae.decode`` and
    ``adapter`` with autograd on."""

    def __init__(self, unet: SDUNet, vae: AutoencoderKL, adapter: SDClipAdapter) -> None:
        self.unet = unet.eval()
        self.vae = vae.eval()
        self.adapter = adapter.eval()

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> [-1, 1] images (B, H, W, 3) in the VAE's dtype."""
        return self.vae.decode(latents / SD_SCALING_FACTOR)

    @torch.no_grad()
    def forward(self, latents_t: torch.Tensor, z_clip: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """eps for scaled latents ``latents_t`` (B, h, w, 4), conditioned on ``z_clip``."""
        return self.unet(latents_t, t, self.adapter(z_clip))

    @torch.no_grad()
    def sample(
        self,
        z_clip: torch.Tensor,
        shape: Tuple[int, int, int, int],
        steps: int = 30,
        eta: float = 0.0,
        guidance_scale: float = 5.0,
        generator: Optional[torch.Generator] = None,
        decode_pixels: bool = True,
        cfg_batched: Optional[bool] = None,
        sampler: str = "ddim",
        x_T: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """CFG sampling of latents of ``shape`` (B, h, w, C); returns decoded
        [-1, 1] images or, with ``decode_pixels=False``, the fp32 latents.

        ``cfg_batched`` runs the (uncond, cond) pair as one UNet forward at
        batch 2B in the order [uncond, cond]; None picks it for B <= 4.
        The initial latent is ``x_T`` if given, else drawn from
        ``generator``, which also draws the per-step noise of ddim at
        ``eta > 0``."""
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}; choose 'ddim' or 'dpmpp'")
        if sampler == "dpmpp" and eta != 0.0:
            raise ValueError("DPM-Solver++ is deterministic: eta must be 0.0")
        B = shape[0]
        if cfg_batched is None:
            cfg_batched = B <= 4
        dev = z_clip.device
        ts, co = sd_step_coefficients(int(steps), SD_TIMESTEPS, sampler, eta)
        co = {k: v.tolist() for k, v in co.items()}
        if x_T is None:
            lat = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        else:
            lat = x_T.to(device=dev, dtype=torch.float32)
        cond = self.adapter(z_clip)
        uncond = self.adapter(torch.zeros_like(z_clip))
        ctx2 = torch.cat([uncond, cond], dim=0) if cfg_batched else None
        g = float(np.float32(guidance_scale))
        m_prev = torch.zeros_like(lat)
        for i, t in enumerate(ts.tolist()):
            if cfg_batched:
                t2 = torch.full((2 * B,), t, dtype=torch.int32, device=dev)
                eps2 = self.unet(torch.cat([lat, lat], dim=0), t2, ctx2).float()
                eps_u, eps_c = eps2[:B], eps2[B:]
            else:
                t_b = torch.full((B,), t, dtype=torch.int32, device=dev)
                eps_u = self.unet(lat, t_b, uncond).float()
                eps_c = self.unet(lat, t_b, cond).float()
            eps = eps_u + g * (eps_c - eps_u)
            x0 = (lat - co["c_noise"][i] * eps) / co["c_x0"][i]
            if sampler == "dpmpp":
                lat = co["c_skip"][i] * lat + co["c0"][i] * x0 + co["c1"][i] * (x0 - m_prev)
                m_prev = x0
            else:
                lat = co["c_prev"][i] * x0 + co["c_dir"][i] * eps
                if eta > 0:
                    noise = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
                    lat = lat + co["sigma"][i] * noise
        return self.decode(lat) if decode_pixels else lat
