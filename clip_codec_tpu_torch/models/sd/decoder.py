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
  ``"dpmpp"`` (whose final target is alpha-bar 1), and
  ``sample_with_inversion``, the same loop with test-time feature-inversion
  guidance, of which ``sample`` is the ``inv_weight=0`` case.

Sampling is a Python loop over fp32 per-step coefficients precomputed on the
host; the update runs in fp32 on the device while the UNet computes in its
own dtype. A guided step backpropagates an embedding loss through the VAE
decode, so on the card it runs flash attention's backward kernels.

int8 serving (``ops/int8.py``): ``StableDiffusionDecoder(..., int8=True)``
runs the UNet's interior in int8 (the VAE stays fp), with the dynamic
per-tensor scales until ``calibrate_int8_scales`` records static ones into
``unet_quant``, which the UNet then reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...diffusion.dpm import dpmpp_coefficients
from ...ops import int8 as q8
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


Guidance = Union[float, torch.Tensor]


def cfg_combine(eps_u: torch.Tensor, eps_c: torch.Tensor, guidance_scale: Guidance) -> torch.Tensor:
    """``eps_u + g (eps_c - eps_u)`` with ``g`` the guidance rounded to fp32:
    a Python number, or a 0-d fp32 tensor on the eps' device, which a CUDA
    graph reads at each replay (one captured sampler serves every guidance).
    The two forms give the same bits: each is one fp32 multiply, then one
    add."""
    g = guidance_scale if torch.is_tensor(guidance_scale) else float(np.float32(guidance_scale))
    return eps_u + g * (eps_c - eps_u)


def clip_m11(x: torch.Tensor) -> torch.Tensor:
    """``x`` clipped to [-1, 1] as ``jnp.clip`` computes it,
    ``minimum(maximum(x, -1), 1)``: at an exact tie the gradient is split
    between the two arguments (0.5 to ``x``), where ``torch.clamp`` passes
    all of it."""
    lo = torch.full((), -1.0, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), -lo)


EmbedFn = Callable[[torch.Tensor], torch.Tensor]


def inversion_loss(img: torch.Tensor, embed_fn: EmbedFn, z_tgt: torch.Tensor) -> torch.Tensor:
    """``1 - mean(cos(embed_fn(clip(img)), z_tgt))`` for fp32 [-1, 1] NHWC
    images and unit targets (B, D): the embedding divided by ``norm + 1e-9``."""
    y = embed_fn(clip_m11(img))
    y = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + 1e-9)
    return 1.0 - (y * z_tgt).sum(dim=-1).mean()


class StableDiffusionDecoder:
    """Frozen SD-1.5 UNet and VAE with the CLIP adapter, all on one device.

    ``unet`` and ``vae`` compute in their own dtype (bf16 on the card) and
    take no gradient (``requires_grad`` off, so their compute-dtype weights
    are cached); the adapter and the sampler's update are fp32. ``decode``,
    ``forward`` and ``sample`` serve under ``torch.no_grad``; the trainer
    (``train/sd_diffusion_train.py``) calls ``unet``, ``vae.decode`` and
    ``adapter`` with autograd on, and ``sample_with_inversion`` takes the
    gradient of its loss in the latent alone.

    ``int8``: None keeps the UNet's own setting; True or False pins it
    (``SDUNet.int8``)."""

    def __init__(self, unet: SDUNet, vae: AutoencoderKL, adapter: SDClipAdapter,
                 int8: Optional[bool] = None) -> None:
        self.unet = unet.eval().requires_grad_(False)
        self.vae = vae.eval().requires_grad_(False)
        self.adapter = adapter.eval()
        if int8 is not None:
            self.unet.int8 = int8
        self._unet_quant: Optional[q8.Quant] = None

    @property
    def unet_quant(self) -> Optional[q8.Quant]:
        """The UNet's static int8 activation scales (the quant dict), or
        None for the dynamic ones; setting it loads them into the UNet."""
        return self._unet_quant

    @unet_quant.setter
    def unet_quant(self, quant: Optional[q8.Quant]) -> None:
        q8.load_quant(self.unet, quant)
        self._unet_quant = quant

    def calibrate_int8_scales(self, z_clip: torch.Tensor, shape: Tuple[int, int, int, int],
                              timesteps: Optional[Sequence[int]] = None,
                              latents: Optional[torch.Tensor] = None) -> None:
        """Record static per-layer activation absmax for the int8 UNet into
        ``unet_quant``: one fp pass per calibration timestep on noise-scale
        latents, for both CFG branches (the adapter's context for
        ``z_clip`` and for zeros). ``timesteps`` None takes the 95%, 50% and
        5% points of the 1000-step schedule, as JAX. The latents of
        ``shape`` are drawn from a ``torch.Generator`` seeded 0 on the
        UNet's device (JAX draws them from ``PRNGKey(0)``: other numbers of
        the same law), or are ``latents``."""
        if timesteps is None:
            T = SD_TIMESTEPS
            timesteps = [max(0, min(T - 1, int(round(f * T)))) for f in (0.95, 0.5, 0.05)]
        dev = z_clip.device
        with torch.no_grad():
            cond = self.adapter(z_clip)
            uncond = self.adapter(torch.zeros_like(z_clip))
        if latents is None:
            latents = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        lat = latents.to(device=dev, dtype=torch.float32)
        self.unet_quant = q8.calibrate_int8(
            self.unet, *[(lat, torch.full((shape[0],), int(t), dtype=torch.int32, device=dev), ctx)
                         for t in timesteps for ctx in (cond, uncond)])

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> [-1, 1] images (B, H, W, 3) in the VAE's dtype."""
        return self.vae.decode(latents / SD_SCALING_FACTOR)

    @torch.no_grad()
    def forward(self, latents_t: torch.Tensor, z_clip: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """eps for scaled latents ``latents_t`` (B, h, w, 4), conditioned on ``z_clip``."""
        return self.unet(latents_t, t, self.adapter(z_clip))

    def sample(
        self,
        z_clip: torch.Tensor,
        shape: Tuple[int, int, int, int],
        steps: int = 30,
        eta: float = 0.0,
        guidance_scale: Guidance = 5.0,
        generator: Optional[torch.Generator] = None,
        decode_pixels: bool = True,
        cfg_batched: Optional[bool] = None,
        sampler: str = "ddim",
        x_T: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """CFG sampling of latents of ``shape`` (B, h, w, C); returns decoded
        [-1, 1] images or, with ``decode_pixels=False``, the fp32 latents.
        The ``inv_weight=0`` case of :meth:`sample_with_inversion`: one step
        implementation for both."""
        return self.sample_with_inversion(
            z_clip, z_clip, None, shape, steps=steps, eta=eta, guidance_scale=guidance_scale,
            inv_weight=0.0, generator=generator, decode_pixels=decode_pixels, cfg_batched=cfg_batched,
            sampler=sampler, x_T=x_T)

    @torch.no_grad()
    def sample_with_inversion(
        self,
        z_clip: torch.Tensor,
        z_target: torch.Tensor,
        embed_fn: Optional[EmbedFn],
        shape: Tuple[int, int, int, int],
        steps: int = 30,
        eta: float = 0.0,
        guidance_scale: Guidance = 5.0,
        inv_weight: float = 1.0,
        inv_every: int = 1,
        generator: Optional[torch.Generator] = None,
        decode_pixels: bool = True,
        cfg_batched: Optional[bool] = None,
        sampler: str = "ddim",
        x_T: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """CFG sampling with feature-inversion guidance: every ``inv_every``
        steps, after eps and before the update, the latent moves against
        the gradient of ``1 - mean(cos(embed_fn(x0_img), z_target))``, where
        ``x0_img`` is the VAE decode of the x0-prediction (eps held
        constant) in fp32, clipped to [-1, 1]; the step is
        ``lat - inv_weight * g / (||g|| + 1e-8)``, ``||g||`` over the whole
        batch. ``embed_fn`` maps [-1, 1] NHWC images to (B, D) embeddings
        and must be differentiable; ``inv_weight=0`` is plain sampling.

        ``cfg_batched`` runs the (uncond, cond) pair as one UNet forward at
        batch 2B in the order [uncond, cond]; None picks it for B <= 4.
        The initial latent is ``x_T`` if given, else drawn from
        ``generator``, which also draws the per-step noise of ddim at
        ``eta > 0``. ``guidance_scale`` is a number or a 0-d fp32 device
        tensor (``cfg_combine``)."""
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
        z_tgt = z_target / torch.linalg.vector_norm(z_target, dim=-1, keepdim=True).clamp_min(1e-9)
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
            eps = cfg_combine(eps_u, eps_c, guidance_scale)
            if inv_weight > 0 and i % max(1, inv_every) == 0:
                grad = self.inversion_grad(lat, eps, co["c_noise"][i], co["c_x0"][i], embed_fn, z_tgt)
                lat = lat - inv_weight * grad / (torch.linalg.vector_norm(grad) + 1e-8)
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

    def inversion_grad(self, lat: torch.Tensor, eps: torch.Tensor, c_noise: float, c_x0: float,
                       embed_fn: EmbedFn, z_tgt: torch.Tensor) -> torch.Tensor:
        """d inversion_loss(decode(x0)) / d(lat), with the x0-prediction
        ``(lat - c_noise eps) / c_x0`` and eps constant."""
        with torch.enable_grad():
            x = lat.detach().requires_grad_(True)
            img = self.vae.decode((x - c_noise * eps) / c_x0 / SD_SCALING_FACTOR).float()
            (grad,) = torch.autograd.grad(inversion_loss(img, embed_fn, z_tgt), x)
        return grad
