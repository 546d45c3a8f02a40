"""DDPM noise schedule: fp32 tables computed on the host in numpy in the
operation order of ``clip_codec_tpu/diffusion/schedule.py`` (so every table
is bit-equal to the JAX one), then moved to the device. The host copies stay
beside them (``NoiseSchedule.host``): the samplers read their per-step
coefficients there, with no device-to-host copy, so a sampler can be
captured in a CUDA graph.

Schedules: ``linear`` (betas = linspace(1e-4, 0.02, T)) and ``cosine``
(Nichol-Dhariwal, s = 0.008, betas clamped to [1e-4, 0.9999]).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch


def _tables(timesteps: int, schedule: str) -> dict:
    if schedule == "linear":
        betas = np.linspace(1e-4, 0.02, timesteps).astype(np.float32)
    elif schedule == "cosine":
        s = np.float32(0.008)
        t = (np.linspace(0, timesteps, timesteps + 1).astype(np.float32)
             / np.float32(timesteps)).astype(np.float32)
        ac = np.cos((t + s) / (1 + s) * np.float32(math.pi / 2)) ** 2
        ac = (ac / ac[0]).astype(np.float32)
        betas = (1 - ac[1:] / ac[:-1]).astype(np.float32)
        betas = np.clip(betas, 0.0001, 0.9999).astype(np.float32)
    else:
        raise ValueError(f"Unknown schedule {schedule}")
    alphas = (1.0 - betas).astype(np.float32)
    alphas_cumprod = np.cumprod(alphas, dtype=np.float32)
    alphas_cumprod_prev = np.concatenate([np.ones(1, np.float32), alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return dict(
        betas=f32(betas),
        alphas=f32(alphas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt((1.0 - alphas_cumprod).astype(np.float32))),
        posterior_variance=f32(posterior_variance),
    )


@dataclass(frozen=True)
class NoiseSchedule:
    """Precomputed DDPM schedule tables, each a ``(T,)`` float32 tensor;
    ``host`` holds the same tables as numpy arrays."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    host: Dict[str, np.ndarray] = field(repr=False, compare=False)

    @property
    def timesteps(self) -> int:
        return self.betas.shape[0]

    @classmethod
    def create(cls, timesteps: int = 1000, schedule: str = "cosine",
               device: torch.device | str = "cpu") -> "NoiseSchedule":
        tables = _tables(timesteps, schedule)
        return cls(**{k: torch.from_numpy(v).to(device) for k, v in tables.items()}, host=tables)

    def numpy(self, name: str) -> np.ndarray:
        """The fp32 table ``name`` on the host, with no device copy."""
        return self.host[name]

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Diffuse ``x0`` to ``x_t``."""
        shape = (-1,) + (1,) * (x0.dim() - 1)
        a = self.sqrt_alphas_cumprod[t].reshape(shape)
        b = self.sqrt_one_minus_alphas_cumprod[t].reshape(shape)
        return a * x0 + b * noise

    def predict_x0_from_eps(self, x_t: torch.Tensor, t: torch.Tensor, eps_hat: torch.Tensor) -> torch.Tensor:
        """Invert ``q_sample`` given predicted noise."""
        shape = (-1,) + (1,) * (x_t.dim() - 1)
        a = self.sqrt_alphas_cumprod[t].reshape(shape)
        b = self.sqrt_one_minus_alphas_cumprod[t].reshape(shape)
        return (x_t - b * eps_hat) / a

    def p_mean_variance(self, model_fn, x_t: torch.Tensor, z: torch.Tensor, t: torch.Tensor):
        """Posterior (mean, variance, clipped x0-prediction) of ancestral
        DDPM at ``t`` (B,), the model's eps turned into an x0-prediction
        clipped to [-1, 1]; fp32, gathered on the tables' device."""
        eps = model_fn(x_t, z, t).float()
        x0_pred = torch.clamp(self.predict_x0_from_eps(x_t, t, eps), -1.0, 1.0)
        shape = (-1,) + (1,) * (x_t.dim() - 1)
        al_t = self.alphas[t].reshape(shape)
        al_bar_t = self.alphas_cumprod[t].reshape(shape)
        al_bar_prev = self.alphas_cumprod_prev[t].reshape(shape)
        coef1 = torch.sqrt(al_bar_prev) * (1 - al_t) / (1 - al_bar_t)
        coef2 = torch.sqrt(al_t) * (1 - al_bar_prev) / (1 - al_bar_t)
        mean = coef1 * x0_pred + coef2 * x_t
        return mean, self.posterior_variance[t].reshape(shape), x0_pred
