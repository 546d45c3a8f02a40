"""DPM-Solver++(2M): the port of ``clip_codec_tpu/diffusion/dpm.py``.

A deterministic second-order multistep solver (Lu et al. 2022) in the
x0-prediction form, over the same source grid as the DDIM sampler, so an
N-step run makes N model evaluations. With ``alpha = sqrt(abar)``,
``sigma = sqrt(1 - abar)``, ``lambda = log(alpha / sigma)`` and per step
``h = lambda_tgt - lambda_src``:

* first order: ``x <- (sig_t / sig_s) x - alpha_t (e^{-h} - 1) m0``
* 2M:          first order ``- 0.5 alpha_t (e^{-h} - 1) (h / h_prev) (m0 - m_prev)``

The first step has no ``m_prev`` and the final step, whose target is
``abar = 1``, is first order, which makes it exactly ``x = m0``.

The per-step coefficients are computed on the host in numpy fp32 in the
operation order of the JAX ``dpmpp_coefficients``; the loop is a Python
loop whose update runs in fp32 on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .ddim import ModelFn, ddim_timestep_grid
from .schedule import NoiseSchedule


def dpmpp_coefficients(ab_src: np.ndarray, ab_tgt: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """fp32 ``(c_skip, c0, c1)`` per step from the source and target
    alpha-bar grids (trajectory order, ``ab_tgt > ab_src``). ``ab_tgt[-1]``
    may be 1: there ``lambda_tgt = +inf``, ``c_skip = 0``, ``c0 = alpha_t``
    and ``c1 = 0``, so the last update is ``x = m0``."""
    one = np.float32(1.0)
    ab_src = np.asarray(ab_src, np.float32)
    ab_tgt = np.asarray(ab_tgt, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        a_s, s_s = np.sqrt(ab_src), np.sqrt(one - ab_src)
        a_t, s_t = np.sqrt(ab_tgt), np.sqrt(one - ab_tgt)
        lam_s = np.log(a_s) - np.log(s_s)
        lam_t = np.log(a_t) - np.log(s_t)  # +inf where ab_tgt == 1
        h = lam_t - lam_s
        c_skip = np.where(np.isfinite(lam_t), s_t / s_s, np.float32(0.0))
        c0 = -a_t * np.expm1(-h)  # expm1(-inf) = -1 -> c0 = a_t
        n = ab_src.shape[0]
        h_prev = np.concatenate([np.ones(1, np.float32), lam_s[1:] - lam_s[:-1]])
        second = (np.arange(n) != 0) & (np.arange(n) != n - 1)
        c1 = np.where(second, np.float32(-0.5) * a_t * np.expm1(-h) * (h / h_prev), np.float32(0.0))
    return tuple(np.asarray(c, np.float32) for c in (c_skip, c0, c1))


@torch.no_grad()
def dpmpp_sample(
    model_fn: ModelFn,
    sched: NoiseSchedule,
    z: torch.Tensor,
    shape: Tuple[int, ...],
    steps: int = 20,
    generator: Optional[torch.Generator] = None,
    x_T: Optional[torch.Tensor] = None,
    clip_x0: bool = True,
) -> torch.Tensor:
    """Sample fp32 images of ``shape`` = (B, H, W, C) conditioned on ``z``.
    ``clip_x0`` clips each x0-prediction to [-1, 1] (pixel-space models)."""
    device = z.device
    ts = ddim_timestep_grid(sched.timesteps, steps)
    ab_src = sched.numpy("alphas_cumprod")[ts]
    ab_tgt = np.concatenate([ab_src[1:], np.ones(1, np.float32)])
    c_skip, c0, c1 = dpmpp_coefficients(ab_src, ab_tgt)
    sa, sb = np.sqrt(ab_src), np.sqrt(np.float32(1.0) - ab_src)
    if x_T is None:
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    else:
        x = x_T.to(device=device, dtype=torch.float32)
    m_prev = torch.zeros_like(x)
    for i in range(len(ts)):
        t_b = torch.full((shape[0],), int(ts[i]), dtype=torch.int32, device=device)
        eps = model_fn(x, z, t_b).float()
        m0 = (x - float(sb[i]) * eps) / float(sa[i])
        if clip_x0:
            m0 = torch.clamp(m0, -1.0, 1.0)
        x = float(c_skip[i]) * x + float(c0[i]) * m0 + float(c1[i]) * (m0 - m_prev)
        m_prev = m0
    return x


@dataclass
class DPMSolverPP:
    """``DPMSolverPP(sched).sample(...)``, the signature of ``DDIMSampler``
    (``cfg_scale`` accepted and ignored likewise)."""

    sched: NoiseSchedule

    def sample(
        self,
        model_fn: ModelFn,
        z: torch.Tensor,
        shape: Tuple[int, ...],
        steps: int = 20,
        cfg_scale: float = 1.0,
        x_T: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        del cfg_scale
        return dpmpp_sample(model_fn, self.sched, z, tuple(shape), steps, generator, x_T)
