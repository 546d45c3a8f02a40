"""DDIM sampler: the port of ``clip_codec_tpu/diffusion/ddim.py``.

Reference parity form (the default), with the reference's deviations from
textbook strided DDIM kept exactly:

(a) the target alpha-bar is ``alphas_cumprod_prev[t]`` on the full schedule
    (one fine step back), not alpha-bar at the next coarse timestep;
(b) the final step forces that target to 1.0;
(c) the direction term is ``sqrt(al_bar_s - sigma**2) * eps`` instead of
    ``sqrt(1 - al_bar_s - sigma**2) * eps`` — for eta near 1 the root's
    argument goes negative and the output is NaN, as in the reference;
(d) ``cfg_scale`` is accepted and ignored.

``standard=True`` (sampler name ``ddim_std``) is textbook strided DDIM
(Song et al. 2021, eq. 12): target alpha-bar at the next grid point,
direction ``sqrt(1 - al_bar_s - sigma^2) * eps``, terminal target 1.

The loop is a Python loop over per-step coefficients precomputed on the host
in numpy fp32 (the same fp32 operations as the JAX scan) from the schedule's
host tables; the update math runs in fp32 on the device while the model may
compute in bf16. Nothing in the loop waits on the device, so ``deploy.py``
captures the whole trajectory in one CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .schedule import NoiseSchedule

# model_fn(x_t: (B,H,W,C) fp32, z: (B,D), t: (B,) int32) -> eps (B,H,W,C)
ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def ddim_timestep_grid(timesteps: int, steps: int) -> np.ndarray:
    """``linspace(T-1, 0, steps)`` truncated toward zero, as the reference."""
    return np.linspace(timesteps - 1, 0, steps).astype(np.float32).astype(np.int64)


def _step_coefficients(sched: NoiseSchedule, steps: int, standard: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-step ``(t, al_bar_t, al_bar_s)`` on the host, fp32 (see (a), (b))."""
    ts = ddim_timestep_grid(sched.timesteps, steps)
    al_bar_t = sched.numpy("alphas_cumprod")[ts]
    if standard:
        al_bar_s = np.concatenate([al_bar_t[1:], np.ones(1, np.float32)])
    else:
        al_bar_s = sched.numpy("alphas_cumprod_prev")[ts].copy()
        al_bar_s[-1] = 1.0
    return ts.astype(np.int32), al_bar_t.astype(np.float32), al_bar_s.astype(np.float32)


def _update_coefficients(abt: np.ndarray, ab_s: np.ndarray, eta: float, standard: bool):
    """fp32 ``sqrt(1-abt), sqrt(abt), sqrt(ab_s), dir, sigma`` for
    ``x_new = sqrt(ab_s) * clip((x - sqrt(1-abt) eps) / sqrt(abt)) + dir * eps
    + sigma * noise``."""
    one = np.float32(1.0)
    eta = np.float32(eta)
    with np.errstate(invalid="ignore", divide="ignore"):
        sigma = eta * np.sqrt((one - ab_s) / (one - abt) * (one - abt / ab_s))
        if standard:
            dir_c = np.sqrt(np.maximum(one - ab_s - sigma**2, np.float32(0)))
        else:
            dir_c = np.sqrt(ab_s - sigma**2)  # NaN for eta ~ 1, see (c)
    return (np.sqrt(one - abt), np.sqrt(abt), np.sqrt(ab_s), dir_c.astype(np.float32),
            np.where(sigma > 0, sigma, np.float32(0)).astype(np.float32))


@torch.no_grad()
def ddim_sample(
    model_fn: ModelFn,
    sched: NoiseSchedule,
    z: torch.Tensor,
    shape: Tuple[int, ...],
    steps: int = 50,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
    x_T: Optional[torch.Tensor] = None,
    standard: bool = False,
    batch_rows: Optional[Tuple[Tuple[int, ...], object]] = None,
) -> torch.Tensor:
    """Sample fp32 images of ``shape`` = (B, H, W, C) conditioned on ``z``.

    ``generator`` (on z's device) draws the initial noise when ``x_T`` is
    None and, for ``eta > 0``, the per-step noise. ``batch_rows`` =
    (whole shape, index): ``shape`` is the ``index`` cut of a larger sample
    (a rank's rows, and under spatial sharding its height slice), and every
    draw is made for the whole shape and cut by the index, so a sample split
    over ranks draws what the whole one would."""
    device = z.device

    def draw() -> torch.Tensor:
        if batch_rows is None:
            return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        whole, index = batch_rows
        return torch.randn(tuple(whole), generator=generator, device=device, dtype=torch.float32)[index]

    ts, abt, ab_s = _step_coefficients(sched, steps, standard)
    c_noise, c_x0, c_s, c_dir, sig = _update_coefficients(abt, ab_s, eta, standard)
    if x_T is None:
        x = draw()
    else:
        x = x_T.to(device=device, dtype=torch.float32)
    for i in range(len(ts)):
        t_b = torch.full((shape[0],), int(ts[i]), dtype=torch.int32, device=device)
        eps = model_fn(x, z, t_b).float()
        x0 = torch.clamp((x - float(c_noise[i]) * eps) / float(c_x0[i]), -1.0, 1.0)
        x = float(c_s[i]) * x0 + float(c_dir[i]) * eps
        if eta > 0:
            x = x + float(sig[i]) * draw()
    return x


@dataclass
class DDIMSampler:
    """``DDIMSampler(sched, eta).sample(...)``; ``standard=True`` is ``ddim_std``."""

    sched: NoiseSchedule
    eta: float = 0.0
    standard: bool = False

    def sample(
        self,
        model_fn: ModelFn,
        z: torch.Tensor,
        shape: Tuple[int, ...],
        steps: int = 50,
        cfg_scale: float = 1.0,
        x_T: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        batch_rows: Optional[Tuple[Tuple[int, ...], object]] = None,
    ) -> torch.Tensor:
        del cfg_scale  # accepted and ignored, as in the reference, see (d)
        return ddim_sample(model_fn, self.sched, z, tuple(shape), steps, self.eta,
                           generator, x_T, standard=self.standard, batch_rows=batch_rows)
