"""Ancestral DDPM sampling, the port of ``clip_codec_tpu/diffusion/ddpm.py``:
for t = T-1 .. 0, ``x <- mean + sqrt(var) * noise`` from
``NoiseSchedule.p_mean_variance``, with no noise at t = 0. T model
evaluations (DDIM stays the production sampler). A Python loop of
device work: nothing in it waits on the device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .ddim import ModelFn
from .schedule import NoiseSchedule


@torch.no_grad()
def ddpm_sample(
    model_fn: ModelFn,
    sched: NoiseSchedule,
    z: torch.Tensor,
    shape: Tuple[int, ...],
    generator: Optional[torch.Generator] = None,
    x_T: Optional[torch.Tensor] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Full-schedule ancestral sampling of fp32 images of ``shape``
    conditioned on ``z``. ``generator`` (on z's device) draws x_T when it
    is not given and each step's noise; ``noise`` injects the draws
    instead, ``noise[i]`` at the i-th step (t = T-1-i; the last is unused),
    as a parity test does with JAX's own sequence."""
    device = z.device
    T = sched.timesteps
    if noise is not None and len(noise) < T - 1:
        raise ValueError(f"noise holds {len(noise)} draws; the schedule needs {T - 1}")
    x = (torch.randn(shape, generator=generator, device=device, dtype=torch.float32) if x_T is None
         else x_T.to(device=device, dtype=torch.float32))
    for i, t in enumerate(range(T - 1, -1, -1)):
        t_b = torch.full((shape[0],), t, dtype=torch.int32, device=device)
        mean, var, _ = sched.p_mean_variance(model_fn, x, z, t_b)
        if t == 0:
            x = mean
            break
        n = (torch.randn(shape, generator=generator, device=device, dtype=torch.float32) if noise is None
             else noise[i].to(device=device, dtype=torch.float32))
        x = mean + torch.sqrt(var) * n
    return x
