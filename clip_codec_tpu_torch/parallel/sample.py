"""Sharded DDIM sampling: the port of ``clip_codec_tpu/parallel/sample.py``.

``sample_sharded``: each rank denoises its rows of the batch with the
weights it holds (no collective runs in the loop). ``sample_spatial_sharded``
also splits the image height over the mesh's ``model`` axis: the ranks of
one data row denoise one batch together, each its rows of every image,
through the U-Net's spatial form (``CLIPCondUNet.forward_spatial``: halo
rows and GroupNorm totals exchanged over the axis at every layer). x_T, and
at ``eta > 0`` every step's noise, are drawn for the global batch from the
caller's generator (the same seed on every rank) and cut to the rank's rows
(and height slice), so the images do not depend on how many ranks share the
work. The images are gathered once at the end.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..diffusion.ddim import ModelFn, ddim_sample
from ..diffusion.schedule import NoiseSchedule
from .mesh import DATA_AXIS, MODEL_AXIS, all_gather_rows, axis_size, local_rows, model_slice, rank_device


def sample_sharded(
    mesh,
    model_fn: ModelFn,
    sched: NoiseSchedule,
    z,
    image_size: int,
    steps: int = 50,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
    x_T=None,
    channels: int = 3,
) -> np.ndarray:
    """Reconstruct a batch of embeddings with the batch split over ``data``.

    ``z``'s leading dim must divide by the data-axis size (pad upstream);
    ``generator`` lives on the rank's device; ``x_T`` (optional) is the
    global initial noise. Every rank returns the host images (B, S, S, C)
    in [-1, 1]-ish (unclipped)."""
    n_data = axis_size(mesh, DATA_AXIS)
    B = int(z.shape[0])
    if B % n_data != 0:
        raise ValueError(f"batch {B} not divisible by data axis {n_data}; pad the batch")
    rows = local_rows(mesh, B)
    dev = rank_device(mesh)
    z_l = torch.as_tensor(np.asarray(z, np.float32) if not torch.is_tensor(z) else z)[rows].to(dev, torch.float32)
    x0 = None if x_T is None else torch.as_tensor(x_T)[rows].to(dev, torch.float32)
    shape = (z_l.shape[0], image_size, image_size, channels)
    out = ddim_sample(model_fn, sched, z_l, shape, steps, eta, generator, x0, batch_rows=((B,) + shape[1:], rows))
    return all_gather_rows(mesh, out).cpu().numpy()


def sample_spatial_sharded(
    mesh,
    model_fn,
    sched: NoiseSchedule,
    z,
    image_size: int,
    steps: int = 50,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
    x_T=None,
    channels: int = 3,
    seed: int = 0,
) -> np.ndarray:
    """High-resolution sampling with the image height split over the
    ``model`` axis on top of the batch over ``data``: activations scale as
    B*H*W*C and this splits H.

    ``model_fn`` is the U-Net (a ``CLIPCondUNet``: its spatial form runs,
    the direct one, whatever ``fused_pallas`` says; JAX asks for
    ``fused_pallas=False`` here). ``generator`` (on the rank's device;
    default: one seeded with ``seed``) draws x_T for the global batch, or
    ``x_T`` is given; each rank cuts its rows and height slice. Every rank
    returns the host images (B, S, S, C), unclipped."""
    n_data = axis_size(mesh, DATA_AXIS)
    n_model = axis_size(mesh, MODEL_AXIS)
    B = int(z.shape[0])
    if B % n_data != 0:
        raise ValueError(f"batch {B} not divisible by data axis {n_data}")
    if image_size % n_model != 0:
        raise ValueError(f"image_size {image_size} not divisible by model axis {n_model}")
    forward = getattr(model_fn, "forward_spatial", None)
    if forward is None:
        raise TypeError(f"sample_spatial_sharded runs the U-Net's spatial form (CLIPCondUNet.forward_spatial); "
                        f"got {type(model_fn).__name__}")
    dev = rank_device(mesh)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    whole = (B, image_size, image_size, channels)
    cut = (local_rows(mesh, B), model_slice(mesh, image_size))
    if x_T is None:
        x0 = torch.randn(whole, generator=generator, device=dev, dtype=torch.float32)[cut]
    else:
        x0 = torch.as_tensor(x_T)[cut].to(dev, torch.float32)
    z_l = torch.as_tensor(np.asarray(z, np.float32) if not torch.is_tensor(z) else z)[cut[0]].to(dev, torch.float32)
    out = ddim_sample(lambda x, zz, t: forward(x, zz, t, mesh), sched, z_l, tuple(x0.shape), steps, eta, generator,
                      x0, batch_rows=(whole, cut))
    out = all_gather_rows(mesh, out, dim=1, axis=MODEL_AXIS)
    return all_gather_rows(mesh, out).cpu().numpy()
