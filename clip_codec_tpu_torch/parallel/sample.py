"""Data-parallel DDIM sampling: the port of ``clip_codec_tpu/parallel/sample.py``.

Each rank denoises its rows of the batch with the weights it holds (no
collective runs in the loop); x_T, and at ``eta > 0`` every step's noise,
are drawn for the global batch from the caller's generator (the same seed
on every rank) and cut to the rank's rows, so the images do not depend on
how many ranks share the batch. The rows are gathered once at the end.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..diffusion.ddim import ModelFn, ddim_sample
from ..diffusion.schedule import NoiseSchedule
from .mesh import DATA_AXIS, all_gather_rows, axis_size, local_rows, rank_device

NOT_PORTED_SPATIAL = ("spatial sharding (sample_spatial_sharded, spatial=True, --spatial_shard > 1: a halo exchange "
                      "at every conv, GroupNorm sums across shards) is not ported to the PyTorch package yet "
                      "(ROADMAP.md Queue 1, parallel/sample.py and parallel/tp.py, the model axis)")


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
    out = ddim_sample(model_fn, sched, z_l, shape, steps, eta, generator, x0, batch_rows=(B, rows))
    return all_gather_rows(mesh, out).cpu().numpy()


def sample_spatial_sharded(*args, **kwargs):
    """Not ported: see ``NOT_PORTED_SPATIAL``."""
    raise NotImplementedError(NOT_PORTED_SPATIAL)
