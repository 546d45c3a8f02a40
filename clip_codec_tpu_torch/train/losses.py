"""Per-sample training losses — the port of ``clip_codec_tpu/train/losses.py``
(``weighted_mean``, ``eps_mse``, ``l1``, ``total_variation``,
``clip_alignment``), so padded batches average over their real rows exactly.
NHWC tensors.

With a ``mesh``, the images are this rank's rows of images whose height is
split over the mesh's model axis: each per-sample term sums this rank's
rows over the whole image's count (``total_variation``'s row differences
reading one halo row of the rank above), so the terms summed over the axis
are the unsharded ones.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel.mesh import MODEL_AXIS, axis_index, axis_size, halo_rows


def weighted_mean(per_sample: torch.Tensor, weight: torch.Tensor, total: Optional[float] = None) -> torch.Tensor:
    """Average over real (non-padding) samples only. ``total`` is the real
    rows of the global batch when these are one rank's rows of it: the
    ranks' results then sum to the global batch's mean."""
    if total is not None:
        return torch.sum(per_sample * weight) / max(float(total), 1.0)
    return torch.sum(per_sample * weight) / torch.clamp(torch.sum(weight), min=1.0)


def _mean(x: torch.Tensor, mesh, rows: int) -> torch.Tensor:
    """(B,) mean over (H, W, C) of ``x``; with ``mesh``, this rank's share of
    the mean over an image of ``rows`` rows of such values (the model axis's
    ranks' shares sum to it)."""
    if mesh is None:
        return torch.mean(x, dim=(1, 2, 3))
    return torch.sum(x, dim=(1, 2, 3)) / (rows * x.shape[2] * x.shape[3])


def eps_mse(eps_hat: torch.Tensor, noise: torch.Tensor, mesh=None) -> torch.Tensor:
    """(B,) per-sample MSE over pixels."""
    n = 1 if mesh is None else axis_size(mesh, MODEL_AXIS)
    return _mean(torch.square(eps_hat - noise), mesh, eps_hat.shape[1] * n)


def l1(a: torch.Tensor, b: torch.Tensor, mesh=None) -> torch.Tensor:
    n = 1 if mesh is None else axis_size(mesh, MODEL_AXIS)
    return _mean(torch.abs(a - b), mesh, a.shape[1] * n)


def total_variation(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-sample anisotropic TV on NHWC. With ``mesh``, the row
    differences of this rank's rows and of its first row against the rank
    above's last (the first rank has none above: the image has H - 1 row
    differences)."""
    if mesh is None:
        tv_h = torch.mean(torch.abs(x[:, 1:, :, :] - x[:, :-1, :, :]), dim=(1, 2, 3))
        tv_w = torch.mean(torch.abs(x[:, :, 1:, :] - x[:, :, :-1, :]), dim=(1, 2, 3))
        return tv_h + tv_w
    H = x.shape[1] * axis_size(mesh, MODEL_AXIS)
    xh = halo_rows(mesh, x, 1, 0)
    dh = torch.abs(xh[:, 1:] - xh[:, :-1])
    if axis_index(mesh, MODEL_AXIS) == 0:
        dh = dh[:, 1:]  # the zero halo row: above the image
    return _mean(dh, mesh, H - 1) + _mean(torch.abs(x[:, :, 1:, :] - x[:, :, :-1, :]), mesh, H)


def clip_alignment(x0_pred: torch.Tensor, z: torch.Tensor,
                   clip_embed_fn: Callable[[torch.Tensor], torch.Tensor],
                   stop_grad: bool = True) -> torch.Tensor:
    """(B,) ``1 - cos(CLIP(x0_pred), z)``; ``clip_embed_fn`` maps [-1, 1]
    NHWC images to embeddings. ``stop_grad`` (the default) keeps the
    reference's quirk: the embedding is taken under ``torch.no_grad``, so
    the term moves the loss but gives no gradient (the trainer's
    ``clip_align_grad=True`` asks for the differentiable term)."""

    def term(xp: torch.Tensor) -> torch.Tensor:
        y = clip_embed_fn(xp)
        y = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)
        zn = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        return 1.0 - torch.sum(y * zn, dim=-1)

    if stop_grad:
        with torch.no_grad():
            return term(x0_pred.detach())
    return term(x0_pred)
