"""Per-sample training losses — the port of ``clip_codec_tpu/train/losses.py``
(``weighted_mean``, ``eps_mse``, ``l1``, ``total_variation``,
``clip_alignment``), so padded batches average over their real rows exactly.
NHWC tensors."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def weighted_mean(per_sample: torch.Tensor, weight: torch.Tensor, total: Optional[float] = None) -> torch.Tensor:
    """Average over real (non-padding) samples only. ``total`` is the real
    rows of the global batch when these are one rank's rows of it: the
    ranks' results then sum to the global batch's mean."""
    if total is not None:
        return torch.sum(per_sample * weight) / max(float(total), 1.0)
    return torch.sum(per_sample * weight) / torch.clamp(torch.sum(weight), min=1.0)


def eps_mse(eps_hat: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """(B,) per-sample MSE over pixels."""
    return torch.mean(torch.square(eps_hat - noise), dim=(1, 2, 3))


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b), dim=(1, 2, 3))


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """Per-sample anisotropic TV on NHWC."""
    tv_h = torch.mean(torch.abs(x[:, 1:, :, :] - x[:, :-1, :, :]), dim=(1, 2, 3))
    tv_w = torch.mean(torch.abs(x[:, :, 1:, :] - x[:, :, :-1, :]), dim=(1, 2, 3))
    return tv_h + tv_w


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
