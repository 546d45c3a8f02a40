"""Per-sample training losses — the port of ``clip_codec_tpu/train/losses.py``
(``weighted_mean``, ``eps_mse``, ``l1``, ``total_variation``), so padded
batches average over their real rows exactly. NHWC tensors."""

from __future__ import annotations

import torch


def weighted_mean(per_sample: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Average over real (non-padding) samples only."""
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
