"""Plain GroupNorm over NHWC with fp32 statistics (port of
``clip_codec_tpu/ops/groupnorm.py:group_norm``).

The pixel ResBlock does not call it (GroupNorm folds into the conv kernel's
affine there); the SD blocks (``models/sd/layers.py`` ``group_norm32``) and
the plain tests do."""

from __future__ import annotations

from typing import Tuple

import torch


def group_norm(x: torch.Tensor, scale_bias: Tuple[torch.Tensor, torch.Tensor],
               groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-group normalisation over (H, W, C/groups) of NHWC
    ``x``; statistics in fp32 (fp64 stays fp64), result in x's dtype."""
    scale, bias = scale_bias
    B, H, W, C = x.shape
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    xg = x32.reshape(B, H, W, groups, C // groups)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)
