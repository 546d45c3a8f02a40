"""Direct (non-diffusion) feed-forward decoders z -> image, the port of
``clip_codec_tpu/models/decoders.py``: one-shot alternatives to diffusion
decoding, NHWC images in [-1, 1] out, computed in ``dtype`` (GroupNorm
statistics in fp32), fp32 parameters under the reference modules' names,
so a reference state dict loads with ``strict=True``:

* ``CLIPCondDecoder``: ``fc.0`` (Linear to base x 8 x 8, then GELU),
  ``up`` (per stage i: ``up.{3i}`` a DWConvBlock, ``up.{3i+1}`` a x2
  bilinear upsample, ``up.{3i+2}`` a DWConvBlock), ``to_img.0`` (3x3 conv,
  then tanh);
* ``FeatureToImageDecoderLite``: ``fc.0``, ``up1``/``up2``/``up3`` (conv,
  GroupNorm(8), GELU, conv, GroupNorm(8), GELU at indices 0-5), each
  followed by a x2 bilinear upsample, ``to_img.0``.

The reference's quirk is kept: ``CLIPCondDecoder.stage_plan`` counts
stages by a length that grows by 3 a stage, so ``out_size=512`` builds two
x2 stages (8 -> 16 -> 32) and the final bilinear resize reaches 512.
Resizes use half-pixel centres with no antialiasing (``align_corners=False``),
as the reference's ``F.interpolate`` and JAX's ``jax.image.resize``. The
convolutions run in cuDNN: no TPU kernel is on this path.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import DWConvBlock, _conv_nhwc, group_norm_nhwc, linear


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC bilinear resize, half-pixel centres, no antialias."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


class Upsample2x(nn.Module):
    """x2 bilinear upsample of NHWC (the reference's parameter-free ``nn.Upsample``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(x, x.shape[1] * 2, x.shape[2] * 2)


class CLIPCondDecoder(nn.Module):
    """Single-path upsampling decoder conditioned only on the CLIP vector."""

    def __init__(self, in_dim: int = 512, base: int = 192, out_size: int = 512,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.base, self.out_size, self.dtype = base, out_size, dtype
        self.fc = nn.Sequential(nn.Linear(in_dim, base * 8 * 8), nn.GELU())
        plan, c = self.stage_plan(base, out_size)
        stages: List[nn.Module] = []
        for cin, cout in plan:
            stages += [DWConvBlock(cin, cin, dtype=dtype), Upsample2x(), DWConvBlock(cin, cout, dtype=dtype)]
        self.up = nn.Sequential(*stages)
        self.to_img = nn.Sequential(nn.Conv2d(c, 3, 3, padding=1), nn.Tanh())

    @staticmethod
    def stage_plan(base: int, out_size: int) -> Tuple[List[Tuple[int, int]], int]:
        """The reference's stage loop: (cin, cout) a stage, channels halved
        and floored at 32, while 8 * 2**(3n) < out_size; and the last width."""
        plan, c, n = [], base, 0
        while 8 * (2 ** (3 * n)) < out_size:
            nxt = max(c // 2, 32)
            plan.append((c, nxt))
            c = nxt
            n += 1
        return plan, c

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        B = z.shape[0]
        x = F.gelu(linear(self.fc[0], z, self.dtype))
        x = x.reshape(B, self.base, 8, 8).permute(0, 2, 3, 1)
        x = self.up(x)
        if x.shape[1] != self.out_size:
            x = resize_bilinear(x, self.out_size, self.out_size)
        return torch.tanh(_conv_nhwc(self.to_img[0], x, self.dtype))


def _plain_block(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1), nn.GroupNorm(8, cout), nn.GELU(),
                         nn.Conv2d(cout, cout, 3, padding=1), nn.GroupNorm(8, cout), nn.GELU())


class FeatureToImageDecoderLite(nn.Module):
    """Progressive x8 upsampler with plain conv blocks."""

    def __init__(self, in_dim: int = 512, base: int = 256, out_size: int = 64,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.base, self.out_size, self.dtype = base, out_size, dtype
        c, h = base, out_size // 8
        self.fc = nn.Sequential(nn.Linear(in_dim, c * h * h), nn.GELU())
        self.up1 = _plain_block(c, c)
        self.up2 = _plain_block(c, c // 2)
        self.up3 = _plain_block(c // 2, c // 4)
        self.to_img = nn.Sequential(nn.Conv2d(c // 4, 3, 3, padding=1), nn.Tanh())

    def _block(self, block: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in ((block[0], block[1]), (block[3], block[4])):
            x = F.gelu(group_norm_nhwc(norm, _conv_nhwc(conv, x, self.dtype)))
        return x

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        B, h = z.shape[0], self.out_size // 8
        x = F.gelu(linear(self.fc[0], z, self.dtype))
        x = x.reshape(B, self.base, h, h).permute(0, 2, 3, 1)
        for block in (self.up1, self.up2, self.up3):
            x = self._block(block, x)
            x = resize_bilinear(x, x.shape[1] * 2, x.shape[2] * 2)
        return torch.tanh(_conv_nhwc(self.to_img[0], x, self.dtype))
