"""CLIP-conditioned U-Net predicting eps(x_t, z, t): the port of
``clip_codec_tpu/models/unet.py`` in its kernel-bearing form
(``CLIPCondUNet(fused_pallas=True)``).

* conditioning: sinusoidal timestep embedding (cos||sin, odd-dim zero pad)
  -> Linear, SiLU, Linear, plus SiLU(Linear(z)); the sum ``h`` drives FiLM;
* encoder: per ``ch_mult`` stage two ResBlocks, skip, then a stride-2 3x3
  conv that multiplies channels; middle: two ResBlocks; decoder: per stage
  two ResBlocks, a 4x4 stride-2 transposed conv, then the additive skip;
* head: GroupNorm(8) folded into the linear affine+conv3x3 kernel (no
  activation).

Every ResBlock is two calls of the affine+SiLU+conv3x3 kernel and the head
one call of its linear variant: 29 launches per forward at ch_mult=(1,2,2).
The stem, downsample and transposed convs are plain ``F.conv2d`` /
``F.conv_transpose2d`` (outside any kernel in JAX too). Activations are NHWC
in ``dtype`` (bf16 on the card); parameters are fp32 with the reference
torch state-dict names, so exported JAX params load with ``strict=True``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import resblock_conv as rc
from .blocks import ResBlock, cast, kernel_weight, linear


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding of integer timesteps, fp32, cos||sin order, odd
    ``dim`` zero-padded.

    The frequency table is the correctly rounded fp32 ``exp`` of the fp32
    exponents, made on the host, so it is the same on every device (device
    ``exp`` implementations differ in the last bit, and one bit of a
    frequency moves ``cos(t * f)`` by up to ~1e-4 at t = 999)."""
    half = dim // 2
    x = np.float32(-math.log(max_period)) * np.arange(half, dtype=np.float32) / np.float32(half)
    freqs = torch.from_numpy(np.exp(x.astype(np.float64)).astype(np.float32)).to(t.device)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class CLIPCondUNet(nn.Module):
    """FiLM-conditioned fully convolutional U-Net; ``forward(x_t, z, t)`` with
    x_t (B, H, W, img_ch) NHWC, z (B, z_dim), t (B,) int -> eps in ``dtype``."""

    def __init__(self, z_dim: int = 512, base: int = 128, ch_mult: Sequence[int] = (1, 2, 2),
                 time_dim: int = 256, img_ch: int = 3, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.time_dim = time_dim
        self.compute_dtype = dtype
        self.time_proj = nn.Sequential(nn.Linear(time_dim, time_dim * 4), nn.SiLU(),
                                       nn.Linear(time_dim * 4, time_dim))
        self.z_proj = nn.Sequential(nn.Linear(z_dim, time_dim), nn.SiLU())
        self.in_conv = nn.Conv2d(img_ch, base, 3, padding=1)
        self.down = nn.ModuleList()
        ch = base
        for m in ch_mult:
            self.down.extend([ResBlock(ch, time_dim), ResBlock(ch, time_dim),
                              nn.Conv2d(ch, ch * m, 3, stride=2, padding=1)])
            ch *= m
        self.mid1 = ResBlock(ch, time_dim)
        self.mid2 = ResBlock(ch, time_dim)
        self.up = nn.ModuleList()
        for m in reversed(ch_mult):
            self.up.extend([ResBlock(ch, time_dim), ResBlock(ch, time_dim),
                            nn.ConvTranspose2d(ch, ch // m, 4, stride=2, padding=1)])
            ch //= m
        self.out_norm = nn.GroupNorm(8, ch)
        self.out = nn.Conv2d(ch, img_ch, 3, padding=1)

    def forward(self, x_t: torch.Tensor, z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        temb = timestep_embedding(t, self.time_dim).to(dt)
        temb = linear(self.time_proj[2], F.silu(linear(self.time_proj[0], temb, dt)), dt)
        h = temb + F.silu(linear(self.z_proj[0], z, dt))

        c = self.in_conv
        x = _nhwc(F.conv2d(_nchw(x_t.to(dt)), cast(c, "weight", dt), cast(c, "bias", dt), padding=1))
        skips = []
        for i in range(0, len(self.down), 3):
            rb0, rb1, ds = self.down[i : i + 3]
            x = rb1(rb0(x, h, dt), h, dt)
            skips.append(x)
            x = _nhwc(F.conv2d(_nchw(x), cast(ds, "weight", dt), cast(ds, "bias", dt), stride=2, padding=1))
        x = self.mid2(self.mid1(x, h, dt), h, dt)
        for j in range(0, len(self.up), 3):
            rb0, rb1, us = self.up[j : j + 3]
            x = rb1(rb0(x, h, dt), h, dt)
            x = _nhwc(F.conv_transpose2d(_nchw(x), cast(us, "weight", dt), cast(us, "bias", dt),
                                         stride=2, padding=1))
            x = x + skips.pop()

        A, B = rc.gn_affine(x, self.out_norm.weight, self.out_norm.bias, 8)
        y, _ = rc.affine_conv3x3(x.to(dt).contiguous(), A, B,
                                 kernel_weight(self.out, dt), self.out.bias)
        return y


@torch.no_grad()
def init_params(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Fresh parameters drawn from ``generator`` as flax initialises them:
    LeCun-normal weights (std 1/sqrt(fan_in), fan_in = numel / shape[0]),
    zero biases, GroupNorm and LayerNorm scale 1 and shift 0. The weights
    are drawn on the parameters' device, so ``generator`` lives there."""
    for mod in model.modules():
        if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            fan_in = w.numel() // w.shape[0]
            w.copy_(torch.randn(w.shape, generator=generator, dtype=w.dtype, device=w.device)
                    / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.fill_(0.0)
    return model
