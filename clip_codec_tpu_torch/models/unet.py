"""CLIP-conditioned U-Net predicting eps(x_t, z, t): the port of
``clip_codec_tpu/models/unet.py``.

* conditioning: sinusoidal timestep embedding (cos||sin, odd-dim zero pad)
  -> Linear, SiLU, Linear, plus SiLU(Linear(z)); the sum ``h`` drives FiLM;
* encoder: per ``ch_mult`` stage two ResBlocks, skip, then a stride-2 3x3
  conv that multiplies channels; middle: two ResBlocks; decoder: per stage
  two ResBlocks, a 4x4 stride-2 transposed conv, then the additive skip;
* head: GroupNorm(8) then a 3x3 conv (no activation).

Two forms on the same parameters, JAX's ``fused_pallas`` and ``remat``:

* ``fused_pallas=True`` (serving, the default): every ResBlock is two calls
  of the affine+SiLU+conv3x3 kernel and the head, GroupNorm folded in, one
  call of its linear variant: 29 launches per forward at ch_mult=(1,2,2).
  It computes no gradient.
* ``fused_pallas=False`` or ``remat=True`` (training): direct ResBlocks,
  each two calls of the fused GroupNorm+SiLU (K1) around ``F.conv2d``, and
  the head as plain ``group_norm`` then ``F.conv2d``: 28 K1 pairs per
  forward. ``remat`` recomputes each ResBlock in the backward
  (``torch.utils.checkpoint``), JAX's ``nn.remat(ResBlock)``.

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
from torch.utils.checkpoint import checkpoint

from ..ops import resblock_conv as rc
from ..ops.groupnorm import group_norm
from .blocks import ResBlock, cast, conv2d, kernel_weight, linear


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


class CLIPCondUNet(nn.Module):
    """FiLM-conditioned fully convolutional U-Net; ``forward(x_t, z, t)`` with
    x_t (B, H, W, img_ch) NHWC, z (B, z_dim), t (B,) int -> eps in ``dtype``."""

    def __init__(self, z_dim: int = 512, base: int = 128, ch_mult: Sequence[int] = (1, 2, 2),
                 time_dim: int = 256, img_ch: int = 3, dtype: torch.dtype = torch.float32,
                 fused_pallas: bool = True, remat: bool = False) -> None:
        super().__init__()
        self.time_dim = time_dim
        self.compute_dtype = dtype
        self.fused_pallas = fused_pallas
        self.remat = remat
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
        fused = self.fused_pallas and not self.remat
        temb = timestep_embedding(t, self.time_dim).to(dt)
        temb = linear(self.time_proj[2], F.silu(linear(self.time_proj[0], temb, dt)), dt)
        h = temb + F.silu(linear(self.z_proj[0], z, dt))

        def rb_pair(x, rb0, rb1):
            for rb in (rb0, rb1):
                if self.remat:
                    x = checkpoint(rb, x, h, dt, False, use_reentrant=False)
                else:
                    x = rb(x, h, dt, fused)
            return x

        x = conv2d(self.in_conv, x_t, dt, padding=1)
        skips = []
        for i in range(0, len(self.down), 3):
            rb0, rb1, ds = self.down[i : i + 3]
            x = rb_pair(x, rb0, rb1)
            skips.append(x)
            x = conv2d(ds, x, dt, stride=2, padding=1)
        x = rb_pair(x, self.mid1, self.mid2)
        for j in range(0, len(self.up), 3):
            rb0, rb1, us = self.up[j : j + 3]
            x = rb_pair(x, rb0, rb1)
            x = F.conv_transpose2d(x.permute(0, 3, 1, 2), cast(us, "weight", dt), cast(us, "bias", dt),
                                   stride=2, padding=1).permute(0, 2, 3, 1).contiguous()
            x = x + skips.pop()

        if not fused:
            x = group_norm(x, (self.out_norm.weight, self.out_norm.bias), 8)
            return conv2d(self.out, x, dt, padding=1)
        A, B = rc.gn_affine(x, self.out_norm.weight, self.out_norm.bias, 8)
        y, _ = rc.affine_conv3x3(x.to(dt).contiguous(), A, B,
                                 kernel_weight(self.out, dt), self.out.bias)
        return y


# flax's lecun_normal is variance_scaling(1, "fan_in", "truncated_normal"): a
# normal cut at +-2 of its sigma, sigma scaled up by 1 / (the std of a unit
# normal truncated at +-2) so that the draws have std 1/sqrt(fan_in).
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Fresh parameters drawn from ``generator`` as flax initialises them:
    LeCun-normal weights (a normal truncated at +-2 sigma with std
    1/sqrt(fan_in), fan_in = numel / shape[0]), zero biases, GroupNorm and
    LayerNorm scale 1 and shift 0. The weights are drawn on the parameters'
    device, so ``generator`` lives there."""
    for mod in model.modules():
        if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            sigma = 1.0 / math.sqrt(w.numel() // w.shape[0]) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, sigma, -2.0 * sigma, 2.0 * sigma, generator=generator)
            if mod.bias is not None:
                mod.bias.fill_(0.0)
    return model
