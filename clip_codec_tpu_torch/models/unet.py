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

* ``int8=True`` (serving, ``ops/int8.py``; ``None`` reads the process
  default at forward time): direct ResBlocks with both convs in int8 (K1
  around the int8 conv kernel), the three stride-2 downsample convs in int8,
  and the head as in the fused form (one K3 call): 31 int8 convs and one K3
  per forward at ch_mult=(1,2,2); in dynamic mode (or calibrating) 28 K1
  and 31 quantize passes, with calibrated scales 28 K1 launches of its
  codes-out form (``group_norm_silu_int8``) and 3 quantize passes, those of
  the downsample convs. The state dict does not change.

* ``forward(x_t, z, t, mesh)`` (sampling and training with the image
  height split over ``mesh``'s ``model`` axis,
  ``parallel.sample_spatial_sharded``, ``train_diffusion(spatial=True)``):
  the direct form on this rank's rows whatever ``fused_pallas`` says, as
  JAX asks for ``fused_pallas=False`` there, with what GSPMD inserts made
  explicit: each GroupNorm+SiLU as K1's split form with the ranks' moments
  merged over the axis (``group_norm_silu_stats`` of ``x - shift``, one
  all-gather, then ``group_norm_silu_apply``: 28 + 28 launches a forward at
  ch_mult (1, 2, 2), none in the backward, 56 + 56 under ``remat``), the
  head's GroupNorm from moments merged the same way, one halo row of each
  neighbour around every 3x3 stride-1 conv, one of the rank above before a
  stride-2 downsample (every shard starts on an even row), and one each
  side before a 4x4 stride-2 transposed conv, cropped after. Every
  collective carries a gradient (``parallel/mesh.py``). Every level's rows
  must split into an even count a rank (``check_spatial``: JAX pads through
  GSPMD instead; the port refuses). ``forward_spatial`` is its no-grad
  call.

The stem and transposed convs are plain ``F.conv2d`` /
``F.conv_transpose2d`` (outside any kernel in JAX too), and so are the
downsample convs outside int8 mode. Activations are NHWC
in ``dtype`` (bf16 on the card); parameters are fp32 with the reference
torch state-dict names, so exported JAX params load with ``strict=True``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import int8 as q8
from ..ops import resblock_conv as rc
from ..ops.groupnorm import GN_EPS, group_norm
from ..parallel.mesh import MODEL_AXIS, axis_size, halo_rows, merge_moments_model
from .blocks import ResBlock, cast, conv2d, conv3x3, kernel_weight, linear


@functools.lru_cache(maxsize=None)
def _frequencies(half: int, max_period: int, device: torch.device) -> torch.Tensor:
    """The embedding's fp32 frequency table on ``device``, copied there once:
    a forward then copies nothing from the host and can be captured in a
    CUDA graph."""
    x = np.float32(-math.log(max_period)) * np.arange(half, dtype=np.float32) / np.float32(half)
    return torch.from_numpy(np.exp(x.astype(np.float64)).astype(np.float32)).to(device)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding of integer timesteps, fp32, cos||sin order, odd
    ``dim`` zero-padded.

    The frequency table is the correctly rounded fp32 ``exp`` of the fp32
    exponents, made on the host, so it is the same on every device (device
    ``exp`` implementations differ in the last bit, and one bit of a
    frequency moves ``cos(t * f)`` by up to ~1e-4 at t = 999)."""
    half = dim // 2
    args = t.float()[:, None] * _frequencies(half, max_period, t.device)[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def check_spatial(size: int, levels: int, n_model: int) -> None:
    """Raise unless an image of ``size`` rows splits over ``n_model`` ranks
    into an even count of rows a rank at each of the U-Net's ``levels``
    downsampling levels (a stride-2 conv then starts every shard on an even
    row), naming the first level that does not."""
    for level in range(levels):
        rows = size // 2 ** level
        if size % 2 ** level or rows % (2 * n_model):
            raise ValueError(f"spatial sharding: level {level} has {size / 2 ** level:g} rows, "
                             f"{rows / n_model:g} a rank over a model axis of {n_model}, and its stride-2 "
                             f"downsample needs an even count a rank (the JAX package pads unevenly split "
                             f"levels through GSPMD; the port refuses them)")


def _group_norm_spatial(x: torch.Tensor, norm: nn.GroupNorm, mesh, eps: float = GN_EPS) -> torch.Tensor:
    """``group_norm`` of this rank's rows ``x`` of an image whose height is
    split over ``mesh``'s model axis: fp32 sums over the rows about this
    rank's own group means, the ranks' moments merged in one collective
    (``merge_moments_model``); differentiable through the merge."""
    B, h, W, C = x.shape
    G = norm.num_groups
    xg = x.float().reshape(B, h, W, G, C // G)
    n = h * W * (C // G)
    local = xg.mean(dim=(1, 2, 4))
    d = xg - local[:, None, None, :, None]
    mean, m2 = merge_moments_model(mesh, local, d.sum(dim=(1, 2, 4)), d.square().sum(dim=(1, 2, 4)), n)
    var = m2 / (n * axis_size(mesh, MODEL_AXIS))
    y = ((xg - mean[:, None, None, :, None]) * torch.rsqrt(var + eps)[:, None, None, :, None]).reshape(B, h, W, C)
    return (y * norm.weight.float() + norm.bias.float()).to(x.dtype)


class CLIPCondUNet(nn.Module):
    """FiLM-conditioned fully convolutional U-Net; ``forward(x_t, z, t)`` with
    x_t (B, H, W, img_ch) NHWC, z (B, z_dim), t (B,) int -> eps in ``dtype``."""

    def __init__(self, z_dim: int = 512, base: int = 128, ch_mult: Sequence[int] = (1, 2, 2),
                 time_dim: int = 256, img_ch: int = 3, dtype: torch.dtype = torch.float32,
                 fused_pallas: bool = True, remat: bool = False, int8: Optional[bool] = None) -> None:
        super().__init__()
        self.time_dim = time_dim
        self.compute_dtype = dtype
        self.fused_pallas = fused_pallas
        self.remat = remat
        self.int8 = int8
        self.INT8_LAYERS = tuple(f"down.{3 * i + 2}" for i in range(len(ch_mult)))  # the downsample convs
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

    def forward(self, x_t: torch.Tensor, z: torch.Tensor, t: torch.Tensor, mesh=None) -> torch.Tensor:
        """eps for ``x_t``; with ``mesh``, of this rank's rows ``x_t`` (B, H /
        n, W, img_ch) of images whose height is split over the mesh's model
        axis of n ranks in rank order (every rank of the axis calls it
        together, in the direct form)."""
        dt = self.compute_dtype
        int8 = q8.resolve(self.int8)
        fused = self.fused_pallas and not self.remat and mesh is None
        if mesh is not None:
            if int8:
                raise ValueError("spatial sharding takes no int8 (the JAX package's spatial artifact takes no quant)")
            n = axis_size(mesh, MODEL_AXIS)
            check_spatial(x_t.shape[1] * n, len(self.down) // 3, n)
        temb = timestep_embedding(t, self.time_dim).to(dt)
        temb = linear(self.time_proj[2], F.silu(linear(self.time_proj[0], temb, dt)), dt)
        h = temb + F.silu(linear(self.z_proj[0], z, dt))

        def rb_pair(x, rb0, rb1):
            for rb in (rb0, rb1):
                if self.remat:
                    x = checkpoint(rb, x, h, dt, False, int8, mesh, use_reentrant=False)
                else:
                    x = rb(x, h, dt, fused, int8, mesh)
            return x

        x = conv3x3(self.in_conv, x_t, dt, mesh)
        skips = []
        for i in range(0, len(self.down), 3):
            rb0, rb1, ds = self.down[i : i + 3]
            x = rb_pair(x, rb0, rb1)
            skips.append(x)
            x = q8.conv(ds, x, dt, stride=2, padding=1) if int8 else conv3x3(ds, x, dt, mesh, stride=2)
        x = rb_pair(x, self.mid1, self.mid2)
        for j in range(0, len(self.up), 3):
            rb0, rb1, us = self.up[j : j + 3]
            x = rb_pair(x, rb0, rb1)
            if mesh is None:
                x = F.conv_transpose2d(x.permute(0, 3, 1, 2), cast(us, "weight", dt), cast(us, "bias", dt),
                                       stride=2, padding=1).permute(0, 2, 3, 1).contiguous()
            else:
                rows = x.shape[1]
                # output row o of the transposed conv reads input rows floor(o/2) - 1 .. floor(o/2): with a
                # halo row each side and no H padding, this rank's 2 * rows outputs start at row 3
                y = F.conv_transpose2d(halo_rows(mesh, x, 1, 1).permute(0, 3, 1, 2), cast(us, "weight", dt),
                                       cast(us, "bias", dt), stride=2, padding=(0, 1))
                x = y[:, :, 3:3 + 2 * rows].permute(0, 2, 3, 1).contiguous()
            x = x + skips.pop()

        if mesh is not None:
            return conv3x3(self.out, _group_norm_spatial(x, self.out_norm, mesh), dt, mesh)
        if not fused:
            x = group_norm(x, (self.out_norm.weight, self.out_norm.bias), 8)
            return conv2d(self.out, x, dt, padding=1)
        A, B = rc.gn_affine(x, self.out_norm.weight, self.out_norm.bias, 8)
        y, _ = rc.affine_conv3x3(x.to(dt).contiguous(), A, B,
                                 kernel_weight(self.out, dt), self.out.bias)
        return y

    @torch.no_grad()
    def forward_spatial(self, x_t: torch.Tensor, z: torch.Tensor, t: torch.Tensor, mesh) -> torch.Tensor:
        """``forward(x_t, z, t, mesh)`` without a gradient (the spatial
        samplers' call)."""
        return self(x_t, z, t, mesh)


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
