"""SD-1.5 conditional UNet — the port of ``clip_codec_tpu/models/sd/unet.py``.

NHWC activations in ``dtype``; fp32 parameters under diffusers'
``UNet2DConditionModel`` names (``conv_in``, ``time_embedding.linear_1``,
``down_blocks.i.{resnets,attentions,downsamplers}``, ``mid_block``,
``up_blocks.k.{resnets,attentions,upsamplers}``, ``conv_norm_out``,
``conv_out``), so a released checkpoint loads with ``strict=True``.

At SD-1.5 widths and 64x64 latents one forward launches flash attention 10
times (the 5 self-attentions at 64x64, D=40, and the 5 at 32x32, D=80; the
16x16 and 8x8 ones stay under the N >= 1024 gate) and the fused MLP 16 times
(every transformer block).

``int8=True`` (``None``: the process default ``ops.int8.set_int8_conv``, read
at forward time) runs the interior in int8 serving mode (``layers.py``):
every resnet conv and shortcut, transformer projection and resampler conv
through the int8 conv kernel, the MLPs unfused (no fused MLP launch),
flash attention as before. ``conv_in``, ``conv_out`` and the time
embedding stay fp, as in JAX. The state dict does not change.

``mesh`` (a ``parallel.make_mesh`` mesh) with a ``model`` axis of n > 1
ranks builds this rank's tensor-parallel UNet (``parallel/tp.py``): each
transformer block with its slices of the Megatron layout, which
``parallel.shard_params_tp`` cuts from a whole state dict, and three
all-reduces over the axis. K4 runs on the rank's ``heads / n`` heads, K6 on
its ``4C / n`` GEGLU columns; every rank returns the same eps. A model axis
of one builds the single-device UNet. Tensor parallelism takes no int8.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import int8 as q8
from ...parallel.tp import validate_tp
from .layers import (Block, Downsample2D, ResnetBlock2D, Transformer2D, Upsample2D, conv, dense, group_norm32,
                     groups_for, model_ranks)

NO_TP_INT8 = "tensor parallelism takes no int8 (JAX's tensor-parallel SD artifact takes no quant either)"


@dataclass(frozen=True)
class SDUNetConfig:
    in_ch: int = 4
    out_ch: int = 4
    block_out: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_dim: int = 768
    heads: int = 8
    freq_dim: int = 320

    @property
    def temb_dim(self) -> int:
        return self.block_out[0] * 4


SD15_UNET = SDUNetConfig()


@functools.lru_cache(maxsize=None)
def _frequencies(half: int, max_period: float, device: torch.device) -> torch.Tensor:
    """The frequency table on ``device``, copied there once: a forward then
    copies nothing from the host and can be captured in a CUDA graph."""
    x = np.float32(-math.log(max_period)) * np.arange(half, dtype=np.float32) / np.float32(half)
    return torch.from_numpy(np.exp(x.astype(np.float64)).astype(np.float32)).to(device)


def sd_timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` with flip_sin_to_cos=True and
    downscale_freq_shift=0: [cos, sin] order, fp32. The frequency table is
    the correctly rounded fp32 ``exp`` of the fp32 exponents, made on the
    host, so it is the same on every device."""
    args = t.float()[:, None] * _frequencies(dim // 2, max_period, t.device)[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class _TimeEmbedding(nn.Module):
    def __init__(self, freq_dim: int, temb_dim: int) -> None:
        super().__init__()
        self.linear_1 = nn.Linear(freq_dim, temb_dim)
        self.linear_2 = nn.Linear(temb_dim, temb_dim)


class SDUNet(nn.Module):
    """``forward(latents (B, H, W, in_ch), t (B,), context (B, S, cross_dim))``
    -> eps (B, H, W, out_ch) in ``dtype``."""

    def __init__(self, cfg: SDUNetConfig = SD15_UNET, dtype: torch.dtype = torch.float32,
                 int8: Optional[bool] = None, mesh=None) -> None:
        super().__init__()
        c = self.cfg = cfg
        self.compute_dtype = dtype
        self.int8 = int8
        self.n_model = model_ranks(mesh)
        validate_tp(c, self.n_model)
        if self.n_model > 1 and int8:
            raise ValueError(NO_TP_INT8)
        n = len(c.block_out)
        has_attn = [i < n - 1 for i in range(n)]  # SD: the last down block is plain
        self.time_embedding = _TimeEmbedding(c.freq_dim, c.temb_dim)
        self.conv_in = nn.Conv2d(c.in_ch, c.block_out[0], 3, padding=1)

        def trf(ch):
            return Transformer2D(ch, c.heads, c.cross_dim, tp=mesh)

        skips = [c.block_out[0]]
        ch_prev = c.block_out[0]
        self.down_blocks = nn.ModuleList()
        for i, ch in enumerate(c.block_out):
            res, att = [], []
            for _ in range(c.layers_per_block):
                res.append(ResnetBlock2D(ch_prev, ch, c.temb_dim))
                if has_attn[i]:
                    att.append(trf(ch))
                ch_prev = ch
                skips.append(ch)
            extra = {}
            if i < n - 1:
                extra["downsamplers"] = Downsample2D(ch, ch)
                skips.append(ch)
            self.down_blocks.append(Block(res, att, **extra))

        ch = c.block_out[-1]
        self.mid_block = Block([ResnetBlock2D(ch, ch, c.temb_dim), ResnetBlock2D(ch, ch, c.temb_dim)],
                                [trf(ch)])

        self.up_blocks = nn.ModuleList()
        for k, i in enumerate(reversed(range(n))):
            ch = c.block_out[i]
            res, att = [], []
            for _ in range(c.layers_per_block + 1):
                res.append(ResnetBlock2D(ch_prev + skips.pop(), ch, c.temb_dim))
                if has_attn[i]:
                    att.append(trf(ch))
                ch_prev = ch
            extra = {"upsamplers": Upsample2D(ch, ch)} if i > 0 else {}
            self.up_blocks.append(Block(res, att, **extra))

        b0 = c.block_out[0]
        self.conv_norm_out = nn.GroupNorm(groups_for(b0), b0, eps=1e-5)
        self.conv_out = nn.Conv2d(b0, c.out_ch, 3, padding=1)

    def forward(self, latents: torch.Tensor, t: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        q = q8.resolve(self.int8)
        if q and self.n_model > 1:
            raise ValueError(NO_TP_INT8)
        te = self.time_embedding
        temb = sd_timestep_embedding(t, self.cfg.freq_dim).to(dt)
        temb = dense(te.linear_2, F.silu(dense(te.linear_1, temb, dt)), dt)
        context = context.to(dt)

        x = conv(self.conv_in, latents, dt)
        skips = [x]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(x, temb, dt, q)
                if len(blk.attentions):
                    x = blk.attentions[j](x, context, dt, q)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x, dt, q)
                skips.append(x)

        mid = self.mid_block
        x = mid.resnets[0](x, temb, dt, q)
        x = mid.attentions[0](x, context, dt, q)
        x = mid.resnets[1](x, temb, dt, q)

        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=-1), temb, dt, q)
                if len(blk.attentions):
                    x = blk.attentions[j](x, context, dt, q)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x, dt, q)

        x = F.silu(group_norm32(x, self.conv_norm_out))
        return conv(self.conv_out, x, dt)
