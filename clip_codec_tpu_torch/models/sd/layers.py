"""Stable-Diffusion building blocks — the port of ``clip_codec_tpu/models/sd/layers.py``.

Activations are NHWC tensors in the compute ``dtype``; parameters are fp32
with diffusers' state-dict names and shapes, so a released SD-1.5
checkpoint loads with ``load_state_dict(strict=True)``. The 3x3 convs run in
cuDNN (``F.conv2d``) on the NHWC storage seen as a channels_last NCHW view,
so neither side of a conv copies; 1x1 convs are linear maps over the token
view ``(B, H*W, C)``, which is the NHWC storage itself.

Two hand-written kernels carry the blocks' hot paths:

* ``CrossAttention`` self-attention at ``N >= 1024, N % 128 == 0`` (the JAX
  gate, a memory rule) and the VAE's single-head mid-block attention go
  through flash attention (``ops/attention.py``);
* every ``BasicTransformerBlock``'s LN -> GEGLU -> out-projection tail goes
  through the fused MLP (``ops/mlp.py``).

On the CPU both run their plain versions. Both are autograd Functions, so
the blocks are differentiable in their activations (adapter training
backpropagates through them; flash attention's backward is a kernel too).
The parameters are not: the conv weights' compute-dtype copies that
``_converted`` caches are detached (``cast`` tracks a cast only for a
parameter that wants a gradient), so the UNet and VAE train nothing and
their parameters are kept frozen (``requires_grad=False``) by the trainer.
The JAX TPU layouts (the spatial fold, the phase-decomposed upsample) and
int8 are not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import attention as attn_ops
from ...ops import mlp as mlp_ops
from ...ops.groupnorm import group_norm
from ..blocks import _converted, cast

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def groups_for(channels: int, groups: int = 32) -> int:
    """``gcd(groups, C)``: 32 at every SD width, a divisor of C at test widths."""
    return math.gcd(groups, channels) or 1


def group_norm32(x: torch.Tensor, norm: nn.GroupNorm, eps: Optional[float] = None) -> torch.Tensor:
    """GroupNorm of NHWC ``x`` with ``norm``'s parameters and group count,
    fp32 statistics, result in x's dtype."""
    return group_norm(x, (norm.weight, norm.bias), norm.num_groups,
                      norm.eps if eps is None else eps)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm``: fp32 statistics with the raw ``E[x^2] - mu^2``
    variance clamped at 0, ``norm.eps``, result in ``dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + norm.eps)
    return (y * norm.weight.float() + norm.bias.float()).to(dtype)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` in ``dtype`` (with or without a bias)."""
    b = None if layer.bias is None else cast(layer, "bias", dtype)
    return F.linear(x.to(dtype), cast(layer, "weight", dtype), b)


def _channels_last(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return w.to(dtype).contiguous(memory_format=torch.channels_last)


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype, stride: int = 1,
         padding: int = 1) -> torch.Tensor:
    """A k x k conv of NHWC ``x`` in ``dtype`` (cuDNN on the card), NHWC out."""
    w = _converted(layer, "weight", dtype, _channels_last)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w, cast(layer, "bias", dtype),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv1x1(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A 1x1 conv of NHWC ``x`` as a linear map over the channels."""
    w = _converted(layer, "weight", dtype, lambda w, dt: w.reshape(w.shape[0], -1).to(dt))
    return F.linear(x.to(dtype), w, cast(layer, "bias", dtype))


class Block(nn.Module):
    """A diffusers down/mid/up block as a container: ``resnets``,
    ``attentions`` (possibly empty) and an optional one-element resampler
    list (``downsamplers`` or ``upsamplers``)."""

    def __init__(self, resnets, attentions=(), **resamplers) -> None:
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        for name, mod in resamplers.items():
            setattr(self, name, nn.ModuleList([mod]))


class ResnetBlock2D(nn.Module):
    """GN32 -> SiLU -> conv -> (+ temb proj) -> GN32 -> SiLU -> conv, with a
    1x1 shortcut when channels change (diffusers ``ResnetBlock2D`` names)."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: Optional[int] = None,
                 eps: float = 1e-5) -> None:
        super().__init__()
        self.norm1 = nn.GroupNorm(groups_for(in_ch), in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = nn.GroupNorm(groups_for(out_ch), out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
        h = conv(self.conv1, F.silu(group_norm32(x, self.norm1)), dtype)
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + dense(self.time_emb_proj, F.silu(temb), dtype)[:, None, None, :]
        h = conv(self.conv2, F.silu(group_norm32(h, self.norm2)), dtype)
        if hasattr(self, "conv_shortcut"):
            x = conv1x1(self.conv_shortcut, x, dtype)
        return x.to(dtype) + h


def _attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """The JAX module path: logits in the compute dtype divided by sqrt(d)
    rounded to that dtype, fp32 softmax cast back, then ``attn . v``.
    q (B, N, h, d), k and v (B, M, h, d) -> (B, N, h, d)."""
    sqrt_d = float(torch.tensor(math.sqrt(d), dtype=torch.float32).to(dtype))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / sqrt_d
    attn = torch.softmax(logits.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


def _flash_gate(n: int) -> bool:
    return n >= 1024 and n % 128 == 0


class CrossAttention(nn.Module):
    """Multi-head attention; ``context=None`` is self-attention (diffusers
    ``Attention``: to_q/to_k/to_v without bias, to_out.0 with bias)."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None) -> None:
        super().__init__()
        cd = dim if context_dim is None else context_dim
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(cd, dim, bias=False)
        self.to_v = nn.Linear(cd, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
        ctx = x if context is None else context
        B, N, dim = x.shape
        M = ctx.shape[1]
        h = self.heads
        d = dim // h
        q = dense(self.to_q, x, dtype).view(B, N, h, d)
        k = dense(self.to_k, ctx, dtype).view(B, M, h, d)
        v = dense(self.to_v, ctx, dtype).view(B, M, h, d)
        if context is None and _flash_gate(N):
            # Self-attention over thousands of latent pixels: the (h, N, N)
            # logits never reach device memory.
            out = attn_ops.flash_attention_heads(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
        else:
            out = _attention_plain(q, k, v, d, dtype)
        return dense(self.to_out[0], out.reshape(B, N, dim), dtype)


class GEGLU(nn.Module):
    """diffusers' fused ``proj`` (C -> 2F) with output order [hidden | gate];
    the fused MLP reads the two halves."""

    def __init__(self, dim: int, dim_out: int) -> None:
        super().__init__()
        self.proj = nn.Linear(dim, 2 * dim_out)

    def halves(self):
        """(wh (C, F), bh, wg (C, F), bg) as fp32 views of ``proj``."""
        f = self.proj.out_features // 2
        w, b = self.proj.weight, self.proj.bias
        return w[:f].t(), b[:f], w[f:].t(), b[f:]


class FeedForward(nn.Module):
    """diffusers ``FeedForward`` names: net.0 = GEGLU, net.1 = dropout (no
    parameters), net.2 = the out-projection."""

    def __init__(self, dim: int, mult: int = 4) -> None:
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn -> LN -> cross-attn(context) -> fused LN -> GEGLU ->
    out-proj MLP; every LayerNorm has flax's eps 1e-6."""

    def __init__(self, dim: int, heads: int, cross_dim: int) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn1 = CrossAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn2 = CrossAttention(dim, heads, cross_dim)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = FeedForward(dim)

    def _packed(self, dtype: torch.dtype) -> mlp_ops.Packed:
        """The fused MLP's packed weights, cached per load of the parameters."""
        geglu, out = self.ff.net[0].proj.weight, self.ff.net[2].weight
        key = (geglu.data_ptr(), geglu._version, out.data_ptr(), out._version, dtype)
        hit = self.__dict__.get("_packed_cache")
        if hit is None or hit[0] != key:
            wh, _, wg, _ = self.ff.net[0].halves()
            hit = self._packed_cache = (key, mlp_ops.pack_weights(wh, wg, out.t(), dtype))
        return hit[1]

    def forward(self, x: torch.Tensor, context: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x + self.attn1(layer_norm(self.norm1, x, dtype), None, dtype)
        x = x + self.attn2(layer_norm(self.norm2, x, dtype), context, dtype)
        wh, bh, wg, bg = self.ff.net[0].halves()
        out = self.ff.net[2]
        packed = self._packed(dtype) if x.device.type == "cuda" else None
        y = mlp_ops.transformer_mlp(x.contiguous(), self.norm3.weight, self.norm3.bias,
                                    wh, bh, wg, bg, out.weight.t(), packed=packed)
        return x + y + cast(out, "bias", dtype)


class Transformer2D(nn.Module):
    """Spatial transformer: GN(eps 1e-6) -> 1x1 proj_in -> transformer
    blocks over the (B, H*W, C) tokens -> 1x1 proj_out, residual (SD-1.5's
    conv projections)."""

    def __init__(self, dim: int, heads: int, cross_dim: int, depth: int = 1) -> None:
        super().__init__()
        self.norm = nn.GroupNorm(groups_for(dim), dim, eps=1e-6)
        self.proj_in = nn.Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, heads, cross_dim) for _ in range(depth)])
        self.proj_out = nn.Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        B, H, W, C = x.shape
        h = conv1x1(self.proj_in, group_norm32(x, self.norm), dtype).reshape(B, H * W, C)
        for blk in self.transformer_blocks:
            h = blk(h, context, dtype)
        return x.to(dtype) + conv1x1(self.proj_out, h.reshape(B, H, W, C), dtype)


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv; ``asymmetric=True`` pads (0, 1) on H and W, as the
    VAE encoder does, instead of 1 on every side."""

    def __init__(self, in_ch: int, out_ch: int, asymmetric: bool = False) -> None:
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = nn.Conv2d(in_ch, out_ch, 3, stride=2, padding=0 if asymmetric else 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.asymmetric:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))  # NHWC: W right, H bottom
            return conv(self.conv, x, dtype, stride=2, padding=0)
        return conv(self.conv, x, dtype, stride=2, padding=1)


class Upsample2D(nn.Module):
    """Nearest 2x, then a 3x3 conv (the SD upsampler)."""

    def __init__(self, ch: int, out_ch: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(ch, out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        up = F.interpolate(x.to(dtype).permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return conv(self.conv, up.permute(0, 2, 3, 1), dtype)


class AttnBlockVAE(nn.Module):
    """Single-head self-attention over pixels (the VAE mid-block; diffusers'
    group_norm, to_q/to_k/to_v/to_out.0 with biases)."""

    def __init__(self, ch: int) -> None:
        super().__init__()
        self.group_norm = nn.GroupNorm(groups_for(ch), ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        B, H, W, C = x.shape
        N = H * W
        h = group_norm32(x, self.group_norm).reshape(B, N, C)
        q = dense(self.to_q, h, dtype)
        k = dense(self.to_k, h, dtype)
        v = dense(self.to_v, h, dtype)
        if _flash_gate(N):
            out = attn_ops.flash_attention_heads(q[:, None], k[:, None], v[:, None])[:, 0]
        else:
            out = _attention_plain(q[:, :, None], k[:, :, None], v[:, :, None], C, dtype)[:, :, 0]
        out = dense(self.to_out[0], out, dtype)
        return x.to(dtype) + out.reshape(B, H, W, C)
