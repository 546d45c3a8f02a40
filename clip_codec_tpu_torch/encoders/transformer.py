"""Pre-LN transformer encoder of the CLIP and DINOv2 towers — the port of
``clip_codec_tpu/encoders/transformer.py``.

Parameters carry the openai / open_clip state-dict names (``ln_1``,
``attn.in_proj_weight`` and ``attn.in_proj_bias`` with q, k, v fused,
``attn.out_proj``, ``ln_2``, ``mlp.c_fc``, ``mlp.c_proj``), so a released
checkpoint loads with ``load_state_dict(strict=True)``. They stay fp32 and
are cast to the compute dtype where they are used, as flax casts a Dense's
kernel; LayerNorm computes in fp32 and rounds its output once.

Attention is written as JAX writes it: logits / sqrt(d) in the compute
dtype, the mask added and the softmax taken in fp32, the probabilities cast
back, then P·V (not ``nn.MultiheadAttention`` or SDPA, whose internal
rounding differs).

A block takes its activation (CLIP's ``quick_gelu``, DINOv2's exact
``F.gelu``), its LayerNorm eps and, for DINOv2, LayerScale: fp32 ``ls1`` and
``ls2`` of shape (dim,) that multiply the attention and MLP outputs. As in
JAX, a compute-dtype output times an fp32 scale is fp32, so from the first
block on the residual stream of a bf16 tower with LayerScale is fp32 (its
LayerNorms still round their outputs to the compute dtype).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.blocks import cast
from ..models.sd.layers import dense, layer_norm


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention with a fused (3D, D) input projection."""

    def __init__(self, dim: int, heads: int) -> None:
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
        B, N, D = x.shape
        h = self.heads
        d = D // h
        qkv = F.linear(x, cast(self, "in_proj_weight", dtype), cast(self, "in_proj_bias", dtype))
        q, k, v = qkv.view(B, N, 3, h, d).permute(2, 0, 3, 1, 4)  # each (B, h, N, d)
        # JAX divides by sqrt(d) rounded to the compute dtype
        logits = (q @ k.transpose(-1, -2)) / float(torch.tensor(math.sqrt(d), dtype=dtype))
        logits = logits.float()
        if mask is not None:
            logits = logits + mask
        attn = torch.softmax(logits, dim=-1).to(dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, D)
        return dense(self.out_proj, out, dtype)


Activation = Callable[[torch.Tensor], torch.Tensor]


class MLP(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, act: Activation = quick_gelu) -> None:
        super().__init__()
        self.act = act
        self.c_fc = nn.Linear(dim, mlp_dim)
        self.c_proj = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return dense(self.c_proj, self.act(dense(self.c_fc, x, dtype)), dtype)


class TransformerBlock(nn.Module):
    """Pre-LN block: x + ls1 attn(ln_1(x)); x + ls2 mlp(ln_2(x)), the
    scales only with ``layer_scale``."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, eps: float = 1e-5, act: Activation = quick_gelu,
                 layer_scale: bool = False) -> None:
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim, eps=eps)
        self.attn = MultiHeadAttention(dim, heads)
        self.ln_2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = MLP(dim, mlp_dim, act)
        if layer_scale:
            self.ls1 = nn.Parameter(torch.ones(dim))
            self.ls2 = nn.Parameter(torch.ones(dim))
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
        y = self.attn(layer_norm(self.ln_1, x, dtype), mask, dtype)
        x = x + (y if self.ls1 is None else y * self.ls1)
        y = self.mlp(layer_norm(self.ln_2, x, dtype), dtype)
        return x + (y if self.ls2 is None else y * self.ls2)


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int, eps: float = 1e-5,
                 act: Activation = quick_gelu, layer_scale: bool = False) -> None:
        super().__init__()
        self.resblocks = nn.ModuleList(TransformerBlock(dim, heads, mlp_dim, eps, act, layer_scale)
                                       for _ in range(depth))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """x: (B, N, dim) -> (B, N, dim) in ``dtype`` (fp32 with LayerScale);
        ``mask`` an fp32 additive (N, N) mask or None."""
        x = x.to(dtype)
        for blk in self.resblocks:
            x = blk(x, mask, dtype)
        return x
