"""FiLM and the FiLM-conditioned ResBlock (port of ``clip_codec_tpu/models/blocks.py``),
NHWC activations, fp32 parameters in the reference torch state-dict layout.

The ResBlock has the JAX block's two forms on the same parameters:

* fused (serving): the two-kernel form of the JAX ``ResBlock._pallas_core``

      A1, B1 = GN1 as a per-(batch, channel) affine of x
      y, mom = affine_silu_conv3x3(x, A1, B1, conv1, want_moments=True)
      A2, B2 = GN2 o FiLM as an affine, from y's fp32 moments
      out    = affine_silu_conv3x3(y, A2, B2, conv2, add=x)

  so the FiLM'd and normalised intermediates never reach device memory. Its
  conv weights are cached detached copies: it computes no gradient.
* direct (training): the JAX block's plain path,
  ``x + conv2(gn_silu2(film(conv1(gn_silu1(x)), h)))``, with GroupNorm+SiLU
  through ``ops.groupnorm.group_norm_silu`` (K1 on the card) and the convs
  as ``F.conv2d``; differentiable in every parameter.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import groupnorm as gn
from ..ops import resblock_conv as rc


def _converted(module: nn.Module, name: str, dtype: torch.dtype, convert) -> torch.Tensor:
    """``convert(module.<name>, dtype)``, computed once per load of the
    parameter: the cache is keyed on its storage and version, so
    ``load_state_dict`` or ``.to(device)`` invalidates it. The result is
    detached: no gradient reaches the parameter (frozen weights only)."""
    p = getattr(module, name)
    key = (p.data_ptr(), p._version, dtype)
    cache = module.__dict__.setdefault("_converted", {})
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        hit = cache[name] = (key, convert(p.detach(), dtype))
    return hit[1]


def cast(module: nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """The fp32 parameter ``module.<name>`` in the compute dtype: a cast that
    autograd tracks when a gradient is wanted for it, else the cached copy
    (serving, frozen weights)."""
    p = getattr(module, name)
    if p.dtype == dtype:
        return p
    if p.requires_grad and torch.is_grad_enabled():
        return p.to(dtype)
    return _converted(module, name, dtype, torch.Tensor.to)


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype``."""
    return F.linear(x.to(dtype), cast(layer, "weight", dtype), cast(layer, "bias", dtype))


def kernel_weight(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``conv.weight`` as the kernel's (9, Cin, Cout) in ``dtype`` (detached)."""
    return _converted(conv, "weight", dtype, rc.conv_weight_to_w9)


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype, **kw) -> torch.Tensor:
    """``conv(x)`` on NHWC ``x``, computed in ``dtype``; NHWC out."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), cast(conv, "weight", dtype), cast(conv, "bias", dtype), **kw)
    return y.permute(0, 2, 3, 1).contiguous()


class FiLM(nn.Module):
    """Feature-wise modulation ``x * (1 + scale(h)) + shift(h)``; the fused
    ResBlock folds it into GroupNorm's affine, so only its coefficients are
    computed here."""

    def __init__(self, cond_dim: int, features: int) -> None:
        super().__init__()
        self.to_scale = nn.Linear(cond_dim, features)
        self.to_shift = nn.Linear(cond_dim, features)

    def coeffs(self, h: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scale, shift), each (B, C), computed in ``dtype``."""
        return linear(self.to_scale, h, dtype), linear(self.to_shift, h, dtype)


class ResBlock(nn.Module):
    """Channel-preserving residual block
    ``x + conv2(silu(gn2(film(conv1(silu(gn1(x))), h))))`` with
    ``min(groups, C)`` GroupNorm groups."""

    def __init__(self, features: int, cond_dim: int, groups: int = 8) -> None:
        super().__init__()
        g = min(groups, features)
        self.norm1 = nn.GroupNorm(g, features)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.film = FiLM(cond_dim, features)
        self.norm2 = nn.GroupNorm(g, features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor, h: torch.Tensor, dtype: torch.dtype, fused: bool = True) -> torch.Tensor:
        """x: (B, H, W, C) NHWC; h: (B, cond_dim) -> (B, H, W, C) in ``dtype``."""
        if not fused:
            return self.direct(x, h, dtype)
        g = self.norm1.num_groups
        xd = x.to(dtype).contiguous()
        A1, B1 = rc.gn_affine(x, self.norm1.weight, self.norm1.bias, g)
        y, mom = rc.affine_silu_conv3x3(
            xd, A1, B1, kernel_weight(self.conv1, dtype), self.conv1.bias, want_moments=True)
        fs, fb = self.film.coeffs(h, dtype)
        A2, B2 = rc.gn_affine_from_moments(
            mom, x.shape[1] * x.shape[2], self.norm2.weight, self.norm2.bias, g,
            film=(fs.float(), fb.float()))
        out, _ = rc.affine_silu_conv3x3(
            y, A2, B2, kernel_weight(self.conv2, dtype), self.conv2.bias, add=xd)
        return out

    def direct(self, x: torch.Tensor, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The JAX block's direct form (``blocks.py`` ``ResBlock.__call__``)."""
        g = self.norm1.num_groups
        x = x.to(dtype).contiguous()
        y = gn.group_norm_silu(x, (self.norm1.weight, self.norm1.bias), g)
        y = conv2d(self.conv1, y, dtype, padding=1)
        fs, fb = self.film.coeffs(h, dtype)
        y = y * (1.0 + fs[:, None, None, :]) + fb[:, None, None, :]
        y = gn.group_norm_silu(y, (self.norm2.weight, self.norm2.bias), g)
        return x + conv2d(self.conv2, y, dtype, padding=1)
