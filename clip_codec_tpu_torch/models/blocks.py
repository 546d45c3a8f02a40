"""FiLM, the FiLM-conditioned ResBlock, the direct decoders' ``DWConvBlock``
and ``AttnBlock`` (port of ``clip_codec_tpu/models/blocks.py``), NHWC
activations, fp32 parameters in the reference torch state-dict layout.

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
* int8 (serving, ``ops/int8.py``): the direct form with both convs through
  the int8 conv kernel, as the JAX block takes its direct path in int8 mode.
  With a calibrated conv (static int8, no mesh) its GroupNorm+SiLU writes
  the conv's int8 codes itself (``ops.groupnorm.group_norm_silu_int8``);
  calibrating or dynamic, the conv quantizes K1's output.
* direct with a ``mesh`` (sampling and training with the image height split
  over the mesh's ``model`` axis): the same body on this rank's rows, each
  GroupNorm+SiLU as K1's split form with the ranks' moments merged over
  the axis between its halves (``ops.groupnorm.group_norm_silu_spatial``),
  each 3x3 conv reading one halo row of each neighbour
  (``parallel.mesh.halo_rows``): what GSPMD inserts into JAX's direct form.
  Differentiable, the collectives included.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import groupnorm as gn
from ..ops import int8 as q8
from ..ops import resblock_conv as rc
from ..parallel.mesh import halo_rows


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


def conv3x3(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype, mesh=None, stride: int = 1) -> torch.Tensor:
    """A 3x3 conv with padding 1 of NHWC ``x`` in ``dtype``. With ``mesh``,
    of this rank's rows of an image whose height is split over the mesh's
    model axis: the rows are read between a halo row of each neighbour
    (stride 1), or of the rank above only (stride 2, where every shard
    starts on an even row), and padded on W alone."""
    if mesh is None:
        return conv2d(conv, x, dtype, stride=stride, padding=1)
    return conv2d(conv, halo_rows(mesh, x, 1, 1 if stride == 1 else 0), dtype, stride=stride, padding=(0, 1))


def group_norm_silu(x: torch.Tensor, norm: nn.GroupNorm, mesh=None) -> torch.Tensor:
    """``silu(norm(x))`` of NHWC ``x`` through K1 (``ops.groupnorm``); with
    ``mesh``, of this rank's rows of an image whose height is split over
    the mesh's model axis, through K1's split form with the moments merged
    over the axis."""
    if mesh is None:
        return gn.group_norm_silu(x, (norm.weight, norm.bias), norm.num_groups)
    return gn.group_norm_silu_spatial(x, (norm.weight, norm.bias), norm.num_groups, mesh)


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

    INT8_LAYERS = ("conv1", "conv2")

    def __init__(self, features: int, cond_dim: int, groups: int = 8) -> None:
        super().__init__()
        g = min(groups, features)
        self.norm1 = nn.GroupNorm(g, features)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.film = FiLM(cond_dim, features)
        self.norm2 = nn.GroupNorm(g, features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor, h: torch.Tensor, dtype: torch.dtype, fused: bool = True,
                int8: bool = False, mesh=None) -> torch.Tensor:
        """x: (B, H, W, C) NHWC (with ``mesh``, this rank's rows of H); h:
        (B, cond_dim) -> (B, H, W, C) in ``dtype``."""
        if int8 or not fused or mesh is not None:
            return self.direct(x, h, dtype, int8, mesh)
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

    def direct(self, x: torch.Tensor, h: torch.Tensor, dtype: torch.dtype, int8: bool = False,
               mesh=None) -> torch.Tensor:
        """The JAX block's direct form (``blocks.py`` ``ResBlock.__call__``),
        its convs in int8 with ``int8``; with ``mesh``, on this rank's rows
        of an image whose height is split over the mesh's model axis."""
        x = x.to(dtype).contiguous()
        y = _norm_conv(self.norm1, self.conv1, x, dtype, int8, mesh)
        fs, fb = self.film.coeffs(h, dtype)
        y = y * (1.0 + fs[:, None, None, :]) + fb[:, None, None, :]
        return x + _norm_conv(self.norm2, self.conv2, y, dtype, int8, mesh)


def _norm_conv(norm: nn.GroupNorm, conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype, int8: bool,
               mesh) -> torch.Tensor:
    """``conv(silu(norm(x)))``, the 3x3 conv in int8 with ``int8``. Static
    int8 without a mesh: K1 writes the conv's int8 codes (one launch, no
    quantize pass)."""
    am = q8.static_absmax(conv) if int8 and mesh is None else None
    if am is not None:
        xq, s = gn.group_norm_silu_int8(x, (norm.weight, norm.bias), norm.num_groups, am)
        return q8.conv_codes(conv, xq, s, dtype)
    y = group_norm_silu(x, norm, mesh)
    return q8.conv(conv, y, dtype, padding=1) if int8 else conv3x3(conv, y, dtype, mesh)


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` (its own padding and groups, bias or none) on NHWC ``x`` in ``dtype``."""
    b = None if conv.bias is None else cast(conv, "bias", dtype)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), cast(conv, "weight", dtype), b, padding=conv.padding,
                 groups=conv.groups)
    return y.permute(0, 2, 3, 1)


def group_norm_nhwc(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """Plain GroupNorm of NHWC ``x`` with fp32 statistics, back in x's dtype
    (``clip_codec_tpu.ops.groupnorm.group_norm``)."""
    y = F.group_norm(x.float().permute(0, 3, 1, 2), norm.num_groups, norm.weight.float(), norm.bias.float(),
                     norm.eps)
    return y.permute(0, 2, 3, 1).to(x.dtype)


class DWConvBlock(nn.Module):
    """Depthwise-separable conv block, dw3x3 -> pw1x1 -> GN -> GELU (exact),
    both convs bias-free; NHWC in and out, computed in ``dtype``. Parameter
    names as the reference block: ``dw``, ``pw``, ``gn`` (gcd(cout, 8)
    groups)."""

    def __init__(self, cin: int, cout: int, max_groups: int = 8, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.dw = nn.Conv2d(cin, cin, 3, padding=1, groups=cin, bias=False)
        self.pw = nn.Conv2d(cin, cout, 1, bias=False)
        self.gn = nn.GroupNorm(math.gcd(cout, max_groups) or 1, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv_nhwc(self.pw, _conv_nhwc(self.dw, x, self.dtype), self.dtype)
        return F.gelu(group_norm_nhwc(self.gn, y))


class AttnBlock(nn.Module):
    """Pixels-as-queries attention over one key/value token derived from the
    conditioning vector ``h``, in its intended form (the reference block
    crashes on any call; the JAX block, ``clip_codec_tpu/models/blocks.py``,
    is the one ported): ``q`` a 1x1 conv of x, ``kv`` a linear of h split in
    two, softmax over the token axis, ``proj`` a 1x1 conv, residual add.
    With one token the softmax is 1; the general form is kept. NHWC."""

    def __init__(self, features: int, cond_dim: int, heads: int = 4, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.q = nn.Conv2d(features, features, 1)
        self.kv = nn.Linear(cond_dim, 2 * features)
        self.proj = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        d = C // self.heads
        q = _conv_nhwc(self.q, x, self.dtype).reshape(B, H * W, self.heads, d)
        k, v = linear(self.kv, h, self.dtype).chunk(2, dim=-1)
        k = k.reshape(B, -1, self.heads, d)
        v = v.reshape(B, -1, self.heads, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v).reshape(B, H, W, C)
        return x + _conv_nhwc(self.proj, out, self.dtype)
