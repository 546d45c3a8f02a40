"""Fused LN -> GEGLU -> out-projection — the port of ``clip_codec_tpu/ops/pallas_mlp.py``.

    transformer_mlp(x, lns, lnb, wh, bh, wg, bg, wo) -> y

over tokens ``x`` (..., C), with ``wh``, ``wg`` (C, F), ``wo`` (F, C) and fp32
``lns``, ``lnb`` (C,) and ``bh``, ``bg`` (F,). It returns the MLP value only:
the caller adds ``x + y + bo`` (``models/sd/layers.py``).

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/transformer_mlp.cu`` (bf16; C in {320, 640, 1280}, SD-1.5's
widths, F a multiple of 160) or raises; on a CPU tensor it runs
``mlp_plain``, which is also what the kernel is checked against on the
card. The kernel reads its weights
pre-packed in mma fragment order: pass ``packed=pack_weights(wh, wg, wo)``
(the model caches it per load) or let the wrapper pack them on each call.
The wrapper is an autograd Function whose backward differentiates
``mlp_plain`` (no kernel: JAX has none either).
``transformer_mlp.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

LN_EPS = 1e-6  # flax nn.LayerNorm's default, what BasicTransformerBlock uses
_LIB = "transformer_mlp"

Packed = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load(_LIB)
    if not getattr(lib, "_typed", False):
        P = ctypes.c_void_p
        lib.transformer_mlp_bf16.argtypes = [P] * 10 + [ctypes.c_int] * 4 + [P]
        lib.transformer_mlp_bf16.restype = ctypes.c_int
        lib.transformer_mlp_splits.argtypes = [ctypes.c_int] * 4
        lib.transformer_mlp_splits.restype = ctypes.c_int
        lib._typed = True
    return lib


def gelu_erf(g: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU in g's dtype, ``g * 0.5 * (1 + erf(g / sqrt(2)))``."""
    return g * 0.5 * (1.0 + torch.erf(g * (1.0 / math.sqrt(2.0))))


def mlp_plain(x: torch.Tensor, lns: torch.Tensor, lnb: torch.Tensor, wh: torch.Tensor,
              bh: torch.Tensor, wg: torch.Tensor, bg: torch.Tensor, wo: torch.Tensor
              ) -> torch.Tensor:
    """The math of the jnp ``mlp_reference`` in the kernel's rounding order:
    LayerNorm statistics in fp32 (raw ``E[x^2] - mu^2`` variance, eps 1e-6),
    xn rounded to x's dtype; ``a`` and ``g`` accumulate in fp32, take their
    fp32 bias and are each rounded to x's dtype; the exact-erf GELU gate runs
    in fp32 and h is rounded; ``h . wo`` accumulates in fp32."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
    xn = ((xf - mu) * torch.rsqrt(var + LN_EPS) * lns.float() + lnb.float()).to(dt).float()
    a = (xn @ wh.to(dt).float() + bh.float()).to(dt).float()
    g = (xn @ wg.to(dt).float() + bg.float()).to(dt).float()
    h = (a * gelu_erf(g)).to(dt).float()
    return (h @ wo.to(dt).float()).to(dt)


def _pack(w: torch.Tensor) -> torch.Tensor:
    """(K, N) -> (N/16, K/16, 32, 8): lane ``4g + t`` of the (k-tile, n-pair)
    holds its m16n8k16 B fragments of both n-tiles, 16 contiguous bytes."""
    K, N = w.shape
    if K % 16 or N % 16:
        raise ValueError(f"packed weights need both dims % 16 == 0, got {tuple(w.shape)}")
    return (w.reshape(K // 16, 2, 4, 2, N // 16, 2, 8)
            .permute(4, 0, 6, 2, 5, 1, 3).reshape(N // 16, K // 16, 32, 8).contiguous())


def pack_weights(wh: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> Packed:
    """The kernel's weight layout, in ``dtype``: wh and wg (C, F), wo (F, C)."""
    return tuple(_pack(w.detach().to(dtype)) for w in (wh, wg, wo))


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def kernel_splits(R: int, C: int, F: int, device: torch.device) -> int:
    """How many blocks the kernel gives the hidden chunks of one row tile at
    (R, C, F) on ``device`` (1: no fp32 partials; 0: shape not supported)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _kernel_lib().transformer_mlp_splits(R, C, F, sms)


def _launch(x, lns, lnb, bh, bg, packed: Packed, splits: Optional[int] = None) -> torch.Tensor:
    """Checks and launches; ``splits`` overrides the kernel's own choice (a
    positive count, used to time the alternatives)."""
    if x.device.type != "cuda":
        raise ValueError(f"transformer MLP kernel needs a CUDA or CPU tensor, got {x.device}")
    C = x.shape[-1]
    R = x.numel() // C if C else 0
    F = bh.shape[0]
    dev = x.device
    _check("x", x, x.shape, torch.bfloat16, dev)
    _check("lns", lns, (C,), torch.float32, dev)
    _check("lnb", lnb, (C,), torch.float32, dev)
    _check("bh", bh, (F,), torch.float32, dev)
    _check("bg", bg, (F,), torch.float32, dev)
    whp, wgp, wop = packed
    _check("packed wh", whp, (F // 16, C // 16, 32, 8), torch.bfloat16, dev)
    _check("packed wg", wgp, (F // 16, C // 16, 32, 8), torch.bfloat16, dev)
    _check("packed wo", wop, (C // 16, F // 16, 32, 8), torch.bfloat16, dev)
    lib = _kernel_lib()
    if kernel_splits(R, C, F, dev) == 0:
        raise ValueError(f"the kernel needs C in (320, 640, 1280) and F % 160 == 0, "
                         f"got R={R}, C={C}, F={F}")
    if splits is None:
        splits = kernel_splits(R, C, F, dev)
    y = torch.empty_like(x)
    part = torch.empty((splits, R, C), dtype=torch.float32, device=dev) if splits > 1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.transformer_mlp_bf16(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), whp.data_ptr(), bh.data_ptr(),
            wgp.data_ptr(), bg.data_ptr(), wop.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(), R, C, F, splits, stream)
    if rc != 0:
        raise RuntimeError(f"transformer_mlp kernel launch failed: CUDA error {rc}")
    return y


class _TransformerMLP(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU). Backward: autograd
    of ``mlp_plain`` recomputed from the saved inputs, the JAX contract
    (``pallas_mlp.py`` ``_mlp_vjp_bwd``, the VJP of ``mlp_reference``); JAX
    has no backward kernel here."""

    @staticmethod
    def forward(ctx, x, lns, lnb, wh, bh, wg, bg, wo, packed):
        ctx.save_for_backward(x, lns, lnb, wh, bh, wg, bg, wo)
        if x.device.type == "cpu":
            return mlp_plain(x, lns, lnb, wh, bh, wg, bg, wo)
        if packed is None:
            packed = pack_weights(wh, wg, wo, x.dtype)
        y = _launch(x, lns, lnb, bh, bg, packed)
        transformer_mlp.launches += 1
        return y

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:8]
        with torch.enable_grad():
            args = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            y = mlp_plain(*args)
            wanted = [a for a, n in zip(args, need) if n]
            got = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(got) if n else None for n in need), None)


def transformer_mlp(x: torch.Tensor, lns: torch.Tensor, lnb: torch.Tensor, wh: torch.Tensor,
                    bh: torch.Tensor, wg: torch.Tensor, bg: torch.Tensor, wo: torch.Tensor,
                    packed: Optional[Packed] = None) -> torch.Tensor:
    """``(LN(x) wh + bh) * gelu_erf(LN(x) wg + bg) . wo`` over (..., C) tokens,
    without the residual or the out-projection bias; differentiable in every
    tensor argument (``packed`` is only the kernel's copy of the weights)."""
    return _TransformerMLP.apply(x, lns, lnb, wh, bh, wg, bg, wo, packed)


transformer_mlp.launches = 0
