"""Fused LN -> GEGLU -> out-projection — the port of ``clip_codec_tpu/ops/pallas_mlp.py``.

    transformer_mlp(x, lns, lnb, wh, bh, wg, bg, wo) -> y

over tokens ``x`` (..., C), with ``wh``, ``wg`` (C, F), ``wo`` (F, C) and fp32
``lns``, ``lnb`` (C,) and ``bh``, ``bg`` (F,). It returns the MLP value only:
the caller adds ``x + y + bo`` (``models/sd/layers.py``).

On a CUDA tensor the wrapper runs the two hand-written Hopper stages in
``csrc/transformer_mlp.cu`` (bf16; C in {320, 640, 1280}, SD-1.5's widths,
F a multiple of 64) or raises; on a CPU tensor it runs ``mlp_plain``, which
is also what the kernels are checked against on the card. The stages are
callable on their own, each with its plain piece
(``mlp_down_plain(mlp_up_plain(...)) == mlp_plain`` bit for bit):

    mlp_up(x, lns, lnb, wh, bh, wg, bg) -> h       LN, then GEGLU: (..., F) bf16
    mlp_down(h, wo) -> y                           the out-projection

The kernels read the weights in a TMA-ready layout: pass
``packed=pack_weights(wh, wg, wo)`` (the model caches it per load) or let
the wrapper pack them on each call. ``transformer_mlp`` is an autograd
Function whose backward differentiates ``mlp_plain`` (no kernel: JAX has
none either). ``transformer_mlp.launches`` counts fused calls on the card,
``mlp_up.launches`` and ``mlp_down.launches`` each stage's (calls recorded
into a CUDA graph are tallied as ``ops/attention.py``'s ``_count`` says).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .attention import _count

LN_EPS = 1e-6  # flax nn.LayerNorm's default, what BasicTransformerBlock uses
WIDTHS = (320, 640, 1280)  # the kernels' C: SD-1.5's transformer widths
ROWS = 128      # rows per tile of both products
UP_COLS = 64    # hidden columns per mlp_up tile (its packed tile: 64 of wh, then 64 of wg)
DOWN_COLS = 160  # output columns per mlp_down tile
DEPTH = 64      # depth per pipeline stage; F is split over mlp_down blocks in runs of these
_LIB = "transformer_mlp"

Packed = Tuple[torch.Tensor, torch.Tensor]  # (wup (2F, C), wdown (C, F))


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load(_LIB)
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.mlp_up_bf16.argtypes = [P] * 8 + [I] * 3 + [P]
        lib.mlp_up_bf16.restype = I
        lib.mlp_down_bf16.argtypes = [P] * 4 + [I] * 4 + [P]
        lib.mlp_down_bf16.restype = I
        lib._typed = True
    return lib


def gelu_erf(g: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU in g's dtype, ``g * 0.5 * (1 + erf(g / sqrt(2)))``."""
    return g * 0.5 * (1.0 + torch.erf(g * (1.0 / math.sqrt(2.0))))


def mlp_up_plain(x: torch.Tensor, lns: torch.Tensor, lnb: torch.Tensor, wh: torch.Tensor,
                 bh: torch.Tensor, wg: torch.Tensor, bg: torch.Tensor) -> torch.Tensor:
    """The hidden ``h`` in x's dtype: LayerNorm statistics in fp32 (raw
    ``E[x^2] - mu^2`` variance, eps 1e-6), xn rounded to x's dtype; ``a`` and
    ``g`` accumulate in fp32, take their fp32 bias and are each rounded; the
    exact-erf GELU gate runs in fp32 and h is rounded."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
    xn = ((xf - mu) * torch.rsqrt(var + LN_EPS) * lns.float() + lnb.float()).to(dt).float()
    a = (xn @ wh.to(dt).float() + bh.float()).to(dt).float()
    g = (xn @ wg.to(dt).float() + bg.float()).to(dt).float()
    return (a * gelu_erf(g)).to(dt)


def mlp_down_plain(h: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``h . wo`` accumulated in fp32, rounded to h's dtype."""
    return (h.float() @ wo.to(h.dtype).float()).to(h.dtype)


def mlp_plain(x: torch.Tensor, lns: torch.Tensor, lnb: torch.Tensor, wh: torch.Tensor,
              bh: torch.Tensor, wg: torch.Tensor, bg: torch.Tensor, wo: torch.Tensor
              ) -> torch.Tensor:
    """The math of the jnp ``mlp_reference`` in the kernels' rounding order
    (``mlp_up_plain``, then ``mlp_down_plain``)."""
    return mlp_down_plain(mlp_up_plain(x, lns, lnb, wh, bh, wg, bg), wo)


def pack_weights(wh: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> Packed:
    """The kernels' weight layout, in ``dtype``, from wh and wg (C, F) and wo
    (F, C): ``wup`` (2F, C), K-major, whose rows ``128 t .. 128 t + 63`` are
    wh's columns ``64 t .. 64 t + 63`` and rows ``128 t + 64 .. 128 t + 127``
    the same columns of wg (one mlp_up tile: a and g of 64 hidden columns);
    ``wdown`` (C, F), K-major: wo transposed."""
    return _pack_up(wh, wg, dtype), _pack_down(wo, dtype)


def _pack_up(wh: torch.Tensor, wg: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    C, F = wh.shape
    if F % UP_COLS:
        raise ValueError(f"packed weights need F % {UP_COLS} == 0, got F={F}")
    cols = lambda w: w.detach().to(dtype).t().reshape(F // UP_COLS, UP_COLS, C)
    return torch.stack([cols(wh), cols(wg)], dim=1).reshape(2 * F, C).contiguous()


def _pack_down(wo: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return wo.detach().to(dtype).t().contiguous()


def down_splits(R: int, C: int, F: int, sms: int) -> int:
    """How many blocks share the depth F of one mlp_down tile (1: no fp32
    partials). Split only where the ceil(R / 128) x C / 160 tiles would leave
    at least half of the ``sms`` SMs without a block; then as many as one
    wave holds, over runs of whole 64-deep stages with none empty."""
    tiles = -(-R // ROWS) * (C // DOWN_COLS)
    depth = F // DEPTH
    if tiles * 2 > sms or depth < 2:
        return 1
    per = -(-depth // min(depth, sms // tiles))
    return -(-depth // per)


def kernel_splits(R: int, C: int, F: int, device: torch.device) -> int:
    """``down_splits`` at (R, C, F) on ``device``'s SM count."""
    return down_splits(R, C, F, torch.cuda.get_device_properties(device).multi_processor_count)


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _supported(x: torch.Tensor, C: int, F: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"transformer MLP kernel needs a CUDA or CPU tensor, got {x.device}")
    if C not in WIDTHS or F <= 0 or F % UP_COLS:
        raise ValueError(f"the kernels need C in {WIDTHS} and F % {UP_COLS} == 0, got C={C}, F={F}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: error {rc}")


def _launch_up(x, lns, lnb, bh, bg, wup) -> torch.Tensor:
    C, F = x.shape[-1], bh.shape[0]
    _supported(x, C, F)
    R, dev = x.numel() // C, x.device
    _check("x", x, x.shape, torch.bfloat16, dev)
    _check("lns", lns, (C,), torch.float32, dev)
    _check("lnb", lnb, (C,), torch.float32, dev)
    _check("bh", bh, (F,), torch.float32, dev)
    _check("bg", bg, (F,), torch.float32, dev)
    _check("packed wup", wup, (2 * F, C), torch.bfloat16, dev)
    xn = torch.empty_like(x)
    h = torch.empty((*x.shape[:-1], F), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _kernel_lib().mlp_up_bf16(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), wup.data_ptr(), bh.data_ptr(), bg.data_ptr(),
            xn.data_ptr(), h.data_ptr(), R, C, F, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mlp_up")
    return h


def _launch_down(h, wdown, splits: Optional[int] = None) -> torch.Tensor:
    """``splits`` overrides ``down_splits`` (a count with no empty split, to
    time the alternatives)."""
    C, F = wdown.shape[0], h.shape[-1]
    _supported(h, C, F)
    R, dev = h.numel() // F, h.device
    _check("h", h, h.shape, torch.bfloat16, dev)
    _check("packed wdown", wdown, (C, F), torch.bfloat16, dev)
    if splits is None:
        splits = kernel_splits(R, C, F, dev)
    y = torch.empty((*h.shape[:-1], C), dtype=h.dtype, device=dev)
    part = torch.empty((splits, R, C), dtype=torch.float32, device=dev) if splits > 1 else None
    with torch.cuda.device(dev):
        rc = _kernel_lib().mlp_down_bf16(
            h.data_ptr(), wdown.data_ptr(), y.data_ptr(), None if part is None else part.data_ptr(),
            R, C, F, splits, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mlp_down")
    return y


def mlp_up(x: torch.Tensor, lns: torch.Tensor, lnb: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
           wg: torch.Tensor, bg: torch.Tensor, packed: Optional[Packed] = None) -> torch.Tensor:
    """The first stage, ``h`` (..., F): ``mlp_up_plain`` on a CPU tensor; on
    CUDA the LayerNorm pre-pass and the GEGLU product (``packed[0]``, or the
    weights packed on the call), or it raises."""
    if x.device.type == "cpu":
        return mlp_up_plain(x, lns, lnb, wh, bh, wg, bg)
    wup = _pack_up(wh, wg, x.dtype) if packed is None else packed[0]
    h = _launch_up(x, lns, lnb, bh, bg, wup)
    _count(mlp_up)
    return h


def mlp_down(h: torch.Tensor, wo: torch.Tensor, packed: Optional[Packed] = None,
             splits: Optional[int] = None) -> torch.Tensor:
    """The second stage, ``h . wo`` (..., C): ``mlp_down_plain`` on a CPU
    tensor; on CUDA the out-projection kernel (``packed[1]``, or wo
    transposed on the call), or it raises."""
    if h.device.type == "cpu":
        return mlp_down_plain(h, wo)
    wdown = _pack_down(wo, h.dtype) if packed is None else packed[1]
    y = _launch_down(h, wdown, splits)
    _count(mlp_down)
    return y


class _TransformerMLP(torch.autograd.Function):
    """Forward: the two stages (the plain version on the CPU). Backward:
    autograd of ``mlp_plain`` recomputed from the saved inputs, the JAX
    contract (``pallas_mlp.py`` ``_mlp_vjp_bwd``, the VJP of
    ``mlp_reference``); JAX has no backward kernel here."""

    @staticmethod
    def forward(ctx, x, lns, lnb, wh, bh, wg, bg, wo, packed):
        ctx.save_for_backward(x, lns, lnb, wh, bh, wg, bg, wo)
        if x.device.type == "cpu":
            return mlp_plain(x, lns, lnb, wh, bh, wg, bg, wo)
        if packed is None:
            packed = pack_weights(wh, wg, wo, x.dtype)
        y = mlp_down(mlp_up(x, lns, lnb, wh, bh, wg, bg, packed), wo, packed)
        _count(transformer_mlp)
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
    tensor argument (``packed`` is only the kernels' copy of the weights)."""
    return _TransformerMLP.apply(x, lns, lnb, wh, bh, wg, bg, wo, packed)


transformer_mlp.launches = 0
mlp_up.launches = 0
mlp_down.launches = 0
