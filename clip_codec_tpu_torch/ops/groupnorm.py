"""GroupNorm, and fused GroupNorm+SiLU over NHWC (port of
``clip_codec_tpu/ops/groupnorm.py`` and of K1, ``ops/pallas_groupnorm.py``).

* ``group_norm``: plain GroupNorm with fp32 statistics. The SD blocks
  (``models/sd/layers.py`` ``group_norm32``) and the pixel U-Net's head in
  its direct form call it.
* ``group_norm_silu(x, (scale, bias), groups, eps)``: the JAX fusion point,
  which the direct-form pixel ResBlock calls twice (``models/blocks.py``).
  On a CUDA tensor it launches K1, the hand-written Hopper kernel pair in
  ``csrc/groupnorm_silu.cu``, or raises; on a CPU tensor it runs
  ``group_norm_silu_plain``. Its backward is autograd of
  ``group_norm_silu_plain`` recomputed from the saved inputs, the JAX
  contract (``pallas_groupnorm.py`` ``_bwd``): the TPU kernel has no
  backward kernel, and neither has the port.

K1's two kernels have a wrapper each, ``group_norm_silu_stats`` (per-chunk
fp32 sums and sums of squares, ``(B, K, 2, C)``) and ``group_norm_silu_norm``
(group statistics from those partials, then the affine and SiLU), each
counting its launches in ``.launches``, and a plain version each with the
kernel's arithmetic (raw moments ``var = SS/n - mean^2``, one rounding to x's
dtype). ``group_norm_silu_plain`` is JAX's jnp ``group_norm_silu`` instead:
two-pass statistics, the normalised value rounded to x's dtype before the
SiLU. In bf16 the kernel and it differ by an ulp or two.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F

GN_EPS = 1e-5
_LIB = "groupnorm_silu"
_VEC, _MAX_C = 8, 2048  # channels per thread; one vector per thread of a 256-thread block
_TARGET_BLOCKS = 528  # 4 blocks on each of the H100's 132 SMs


def group_norm(x: torch.Tensor, scale_bias: Tuple[torch.Tensor, torch.Tensor],
               groups: int, eps: float = GN_EPS) -> torch.Tensor:
    """Per-sample, per-group normalisation over (H, W, C/groups) of NHWC
    ``x``; statistics in fp32 (fp64 stays fp64), result in x's dtype."""
    scale, bias = scale_bias
    B, H, W, C = x.shape
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    xg = x32.reshape(B, H, W, groups, C // groups)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def group_norm_silu_plain(x: torch.Tensor, scale_bias: Tuple[torch.Tensor, torch.Tensor],
                          groups: int, eps: float = GN_EPS) -> torch.Tensor:
    """JAX's jnp ``group_norm_silu``: ``y * sigmoid(y in fp32)`` with
    ``y = group_norm(x)`` in x's dtype, the sigmoid rounded to it."""
    y = group_norm(x, scale_bias, groups, eps)
    return y * torch.sigmoid(y.to(torch.promote_types(y.dtype, torch.float32))).to(y.dtype)


def n_chunks(B: int, HW: int) -> int:
    """Row chunks per sample for K1 (the grid is (chunks, B)): enough blocks
    to fill the card, but no more than ~sqrt(HW/8), since every norm block
    re-reads all its sample's ``chunks x 2 x C`` partials. A function of the
    shape alone, so the statistics are the same in every run."""
    return max(1, min(-(-_TARGET_BLOCKS // B), math.isqrt(HW // 8)))


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load(_LIB)
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.groupnorm_silu_stats.argtypes = [P, P, I, I, I, I, I, P]
        lib.groupnorm_silu_stats.restype = I
        lib.groupnorm_silu_norm.argtypes = [P] * 5 + [I] * 5 + [ctypes.c_float, I, P]
        lib.groupnorm_silu_norm.restype = I
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_x(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"GroupNorm+SiLU kernel needs a CUDA or CPU tensor, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes x as torch.bfloat16 or torch.float32, got {x.dtype}")
    C = x.shape[3]
    if C % _VEC or C > _MAX_C:
        raise ValueError(f"the kernel needs C % {_VEC} == 0 and C <= {_MAX_C}, got C={C}")
    _check("x", x, x.shape, x.dtype, x.device)


def _check_args(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int) -> None:
    _check_x(x)
    C = x.shape[3]
    if groups <= 0 or C % groups:
        raise ValueError(f"C={C} is not a multiple of groups={groups}")
    _check("scale", scale, (C,), torch.float32, x.device)
    _check("bias", bias, (C,), torch.float32, x.device)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def group_norm_silu_stats_plain(x: torch.Tensor, chunks: int) -> torch.Tensor:
    """The stats kernel's result: (B, chunks, 2, C) fp32 sums and sums of
    squares over each chunk of ceil(H*W / chunks) pixels (the last ragged)."""
    B, H, W, C = x.shape
    hw = H * W
    chunk = -(-hw // chunks)
    xf = F.pad(x.to(torch.promote_types(x.dtype, torch.float32)).reshape(B, hw, C),
               (0, 0, 0, chunk * chunks - hw))
    xc = xf.reshape(B, chunks, chunk, C)
    return torch.stack([xc.sum(dim=2), xc.square().sum(dim=2)], dim=2)


def group_norm_silu_stats(x: torch.Tensor) -> torch.Tensor:
    """Per-chunk statistics of NHWC ``x`` (the stats kernel on CUDA)."""
    B, H, W, C = x.shape
    chunks = n_chunks(B, H * W)
    if x.device.type == "cpu":
        return group_norm_silu_stats_plain(x, chunks)
    _check_x(x)
    part = torch.empty((B, chunks, 2, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernel_lib().groupnorm_silu_stats(x.data_ptr(), part.data_ptr(), B, H * W, C, chunks,
                                                int(x.dtype == torch.bfloat16), _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"groupnorm_silu stats kernel launch failed: CUDA error {rc}")
    group_norm_silu_stats.launches += 1
    return part


def group_norm_silu_norm_plain(x: torch.Tensor, part: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                               groups: int, eps: float = GN_EPS) -> torch.Tensor:
    """The norm kernel's result: group statistics from the partials in raw
    moments, then ``silu((x - mean) * rstd * scale + bias)`` in fp32, stored
    once in x's dtype."""
    B, H, W, C = x.shape
    cg = C // groups
    tot = part.sum(dim=1).reshape(B, 2, groups, cg).sum(dim=3)  # (B, 2, G)
    n = float(H * W * cg)
    mean = tot[:, 0] / n
    rstd = torch.rsqrt(tot[:, 1] / n - mean * mean + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)[:, None, None, :]
    rstd_c = rstd.repeat_interleave(cg, dim=1)[:, None, None, :]
    t = (x.to(part.dtype) - mean_c) * rstd_c * scale.to(part.dtype) + bias.to(part.dtype)
    return (t * torch.sigmoid(t)).to(x.dtype)


def group_norm_silu_norm(x: torch.Tensor, part: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         groups: int, eps: float = GN_EPS) -> torch.Tensor:
    """``silu(GroupNorm(x))`` from the stats kernel's partials (the norm
    kernel on CUDA); scale and bias are fp32 (C,)."""
    if x.device.type == "cpu":
        return group_norm_silu_norm_plain(x, part, scale, bias, groups, eps)
    _check_args(x, scale, bias, groups)
    B, H, W, C = x.shape
    dev = x.device
    _check("part", part, (B, n_chunks(B, H * W), 2, C), torch.float32, dev)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = _kernel_lib().groupnorm_silu_norm(
            x.data_ptr(), part.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            B, H * W, C, groups, part.shape[1], eps, int(x.dtype == torch.bfloat16), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"groupnorm_silu norm kernel launch failed: CUDA error {rc}")
    group_norm_silu_norm.launches += 1
    return y


group_norm_silu_stats.launches = 0
group_norm_silu_norm.launches = 0


class _GroupNormSiLU(torch.autograd.Function):
    """Forward: K1's two kernels. Backward: autograd of
    ``group_norm_silu_plain`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.groups, ctx.eps = groups, eps
        return group_norm_silu_norm(x, group_norm_silu_stats(x), scale, bias, groups, eps)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            x, scale, bias = (t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need))
            y = group_norm_silu_plain(x, (scale, bias), ctx.groups, ctx.eps)
            got = iter(torch.autograd.grad(y, [a for a, n in zip((x, scale, bias), need) if n], g))
        return (*(next(got) if n else None for n in need), None, None)


def group_norm_silu(x: torch.Tensor, scale_bias: Tuple[torch.Tensor, torch.Tensor],
                    groups: int, eps: float = GN_EPS) -> torch.Tensor:
    """Fused GroupNorm + SiLU of NHWC ``x``: K1 on a CUDA tensor (or raise),
    the plain version on a CPU tensor; differentiable in x, scale and bias."""
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, scale_bias, groups, eps)
    _check_args(x, scale_bias[0], scale_bias[1], groups)  # before the stats kernel launches
    return _GroupNormSiLU.apply(x, scale_bias[0], scale_bias[1], groups, eps)
