"""GroupNorm, and fused GroupNorm+SiLU over NHWC (port of
``clip_codec_tpu/ops/groupnorm.py`` and of K1, ``ops/pallas_groupnorm.py``).

* ``group_norm``: plain GroupNorm with fp32 statistics. The SD blocks
  (``models/sd/layers.py`` ``group_norm32``) and the pixel U-Net's head in
  its direct form call it.
* ``group_norm_silu(x, (scale, bias), groups, eps)``: the JAX fusion point,
  which the direct-form pixel ResBlock calls twice (``models/blocks.py``).
  On a CUDA tensor it launches K1, the hand-written Hopper kernel in
  ``csrc/groupnorm_silu.cu`` (one persistent cooperative launch that reads x
  from device memory once), or raises; on a CPU tensor it runs
  ``group_norm_silu_plain``. Its backward is autograd of
  ``group_norm_silu_plain`` recomputed from the saved inputs, the JAX
  contract (``pallas_groupnorm.py`` ``_bwd``): the TPU kernel has no
  backward kernel, and neither has the port.

The kernel cuts each sample's H*W rows into slabs (``slab_cut``: a function
of the shape alone), plans its rounds and grid itself (``plan``), sums each
slab per group in fp32, and normalises from the slab partials summed in a
fixed order. Its plain version is the pair
``group_norm_silu_stats_plain`` (the (B, S, 2, G) slab partials: channel
sums, then group sums) and ``group_norm_silu_norm_plain`` (raw moments
``var = SS/n - mean^2`` from the partials, the affine and SiLU in fp32, one
rounding to x's dtype). ``group_norm_silu_plain`` is JAX's jnp
``group_norm_silu`` instead: two-pass statistics, the normalised value
rounded to x's dtype before the SiLU. In bf16 the kernel and it differ by
an ulp or two. ``group_norm_silu.launches`` counts K1's launches (a call
recorded into a CUDA graph is tallied as ``ops/attention.py``'s ``_count``
says: the int8 serving artifacts replay K1).

``group_norm_silu_int8(x, (scale, bias), groups, absmax, eps)`` -> ``(xq,
s)`` is K1 for the pixel U-Net's static int8 path, where its output only
feeds an int8 conv: the int8 codes of ``group_norm_silu``'s result against
the layer's calibrated 0-d fp32 ``absmax`` (``ops.int8.quantize``'s codes
and scale), written by K1 itself in place of y (the kernel's codes-out
entry, ``groupnorm_silu_int8``: one launch, 1 byte an element out, no
bf16 round trip), counted on ``group_norm_silu_int8.launches``; on a CPU
tensor ``group_norm_silu`` then ``quantize_plain``, the CPU path's two
steps. Its plain version ``group_norm_silu_int8_plain`` is K1's plain
version then ``quantize_plain``. Serving only: no gradient.

The split form, for a caller that combines the statistics of several
tensors between the two halves (the U-Net whose height is split over the
ranks of a mesh's model axis merges its moments over them,
``group_norm_silu_spatial``), is the JAX original's own two steps:

* ``group_norm_silu_stats(x, groups, shift=None)``: the (B, S, 2, G) fp32
  slab partials of ``x - shift`` (shift (B, G) fp32, per sample and
  group), the one launch's without a shift for the same slab cut (its plain
  version ``group_norm_silu_stats_plain``);
* ``group_norm_silu_apply(x, tot, n, (scale, bias), groups, eps, shift)``:
  the normalisation, affine and SiLU from (B, 2, G) fp32 totals of ``x -
  shift`` over ``n`` elements a group, mean ``shift + S / n`` (its plain
  version ``group_norm_silu_norm_plain``).

The shift is the shifted-data form of the variance: the raw-moment
difference ``SS / n - mean^2`` cancels in fp32 where a group's mean is
large against its spread (a pixel U-Net's activations after a conv and
FiLM are), and the sums of ``x - shift`` for a shift near the data do
not. The spatial U-Net shifts each rank's statistics by one element of each
group, and normalises about the merged mean with totals ``(0, M2)``.

On a CUDA tensor each launches its kernel of ``csrc/groupnorm_silu.cu`` (an
ordinary launch, one block a slab) or raises, counted on its own
``.launches``; on a CPU tensor each runs its plain version.

``group_norm_silu_spatial(x, (scale, bias), groups, mesh, eps)`` is
GroupNorm+SiLU of one rank's rows of an image whose height is split over
``mesh``'s model axis, differentiable: forward, the statistics kernel, the
moments merged over the axis (``parallel.mesh.merge_moments_model``), the
normalisation kernel (the plain pair on a CPU tensor); backward, autograd
of the plain pair recomputed from the saved inputs with the differentiable
merge between them (one all-gather and its backward's all-reduce over the
axis), as the one-launch K1's backward is autograd of its plain version.
No kernel launches in the backward.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .attention import _count
from .int8 import quantize_plain

GN_EPS = 1e-5
_LIB = "groupnorm_silu"
# csrc/groupnorm_silu.cu's argument checks: channels per thread, most
# channels, a chunk's most bytes, most chunks a slab
_VEC, _MAX_C, _CHUNK_BYTES, _MAX_CHUNKS = 8, 2048, 32768, 4
_SLABS_A_SAMPLE = 128  # a sample of more chunks than this gets slabs of several chunks


def slab_cut(hw: int, C: int, itemsize: int) -> Tuple[int, int]:
    """Rows a chunk and chunks a slab for samples of ``hw`` rows of ``C``
    channels: chunks of as many rows as 32 KB holds (at most the sample's),
    one a slab, or up to 4 where a sample has more than 128 chunks (fewer
    partials for every block to read after the barrier). A function of the
    shape alone, so the statistics are the same on every card and in every
    run; the kernel takes it from here, and plans its rounds, grid and ring
    buffers itself (``plan``)."""
    rows = max(1, min(hw, _CHUNK_BYTES // (C * itemsize)))
    return rows, min(_MAX_CHUNKS, max(1, -(-hw // rows) // _SLABS_A_SAMPLE))


def slab_rows(hw: int, C: int, itemsize: int) -> int:
    """Rows per slab (the last of a sample ragged): the unit of the
    statistics."""
    rows, chunks = slab_cut(hw, C, itemsize)
    return rows * chunks


class Plan(NamedTuple):
    """K1's launch for a (B, H, W, C) call: ``slab_rows`` rows a slab,
    ``slabs`` a sample, each ``chunks`` chunks of ``chunk_rows`` rows (the
    unit of a copy and of a buffer); ``per_round`` whole samples a round
    over ``rounds`` rounds, ``grid`` blocks, each with a ring of ``ring``
    chunk buffers in ``smem`` bytes of shared memory."""
    slab_rows: int
    slabs: int
    chunk_rows: int
    chunks: int
    ring: int
    per_round: int
    rounds: int
    grid: int
    smem: int


def plan(B: int, H: int, W: int, C: int, groups: int, itemsize: int, sms: int = 0) -> Plan:
    """The kernel's own plan for a call on ``sms`` SMs of the current
    device (0: all of them), from ``csrc/groupnorm_silu.cu`` (builds it at
    the first call; needs a card). Raises for a shape the kernel does not
    take."""
    hw = H * W
    rows, chunks = slab_cut(hw, C, itemsize)
    out = (ctypes.c_int * 5)()
    rc = _kernel_lib().groupnorm_silu_plan(B, hw, C, groups, rows, chunks, int(itemsize == 2), sms, out)
    if rc != 0:
        raise RuntimeError(f"groupnorm_silu_plan{(B, H, W, C, groups, itemsize, sms)} failed: CUDA error {rc}")
    return Plan(rows * chunks, -(-hw // (rows * chunks)), rows, chunks, *out)


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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's arguments on a loaded library."""
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.groupnorm_silu.argtypes = [P] * 6 + [I] * 7 + [ctypes.c_float, I, P]
        lib.groupnorm_silu.restype = I
        lib.groupnorm_silu_plan.argtypes = [I] * 8 + [P]
        lib.groupnorm_silu_plan.restype = I
        lib.groupnorm_silu_stats.argtypes = [P] * 3 + [I] * 7 + [P]
        lib.groupnorm_silu_stats.restype = I
        lib.groupnorm_silu_apply.argtypes = [P] * 6 + [I] * 6 + [ctypes.c_float] * 2 + [I, P]
        lib.groupnorm_silu_apply.restype = I
        lib.groupnorm_silu_int8.argtypes = [P] * 8 + [I] * 7 + [ctypes.c_float, I, P]
        lib.groupnorm_silu_int8.restype = I
        lib._typed = True
    return lib


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    return bind(_build.load(_LIB))


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_args(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int) -> None:
    _check_x(x, groups)
    _check("scale", scale, (x.shape[3],), torch.float32, x.device)
    _check("bias", bias, (x.shape[3],), torch.float32, x.device)


def _check_x(x: torch.Tensor, groups: int) -> None:
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
    if groups <= 0 or C % groups:
        raise ValueError(f"C={C} is not a multiple of groups={groups}")


def group_norm_silu_stats_plain(x: torch.Tensor, groups: int, shift: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """The kernel's slab partials, (B, S, 2, G) fp32: over each slab of
    ``slab_rows`` pixels (the last of a sample ragged) every channel's sum
    and sum of squares of ``x - shift`` (shift (B, G), per sample and
    group; none: x itself), then each group's sums of its channels in
    order."""
    B, H, W, C = x.shape
    hw = H * W
    rows = slab_rows(hw, C, x.element_size())
    S = -(-hw // rows)
    xf = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(B, hw, C)
    if shift is not None:
        xf = xf - shift.to(xf.dtype).repeat_interleave(C // groups, dim=1)[:, None, :]
    xs = F.pad(xf, (0, 0, 0, rows * S - hw)).reshape(B, S, rows, C)
    part = torch.stack([xs.sum(dim=2), xs.square().sum(dim=2)], dim=2)
    return part.reshape(B, S, 2, groups, C // groups).sum(dim=4)


def group_norm_silu_norm_plain(x: torch.Tensor, part: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                               groups: int, eps: float = GN_EPS, n: Optional[float] = None,
                               shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's result from its slab partials (B, S, 2, G), summed over
    the slabs in a fixed order, or from totals (B, 2, G) over ``n``
    elements a group (default: x's own, H * W * C / G), of ``x - shift``
    (shift (B, G); none: x itself): group statistics in raw moments of the
    shifted data, mean ``shift + S / n``, then ``silu((x - mean) * rstd *
    scale + bias)`` in fp32, stored once in x's dtype."""
    B, H, W, C = x.shape
    cg = C // groups
    tot = part.sum(dim=1) if part.dim() == 4 else part  # (B, 2, G)
    n = float(H * W * cg) if n is None else float(n)
    m = tot[:, 0] / n
    rstd = torch.rsqrt(tot[:, 1] / n - m * m + eps)
    mean = m if shift is None else shift.to(m.dtype) + m
    mean_c = mean.repeat_interleave(cg, dim=1)[:, None, None, :]
    rstd_c = rstd.repeat_interleave(cg, dim=1)[:, None, None, :]
    t = (x.to(part.dtype) - mean_c) * rstd_c * scale.to(part.dtype) + bias.to(part.dtype)
    return (t * torch.sigmoid(t)).to(x.dtype)


_barriers: Dict[int, torch.Tensor] = {}


def _barrier(dev: torch.device) -> torch.Tensor:
    """The grid barrier's words on ``dev`` (two arrival counts and a
    sense): zeroed at the first call on the device, then reset by every
    launch itself (no memset per call, so a replayed CUDA graph stays
    right)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    bar = _barriers.get(idx)
    if bar is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("group_norm_silu: call it once on this device before capturing a CUDA graph "
                               "(its grid barrier's state is allocated at the first call)")
        bar = _barriers[idx] = torch.zeros(4, dtype=torch.int32, device=dev)
    return bar


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
            sms: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K1 on checked arguments, on ``sms`` SMs (0: all of
    the device's); returns y and the (B, S, 2, G) slab partials."""
    B, H, W, C = x.shape
    dev = x.device
    rows, chunks = slab_cut(H * W, C, x.element_size())
    part = torch.empty((B, -(-H * W // (rows * chunks)), 2, groups), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = _kernel_lib().groupnorm_silu(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), part.data_ptr(), _barrier(dev).data_ptr(),
            B, H * W, C, groups, rows, chunks, sms, eps, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"groupnorm_silu kernel launch failed: CUDA error {rc}")
    _count(group_norm_silu)
    return y, part


class _GroupNormSiLU(torch.autograd.Function):
    """Forward: K1 (its plain version on a CPU tensor). Backward: autograd of
    ``group_norm_silu_plain`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.groups, ctx.eps = groups, eps
        if x.device.type == "cpu":  # the kernel's plain version
            return group_norm_silu_norm_plain(x, group_norm_silu_stats_plain(x, groups), scale, bias, groups, eps)
        return _launch(x, scale, bias, groups, eps)[0]

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
    _check_args(x, scale_bias[0], scale_bias[1], groups)
    return _GroupNormSiLU.apply(x, scale_bias[0], scale_bias[1], groups, eps)


group_norm_silu.launches = 0


def group_norm_silu_int8_plain(x: torch.Tensor, scale_bias: Tuple[torch.Tensor, torch.Tensor], groups: int,
                               absmax: torch.Tensor, eps: float = GN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """The codes-out kernel's function in torch: K1's plain version (y in
    x's dtype), then ``quantize_plain`` of y against ``absmax``."""
    scale, bias = scale_bias
    y = group_norm_silu_norm_plain(x, group_norm_silu_stats_plain(x, groups), scale, bias, groups, eps)
    return quantize_plain(y, absmax)


def _launch_int8(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int, absmax: torch.Tensor,
                 eps: float, sms: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K1's codes-out entry on checked arguments, on ``sms``
    SMs (0: all); returns the codes and the 0-d scale."""
    B, H, W, C = x.shape
    dev = x.device
    rows, chunks = slab_cut(H * W, C, x.element_size())
    part = torch.empty((B, -(-H * W // (rows * chunks)), 2, groups), dtype=torch.float32, device=dev)
    xq = torch.empty(x.shape, dtype=torch.int8, device=dev)
    s = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _kernel_lib().groupnorm_silu_int8(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), absmax.data_ptr(), xq.data_ptr(), s.data_ptr(),
            part.data_ptr(), _barrier(dev).data_ptr(), B, H * W, C, groups, rows, chunks, sms, eps,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"groupnorm_silu_int8 kernel launch failed: CUDA error {rc}")
    return xq, s


def group_norm_silu_int8(x: torch.Tensor, scale_bias: Tuple[torch.Tensor, torch.Tensor], groups: int,
                         absmax: torch.Tensor, eps: float = GN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(xq, s)``: the int8 codes (x's shape) of ``group_norm_silu(x)``
    against the 0-d fp32 ``absmax`` and their 0-d scale, as
    ``ops.int8.quantize`` makes them. On a CUDA tensor one launch of K1's
    codes-out entry (or raise; C % 16 == 0), on a CPU tensor
    ``group_norm_silu``'s CPU path then ``quantize_plain``. No gradient."""
    if x.device.type == "cpu":
        return quantize_plain(group_norm_silu(x, scale_bias, groups, eps), absmax)
    scale, bias = scale_bias
    _check_args(x, scale, bias, groups)
    if x.shape[3] % 16:
        raise ValueError(f"the codes-out kernel needs C % 16 == 0, got C={x.shape[3]}")
    if absmax.device != x.device or absmax.dtype != torch.float32 or absmax.numel() != 1:
        raise ValueError(f"absmax must be one torch.float32 value on {x.device}, got {absmax.dtype} "
                         f"{tuple(absmax.shape)} on {absmax.device}")
    out = _launch_int8(x, scale, bias, groups, absmax, eps)
    _count(group_norm_silu_int8)
    return out


group_norm_silu_int8.launches = 0


def _split_cut(x: torch.Tensor) -> Tuple[int, int, int]:
    """(rows a chunk, chunks a slab, slabs a sample) of ``slab_cut``."""
    hw = x.shape[1] * x.shape[2]
    rows, chunks = slab_cut(hw, x.shape[3], x.element_size())
    return rows, chunks, -(-hw // (rows * chunks))


def group_norm_silu_stats(x: torch.Tensor, groups: int, shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The slab partials (B, S, 2, G) fp32 of NHWC ``x - shift`` (shift (B,
    G) fp32 or None): the split form's kernel on a CUDA tensor (or raise),
    ``group_norm_silu_stats_plain`` on a CPU tensor."""
    if x.device.type == "cpu":
        return group_norm_silu_stats_plain(x, groups, shift)
    return _launch_stats(x, groups, shift)


def _launch_stats(x: torch.Tensor, groups: int, shift: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of the split form's statistics kernel, checked and counted."""
    _check_x(x, groups)
    B, H, W, C = x.shape
    if shift is not None:
        _check("shift", shift, (B, groups), torch.float32, x.device)
    rows, chunks, S = _split_cut(x)
    part = torch.empty((B, S, 2, groups), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernel_lib().groupnorm_silu_stats(x.data_ptr(), None if shift is None else shift.data_ptr(),
                                                part.data_ptr(), B, H * W, C, groups, rows, chunks,
                                                int(x.dtype == torch.bfloat16),
                                                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"groupnorm_silu_stats kernel launch failed: CUDA error {rc}")
    _count(group_norm_silu_stats)
    return part


def group_norm_silu_apply(x: torch.Tensor, tot: torch.Tensor, n: float,
                          scale_bias: Tuple[torch.Tensor, torch.Tensor], groups: int,
                          eps: float = GN_EPS, shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``silu(GroupNorm(x))`` from the groups' fp32 totals ``tot`` (B, 2,
    G: sums, then sums of squares) of ``x - shift`` (shift (B, G) fp32 or
    None) over ``n`` elements a group: the split form's kernel on a CUDA
    tensor (or raise), ``group_norm_silu_norm_plain`` on a CPU tensor."""
    scale, bias = scale_bias
    if x.device.type == "cpu":
        return group_norm_silu_norm_plain(x, tot, scale, bias, groups, eps, n=n, shift=shift)
    return _launch_apply(x, tot, n, scale, bias, groups, eps, shift)


def _launch_apply(x: torch.Tensor, tot: torch.Tensor, n: float, scale: torch.Tensor, bias: torch.Tensor,
                  groups: int, eps: float, shift: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of the split form's normalisation kernel, checked and counted."""
    _check_args(x, scale, bias, groups)
    B, H, W, C = x.shape
    _check("tot", tot, (B, 2, groups), torch.float32, x.device)
    if shift is not None:
        _check("shift", shift, (B, groups), torch.float32, x.device)
    rows, chunks, _ = _split_cut(x)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _kernel_lib().groupnorm_silu_apply(
            x.data_ptr(), tot.data_ptr(), None if shift is None else shift.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), y.data_ptr(), B, H * W, C, groups, rows, chunks, float(n), eps,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"groupnorm_silu_apply kernel launch failed: CUDA error {rc}")
    _count(group_norm_silu_apply)
    return y


group_norm_silu_stats.launches = 0
group_norm_silu_apply.launches = 0


def _spatial(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int, eps: float, mesh,
             stats, apply) -> torch.Tensor:
    """GroupNorm+SiLU of this rank's rows ``x`` through ``stats`` and
    ``apply`` (the split form's entries or their plain versions): one
    statistics pass over ``x - shift``, the shift one element of each group
    on this rank (the shifted-data sums, which do not cancel where a
    group's mean is large against its spread), the ranks' moments merged in
    one collective, then the normalisation about the merged mean with
    totals (0, M2) over the whole image's count."""
    from ..parallel.mesh import MODEL_AXIS, axis_size, merge_moments_model

    B, h, W, C = x.shape
    n = h * W * (C // groups)
    shift = x.detach()[:, 0, 0].reshape(B, groups, C // groups)[:, :, 0].float().contiguous()
    part = stats(x, groups, shift=shift).sum(dim=1)
    mean, m2 = merge_moments_model(mesh, shift, part[:, 0], part[:, 1], n)
    tot = torch.stack([torch.zeros_like(m2), m2], dim=1)
    ranks = 1 if mesh is None else axis_size(mesh, MODEL_AXIS)
    return apply(x, tot, n * ranks, (scale, bias), groups, eps, shift=mean)


def _apply_plain(x, tot, n, scale_bias, groups, eps, shift):
    return group_norm_silu_norm_plain(x, tot, scale_bias[0], scale_bias[1], groups, eps, n=n, shift=shift)


class _GroupNormSiLUSpatial(torch.autograd.Function):
    """Forward: K1's split form with the moments merged over the mesh's
    model axis (its plain pair on a CPU tensor). Backward: autograd of the
    plain pair, and of the merge between them, recomputed from the saved
    inputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, mesh):
        ctx.save_for_backward(x, scale, bias)
        ctx.groups, ctx.eps, ctx.mesh = groups, eps, mesh
        return _spatial(x, scale, bias, groups, eps, mesh, group_norm_silu_stats, group_norm_silu_apply)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            x, scale, bias = (t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need))
            y = _spatial(x, scale, bias, ctx.groups, ctx.eps, ctx.mesh, group_norm_silu_stats_plain, _apply_plain)
            got = iter(torch.autograd.grad(y, [a for a, n in zip((x, scale, bias), need) if n], g))
        return (*(next(got) if n else None for n in need), None, None, None)


def group_norm_silu_spatial(x: torch.Tensor, scale_bias: Tuple[torch.Tensor, torch.Tensor], groups: int, mesh,
                            eps: float = GN_EPS) -> torch.Tensor:
    """``silu(GroupNorm(.))`` of this rank's rows ``x`` (B, h, W, C) of an
    NHWC image whose height is split over ``mesh``'s model axis (None: a
    model axis of one), its statistics over the whole image: K1's split form
    on a CUDA tensor (or raise), its plain pair on a CPU tensor; every rank
    of the axis calls it together. Differentiable in x, scale and bias."""
    return _GroupNormSiLUSpatial.apply(x.contiguous(), scale_bias[0], scale_bias[1], groups, eps, mesh)
