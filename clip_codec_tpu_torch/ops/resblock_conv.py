"""Fused affine(+SiLU)+conv3x3 — the port of ``clip_codec_tpu/ops/pallas_resblock.py``.

One kernel shape carries every 3x3 conv of the U-Net's ResBlocks and its
GroupNorm->head conv:

    affine_silu_conv3x3(x, A, B, w9, bias, add=None, want_moments=False)
      = conv3x3(silu(x * A + B)) + bias (+ add)     [+ per-channel fp32 moments]
    affine_conv3x3(...)  — the same without the activation (linear)

x is NHWC, A and B are per-(batch, channel) fp32, w9 is the conv kernel as
(9, Cin, Cout) in the compute dtype, bias is fp32 (Cout,). The moments are
``(B, 2, Cout)`` = [sum, sum of squares] over H*W of the fp32 output.

On a CUDA tensor the wrappers launch a hand-written Hopper kernel in
``csrc/affine_conv3x3.cu`` (bf16 only) or raise: K3 for the head's
function (linear, no residual or moments, Cout <= 8, Cin <= 512), K2
otherwise. On a CPU tensor they run the plain PyTorch version below, which
is also what the kernels are checked against on the card. Each wrapper
counts its launches in ``.launches`` (calls recorded into a CUDA graph
launch nothing and are not counted).

The block-level glue ``gn_affine`` / ``gn_affine_from_moments`` folds
GroupNorm (and GroupNorm after FiLM) into the per-(batch, channel) affine,
so a whole ResBlock is two kernel calls (``models/blocks.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .attention import _count, _launch_error

GN_EPS = 1e-5
_LIB = "affine_conv3x3"
_CIN_STEP = 32  # the kernels take Cin % 32 == 0


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load(_LIB)
    if not getattr(lib, "_typed", False):
        P = ctypes.c_void_p
        lib.affine_conv3x3_bf16.argtypes = [P] * 8 + [ctypes.c_int] * 6 + [P]
        lib.affine_conv3x3_bf16.restype = ctypes.c_int
        lib.affine_conv3x3_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.affine_conv3x3_tiles.restype = ctypes.c_int
        lib.affine_conv3x3_is_head.argtypes = [ctypes.c_int] * 5
        lib.affine_conv3x3_is_head.restype = ctypes.c_int
        lib._typed = True
    return lib


def pad_cout(w9: torch.Tensor, bias: torch.Tensor, add: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``w9`` (9, Cin, Cout), ``bias`` (Cout,) and ``add`` (B, H, W, Cout)
    zero-padded along Cout to a multiple of 8, as K2 needs (its tensor maps
    take 16-byte strides); the same tensors when Cout is one already (every
    U-Net conv: no copy on the main path). The padded columns of y and of the
    moments are zero-weight columns the caller drops."""
    extra = -w9.shape[2] % 8
    if extra == 0:
        return w9, bias, add
    return (F.pad(w9, (0, extra)).contiguous(), F.pad(bias, (0, extra)).contiguous(),
            None if add is None else F.pad(add, (0, extra)).contiguous())


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(x, A, B, w9, bias, add, want_moments, linear):
    if x.device.type != "cuda":
        raise ValueError(f"affine conv3x3 kernel needs a CUDA or CPU tensor, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    Bn, H, W, cin = x.shape
    if w9.dim() != 3:
        raise ValueError(f"w9 must be (9, Cin, Cout), got {tuple(w9.shape)}")
    cout = w9.shape[2]
    if cin % _CIN_STEP:
        raise ValueError(f"the kernel needs Cin % {_CIN_STEP} == 0, got Cin={cin}")
    dev = x.device
    _check("x", x, (Bn, H, W, cin), torch.bfloat16, dev)
    _check("A", A, (Bn, cin), torch.float32, dev)
    _check("B", B, (Bn, cin), torch.float32, dev)
    _check("w9", w9, (9, cin, cout), torch.bfloat16, dev)
    _check("bias", bias, (cout,), torch.float32, dev)
    if add is not None:
        _check("add", add, (Bn, H, W, cout), torch.bfloat16, dev)

    lib = _kernel_lib()
    if not lib.affine_conv3x3_is_head(cin, cout, int(linear), add is not None, int(want_moments)):
        w9, bias, add = pad_cout(w9, bias, add)  # K2's weight map needs Cout % 8 == 0
    cout_k = w9.shape[2]
    y = torch.empty((Bn, H, W, cout_k), dtype=x.dtype, device=dev)
    n_tiles = lib.affine_conv3x3_tiles(H, W)
    part = (torch.empty((Bn, n_tiles, 2, cout_k), dtype=torch.float32, device=dev)
            if want_moments else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.affine_conv3x3_bf16(
            x.data_ptr(), A.data_ptr(), B.data_ptr(), w9.data_ptr(), bias.data_ptr(),
            None if add is None else add.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(),
            Bn, H, W, cin, cout_k, int(linear), stream,
        )
    if rc != 0:
        raise _launch_error("affine_conv3x3 kernel", rc)
    if cout_k != cout:
        y = y[..., :cout].contiguous()
        part = None if part is None else part[..., :cout]
    return y, (part.sum(dim=1) if want_moments else None)


def affine_conv3x3_plain(
    x: torch.Tensor, A: torch.Tensor, B: torch.Tensor, w9: torch.Tensor,
    bias: torch.Tensor, add: Optional[torch.Tensor] = None,
    want_moments: bool = False, linear: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel (the jnp ``_reference`` semantics):
    the activation is rounded to x's dtype, the conv accumulates in fp32, and
    bias, residual and moments are fp32 before the store in x's dtype."""
    cin, cout = w9.shape[1], w9.shape[2]
    pre = x.float() * A.float()[:, None, None, :] + B.float()[:, None, None, :]
    act = (pre if linear else F.silu(pre)).to(x.dtype)
    w = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)  # (Cout, Cin, kh, kw)
    y = F.conv2d(act.permute(0, 3, 1, 2).float(), w.float(), padding=1).permute(0, 2, 3, 1)
    y = y + bias.float()
    if add is not None:
        y = y + add.float()
    mom = torch.stack([y.sum(dim=(1, 2)), (y * y).sum(dim=(1, 2))], dim=1) if want_moments else None
    return y.to(x.dtype), mom


def affine_silu_conv3x3(
    x: torch.Tensor, A: torch.Tensor, B: torch.Tensor, w9: torch.Tensor,
    bias: torch.Tensor, add: Optional[torch.Tensor] = None, want_moments: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``conv3x3(silu(x*A + B)) + bias (+ add)``; returns ``(y, moments or None)``."""
    if x.device.type == "cpu":
        return affine_conv3x3_plain(x, A, B, w9, bias, add, want_moments)
    out = _launch(x, A, B, w9, bias, add, want_moments, linear=False)
    _count(affine_silu_conv3x3)
    return out


def affine_conv3x3(
    x: torch.Tensor, A: torch.Tensor, B: torch.Tensor, w9: torch.Tensor,
    bias: torch.Tensor, add: Optional[torch.Tensor] = None, want_moments: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``conv3x3(x*A + B) + bias (+ add)`` — the no-activation variant, for
    the GroupNorm -> head conv."""
    if x.device.type == "cpu":
        return affine_conv3x3_plain(x, A, B, w9, bias, add, want_moments, linear=True)
    out = _launch(x, A, B, w9, bias, add, want_moments, linear=True)
    _count(affine_conv3x3)
    return out


affine_silu_conv3x3.launches = 0
affine_conv3x3.launches = 0


def conv_weight_to_w9(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """torch conv weight (Cout, Cin, 3, 3) -> the kernel's (9, Cin, Cout),
    tap-major (3*dy + dx) as the JAX ``k.reshape(9, Cin, Cout)``."""
    cout, cin = weight.shape[:2]
    return weight.detach().permute(2, 3, 1, 0).reshape(9, cin, cout).to(dtype).contiguous()


# ----------------------------------------------------------- block-level glue


def gn_affine(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
              eps: float = GN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) fp32 ``(A, B)`` with ``x*A + B == GroupNorm(x)``
    for NHWC ``x``: one reduction pass, raw ``E[x^2] - m^2`` variance."""
    Bn, C = x.shape[0], x.shape[-1]
    xg = x.float().reshape(Bn, -1, groups, C // groups)
    m = xg.mean(dim=(1, 3))
    v = xg.square().mean(dim=(1, 3)) - m * m
    mc = m.repeat_interleave(C // groups, dim=1)
    vc = v.repeat_interleave(C // groups, dim=1)
    A = gamma.float()[None, :] * torch.rsqrt(vc + eps)
    return A, beta.float()[None, :] - mc * A


def gn_affine_from_moments(
    mom: torch.Tensor, hw: int, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
    film: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, eps: float = GN_EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm affine of ``y`` (optionally of ``FiLM(y) = y*(1+s) + b``)
    from y's per-channel raw moments ``mom`` (B, 2, C): the returned (A, B)
    satisfy ``y*A + B == GN(FiLM(y))``. The raw-moment group variance is
    clamped at 0."""
    mean_y = mom[:, 0] / hw
    ey2 = mom[:, 1] / hw
    if film is not None:
        f1 = 1.0 + film[0]
        fb = film[1]
        mean_yp = f1 * mean_y + fb
        ey2p = f1 * f1 * ey2 + 2.0 * f1 * fb * mean_y + fb * fb
    else:
        f1 = torch.ones_like(mean_y)
        fb = torch.zeros_like(mean_y)
        mean_yp, ey2p = mean_y, ey2
    Bn, C = mean_y.shape
    mg = mean_yp.reshape(Bn, groups, C // groups).mean(dim=2)
    eg = ey2p.reshape(Bn, groups, C // groups).mean(dim=2)
    vg = torch.clamp(eg - mg * mg, min=0.0)
    mgc = mg.repeat_interleave(C // groups, dim=1)
    vgc = vg.repeat_interleave(C // groups, dim=1)
    inv = gamma.float()[None, :] * torch.rsqrt(vgc + eps)
    return f1 * inv, (fb - mgc) * inv + beta.float()[None, :]
