"""Flash attention forward and backward — the port of ``clip_codec_tpu/ops/pallas_attention.py``.

    flash_attention_fwd(q, k, v)                     -> (out, lse)     over (BH, N, D)
    flash_attention_bwd(q, k, v, out, lse, dout)     -> (dq, dk, dv)
    flash_attention_heads(q, k, v)                   -> out            over (B, H, N, D), differentiable

``out = softmax(q k^T / sqrt(D)) v`` with no mask and ``lse`` the fp32
natural-log row logsumexp of the scaled logits, which the backward reads.

On a CUDA tensor the wrappers launch the hand-written Hopper kernels
(``csrc/flash_attention.cu`` forward, ``csrc/flash_attention_bwd.cu`` the
dq and the dk/dv kernels: wgmma fed by TMA through ``csrc/sm90.cuh``; bf16;
D in 40, 48, 72, 80 or 512, SD-1.5's head dims and the widths that pad to
the same depth) or raise; on a CPU tensor
they run ``flash_attention_plain`` and ``flash_attention_bwd_plain``, the
materializing fp32 versions, which are also what the kernels are checked
against on the card. ``flash_attention_heads`` is an autograd Function: the
forward kernel saves ``(q, k, v, out, lse)`` and the backward kernels
consume them. ``flash_attention_fwd.launches``,
``flash_attention_bwd_dq.launches`` and ``flash_attention_bwd_dkv.launches``
count kernel launches (a call recorded into a CUDA graph launches nothing
and is not counted; the graph's replays pass no wrapper).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

LOG2E = math.log2(math.e)


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        P = ctypes.c_void_p
        lib.flash_attention_fwd_bf16.argtypes = [P] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, P]
        lib.flash_attention_fwd_bf16.restype = ctypes.c_int
        lib.flash_attention_depth.argtypes = [ctypes.c_int]
        lib.flash_attention_depth.restype = ctypes.c_int
        lib._typed = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("flash_attention_bwd")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_bwd_dq_bf16.argtypes = [P] * 7 + [I] * 4 + [F, F, P]
        lib.flash_attention_bwd_dq_bf16.restype = I
        lib.flash_attention_bwd_dkv_bf16.argtypes = [P] * 8 + [I] * 4 + [F, F, P]
        lib.flash_attention_bwd_dkv_bf16.restype = I
        lib.flash_attention_bwd_depth.argtypes = [I]
        lib.flash_attention_bwd_depth.restype = I
        lib._typed = True
    return lib


def _launch_error(name: str, rc: int) -> RuntimeError:
    """The C entry points return a CUDA error, or 9000 (libcuda's
    cuTensorMapEncodeTiled not found) or 10000 + its CUresult (a tensor map
    refused), from ``csrc/sm90.cuh``."""
    if rc == 9000:
        why = "cuTensorMapEncodeTiled not found in libcuda"
    elif rc >= 10000:
        why = f"cuTensorMapEncodeTiled refused a tensor map: CUresult {rc - 10000}"
    else:
        why = f"CUDA error {rc}"
    return RuntimeError(f"{name} launch failed: {why}")


def _count(wrapper) -> None:
    """One launch on ``wrapper.launches``, unless the call was recorded into a CUDA graph."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1


def _scale(D: int) -> float:
    return 1.0 / float(D) ** 0.5


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materializing version: fp32 logits ``q k^T / sqrt(D)``, fp32 softmax
    through the natural-log lse, ``p v`` in fp32, out in q's dtype (the jnp
    ``attention_reference`` and the lse of ``_heads_fwd_local``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q.shape[-1])
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def _check(name: str, t: torch.Tensor, shape, device, dtype=torch.bfloat16) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q is on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernel needs a CUDA or CPU tensor, got {q.device}")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q, k, v must be (BH, N, D), got {tuple(q.shape)}, {tuple(k.shape)}")
    BH, N, D = q.shape
    Nk = k.shape[1]
    _check("q", q, (BH, N, D), q.device)
    _check("k", k, (BH, Nk, D), q.device)
    _check("v", v, (BH, Nk, D), q.device)
    lib = _kernel_lib()
    if lib.flash_attention_depth(D) == 0:
        raise ValueError(f"the kernel takes D in (40, 48, 72, 80, 512), got D={D}")
    out = torch.empty_like(q)
    lse = torch.empty((BH, N), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            BH, N, Nk, D, _scale(D) * LOG2E, stream)  # c_float rounds it to fp32
    if rc != 0:
        raise _launch_error("flash_attention kernel", rc)
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, N, D) q and (BH, Nk, D) k, v -> (out (BH, N, D), lse (BH, N) fp32)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    out = _launch(q, k, v)
    _count(flash_attention_fwd)
    return out


flash_attention_fwd.launches = 0


# ------------------------------------------------------------------ backward
#
# From the forward's lse (pallas_attention.py:170-178), scale = 1/sqrt(D):
#   p    = exp(scale q k^T - lse)        dvec = rowsum(dO * O)
#   dv   = p^T dO                        ds   = p * (dO v^T - dvec)
#   dq   = scale ds k                    dk   = scale ds^T q
# p is taken as exp2(scale log2(e) q k^T - lse2) with lse2 = lse log2(e);
# lse2 and dvec are torch ops outside the kernels, as in JAX (:262-263).


def _bwd_stats(out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse2, dvec), each (BH, N) fp32: the log2-domain lse and rowsum(dO * O)."""
    return lse * LOG2E, (dout.float() * out.float()).sum(dim=-1)


def _p_ds(q, k, v, dout, lse2, dvec):
    """fp32 ``p`` and ``ds`` of the formulas above."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (_scale(q.shape[-1]) * LOG2E)
    p = torch.exp2(s - lse2[..., None])
    return p, p * (torch.matmul(dout.float(), v.float().transpose(-1, -2)) - dvec[..., None])


def flash_attention_bwd_dq_plain(q, k, v, dout, lse2, dvec) -> torch.Tensor:
    """Materializing fp32 dq, in q's dtype."""
    _, ds = _p_ds(q, k, v, dout, lse2, dvec)
    return (torch.matmul(ds, k.float()) * _scale(q.shape[-1])).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, dout, lse2, dvec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materializing fp32 (dk, dv), in k's and v's dtypes."""
    p, ds = _p_ds(q, k, v, dout, lse2, dvec)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * _scale(q.shape[-1])
    return dk.to(k.dtype), torch.matmul(p.transpose(-1, -2), dout.float()).to(v.dtype)


def _bwd_launch(fn_name: str, q, k, v, dout, lse2, dvec, outs) -> None:
    """Checks and launches one of the two backward kernels into ``outs``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernel needs a CUDA or CPU tensor, got {q.device}")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q, k, v must be (BH, N, D), got {tuple(q.shape)}, {tuple(k.shape)}")
    BH, N, D = q.shape
    Nk = k.shape[1]
    dev = q.device
    for name, t, shape in (("q", q, (BH, N, D)), ("k", k, (BH, Nk, D)), ("v", v, (BH, Nk, D)),
                           ("dout", dout, (BH, N, D))):
        _check(name, t, shape, dev)
    _check("lse2", lse2, (BH, N), dev, torch.float32)
    _check("dvec", dvec, (BH, N), dev, torch.float32)
    lib = _bwd_lib()
    if lib.flash_attention_bwd_depth(D) == 0:
        raise ValueError(f"the kernel takes D in (40, 48, 72, 80, 512), got D={D}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn_name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse2.data_ptr(), dvec.data_ptr(),
            *(t.data_ptr() for t in outs), BH, N, Nk, D, _scale(D) * LOG2E, _scale(D), stream)
    if rc != 0:
        raise _launch_error(fn_name, rc)


def flash_attention_bwd_dq(q, k, v, dout, lse2, dvec) -> torch.Tensor:
    """dq (BH, N, D) from q, dout (BH, N, D), k, v (BH, Nk, D) and the fp32
    (BH, N) ``lse2`` and ``dvec`` of ``_bwd_stats``: the dq kernel on CUDA."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, dout, lse2, dvec)
    dq = torch.empty_like(q)
    _bwd_launch("flash_attention_bwd_dq_bf16", q, k, v, dout, lse2, dvec, (dq,))
    _count(flash_attention_bwd_dq)
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse2, dvec) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (BH, Nk, D), from the same inputs: the dk/dv kernel on CUDA."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, dout, lse2, dvec)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_attention_bwd_dkv_bf16", q, k, v, dout, lse2, dvec, (dk, dv))
    _count(flash_attention_bwd_dkv)
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_plain(q, k, v, out, lse, dout):
    """The plain backward: (dq, dk, dv) in the inputs' dtypes, fp32 math."""
    stats = _bwd_stats(out, lse, dout)
    return (flash_attention_bwd_dq_plain(q, k, v, dout, *stats),
            *flash_attention_bwd_dkv_plain(q, k, v, dout, *stats))


def flash_attention_bwd(q, k, v, out, lse, dout):
    """(dq, dk, dv) of ``out = flash_attention_fwd(q, k, v)[0]`` for the
    upstream gradient ``dout``, from the forward's ``out`` and ``lse``."""
    stats = _bwd_stats(out, lse, dout)
    return (flash_attention_bwd_dq(q, k, v, dout, *stats),
            *flash_attention_bwd_dkv(q, k, v, dout, *stats))


class _FlashAttention(torch.autograd.Function):
    """Forward kernel saving ``(q, k, v, out, lse)``; backward kernels. The
    module globals are read at call time, so swapping
    ``flash_attention_fwd`` / ``flash_attention_bwd`` swaps both directions."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return flash_attention_bwd(*ctx.saved_tensors, dout.contiguous())


def flash_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flash attention over (B, H, N, D) with the default 1/sqrt(D) scale,
    differentiable in q, k and v."""
    B, H, N, D = q.shape
    M = k.shape[2]
    # contiguous(): at B = 1 the reshape of a (B, N, H, D) transpose is a strided view, not a copy
    flat = [t.reshape(B * H, -1, D).contiguous() for t in (q, k, v)]
    return _FlashAttention.apply(*flat).reshape(B, H, N, D)
