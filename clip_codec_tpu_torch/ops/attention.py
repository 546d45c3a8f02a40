"""Flash attention forward — the port of ``clip_codec_tpu/ops/pallas_attention.py``.

    flash_attention_fwd(q, k, v)   -> (out, lse)   over (BH, N, D)
    flash_attention_heads(q, k, v) -> out          over (B, H, N, D)

``out = softmax(q k^T / sqrt(D)) v`` with no mask and ``lse`` the fp32
natural-log row logsumexp of the scaled logits (kept for the backward).

On a CUDA tensor the wrappers launch the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (bf16; D in 40, 48, 72, 80 or 512, SD-1.5's
head dims and the widths that pad to the same depth) or raise; on a
CPU tensor they run ``flash_attention_plain``, the materializing fp32
softmax, which is also what the kernel is checked against on the card.
``flash_attention_fwd.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

LOG2E = math.log2(math.e)
_LIB = "flash_attention"


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load(_LIB)
    if not getattr(lib, "_typed", False):
        P = ctypes.c_void_p
        lib.flash_attention_fwd_bf16.argtypes = [P] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, P]
        lib.flash_attention_fwd_bf16.restype = ctypes.c_int
        lib.flash_attention_depth.argtypes = [ctypes.c_int]
        lib.flash_attention_depth.restype = ctypes.c_int
        lib._typed = True
    return lib


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


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q is on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be torch.bfloat16, got {t.dtype}")
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
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, N, D) q and (BH, Nk, D) k, v -> (out (BH, N, D), lse (BH, N) fp32)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    out = _launch(q, k, v)
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


def flash_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flash attention over (B, H, N, D) with the default 1/sqrt(D) scale."""
    B, H, N, D = q.shape
    M = k.shape[2]
    out, _ = flash_attention_fwd(q.reshape(B * H, N, D), k.reshape(B * H, M, D),
                                 v.reshape(B * H, M, D))
    return out.reshape(B, H, N, D)
