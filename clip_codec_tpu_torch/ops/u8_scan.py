"""Inner products of fp32 queries with uint8 code rows — the score of the
uint8-resident retrieval indexes (``index/search.py``, ``index/ivf.py``):

    u8_ip_scores(codes (N, D) u8, qs (Q, D), qz (Q,), inv (N,)) -> (Q, N)
        s[q, i] = (sum_d qs[q, d] * codes[i, d] + qz[q]) * inv[i]
    u8_ip_probe(lists (nlist, cap, D) u8, list_inv (nlist, cap), probe (Q, nprobe) i32, qs, qz)
        -> (Q, nprobe, cap): the same score of query q over each list it probes

all fp32 but the codes. With ``qs = q * scale``, ``qz = q . zero`` and
``inv = 1 / |scale * u + zero|`` this is q against the dequantized,
renormalized row (``fold_query``), with the matrix left in uint8.

On a CUDA tensor both launch the hand-written Hopper kernel in
``csrc/u8_ip_scan.cu`` or raise. It runs the products on the tensor cores
(wgmma, bf16 in, fp32 accumulate) and still exactly: a code byte is exact in
bf16, and the kernel splits each fp32 query value into three bf16 parts
whose sum is the value, so every product is exact. Only the sums round:
each 64-byte chunk's products from zero in the tensor cores, then the chunk
partials in fp32 rounded to nearest, which errs less against float64 than
the plain version's fp32 product. A row's sum runs in one order wherever the
row lies and whatever Q is, so identical rows score bit-identically. Each
code byte leaves device memory once a search (once a probed list in the
probe, whose pairs the kernel groups by list itself with no host sync); a
search is bytes-bound up to Q ~ 50. Any D. The JAX package has no Pallas
kernel here: XLA fuses the u8 -> f32 convert into the dot of
``_u8_search_jit`` (``clip_codec_tpu/index/search.py:97``) and
``_ivf_u8_search`` (``clip_codec_tpu/index/ivf.py:117``); ``codes.float() @
qs.T`` in PyTorch would write and read an (N, D) fp32 copy each search
instead. On a CPU tensor they run the plain versions, ``torch.matmul`` over
row chunks of at most ``CHUNK_ROWS`` rows, so no more than a chunk is ever
held in fp32. Each wrapper counts its launches in ``.launches`` (calls
recorded into a CUDA graph launch nothing and are not counted).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator, Tuple

import torch

from .attention import _count, _launch_error

_LIB = "u8_ip_scan"
CHUNK_ROWS = 131072


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """fp32 matrix products in full fp32 whatever the caller set: TF32 would
    move scores by ~1e-3 and reorder hits."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def fold_query(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) queries -> ``(qs, qz) = (q * scale, q . zero)``, the query side of
    the dequantize fold."""
    with full_fp32():
        return (q * scale[None, :]).contiguous(), (q @ zero).contiguous()


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load(_LIB)
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.u8_ip_scores.argtypes = [P] * 5 + [I] * 3 + [P]
        lib.u8_ip_scores.restype = I
        lib.u8_ip_probe.argtypes = [P] * 6 + [I] * 5 + [P]
        lib.u8_ip_probe.restype = I
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, shape, dtype, device, align: int = 4) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the codes are on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte aligned")


def _launch_scores(codes, qs, qz, inv) -> torch.Tensor:
    if codes.device.type != "cuda":
        raise ValueError(f"u8_ip_scores needs a CUDA or CPU tensor, got {codes.device}")
    if codes.dim() != 2:
        raise ValueError(f"codes must be (N, D), got {tuple(codes.shape)}")
    N, D = codes.shape
    Q, dev = qs.shape[0], codes.device
    _check("codes", codes, (N, D), torch.uint8, dev, align=16)  # read with 16-byte loads
    _check("qs", qs, (Q, D), torch.float32, dev)
    _check("qz", qz, (Q,), torch.float32, dev)
    _check("inv", inv, (N,), torch.float32, dev)
    lib = _kernel_lib()
    out = torch.empty((Q, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.u8_ip_scores(codes.data_ptr(), qs.data_ptr(), qz.data_ptr(), inv.data_ptr(), out.data_ptr(),
                              N, D, Q, stream)
    if rc != 0:
        raise _launch_error("u8_ip_scores kernel", rc)
    return out


def _launch_probe(lists, list_inv, probe, qs, qz) -> torch.Tensor:
    if lists.device.type != "cuda":
        raise ValueError(f"u8_ip_probe needs a CUDA or CPU tensor, got {lists.device}")
    if lists.dim() != 3 or probe.dim() != 2:
        raise ValueError(f"lists must be (nlist, cap, D) and probe (Q, nprobe), got {tuple(lists.shape)} and "
                         f"{tuple(probe.shape)}")
    nlist, cap, D = lists.shape
    (Q, nprobe), dev = probe.shape, lists.device
    _check("lists", lists, (nlist, cap, D), torch.uint8, dev, align=16)
    _check("list_inv", list_inv, (nlist, cap), torch.float32, dev)
    _check("probe", probe, (Q, nprobe), torch.int32, dev)
    _check("qs", qs, (Q, D), torch.float32, dev)
    _check("qz", qz, (Q,), torch.float32, dev)
    lib = _kernel_lib()
    out = torch.empty((Q, nprobe, cap), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.u8_ip_probe(lists.data_ptr(), list_inv.data_ptr(), probe.data_ptr(), qs.data_ptr(), qz.data_ptr(),
                             out.data_ptr(), nlist, cap, D, Q, nprobe, stream)
    if rc != 0:
        raise _launch_error("u8_ip_probe kernel", rc)
    return out


def u8_ip_scores_plain(codes: torch.Tensor, qs: torch.Tensor, qz: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch: fp32 products over row chunks."""
    N = codes.shape[0]
    out = torch.empty((qs.shape[0], N), dtype=torch.float32, device=codes.device)
    with full_fp32():
        for lo in range(0, N, CHUNK_ROWS):
            hi = min(lo + CHUNK_ROWS, N)
            out[:, lo:hi] = (qs @ codes[lo:hi].to(torch.float32).T + qz[:, None]) * inv[None, lo:hi]
    return out


def u8_ip_probe_plain(lists: torch.Tensor, list_inv: torch.Tensor, probe: torch.Tensor, qs: torch.Tensor,
                      qz: torch.Tensor) -> torch.Tensor:
    """The probe kernel's function in torch: each query against its probed lists."""
    (Q, nprobe), (_, cap, D) = probe.shape, lists.shape
    out = torch.empty((Q, nprobe, cap), dtype=torch.float32, device=lists.device)
    for q in range(Q):
        sel = probe[q].long()
        out[q] = u8_ip_scores_plain(lists[sel].reshape(-1, D), qs[q:q + 1], qz[q:q + 1],
                                    list_inv[sel].reshape(-1)).view(nprobe, cap)
    return out


def u8_ip_scores(codes: torch.Tensor, qs: torch.Tensor, qz: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """(Q, N) fp32 scores ``(qs @ codes.T + qz[:, None]) * inv[None, :]``."""
    if codes.device.type == "cpu":
        return u8_ip_scores_plain(codes, qs, qz, inv)
    if codes.shape[0] == 0 or qs.shape[0] == 0:
        return torch.empty((qs.shape[0], codes.shape[0]), dtype=torch.float32, device=codes.device)
    out = _launch_scores(codes, qs, qz, inv)
    _count(u8_ip_scores)
    return out


def u8_ip_probe(lists: torch.Tensor, list_inv: torch.Tensor, probe: torch.Tensor, qs: torch.Tensor,
                qz: torch.Tensor) -> torch.Tensor:
    """(Q, nprobe, cap) fp32 scores of each query over the lists ``probe`` names."""
    if lists.device.type == "cpu":
        return u8_ip_probe_plain(lists, list_inv, probe, qs, qz)
    if probe.numel() == 0:
        return torch.empty((*probe.shape, lists.shape[1]), dtype=torch.float32, device=lists.device)
    out = _launch_probe(lists, list_inv, probe, qs, qz)
    _count(u8_ip_probe)
    return out


u8_ip_scores.launches = 0
u8_ip_probe.launches = 0
