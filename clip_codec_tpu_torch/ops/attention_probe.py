"""Attention probe kernels — the port of ``bench_attn_probe.py``'s three Pallas kernels.

    flash_variant(q, k, v, tq, tk, mode)              -> out (BH, N, D)        P1
    fast_flash_acc(q, k, v, tq, tk, deg, mxu_sum)     -> acc (BH, N, D+1) fp32 P2
    fast_flash_kernel(q, k, fast_v(v, mxu_sum), ...)  -> acc, the kernel alone P2
    fast_flash(q, k, v, tq, tk, deg, mxu_sum=True)    -> out (BH, N, D)        P2, divided
    single_pass(q, k, v, tq)                          -> out (BH, N, D)        P3

Variants of the flash-attention forward that take one piece of its work
away at a time, so that timing them says where the forward's time goes:

* P1 ``mode``: ``full`` (online softmax with ``exp``, the production
  form), ``exp2`` (scale * log2(e) folded into q in q's dtype, ``exp2``),
  ``noscale`` (no scale multiply), ``nomax`` (``p = exp(s)``, no running
  max: overflows at large logits by design), ``noexp`` (``alpha = m_prev -
  m_cur`` and ``p = s - m_cur``: no ``exp``; its output depends on the key
  tile width ``tk``), ``dotonly`` (``acc += bf16(s * scale) v``, no softmax).
* P2: the exp2-domain forward with the logits scaled in fp32, ``p`` from a
  polynomial ``fast_exp2`` of degree ``deg`` (0: the hardware ``exp2``), and
  the row sum carried by the P.V product through a ones column appended to
  v (``mxu_sum``, which sums the bf16-rounded p) or summed from the fp32 p.
  The kernel writes the raw fp32 accumulator, whose last column is the row
  sum; ``fast_flash`` divides.
* P3: the exact row max over all keys first, then ``exp`` with no rescale.

In every form p is rounded to v's dtype for the P.V product and the
accumulator is fp32. The running max starts at the finite ``NEG_INF``.

On a CUDA tensor the wrappers launch the hand-written Hopper kernels of
``csrc/flash_attention_probe.cu`` or raise: bf16 q, k, v of one (BH, N, D)
shape, contiguous, D in (40, 48), N % 128 == 0, and (tq, tk) one of the
instantiated tiles (``P1_TILES``, ``P2_TILES``, ``P3_TILES``; tq is the
block's query rows, tk the keys per shared-memory tile). All three run on
the production forward's (K4's) loop: ``wgmma`` fed by TMA, 64 query rows
per consumer warpgroup, two or three warpgroups taking turns (tq = 128 or
192, the last query tile of a head may be partial), tk = 64 or 128, the six
P1 modes and the four P2 forms at K4's own tile (192, 128); P3 over key
tiles of 128. P2's kernel maps v as ``fast_v`` lays it out: with
``mxu_sum`` the ones column sits in the P.V product's zero padding (column
D of 48 at D = 40, of 56 at D = 48). On a CPU tensor
they run the plain versions (``flash_variant_plain``, ``fast_flash_plain``,
``single_pass_plain``), which are also what the kernels are held against on
the card. ``flash_variant.launches``, ``fast_flash_acc.launches`` and
``single_pass.launches`` count the kernels each wrapper launches (P2's
through ``fast_flash_acc`` or ``fast_flash_kernel``); a call
recorded into a CUDA graph launches nothing and is not counted (the graph's
replays run the kernel without the wrapper).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .attention import _count

NEG_INF = -1e30
LOG2E = math.log2(math.e)
MODES = ("full", "exp2", "noscale", "nomax", "noexp", "dotonly")
# Minimax-ish coefficients of 2^f on [0, 1), constant term first (bench_attn_probe.py:192-197).
EXP2_COEFFS = {2: (1.0, 0.65617384, 0.34382616), 3: (1.0, 0.69583354, 0.22610143, 0.07806503)}

# The instantiated kernels: (mode, tq, tk) for P1, (deg, mxu_sum, tq, tk) for P2, tq for P3.
P1_TILES = ([(m, 192, 128) for m in MODES]
            + [(m, tq, tk) for tq, tk in ((128, 128), (192, 64), (128, 64)) for m in ("full", "exp2")])
P2_TILES = ([(0, True, 192, 128), (2, False, 192, 128), (2, True, 192, 128), (3, True, 192, 128)]
            + [(2, True, tq, tk) for tq, tk in ((128, 128), (192, 64), (128, 64))])
P3_TILES = (128, 192)
KERNEL_DEPTHS = (40, 48)


def _scale(D: int) -> float:
    return 1.0 / float(D) ** 0.5


def _fold_exp2(q: torch.Tensor) -> torch.Tensor:
    """q * scale * log2(e) in q's dtype: the constant and the product are
    each rounded to it, as ``bench_attn_probe.py:165`` does."""
    c = torch.tensor(_scale(q.shape[-1]) * LOG2E, dtype=q.dtype).item()  # the constant rounded to q's dtype
    return q * c


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """fp32 ``p v`` with p rounded to v's dtype first."""
    return torch.matmul(p.to(v.dtype).float(), v.float())


def _key_tiles(k: torch.Tensor, v: torch.Tensor, tk: int):
    for j in range(0, k.shape[1], tk):
        yield k[:, j:j + tk].float(), v[:, j:j + tk]


# ------------------------------------------------------------------ P1


def flash_variant_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tk: int, mode: str) -> torch.Tensor:
    """P1 in torch: the online softmax of ``mode`` over key tiles of ``tk``
    (the tile width matters for ``noexp``), fp32 logits and statistics, out
    in q's dtype."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    scale = _scale(q.shape[-1])
    if mode == "exp2":
        q = _fold_exp2(q)
    qf = q.float()
    rows = q.shape[:2]
    m = torch.full(rows, NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(rows, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for kt, vt in _key_tiles(k, v, tk):
        s = torch.matmul(qf, kt.transpose(-1, -2))
        if mode not in ("noscale", "exp2"):
            s = s * scale
        if mode == "dotonly":
            acc = acc + _pv(s, vt)
            l = torch.ones_like(l)
            continue
        if mode == "nomax":
            p = torch.exp(s)
            l = l + p.sum(-1)
            acc = acc + _pv(p, vt)
            continue
        m_cur = torch.maximum(m, s.amax(-1))
        if mode == "noexp":
            alpha, p = m - m_cur, s - m_cur[..., None]
        else:
            ex = torch.exp2 if mode == "exp2" else torch.exp
            alpha, p = ex(m - m_cur), ex(s - m_cur[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _pv(p, vt)
        m = m_cur
    return (acc / l[..., None]).to(q.dtype)


# ------------------------------------------------------------------ P2


def fast_exp2(x: torch.Tensor, deg: int = 2) -> torch.Tensor:
    """2^x for x <= ~0 from the exponent bits of floor(x) and a degree-``deg``
    polynomial of the fraction (``bench_attn_probe.py:200``); deg 0 is
    ``torch.exp2``. The exponent is clamped at -126, so x < -126 gives
    2^-126 * p(frac(x)), not 0."""
    if deg == 0:
        return torch.exp2(x)
    xi = torch.floor(x)
    f = x - xi
    c = EXP2_COEFFS[deg]
    p = torch.full_like(x, c[-1])
    for cc in c[-2::-1]:
        p = p * f + cc
    e = (torch.clamp(xi, min=-126.0).to(torch.int32) + 127) << 23
    return e.view(torch.float32) * p


def _ones_column(v: torch.Tensor, width: int) -> torch.Tensor:
    """v with a ones column appended at index D, zero-padded to ``width``
    columns."""
    BH, N, D = v.shape
    out = torch.zeros((BH, N, width), dtype=v.dtype, device=v.device)
    out[..., :D] = v
    out[..., D] = 1
    return out


def fast_v_width(D: int, mxu_sum: bool) -> int:
    """Columns of the v that P2's kernel maps: D + 1 rounded up to 8 with
    ``mxu_sum`` (a TMA row stride is a multiple of 16 bytes), else D."""
    return -(-(D + 1) // 8) * 8 if mxu_sum else D


def fast_v(v: torch.Tensor, mxu_sum: bool) -> torch.Tensor:
    """v as P2's kernel maps it: with ``mxu_sum``, ones in column D and
    zeros after it, ``fast_v_width`` columns; else v itself."""
    return _ones_column(v, fast_v_width(v.shape[-1], True)) if mxu_sum else v


def fast_flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tk: int, deg: int,
                     mxu_sum: bool) -> torch.Tensor:
    """P2 in torch: the raw fp32 (BH, N, D+1) accumulator, the unnormalized
    output and, as its last column, the row sum (of the bf16-rounded p with
    ``mxu_sum``, of the fp32 p without)."""
    BH, N, D = q.shape
    scale2 = _scale(D) * LOG2E
    if mxu_sum:
        v = _ones_column(v, D + 1)
    qf = q.float()
    m = torch.full((BH, N), NEG_INF, dtype=torch.float32, device=q.device)
    acc = torch.zeros((BH, N, D + 1), dtype=torch.float32, device=q.device)
    for kt, vt in _key_tiles(k, v, tk):
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale2
        m_cur = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_cur)
        p = fast_exp2(s - m_cur[..., None], deg)
        new = _pv(p, vt) if mxu_sum else torch.cat([_pv(p, vt), p.sum(-1, keepdim=True)], dim=-1)
        acc = acc * alpha[..., None] + new
        m = m_cur
    return acc


# ------------------------------------------------------------------ P3


def single_pass_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """P3 in torch: the exact row max over all N keys, ``p = exp(s - m)``, no
    rescale; materializes the (BH, N, N) fp32 logits."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q.shape[-1])
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return (_pv(p, v) / p.sum(-1, keepdim=True)).to(q.dtype)


# ------------------------------------------------------------------ kernels


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("flash_attention_probe")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attn_probe_variant_bf16.argtypes = [P] * 4 + [I] * 6 + [F, P]
        lib.attn_probe_fast_bf16.argtypes = [P] * 4 + [I] * 8 + [F, P]
        lib.attn_probe_single_pass_bf16.argtypes = [P] * 4 + [I] * 4 + [F, P]
        for fn in (lib.attn_probe_variant_bf16, lib.attn_probe_fast_bf16, lib.attn_probe_single_pass_bf16):
            fn.restype = I
        lib._typed = True
    return lib


def _on_cpu(q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"attention probe kernel needs a CUDA or CPU tensor, got {q.device}")
    return False


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tile, tiles, v_width=None) -> None:
    """Raise ValueError on what the kernels do not take; v has ``v_width``
    columns (default D)."""
    if q.dim() != 3:
        raise ValueError(f"q, k, v must be (BH, N, D), got {tuple(q.shape)}")
    BH, N, D = q.shape
    for name, t, width in (("q", q, D), ("k", k, D), ("v", v, D if v_width is None else v_width)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q is on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be torch.bfloat16, got {t.dtype}")
        if tuple(t.shape) != (BH, N, width):
            raise ValueError(f"{name} must have shape {(BH, N, width)}, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if D not in KERNEL_DEPTHS:
        raise ValueError(f"the probe kernels take D in {KERNEL_DEPTHS}, got D={D}")
    if N % 128:
        raise ValueError(f"the probe kernels take N % 128 == 0, got N={N}")
    if tile not in tiles:
        raise ValueError(f"no kernel is instantiated for {tile}; the kernels are {tiles}")


def _launch(fn_name: str, q: torch.Tensor, *args) -> None:
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(_kernel_lib(), fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc}")


def flash_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tq: int, tk: int, mode: str) -> torch.Tensor:
    """P1: (BH, N, D) q, k, v -> out in q's dtype; the kernel on CUDA."""
    if _on_cpu(q):
        return flash_variant_plain(q, k, v, tk, mode)
    _check(q, k, v, (mode, tq, tk), P1_TILES)
    BH, N, D = q.shape
    if mode == "exp2":
        q = _fold_exp2(q)
    out = torch.empty_like(q)
    _launch("attn_probe_variant_bf16", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            BH, N, D, tq, tk, MODES.index(mode), _scale(D))
    _count(flash_variant)
    return out


def fast_flash_acc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tq: int, tk: int, deg: int,
                   mxu_sum: bool = True) -> torch.Tensor:
    """P2's raw fp32 (BH, N, D+1) accumulator; on CUDA ``fast_v`` then the kernel."""
    if _on_cpu(q):
        return fast_flash_plain(q, k, v, tk, deg, mxu_sum)
    _check(q, k, v, (deg, bool(mxu_sum), tq, tk), P2_TILES)
    return fast_flash_kernel(q, k, fast_v(v, mxu_sum), tq, tk, deg, mxu_sum)


def fast_flash_kernel(q: torch.Tensor, k: torch.Tensor, vk: torch.Tensor, tq: int, tk: int, deg: int,
                      mxu_sum: bool = True) -> torch.Tensor:
    """P2's accumulator from ``vk = fast_v(v, mxu_sum)``, made once by the
    caller: on CUDA the kernel alone (what the probe times as P2's ms), on
    a CPU tensor the plain version of v = vk's first D columns. Its
    launches count on ``fast_flash_acc.launches``."""
    D = q.shape[-1]
    if _on_cpu(q):
        return fast_flash_plain(q, k, vk[..., :D], tk, deg, mxu_sum)
    _check(q, k, vk, (deg, bool(mxu_sum), tq, tk), P2_TILES, fast_v_width(D, mxu_sum))
    BH, N, D = q.shape
    out = torch.empty((BH, N, D + 1), dtype=torch.float32, device=q.device)
    _launch("attn_probe_fast_bf16", q, q.data_ptr(), k.data_ptr(), vk.data_ptr(), out.data_ptr(),
            BH, N, D, vk.shape[-1], tq, tk, deg, int(mxu_sum), _scale(D) * LOG2E)
    _count(fast_flash_acc)
    return out


def fast_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tq: int, tk: int, deg: int,
               mxu_sum: bool = True) -> torch.Tensor:
    """P2: out = acc[..., :D] / acc[..., D:] in q's dtype (``bench_attn_probe.py:277``)."""
    acc = fast_flash_acc(q, k, v, tq, tk, deg, mxu_sum)
    D = q.shape[-1]
    return (acc[..., :D] / acc[..., D:]).to(q.dtype)


def single_pass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tq: int) -> torch.Tensor:
    """P3: (BH, N, D) -> out in q's dtype; the two-sweep kernel on CUDA."""
    if _on_cpu(q):
        return single_pass_plain(q, k, v)
    _check(q, k, v, tq, P3_TILES)
    BH, N, D = q.shape
    out = torch.empty_like(q)
    _launch("attn_probe_single_pass_bf16", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            BH, N, D, tq, _scale(D))
    _count(single_pass)
    return out


flash_variant.launches = 0
fast_flash_acc.launches = 0
single_pass.launches = 0
