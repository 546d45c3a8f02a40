"""int8 serving mode: the port of ``clip_codec_tpu/ops/int8.py``.

An inference-only, opt-in mode for the U-Nets' big products:

* weights: per-output-channel symmetric int8, ``w_scale = max(max|w| / 127,
  1e-12)`` over everything but the output channel, ``wq = clip(round(w /
  w_scale), -127, 127)`` (:func:`quantize_weight`), computed once per load of
  the parameter and packed as ``(Cout, kh, kw, Cin)``;
* activations: per-tensor symmetric int8, ``s = max(absmax, 1e-12) / 127``,
  ``xq = clip(round(x / s), -127, 127)``, with ``absmax`` either ``max|x|``
  of this call (dynamic; a device scalar, so the path can be captured in a
  CUDA graph) or a calibrated per-layer value (static, :func:`calibrate_int8`);
* the product accumulates int32; the epilogue is ``float(acc) * (w_scale *
  s)``, then ``+ bias``, then the cast to the model's dtype.

On a CUDA tensor the steps are hand-written kernels (``csrc/int8_conv.cu``).
A layer (:func:`conv`, :func:`linear`) runs ``absmax`` (dynamic mode only),
``int8_quantize`` (:func:`quantize`) and the implicit-GEMM
``int8_conv_nhwc`` (:func:`int8_conv2d`, :func:`int8_linear`). The act
form ``int8_conv_act_nhwc`` (:func:`int8_conv2d_act`,
:func:`int8_linear_act`) does the quantize and the conv in one launch: it
reads the bf16 or fp32 activation itself and makes the codes in shared
memory, so they never reach device memory. It is checked and timed, but it
is slower than the pair at every shape of the int8 paths (PERF.md), so no
model path calls it. Every ``Linear`` is a 1x1 conv over ``(M, 1, 1, K)``
rows. The kernels raise on what they do not take (Cin % 32 != 0, Cout % 8
!= 0, other kernel sizes, strides or paddings); nothing falls back.
The conv's tiles, K splits and operand swap come from
:func:`int8_conv_plan` (given the activations' element size), a pure
function the CPU tests check and the launch passes to the kernel as it
is. Split-K tiles and ``absmax`` sum
across blocks through a scratch buffer whose arrival counters every launch
leaves zero (:func:`_workspace`): one for each device and stream, as the
launches that share it must be ordered.
On a CPU tensor each runs its plain version: the codes in fp32 with
``torch.round`` (half to even) and a true division, and the integer product
in float64, which is exact for these sums (|sum| <= 9 * 2560 * 127^2 < 2^53;
fp32 is not above 2^24).

Models read the process default :func:`set_int8_conv` at forward time when
built with ``int8=None``; an explicit ``int8=`` pins a model. The state dict
is the same either way. A layer uses its calibrated ``absmax`` when one was
loaded into the model (:func:`load_quant`), else the dynamic one. The quant
dict is keyed by the port's module names (``down.0.conv1``,
``down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj``, ...) with
0-d fp32 tensors as values. round() has no gradient: serving only.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .attention import _count, _launch_error

_LIB = "int8_conv"
Quant = Dict[str, torch.Tensor]
_USE_INT8 = False
_OUT_KIND = {torch.bfloat16: 0, torch.float32: 1, torch.int32: 2}


def set_int8_conv(enabled: bool) -> None:
    """The process default for models built with ``int8=None`` (read at
    forward time). Models with an explicit ``int8=`` ignore it."""
    global _USE_INT8
    _USE_INT8 = bool(enabled)


def int8_enabled() -> bool:
    return _USE_INT8


def resolve(int8: Optional[bool]) -> bool:
    """A model's ``int8`` setting: the process default for None."""
    return _USE_INT8 if int8 is None else bool(int8)


# ------------------------------------------------------------ the plain versions


def _div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as an IEEE division: CUDA turns a division by a Python
    number into a multiply by its rounded reciprocal, a divisor on the
    device keeps it a division (as JAX's and the kernels')."""
    return t / torch.full((), 127.0, dtype=torch.float32, device=t.device)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A conv's ``(O, I, kh, kw)`` or a Linear's ``(O, I)`` fp32 weight ->
    ``(wq (O, kh, kw, I) int8 contiguous, w_scale (O,) fp32)``."""
    wf = w.detach().float()
    ws = torch.clamp_min(_div127(wf.abs().amax(dim=tuple(range(1, wf.dim())))), 1e-12)
    q = torch.clamp(torch.round(wf / ws.view(-1, *[1] * (wf.dim() - 1))), -127, 127).to(torch.int8)
    q = q.permute(0, 2, 3, 1) if q.dim() == 4 else q[:, None, None, :]
    return q.contiguous(), ws


def act_scale_plain(absmax: torch.Tensor) -> torch.Tensor:
    """``s = max(absmax, 1e-12) / 127`` in fp32."""
    return _div127(torch.clamp_min(absmax.float(), 1e-12))


def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """``max|x|`` as a 0-d fp32 tensor."""
    return x.float().abs().amax()


def quantize_plain(x: torch.Tensor, absmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(xq, s)``: the codes ``clip(round(x / s), -127, 127)`` in int8 and
    the scale."""
    s = act_scale_plain(absmax)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8), s


def _epilogue(acc: torch.Tensor, w_scale, s, bias, out_dtype) -> torch.Tensor:
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * (w_scale * s)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


@contextlib.contextmanager
def _exact_f64() -> Iterator[None]:
    """PyTorch's own float64 conv, never cuDNN's or oneDNN's: their FFT and
    Winograd forms would round the integer sums."""
    with torch.backends.cudnn.flags(enabled=False), torch.backends.mkldnn.flags(enabled=False):
        yield


def int8_conv2d_plain(xq: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor, s: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 1,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's function in torch: the exact integer product in float64,
    cast to int32, then the epilogue in fp32. NHWC in, NHWC out."""
    with _exact_f64():
        acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(), stride=stride,
                       padding=padding)
    acc = acc.permute(0, 2, 3, 1).to(torch.int32)
    return _epilogue(acc, w_scale, s, bias, out_dtype).contiguous()


# ------------------------------------------------------------ the conv's plan
#
# csrc/int8_conv.cu's constants, mirrored: a block is two consumer
# warpgroups, each 64 MW rows of wgmma's M side; a ring stage carries 128
# bytes of K (one 128-byte swizzled row) of the tile's activation rows, as
# ``act`` boxes (the activations' element size: 1 for codes, 2 bf16, 4
# fp32), beside its weight rows.

KSTEP = 128
TILES = ((1, 64), (1, 128), (1, 256), (2, 64), (2, 128))  # (MW, BN): 128 MW output rows x BN channels
SWAP_BN = (8, 16, 32, 64)  # M <= 64: the weights are the 128-row side, the M rows wgmma's N
ACTS = (1, 2, 4)  # the activation operand's element size: int8 codes, bf16, fp32
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
SMEM_FIXED = 1024 + 8 * 2048 + 2 * 8 * 8 + 16 + 4096 + 16 * 32  # alignment, staging, barriers, flag, scales, units
MAX_STAGES = 8
SPLIT_TILE_INTS = 256 * 128  # a split slice's scratch: 128 MW x BN <= 32768 int32
# The plan's cost model, microseconds on an H100 SXM at 700 W: a K step and
# an epilogue of each tile, a split tile's arrival, and the last slice's read
# of the others' partials (a KB); a swapped tile is priced as a (1, 64) one.
# Fitted by least squares to CUDA-graph times of every plan at the int8
# paths' shapes. CONVERT_US: the act form's conversion of 128 activation
# rows a K step, by element size, fitted in the same way.
STEP_US = {(1, 64): 0.28, (1, 128): 0.36, (1, 256): 0.54, (2, 64): 0.42, (2, 128): 0.58}
EPILOGUE_US = {(1, 64): 1.5, (1, 128): 2.3, (1, 256): 5.8, (2, 64): 3.4, (2, 128): 4.0}
SPLIT_US, SLICE_US_PER_KB = 2.4, 0.011
CONVERT_US = {1: 0.0, 2: 1.40, 4: 1.86}


class Int8ConvPlan(NamedTuple):
    """How ``int8_conv_nhwc`` walks one call. ``view`` is the output as the
    kernel sees it: ``(B, Ho, Wo)``, or ``(M, 1, 1)`` for a GEMM (a 1x1,
    stride 1, unpadded conv, whose rows are contiguous). A tile is ``rows``
    output pixels, ``tile = (TB, TH, TW)`` of images, rows and columns,
    times ``n_width`` output channels; each of its ``k_steps`` steps is one
    tap's 128 input channels. ``swap``: the weights are wgmma's 128-row A
    side and the pixels its N = ``bn`` side. A unit is one of ``splits``
    slices of a tile's K steps; ``blocks`` persistent blocks walk the
    ``units`` with a ring of ``stages``. ``act``: the activations' element
    size (1: int8 codes; 2, 4: bf16, fp32 values the kernel quantizes)."""
    mw: int
    bn: int
    splits: int
    swap: bool
    gemm: bool
    view: Tuple[int, int, int]
    tile: Tuple[int, int, int]
    m_tiles: int
    n_tiles: int
    k_steps: int
    units: int
    blocks: int
    stages: int
    act: int = 1

    @property
    def rows(self) -> int:
        """Output pixels a tile."""
        return self.bn if self.swap else 128 * self.mw

    @property
    def n_width(self) -> int:
        """Output channels a tile."""
        return 128 if self.swap else self.bn

    def unit(self, u: int) -> Tuple[int, Tuple[int, int, int], int, Tuple[int, int]]:
        """Unit ``u`` as the kernel decodes it: ``(tile, (b0, h0, w0), n0,
        (k0, k1))``, slice ``u % splits`` of tile ``u // splits``; tiles
        walk the output pixels fastest (columns, rows, images), then the
        channels."""
        split, tile = u % self.splits, u // self.splits
        tiles_w, tiles_h = _cdiv(self.view[2], self.tile[2]), _cdiv(self.view[1], self.tile[1])
        mt = tile % self.m_tiles
        corner = (mt // (tiles_w * tiles_h) * self.tile[0], mt // tiles_w % tiles_h * self.tile[1],
                  mt % tiles_w * self.tile[2])
        steps = (split * self.k_steps // self.splits, (split + 1) * self.k_steps // self.splits)
        return tile, corner, tile // self.m_tiles * self.n_width, steps


def stage_bytes(mw: int, bn: int, swap: bool = False, act: int = 1) -> int:
    """A ring stage: ``act`` boxes of the tile's activation rows (128 MW, or
    BN swapped) and its weight rows (BN, or 128 swapped), 128 bytes each."""
    x_rows, w_rows = (bn, 128) if swap else (128 * mw, bn)
    return (act * x_rows + w_rows) * KSTEP


def ring_stages(mw: int, bn: int, swap: bool = False, act: int = 1) -> int:
    """Stages of the ring that fit beside the fixed shared memory."""
    return min(MAX_STAGES, (SMEM_LIMIT - SMEM_FIXED) // stage_bytes(mw, bn, swap, act))


def smem_bytes(mw: int, bn: int, swap: bool = False, act: int = 1) -> int:
    """The kernel's dynamic shared memory at (MW, BN)."""
    return SMEM_FIXED + ring_stages(mw, bn, swap, act) * stage_bytes(mw, bn, swap, act)



def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _tile(view: Tuple[int, int, int], rows: int) -> Tuple[int, int, int]:
    """``rows`` output pixels as (TB, TH, TW): powers of two, the columns first."""
    tw = min(_pow2(view[2]), rows)
    th = min(_pow2(view[1]), rows // tw)
    return rows // (tw * th), th, tw


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def int8_conv_plans(B: int, H: int, W: int, cin: int, cout: int, k: int, stride: int, padding: int,
                    sms: int, act: int = 1) -> List[Tuple[float, Int8ConvPlan]]:
    """Every plan ``int8_conv_nhwc`` (``act`` 1) or ``int8_conv_act_nhwc``
    (``act`` 2 or 4: bf16 or fp32 activations) can run for a ``k`` x ``k``
    conv of ``(B, H, W, cin)`` activations to ``cout`` channels on a card of
    ``sms`` SMs, with its modelled microseconds: waves of units times a
    unit's K steps (and their conversion), epilogue and split costs. M = B
    Ho Wo <= 64 swaps the operands; K is split (int32 partials summed
    exactly, in any order) only where the output tiles cannot fill the
    card, into at most 2 sms units; a tile whose ring would not hold two
    stages is left out."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS} (the activations' element size), got {act}")
    ho, wo = (H + 2 * padding - k) // stride + 1, (W + 2 * padding - k) // stride + 1
    M = B * ho * wo
    gemm = k == 1 and stride == 1 and padding == 0
    view = (M, 1, 1) if gemm else (B, ho, wo)
    k_steps = k * k * _cdiv(cin, KSTEP)
    swap = M <= 64
    shapes = [(1, next(b for b in SWAP_BN if b >= M))] if swap else list(TILES)
    plans = []
    for mw, bn in shapes:
        stages = ring_stages(mw, bn, swap, act)
        if stages < 2:
            continue
        rows, width = (bn, 128) if swap else (128 * mw, bn)
        tb, th, tw = _tile(view, rows)
        m_tiles = _cdiv(view[0], tb) * _cdiv(view[1], th) * _cdiv(view[2], tw)
        n_tiles = _cdiv(cout, width)
        tiles = m_tiles * n_tiles
        priced = (1, 64) if swap else (mw, bn)
        step = STEP_US[priced] + CONVERT_US[act] * rows / 128
        slice_kb = 128 * mw * bn * 4 / 1024
        for splits in range(1, min(k_steps, 64) + 1):
            if splits > 1 and (tiles >= sms or tiles * splits > 2 * sms):
                break
            units = tiles * splits
            split = SPLIT_US + (splits - 1) * slice_kb * SLICE_US_PER_KB if splits > 1 else 0.0
            cost = _cdiv(units, sms) * (_cdiv(k_steps, splits) * step + EPILOGUE_US[priced] + split)
            plans.append((cost, Int8ConvPlan(mw, bn, splits, swap, gemm, view, (tb, th, tw), m_tiles, n_tiles,
                                             k_steps, units, min(units, sms), stages, act)))
    return plans


@functools.lru_cache(maxsize=None)
def int8_conv_plan(B: int, H: int, W: int, cin: int, cout: int, k: int, stride: int, padding: int,
                   sms: int, act: int = 1) -> Int8ConvPlan:
    """The plan the kernel runs: of ``int8_conv_plans``, the least
    modelled time; on a tie the fewer splits, then the larger tile. Cached:
    the launch asks at every call, an eager SD request makes thousands,
    and listing the plans takes longer than the launch itself."""
    return min(int8_conv_plans(B, H, W, cin, cout, k, stride, padding, sms, act),
               key=lambda cp: (round(cp[0], 6), cp[1].splits, -cp[1].mw, -cp[1].bn))[1]


_SMS: Dict[int, int] = {}


def _sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _workspace_ints(sms: int) -> int:
    """The scratch's int32 count: the split slices' partial sums (a split
    plan has at most 2 sms units), a counter per tile (fewer than sms),
    absmax's counter (padded to 16 bytes) and its per-block maxima (at most
    2 a SM)."""
    return _absmax_scratch(sms) + 4 + 2 * sms


def _absmax_scratch(sms: int) -> int:
    """Where absmax's part of the scratch starts, in int32."""
    return 2 * sms * SPLIT_TILE_INTS + sms


_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}


def _workspace(dev: torch.device, stream: int) -> torch.Tensor:
    """The split-K and absmax scratch of launches on ``stream`` (a
    ``cudaStream_t``) of ``dev``. Its arrival counters are zero when made and
    left zero by every launch (the last block to reach a split tile, or
    absmax's last block, resets its counter); the partials are overwritten.
    So a launch or a graph replay needs no memset, but two launches that
    share a scratch must not overlap: one scratch a stream keeps them
    ordered. A CUDA graph keeps the scratch of the stream it was captured
    on (its first capture there records the zero fill), so graphs captured
    on one stream must not be replayed concurrently."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    ws = _WORKSPACE.get((idx, stream))
    if ws is None:
        ws = _WORKSPACE[(idx, stream)] = torch.zeros(_workspace_ints(_sms(dev)), dtype=torch.int32, device=dev)
    return ws


# ------------------------------------------------------------ the kernels


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' arguments on a loaded library."""
    if not getattr(lib, "_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.int8_conv_nhwc.argtypes = [P] * 7 + [L] + [I] * 21 + [P]
        lib.int8_conv_nhwc.restype = I
        lib.int8_conv_act_nhwc.argtypes = [P, I] + [P] * 6 + [L] + [I] * 21 + [P]
        lib.int8_conv_act_nhwc.restype = I
        lib.int8_quantize.argtypes = [P, I, L, P, P, P, P]
        lib.int8_quantize.restype = I
        lib.absmax.argtypes = [P, I, L, P, P, L, I, P]
        lib.absmax.restype = I
        lib._typed = True
    return lib


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    return bind(_build.load(_LIB))


def _check(name: str, t: torch.Tensor, dtypes, device, shape=None, align: int = 4) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the activations are on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte aligned")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_elementwise(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA or CPU tensor, got {x.device}")
    _check("x", x, (torch.bfloat16, torch.float32), x.device, align=16)
    if x.numel() == 0 or x.numel() % 8:
        raise ValueError(f"{name} takes a multiple of 8 elements, got {x.numel()}")


def _launch_absmax(x: torch.Tensor) -> torch.Tensor:
    _check_elementwise("absmax", x)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        sms, stream = _sms(x.device), _stream(x.device)
        ws, at = _workspace(x.device, stream), _absmax_scratch(sms)
        rc = _kernel_lib().absmax(x.data_ptr(), int(x.dtype == torch.bfloat16), x.numel(), out.data_ptr(),
                                  ws.data_ptr() + 4 * at, 4 * (ws.numel() - at), sms, stream)
    if rc != 0:
        raise _launch_error("absmax kernel", rc)
    return out


def absmax(x: torch.Tensor) -> torch.Tensor:
    """``max|x|`` over the whole tensor, a 0-d fp32 tensor on x's device
    (no host sync)."""
    if x.device.type == "cpu":
        return absmax_plain(x)
    out = _launch_absmax(x)
    _count(absmax)
    return out


def _launch_quantize(x: torch.Tensor, absmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_elementwise("int8_quantize", x)
    _check("absmax", absmax.reshape(()), (torch.float32,), x.device)
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernel_lib().int8_quantize(x.data_ptr(), int(x.dtype == torch.bfloat16), x.numel(), absmax.data_ptr(),
                                         xq.data_ptr(), s.data_ptr(), _stream(x.device))
    if rc != 0:
        raise _launch_error("int8_quantize kernel", rc)
    return xq, s


def quantize(x: torch.Tensor, absmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(xq, s)`` of x (bf16 or fp32) against the 0-d fp32 ``absmax``: the
    int8 codes in x's shape and the 0-d scale."""
    if x.device.type == "cpu":
        return quantize_plain(x, absmax)
    out = _launch_quantize(x, absmax)
    _count(quantize)
    return out


def quantize_act(x: torch.Tensor, absmax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(xq, s)``: the dynamic codes (the absmax of x itself) or, given a
    calibrated ``absmax``, the static ones."""
    return quantize(x, _absmax(x) if absmax is None else absmax)


def _conv(x, act: int, wq, w_scale, scale, bias, stride: int, padding: int, out_dtype) -> torch.Tensor:
    """Either entry's checks and launch, with ``int8_conv_plan``'s plan:
    ``act`` 1 for codes ``x`` and the scale ``scale``, 2 or 4 for bf16 or
    fp32 ``x`` and its absmax."""
    what = "int8_conv_nhwc" if act == 1 else "int8_conv_act_nhwc"
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA or CPU tensor, got {x.device}")
    if x.dim() != 4 or wq.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin) and wq (Cout, kh, kw, Cin), got {tuple(x.shape)} and "
                         f"{tuple(wq.shape)}")
    B, H, W, cin = x.shape
    cout, kh, kw, _ = wq.shape
    dev = x.device
    if cin % 32 or cout % 8:
        raise ValueError(f"the int8 conv kernel takes Cin % 32 == 0 and Cout % 8 == 0, got {cin} -> {cout}")
    if kh != kw or kh not in (1, 3) or stride not in (1, 2) or padding not in (0, 1):
        raise ValueError(f"the int8 conv kernel takes 1x1 or 3x3, stride 1 or 2, padding 0 or 1; got {kh}x{kw}, "
                         f"stride {stride}, padding {padding}")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"out_dtype must be bf16, fp32 or int32, got {out_dtype}")
    _check("x" if act > 1 else "xq", x, (torch.int8,) if act == 1 else (torch.bfloat16, torch.float32), dev, align=16)
    _check("wq", wq, (torch.int8,), dev, (cout, kh, kw, cin), align=16)
    _check("w_scale", w_scale, (torch.float32,), dev, (cout,))
    _check("s" if act == 1 else "absmax", scale.reshape(()), (torch.float32,), dev)
    if bias is not None:
        _check("bias", bias, (torch.float32,), dev, (cout,))
    ho, wo = (H + 2 * padding - kh) // stride + 1, (W + 2 * padding - kw) // stride + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"the int8 conv of a {H}x{W} input by {kh}x{kw}, padding {padding}, has no output")
    y = torch.empty((B, ho, wo, cout), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        sms, stream = _sms(dev), _stream(dev)
        pl = int8_conv_plan(B, H, W, cin, cout, kh, stride, padding, sms, act)
        ws = _workspace(dev, stream)
        tail = (y.data_ptr(), ws.data_ptr(), 4 * ws.numel(), B, H, W, cin, cout, kh, kw, stride, padding,
                _OUT_KIND[out_dtype], pl.mw, pl.bn, pl.splits, int(pl.swap), int(pl.gemm), *pl.tile, pl.blocks,
                pl.stages, sms, stream)
        bias_ptr = None if bias is None else bias.data_ptr()
        lib = _kernel_lib()
        if act == 1:
            rc = lib.int8_conv_nhwc(x.data_ptr(), wq.data_ptr(), w_scale.data_ptr(), scale.data_ptr(), bias_ptr, *tail)
        else:
            rc = lib.int8_conv_act_nhwc(x.data_ptr(), act, wq.data_ptr(), w_scale.data_ptr(), scale.data_ptr(),
                                        bias_ptr, *tail)
    if rc != 0:
        raise _launch_error(f"{what} kernel", rc)
    return y


def _launch_conv(xq, wq, w_scale, s, bias, stride: int, padding: int, out_dtype) -> torch.Tensor:
    """The codes' kernel's launch, with ``int8_conv_plan``'s plan."""
    return _conv(xq, 1, wq, w_scale, s, bias, stride, padding, out_dtype)


def _launch_conv_act(x, absmax, wq, w_scale, bias, stride: int, padding: int, out_dtype) -> torch.Tensor:
    """The act form's launch: x bf16 or fp32, with the plan for its kind."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8_conv_act_nhwc takes bf16 or fp32 activations, got {x.dtype}")
    return _conv(x, x.element_size(), wq, w_scale, absmax, bias, stride, padding, out_dtype)


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor, s: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 1,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The int8 conv of NHWC codes ``xq`` with ``wq`` (Cout, kh, kw, Cin) and
    JAX's epilogue, NHWC ``out_dtype`` out (``torch.int32``: the raw
    accumulator)."""
    if xq.device.type == "cpu":
        return int8_conv2d_plain(xq, wq, w_scale, s, bias, stride, padding, out_dtype)
    y = _launch_conv(xq, wq, w_scale, s, bias, stride, padding, out_dtype)
    _count(int8_conv2d)
    return y


def int8_linear(xq: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor, s: torch.Tensor,
                bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``xq (..., K) @ wq (N, 1, 1, K)^T`` with the epilogue, (..., N) out:
    the conv's 1x1 case over ``(M, 1, 1, K)`` rows."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    y = int8_conv2d(xq.reshape(-1, 1, 1, k), wq, w_scale, s, bias, 1, 0, out_dtype)
    return y.reshape(*lead, wq.shape[0])


def int8_conv2d_act_plain(x: torch.Tensor, absmax: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 1,
                          out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The act form's function in torch: ``quantize_plain`` then
    ``int8_conv2d_plain``."""
    xq, s = quantize_plain(x, absmax)
    return int8_conv2d_plain(xq, wq, w_scale, s, bias, stride, padding, out_dtype)


def int8_conv2d_act(x: torch.Tensor, absmax: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 1,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The int8 conv of NHWC ``x`` (bf16 or fp32) quantized against the 0-d
    fp32 ``absmax`` (``s = max(absmax, 1e-12) / 127``), with ``wq`` (Cout,
    kh, kw, Cin) and JAX's epilogue, NHWC ``out_dtype`` out: on a card one
    launch of ``int8_conv_act_nhwc``, which makes the codes in shared memory
    (bit for bit ``quantize``'s), on the CPU ``int8_conv2d_act_plain``."""
    if x.device.type == "cpu":
        return int8_conv2d_act_plain(x, absmax, wq, w_scale, bias, stride, padding, out_dtype)
    y = _launch_conv_act(x, absmax, wq, w_scale, bias, stride, padding, out_dtype)
    _count(int8_conv2d_act)
    return y


def int8_linear_act(x: torch.Tensor, absmax: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``quantize(x) (..., K) @ wq (N, 1, 1, K)^T`` with the epilogue, (...,
    N) out: ``int8_conv2d_act``'s 1x1 case over ``(M, 1, 1, K)`` rows (its
    launches count there; ``int8_linear_act.launches`` counts those that
    came through here)."""
    lead, k = x.shape[:-1], x.shape[-1]
    y = int8_conv2d_act(x.reshape(-1, 1, 1, k), absmax, wq, w_scale, bias, 1, 0, out_dtype)
    if x.device.type != "cpu":
        _count(int8_linear_act)
    return y.reshape(*lead, wq.shape[0])


_absmax = absmax
absmax.launches = 0
quantize.launches = 0
int8_conv2d.launches = 0
int8_conv2d_act.launches = 0
int8_linear_act.launches = 0


# ------------------------------------------------------------ the layers


def layer_weight(layer: nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_weight(layer.weight)``, computed once per load of the
    parameter (keyed on its storage and version, as ``models.blocks``'s
    cast cache), so a replay quantizes no weight."""
    w = layer.weight
    key = (w.data_ptr(), w._version, w.device)
    hit = layer.__dict__.get("_int8_weight")
    if hit is None or hit[0] != key:
        hit = layer.__dict__["_int8_weight"] = (key, quantize_weight(w))
    return hit[1]


# The calibration in progress: (module id -> name, the quant dict it fills).
_CALIB: Optional[Tuple[Dict[int, str], Quant]] = None


def _record(layer: nn.Module, x: torch.Tensor) -> None:
    names, quant = _CALIB
    name = names.get(id(layer))
    if name is None:
        raise RuntimeError("an int8 layer outside the model being calibrated ran during calibration")
    m = x.detach().float().abs().amax()
    quant[name] = m if name not in quant else torch.maximum(quant[name], m)


def _bias(layer: nn.Module) -> Optional[torch.Tensor]:
    return None if layer.bias is None else layer.bias.detach().float()


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """``layer(x)`` in int8 (JAX's ``Int8Conv``) on NHWC ``x``, NHWC ``dtype``
    out. While calibrating: the fp conv in ``dtype``, recording max|x|."""
    if _CALIB is not None:
        _record(layer, x)
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), layer.weight.detach().to(dtype), None, stride=stride,
                     padding=padding).permute(0, 2, 3, 1).float()
        return (y if layer.bias is None else y + layer.bias.detach().float()).to(dtype).contiguous()
    wq, ws = layer_weight(layer)
    xq, s = quantize_act(x.contiguous(), layer.__dict__.get("_x_absmax"))
    return int8_conv2d(xq, wq, ws, s, _bias(layer), stride, padding, dtype)


def static_absmax(layer: nn.Module) -> Optional[torch.Tensor]:
    """The layer's calibrated absmax where its codes can be made before it
    runs (by their producer, ``ops.groupnorm.group_norm_silu_int8``): None
    while calibrating (``conv`` must see the activation) or in dynamic mode
    (a per-tensor max needs the whole activation before its first code)."""
    return None if _CALIB is not None else layer.__dict__.get("_x_absmax")


def conv_codes(layer: nn.Conv2d, xq: torch.Tensor, s: torch.Tensor, dtype: torch.dtype, stride: int = 1,
               padding: int = 1) -> torch.Tensor:
    """``layer(x)`` in int8 from codes made elsewhere: ``xq``, ``s`` the
    static codes of x against the layer's ``static_absmax``."""
    wq, ws = layer_weight(layer)
    return int8_conv2d(xq, wq, ws, s, _bias(layer), stride, padding, dtype)


def linear(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` over the last axis in int8 (JAX's ``Int8Dense``, or an
    ``Int8Conv`` 1x1): ``layer`` is an ``nn.Linear`` or a 1x1 ``nn.Conv2d``.
    While calibrating: the fp product in ``dtype``, recording max|x|."""
    if _CALIB is not None:
        _record(layer, x)
        w = layer.weight.detach().reshape(layer.weight.shape[0], -1)
        y = F.linear(x.to(dtype), w.to(dtype)).float()
        return (y if layer.bias is None else y + layer.bias.detach().float()).to(dtype)
    wq, ws = layer_weight(layer)
    xq, s = quantize_act(x.contiguous(), layer.__dict__.get("_x_absmax"))
    return int8_linear(xq, wq, ws, s, _bias(layer), dtype)


# ------------------------------------------------------------ calibration and the quant dict


def int8_layer_names(model: nn.Module) -> List[str]:
    """The names of the layers ``model`` runs in int8: each module lists
    its own in ``INT8_LAYERS`` (a submodule path, skipped where absent)."""
    names = []
    for prefix, mod in model.named_modules():
        for sub in getattr(mod, "INT8_LAYERS", ()):
            try:
                mod.get_submodule(sub)
            except AttributeError:
                continue
            names.append(f"{prefix}.{sub}" if prefix else sub)
    return names


def load_quant(model: nn.Module, quant: Optional[Quant]) -> None:
    """Give each int8 layer of ``model`` its calibrated absmax from
    ``quant`` (the static path), or with None take every one away (the
    dynamic path). The tensors are used as they are: a CUDA graph captured
    afterwards reads them, so copying new values into them re-scales the
    replays. Not part of the state dict."""
    layers = dict(model.named_modules())
    for name in int8_layer_names(model):
        layers[name].__dict__.pop("_x_absmax", None)
    if quant is None:
        return
    unknown = sorted(set(quant) - set(int8_layer_names(model)))
    if unknown:
        raise KeyError(f"quant names layers this model does not run in int8: {unknown[:5]}")
    for name, v in quant.items():
        layer = layers[name]
        layer.__dict__["_x_absmax"] = v.to(device=layer.weight.device, dtype=torch.float32).reshape(())


@contextlib.contextmanager
def calibrating(model: nn.Module) -> Iterator[Quant]:
    """While inside, every int8 layer of ``model`` runs its fp form in the
    model's dtype and records the running max|x| of its input into the
    yielded dict (JAX's ``apply(..., mutable=['quant'])``)."""
    global _CALIB
    saved = _CALIB
    quant: Quant = {}
    _CALIB = ({id(m): n for n, m in model.named_modules()}, quant)
    try:
        yield quant
    finally:
        _CALIB = saved


@torch.no_grad()
def calibrate_int8(model: nn.Module, *batches: Sequence) -> Quant:
    """Per-layer activation absmax for the static path: ``model(*batch)``
    in calibration mode for every batch. ``model`` must run int8 layers
    (``int8=True``, or the process default on)::

        net = CLIPCondUNet(..., int8=True)
        load_quant(net, calibrate_int8(net, (x1, z1, t1), ...))
    """
    if not batches:
        raise RuntimeError("calibration needs at least one batch")
    with calibrating(model) as quant:
        for batch in batches:
            model(*batch)
            if not quant:
                raise RuntimeError(
                    "calibration recorded nothing — the model has no int8 layer in its forward; build it with "
                    "int8=True (or set_int8_conv(True) first)")
    return quant


def calibrate_unet(model: nn.Module, size: int, z_dim: int, timesteps: Union[int, Sequence[int]] = 1000,
                   batch: int = 4, seed: int = 0) -> Quant:
    """Calibration of a ``CLIPCondUNet``-shaped model (``model(x, z, t)``):
    noise-scale images and L2-normalised random embeddings from numpy's
    ``default_rng(seed)`` (JAX's numbers), at the 95%, 50% and 5% points of
    a schedule of ``timesteps`` steps, or at the given t values."""
    if isinstance(timesteps, int):
        t_values = [max(0, min(timesteps - 1, int(round(f * timesteps)))) for f in (0.95, 0.5, 0.05)]
    else:
        t_values = [int(t) for t in timesteps]
    dev = next(model.parameters()).device
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((batch, size, size, 3)).astype(np.float32)).to(dev)
    z = r.standard_normal((batch, z_dim)).astype("float32")
    z = torch.from_numpy(z / (np.linalg.norm(z, axis=1, keepdims=True) + 1e-9)).to(dev)
    return calibrate_int8(model, *[(x, z, torch.full((batch,), t, dtype=torch.int32, device=dev))
                                   for t in t_values])


def save_quant(quant: Quant, path) -> None:
    """The sidecar: ``torch.save`` of the dict, on the CPU."""
    torch.save({k: v.detach().float().cpu().reshape(()) for k, v in quant.items()}, path)


def read_quant(path, device: Union[str, torch.device] = "cpu") -> Quant:
    """A sidecar written by :func:`save_quant`, its tensors on ``device``.
    A JAX sidecar (``.quant.msgpack``) is refused: it goes with a JAX
    artifact, which the port does not serve (a known difference)."""
    if str(path).endswith(".msgpack"):
        raise ValueError(f"{path}: a JAX int8 calibration sidecar; the port reads only its own "
                         "<artifact>.quant.pt (export_decoder --int8 writes one)")
    q = torch.load(path, map_location=device, weights_only=True)
    if not isinstance(q, dict) or not all(isinstance(k, str) and torch.is_tensor(v) and v.numel() == 1
                                          for k, v in q.items()):
        raise ValueError(f"{path}: not an int8 calibration sidecar (a dict of scalar tensors)")
    return {k: v.float().reshape(()) for k, v in q.items()}
