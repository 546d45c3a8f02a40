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

On a CUDA tensor the three steps are hand-written kernels
(``csrc/int8_conv.cu``): ``absmax``, ``int8_quantize`` and the implicit-GEMM
``int8_conv_nhwc``, which also runs every ``Linear`` as a 1x1 conv over
``(M, 1, 1, K)`` rows. They raise on what they do not take (Cin % 32 != 0,
Cout % 8 != 0, other kernel sizes, strides or paddings); nothing falls back.
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
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

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


# ------------------------------------------------------------ the kernels


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load(_LIB)
    if not getattr(lib, "_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.int8_conv_nhwc.argtypes = [P] * 6 + [I] * 10 + [P]
        lib.int8_conv_nhwc.restype = I
        lib.int8_quantize.argtypes = [P, I, L, P, P, P, P]
        lib.int8_quantize.restype = I
        lib.absmax.argtypes = [P, I, L, P, P]
        lib.absmax.restype = I
        lib._typed = True
    return lib


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
        rc = _kernel_lib().absmax(x.data_ptr(), int(x.dtype == torch.bfloat16), x.numel(), out.data_ptr(),
                                  _stream(x.device))
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


def _launch_conv(xq, wq, w_scale, s, bias, stride: int, padding: int, out_dtype) -> torch.Tensor:
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv2d needs a CUDA or CPU tensor, got {xq.device}")
    if xq.dim() != 4 or wq.dim() != 4:
        raise ValueError(f"xq must be (B, H, W, Cin) and wq (Cout, kh, kw, Cin), got {tuple(xq.shape)} and "
                         f"{tuple(wq.shape)}")
    B, H, W, cin = xq.shape
    cout, kh, kw, _ = wq.shape
    dev = xq.device
    if cin % 32 or cout % 8:
        raise ValueError(f"the int8 conv kernel takes Cin % 32 == 0 and Cout % 8 == 0, got {cin} -> {cout}")
    if kh != kw or kh not in (1, 3) or stride not in (1, 2) or padding not in (0, 1):
        raise ValueError(f"the int8 conv kernel takes 1x1 or 3x3, stride 1 or 2, padding 0 or 1; got {kh}x{kw}, "
                         f"stride {stride}, padding {padding}")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"out_dtype must be bf16, fp32 or int32, got {out_dtype}")
    _check("xq", xq, (torch.int8,), dev, align=16)
    _check("wq", wq, (torch.int8,), dev, (cout, kh, kw, cin), align=16)
    _check("w_scale", w_scale, (torch.float32,), dev, (cout,))
    _check("s", s.reshape(()), (torch.float32,), dev)
    if bias is not None:
        _check("bias", bias, (torch.float32,), dev, (cout,))
    ho, wo = (H + 2 * padding - kh) // stride + 1, (W + 2 * padding - kw) // stride + 1
    y = torch.empty((B, ho, wo, cout), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _kernel_lib().int8_conv_nhwc(xq.data_ptr(), wq.data_ptr(), w_scale.data_ptr(), s.data_ptr(),
                                          None if bias is None else bias.data_ptr(), y.data_ptr(), B, H, W, cin,
                                          cout, kh, kw, stride, padding, _OUT_KIND[out_dtype], _stream(dev))
    if rc != 0:
        raise _launch_error("int8_conv_nhwc kernel", rc)
    return y


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


_absmax = absmax
absmax.launches = 0
quantize.launches = 0
int8_conv2d.launches = 0


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
    """A sidecar written by :func:`save_quant`, its tensors on ``device``."""
    q = torch.load(path, map_location=device, weights_only=True)
    if not isinstance(q, dict) or not all(isinstance(k, str) and torch.is_tensor(v) and v.numel() == 1
                                          for k, v in q.items()):
        raise ValueError(f"{path}: not an int8 calibration sidecar (a dict of scalar tensors)")
    return {k: v.float().reshape(()) for k, v in q.items()}
