"""Per-channel affine uint8 quantizer — the port of ``clip_codec_tpu/codecs/quantizer.py``:

    scale = max(xmax - xmin, eps) / (2**bits - 1)     per channel, fit on data
    zero  = xmin
    q     = clip(round((x - zero) / scale), 0, 2**bits - 1)   -> uint8
    x̂     = q * scale + zero

The min/max reduction runs on the data's device; the O(D) scale arithmetic
runs on the host in IEEE fp32 numpy, so the codebook is the same bits on
every backend. ``quantize`` divides (an IEEE division on the CPU and on
CUDA; never a multiply by a reciprocal, which moves quotients by an ulp and
flips rounding ties) and rounds half to even, so the codes are
integer-exact against numpy and the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

ArrayLike = Union[np.ndarray, torch.Tensor]


def _on(a: ArrayLike, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32).to(like.device)


def fit_affine(X: ArrayLike, num_bits: int = 8, eps: float = 1e-8) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel ``(scale, zero)`` as fp32 numpy over ``X`` (N, D): the
    min/max on X's device (a tensor's own; numpy on the CPU), the scale on
    the host."""
    xmin, xmax = torch.aminmax(torch.as_tensor(X, dtype=torch.float32), dim=0)
    xmin = xmin.cpu().numpy()
    rng_ = np.maximum(xmax.cpu().numpy() - xmin, np.float32(eps))
    return rng_ / np.float32(2**num_bits - 1), xmin


def quantize(x: ArrayLike, scale: ArrayLike, zero: ArrayLike, num_bits: int = 8) -> torch.Tensor:
    """Float vectors -> uint8 codes on x's device; broadcasts over leading dims."""
    x = torch.as_tensor(x, dtype=torch.float32)
    q = torch.round((x - _on(zero, x)) / _on(scale, x))
    return torch.clamp(q, 0, 2**num_bits - 1).to(torch.uint8)


def dequantize(q: ArrayLike, scale: ArrayLike, zero: ArrayLike) -> torch.Tensor:
    """uint8 codes -> fp32 vectors on q's device."""
    x = torch.as_tensor(q).to(torch.float32)
    return x * _on(scale, x) + _on(zero, x)


def dequantize_l2norm(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                      eps: float = 1e-9) -> torch.Tensor:
    """uint8 codes (..., D) -> L2-normalized fp32 embeddings, on q's device."""
    x = q.to(torch.float32) * scale.to(torch.float32) + zero.to(torch.float32)
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def dequantize_l2norm_host(q: np.ndarray, scale: np.ndarray, zero: np.ndarray,
                           eps: float = 1e-9) -> np.ndarray:
    """The same fp32 math in numpy, for host-side callers."""
    x = np.asarray(q).astype(np.float32) * np.asarray(scale) + np.asarray(zero)
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, eps)


@dataclass
class PerChannelAffineQuantizer:
    """The reference class API (fit / encode / decode) on ``device``; numpy
    in and out."""

    num_bits: int = 8
    eps: float = 1e-8
    scale: Optional[np.ndarray] = None
    zero: Optional[np.ndarray] = None
    device: Union[str, torch.device] = "cuda"

    def _tensor(self, a: ArrayLike, dtype: Optional[torch.dtype] = torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def fit(self, X: ArrayLike) -> "PerChannelAffineQuantizer":
        self.scale, self.zero = fit_affine(self._tensor(X), self.num_bits, self.eps)
        return self

    def _check(self) -> None:
        if self.scale is None or self.zero is None:
            raise RuntimeError("Quantizer has not been fitted.")

    def encode(self, x: ArrayLike) -> np.ndarray:
        self._check()
        return quantize(self._tensor(x), self.scale, self.zero, self.num_bits).cpu().numpy()

    def decode(self, q: ArrayLike) -> np.ndarray:
        self._check()
        return dequantize(self._tensor(q, None), self.scale, self.zero).cpu().numpy()
