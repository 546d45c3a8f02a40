"""Dequantize + L2-normalize the uint8 codes (the decode half of
``clip_codec_tpu/codecs/quantizer.py``): ``x = q * scale + zero`` per
channel in fp32, then ``x / max(||x||, eps)``. The fit and quantize halves
belong to the compress side."""

from __future__ import annotations

import numpy as np
import torch


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
