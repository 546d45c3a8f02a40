"""The optimizer and EMA shared by the port's trainers (the JAX package's
``optax.adamw`` and its in-step EMA)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def make_optimizer(module: torch.nn.Module, lr: float) -> torch.optim.AdamW:
    """AdamW over ``module``'s parameters with optax.adamw's defaults (b1
    0.9, b2 0.999, eps 1e-8, weight decay 1e-4; torch's own default decay is
    1e-2)."""
    return torch.optim.AdamW(module.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], decay: float) -> None:
    """``e <- e * d + p * (1 - d)`` in fp32, in place, as the JAX step."""
    d = np.float32(decay)
    one_minus = float(np.float32(1.0) - d)
    with torch.no_grad():
        for k, e in ema.items():
            e.mul_(float(d)).add_(params[k].detach().float() * one_minus)
