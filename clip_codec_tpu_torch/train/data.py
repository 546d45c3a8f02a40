"""Host-side data helpers for training from a store — the port of the parts of
``clip_codec_tpu/train/data.py`` that SD adapter training uses.

* ``load_image_u8`` / ``load_image_m11``: PIL decode, BICUBIC resize, (H, W, 3)
  uint8 or float32 in [-1, 1] (PIL is imported when an image is loaded);
* ``scale_m11_u8``: uint8 -> [-1, 1] float32 on the tensor's device,
  bit-identical to the host's ``x.astype(np.float32) / 127.5 - 1``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

PathLike = Union[str, Path]


def load_image_u8(path: PathLike, out_size: int) -> np.ndarray:
    """RGB image -> (H, W, 3) uint8, BICUBIC resize."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((out_size, out_size), Image.BICUBIC)
    return np.asarray(img, dtype=np.uint8)


def load_image_m11(path: PathLike, out_size: int) -> np.ndarray:
    """RGB image -> (H, W, 3) float32 in [-1, 1], BICUBIC resize."""
    return load_image_u8(path, out_size).astype(np.float32) / 127.5 - 1.0


_M11_TABLE = np.arange(256, dtype=np.float32) / 127.5 - 1.0  # the host math, exact
_tables: Dict[torch.device, torch.Tensor] = {}


def scale_m11_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [-1, 1] as a gather from a 256-entry table made
    with the host's numpy math, so the result is bit-identical to
    ``x.astype(np.float32) / 127.5 - 1.0`` on every device (a device divide
    need not round as the host's does). Float inputs pass through."""
    if x.dtype != torch.uint8:
        return x
    table = _tables.get(x.device)
    if table is None:
        table = _tables[x.device] = torch.from_numpy(_M11_TABLE).to(x.device)
    return table[x.long()]

