"""JAX (flax) ``CLIPCondUNet`` params -> this package's state dict.

The mapping is ``clip_codec_tpu.weights.export.export_unet`` itself (numpy
only, behind an empty package ``__init__``), so importing this module loads
no jax; its values are wrapped as tensors."""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch


def unet_state_dict_from_jax(params: Mapping, ch_mult: Sequence[int] = (1, 2, 2)) -> Dict[str, torch.Tensor]:
    """``load_state_dict(strict=True)``-ready tensors for ``CLIPCondUNet``."""
    from clip_codec_tpu.weights.export import export_unet

    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in export_unet(params, ch_mult).items()}
