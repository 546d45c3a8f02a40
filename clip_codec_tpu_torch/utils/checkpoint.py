"""Load a decoder checkpoint: a torch ``.pt`` state dict in the reference
layout (what ``clip_codec_tpu.weights.export.save_torch_unet`` writes); its
``model_config.json`` is found by ``ModelConfig.find_for_checkpoint``.
Flax ``.msgpack`` checkpoints need flax/msgpack and are not read here."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import torch

PathLike = Union[str, Path]


def load_state_dict(path: PathLike) -> Dict[str, torch.Tensor]:
    """A ``.pt`` state dict of tensors, on the CPU."""
    path = Path(path)
    if path.suffix == ".msgpack":
        raise ValueError(f"{path}: msgpack (flax) checkpoints are not supported by the "
                         "torch package; export with clip_codec_tpu.weights.export.save_torch_unet")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict) or not all(isinstance(v, torch.Tensor) for v in sd.values()):
        raise ValueError(f"{path} does not hold a state dict of tensors")
    return sd

