"""Checkpoints of the port, all torch ``.pt`` files.

* ``load_state_dict``: a decoder checkpoint, a ``.pt`` state dict in the
  reference layout (what ``clip_codec_tpu.weights.export.save_torch_unet``
  writes); its ``model_config.json`` is found by
  ``ModelConfig.find_for_checkpoint``. Flax ``.msgpack`` files are not read.
* ``save_state_dict``: a module's parameters as a ``.pt`` state dict of CPU
  tensors (the trained SD adapter: ``weights/sd_checkpoint.py`` and the SD
  CLI's ``load_decoder`` read it as it is).
* ``TrainCheckpointer``: full training state (parameters, optimizer state,
  epoch, EMA) for resuming, in place of the JAX package's orbax manager.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

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


def _atomic_save(obj: Any, path: Path) -> Path:
    """``torch.save`` to a temporary name, then rename: a crash never
    leaves a truncated checkpoint under the final name."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def save_state_dict(path: PathLike, state: Mapping[str, torch.Tensor]) -> Path:
    """A state dict as a ``.pt`` file of detached CPU tensors."""
    return _atomic_save({k: v.detach().cpu() for k, v in state.items()}, Path(path))


class TrainCheckpointer:
    """Full training state as ``<directory>/state_<step>.pt``, the newest
    ``max_to_keep`` kept. ``state`` is a dict of tensors, state dicts and
    numbers (what ``torch.load(weights_only=True)`` reads back)."""

    def __init__(self, directory: PathLike, max_to_keep: int = 3) -> None:
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep

    def _steps(self):
        found = (re.fullmatch(r"state_(\d+)\.pt", p.name) for p in self.directory.glob("state_*.pt"))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: Mapping[str, Any]) -> None:
        _atomic_save(dict(state), self.directory / f"state_{step}.pt")
        for old in self._steps()[:-self.max_to_keep]:
            (self.directory / f"state_{old}.pt").unlink()

    def restore(self, map_location: Union[str, torch.device] = "cpu") -> Optional[Dict[str, Any]]:
        """The newest saved state, or None."""
        steps = self._steps()
        if not steps:
            return None
        return torch.load(self.directory / f"state_{steps[-1]}.pt", map_location=map_location, weights_only=True)
