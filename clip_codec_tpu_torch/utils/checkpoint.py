"""Checkpoints of the port: torch ``.pt`` files, and the JAX package's flax
``.msgpack`` parameter trees.

* ``load_state_dict``: a ``.pt`` state dict of tensors in the reference
  layout (what the port's trainers and
  ``clip_codec_tpu.weights.export.save_torch_unet`` write).
* ``save_params`` / ``load_params``: a parameter tree as flax's msgpack
  bytes (``utils/flax_msgpack.py``), the JAX package's ``save_params`` /
  ``load_params`` format: what its trainers write as
  ``diffusion_unet_final.msgpack``, its ``_ema_final`` and ``_ep{N}``
  siblings and ``sd_adapter_*.msgpack``.
* ``load_unet_checkpoint``: a pixel U-Net decoder checkpoint, ``.pt`` as
  it is or a JAX ``.msgpack`` tree through ``unet_state_dict_from_jax``;
  its ``model_config.json`` is found by ``ModelConfig.find_for_checkpoint``.
* ``save_state_dict``: a module's parameters as a ``.pt`` state dict of CPU
  tensors (the trained SD adapter: ``weights/sd_checkpoint.py`` and the SD
  CLI's ``load_decoder`` read it as it is).
* ``TrainCheckpointer``: full training state (parameters, optimizer state,
  epoch, EMA) for resuming, in place of the JAX package's orbax manager.
  An orbax directory of the JAX package's is not read (a known difference):
  resuming next to one raises.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

PathLike = Union[str, Path]


def load_state_dict(path: PathLike) -> Dict[str, torch.Tensor]:
    """A ``.pt`` state dict of tensors, on the CPU."""
    path = Path(path)
    if path.suffix == ".msgpack":
        raise ValueError(f"{path}: a flax msgpack tree, not a torch state dict: read it with "
                         "load_params, or load_unet_checkpoint for a U-Net decoder")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict) or not all(isinstance(v, torch.Tensor) for v in sd.values()):
        raise ValueError(f"{path} does not hold a state dict of tensors")
    return sd


def _as_arrays(tree: Any) -> Any:
    """Every leaf an array, as the JAX ``save_params``'s ``tree_map(np.asarray, ...)``
    makes it (torch tensors kept: the writer reads them as arrays)."""
    if isinstance(tree, dict):
        return {k: _as_arrays(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_arrays(v) for v in tree]
    if tree is None or isinstance(tree, torch.Tensor):
        return tree
    return np.asarray(tree)


def save_params(path: PathLike, params: Mapping) -> Path:
    """``params`` (numpy arrays and scalars, torch tensors, numbers, in
    nested dicts) as flax msgpack bytes: the bytes of the JAX package's
    ``save_params`` for the same tree."""
    from .flax_msgpack import packb

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(packb(_as_arrays(params)))
    os.replace(tmp, path)
    return path


def load_params(path: PathLike) -> Any:
    """A flax msgpack file as its tree: numpy arrays, bfloat16 leaves as
    ``torch.bfloat16`` tensors. A JAX int8 sidecar (``*.quant.msgpack``)
    is refused: JAX's artifacts are not served by the port (known
    difference; calibrate with the port's ``export_decoder --int8``)."""
    from .flax_msgpack import unpackb

    path = Path(path)
    if path.name.endswith(".quant.msgpack"):
        raise ValueError(f"{path}: a JAX int8 calibration sidecar; the port does not read JAX artifacts "
                         "or their sidecars (calibrate with clip_codec_tpu_torch.cli.export_decoder --int8, "
                         "which writes <artifact>.quant.pt)")
    return unpackb(path.read_bytes())


def float_leaves(tree: Any) -> Any:
    """A loaded tree with every tensor leaf as an fp32 numpy array (a
    bfloat16 leaf widens exactly), for the numpy converters."""
    if isinstance(tree, dict):
        return {k: float_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def load_unet_checkpoint(path: PathLike, ch_mult: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
    """A ``CLIPCondUNet`` state dict from a ``.pt`` file, or from a JAX
    ``.msgpack`` tree (``diffusion_unet_final.msgpack`` and its siblings)
    converted by ``unet_state_dict_from_jax`` (``ch_mult``: its length is
    the number of levels; None counts them in the tree)."""
    path = Path(path)
    if path.suffix != ".msgpack":
        return load_state_dict(path)
    from ..weights.from_jax import unet_state_dict_from_jax

    tree = load_params(path)
    if not isinstance(tree, dict):
        raise ValueError(f"{path} does not hold a parameter tree")
    return unet_state_dict_from_jax(float_leaves(tree.get("params", tree)), ch_mult)


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
        """The newest saved state, or None. Raises where there is none but
        the JAX trainers' orbax directory (``orbax/``, ``orbax_sd/``) sits
        beside this one: the port does not read orbax state."""
        steps = self._steps()
        if not steps:
            for name in ("orbax", "orbax_sd"):
                if (self.directory.parent / name).is_dir():
                    raise ValueError(
                        f"{self.directory.parent / name} holds the JAX package's orbax training state, "
                        f"which the port does not read; resume from the port's own {self.directory} "
                        "(or start anew without --resume, from the JAX run's .msgpack weights)")
            return None
        return torch.load(self.directory / f"state_{steps[-1]}.pt", map_location=map_location, weights_only=True)
