"""Tensor parallelism for the SD-1.5 UNet (Megatron-style): the port of
``clip_codec_tpu/parallel/tp.py``.

JAX shards the parameters and lets GSPMD insert the collectives. Here each
rank of the mesh's ``model`` axis holds its slices of the same Megatron
layout (``shard_params_tp``) in an ``SDUNet`` built for the axis
(``SDUNet(cfg, mesh=mesh)``, ``models/sd/layers.py``), and the blocks sum
their row-parallel products over the axis themselves
(``parallel.mesh.all_reduce_model``):

- attention ``to_q``/``to_k``/``to_v`` column-parallel (torch dim 0 of the
  ``(out, in)`` weight) -> each rank computes ``heads / n`` whole heads,
  its self-attention through flash attention (K4) on those heads;
- attention ``to_out.0`` row-parallel (dim 1) -> its product without the
  bias, one all-reduce, then the bias, which stays whole;
- the GEGLU ``ff.net.0.proj`` column-parallel: diffusers fuses it into one
  ``(2F, C)`` weight in the order [hidden | gate], and JAX shards its two
  halves ``proj_h`` and ``proj_g`` separately, so rank r keeps rows
  ``[rF/n, (r+1)F/n)`` and ``[F + rF/n, F + (r+1)F/n)`` of the weight and
  the bias (a plain chunk of dim 0 would give rank 0 the hidden rows and
  rank 1 the gate rows). The fused MLP (K6) then runs on the rank's F/n
  columns and its output is summed over the axis before the bias;
- ``ff.net.2`` row-parallel (dim 1), its bias whole.

Everything else (convs, norms, the time embedding) stays replicated, and so
do the VAE and the adapter, which this module never sees: activations are
whole on every rank between the blocks, and the only collectives are the
three all-reduces of each transformer block.

Requirements checked by :func:`validate_tp`: ``heads`` and every
``block_out`` divisible by the model-axis size.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from .mesh import MODEL_AXIS, axis_index, axis_size

_COL = ("to_q", "to_k", "to_v")  # column-parallel attention projections
_ROW = ("to_out.0", "ff.net.2")  # row-parallel (summed after the local contraction)
_GEGLU = "ff.net.0.proj"  # column-parallel in its two halves


def _module(name: str) -> str:
    return name.rsplit(".", 1)[0]


def _rule(name: str) -> Optional[int]:
    """The torch dim of parameter ``name`` (diffusers names) that a rank
    keeps a slice of, or None for a replicated tensor."""
    mod, leaf = _module(name), name.rsplit(".", 1)[-1]
    if mod.rsplit(".", 1)[-1] in _COL or mod.endswith(_GEGLU):
        return 0  # the output dim, of the weight and of a bias
    if mod.endswith(_ROW):
        return 1 if leaf == "weight" else None  # the bias is added once, after the sum
    return None


def sd_unet_tp_specs(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Optional[int]]:
    """For each name of an SD-UNet state dict, the dim a rank keeps a slice
    of (the Megatron layout on the transformer blocks), or None."""
    return {k: _rule(k) for k in state_dict}


def validate_tp(cfg, n_model: int) -> None:
    """Raise early (with the offending dimension) if ``cfg`` cannot shard
    over ``n_model`` devices."""
    if n_model <= 1:
        return
    if cfg.heads % n_model:
        raise ValueError(f"heads={cfg.heads} not divisible by model axis {n_model}")
    # Every block_out attends: the down blocks at their widths, the mid block
    # and the first up block at block_out[-1].
    for ch in cfg.block_out:
        if ch % n_model:
            raise ValueError(f"block width {ch} not divisible by model axis {n_model}")


def local_slice(name: str, t: torch.Tensor, dim: Optional[int], rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s slice of parameter ``name`` under ``n`` ranks
    (``dim`` from :func:`sd_unet_tp_specs`); the GEGLU projection's
    [hidden | gate] halves are sliced each on its own."""
    if dim is None or n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} not divisible by model axis {n}")
    if _module(name).endswith(_GEGLU):
        f = t.shape[0] // 2
        return torch.cat([local_slice(name + ".half", h, 0, rank, n) for h in (t[:f], t[f:])])
    per = t.shape[dim] // n
    return t.narrow(dim, rank * per, per).contiguous()


def shard_params_tp(mesh, state_dict: Mapping[str, torch.Tensor], specs=None) -> Dict[str, torch.Tensor]:
    """This rank's tensors of an SD-UNet ``state_dict`` under the mesh's
    model axis (``specs`` defaults to :func:`sd_unet_tp_specs`): what an
    ``SDUNet(cfg, mesh=mesh)`` loads with ``strict=True``. A model axis of
    one returns the tensors as they are."""
    if specs is None:
        specs = sd_unet_tp_specs(state_dict)
    n = 1 if mesh is None else axis_size(mesh, MODEL_AXIS)
    r = 0 if mesh is None else axis_index(mesh, MODEL_AXIS)
    return {k: local_slice(k, v, specs[k], r, n) for k, v in state_dict.items()}
