"""Read DINOv2 checkpoints for the port's ``encoders.dino.DinoV2``.

A HuggingFace ``Dinov2Model`` state dict (``embeddings.*``,
``encoder.layer.{i}.*``, ``layernorm.*``; the names that the JAX package's
``convert_dino_hf`` reads, ``clip_codec_tpu/encoders/dino.py``) is mapped
onto the port's names: q, k and v fused into ``attn.in_proj_weight`` /
``in_proj_bias`` as ``weights/convert_clip.py`` fuses HF CLIP's, the
LayerScale ``lambda1`` vectors as ``ls1``/``ls2``. ``embeddings.mask_token``
(used only in DINOv2's masked pre-training) is dropped. No ``transformers``
import: the file is read by ``sd_checkpoint.read_checkpoint`` (``.pt``,
``.bin``, or ``.safetensors`` where that package is installed).
``dino_state_dict_to_hf`` is the inverse, for writing a HF-layout file from
a seeded module.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Union

import torch

from .sd_checkpoint import _count, read_checkpoint, strip_prefixes

PathLike = Union[str, Path]
StateDict = Dict[str, torch.Tensor]

# (port name in a block, HF name in encoder.layer.{i}) for every tensor kept as it is
_BLOCK = [("ln_1", "norm1"), ("ln_2", "norm2"), ("attn.out_proj", "attention.output.dense"),
          ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")]
_TOP = [("patch_embed.weight", "embeddings.patch_embeddings.projection.weight"),
        ("patch_embed.bias", "embeddings.patch_embeddings.projection.bias"),
        ("cls_token", "embeddings.cls_token"), ("position_embeddings", "embeddings.position_embeddings"),
        ("final_ln.weight", "layernorm.weight"), ("final_ln.bias", "layernorm.bias")]
_QKV = ("query", "key", "value")


def dino_state_dict_from_hf(sd: Mapping) -> StateDict:
    """A HuggingFace ``Dinov2Model`` state dict -> the port's names."""
    out: StateDict = {ours: sd[hf] for ours, hf in _TOP}
    for i in range(_count(sd, "encoder.layer.{}.norm1.weight")):
        src, dst = f"encoder.layer.{i}", f"encoder.resblocks.{i}"
        for ours, hf in _BLOCK:
            for n in ("weight", "bias"):
                out[f"{dst}.{ours}.{n}"] = sd[f"{src}.{hf}.{n}"]
        for n in ("weight", "bias"):
            out[f"{dst}.attn.in_proj_{n}"] = torch.cat([sd[f"{src}.attention.attention.{p}.{n}"] for p in _QKV])
        out[f"{dst}.ls1"] = sd[f"{src}.layer_scale1.lambda1"]
        out[f"{dst}.ls2"] = sd[f"{src}.layer_scale2.lambda1"]
    return out


def dino_state_dict_to_hf(sd: Mapping) -> StateDict:
    """The port's ``DinoV2`` state dict -> HuggingFace ``Dinov2Model``
    names (a zero ``mask_token`` included), the inverse of
    ``dino_state_dict_from_hf``."""
    out: StateDict = {hf: sd[ours] for ours, hf in _TOP}
    dim = out["layernorm.weight"].shape[0]
    out["embeddings.mask_token"] = torch.zeros(1, dim)
    for i in range(_count(sd, "encoder.resblocks.{}.ls1")):
        src, dst = f"encoder.resblocks.{i}", f"encoder.layer.{i}"
        for ours, hf in _BLOCK:
            for n in ("weight", "bias"):
                out[f"{dst}.{hf}.{n}"] = sd[f"{src}.{ours}.{n}"]
        for n in ("weight", "bias"):
            for p, t in zip(_QKV, sd[f"{src}.attn.in_proj_{n}"].chunk(3)):
                out[f"{dst}.attention.attention.{p}.{n}"] = t
        out[f"{dst}.layer_scale1.lambda1"] = sd[f"{src}.ls1"]
        out[f"{dst}.layer_scale2.lambda1"] = sd[f"{src}.ls2"]
    return out


def load_dino_state_dict(path: PathLike) -> StateDict:
    """A ``.pt``/``.bin``/``.safetensors`` HuggingFace DINOv2 checkpoint ->
    fp32 CPU tensors for ``DinoV2.load_state_dict(strict=True)``."""
    sd = dino_state_dict_from_hf(strip_prefixes(read_checkpoint(path)))
    return {k: v.float().contiguous() for k, v in sd.items()}
