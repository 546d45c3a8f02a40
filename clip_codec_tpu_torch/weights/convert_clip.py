"""Read CLIP checkpoints for the port's ``encoders.clip.CLIPModel``.

The port's towers carry the openai / open_clip layout (``visual.conv1``,
fused ``attn.in_proj_weight``, ``visual.proj`` used as ``x @ proj``), so
such a checkpoint loads as it is. A HuggingFace ``CLIPModel`` state dict
(``vision_model.*``, ``text_model.*``, separate q/k/v) is mapped into that
layout: the inverse of ``clip_codec_tpu/weights/convert_clip.py``'s
``convert_clip_hf`` composed with its ``convert_clip_openai``. The layout is
detected from the keys, as the JAX ``load_clip_params`` does. Entries the
towers do not use (``logit_scale``, the openai archive's
``input_resolution``/``context_length``/``vocab_size``, HF's
``position_ids``) are dropped; everything else must match the model.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Union

import torch

from .sd_checkpoint import _count, read_checkpoint, strip_prefixes

PathLike = Union[str, Path]
StateDict = Dict[str, torch.Tensor]

_UNUSED = ("logit_scale", "input_resolution", "context_length", "vocab_size")


def _hf_block(sd: Mapping, src: str, dst: str, out: StateDict) -> None:
    a = f"{src}.self_attn"
    out[f"{dst}.ln_1.weight"] = sd[f"{src}.layer_norm1.weight"]
    out[f"{dst}.ln_1.bias"] = sd[f"{src}.layer_norm1.bias"]
    out[f"{dst}.attn.in_proj_weight"] = torch.cat([sd[f"{a}.{p}_proj.weight"] for p in "qkv"])
    out[f"{dst}.attn.in_proj_bias"] = torch.cat([sd[f"{a}.{p}_proj.bias"] for p in "qkv"])
    for n in ("weight", "bias"):
        out[f"{dst}.attn.out_proj.{n}"] = sd[f"{a}.out_proj.{n}"]
        out[f"{dst}.ln_2.{n}"] = sd[f"{src}.layer_norm2.{n}"]
        out[f"{dst}.mlp.c_fc.{n}"] = sd[f"{src}.mlp.fc1.{n}"]
        out[f"{dst}.mlp.c_proj.{n}"] = sd[f"{src}.mlp.fc2.{n}"]


def clip_state_dict_from_hf(sd: Mapping) -> StateDict:
    """A HuggingFace ``CLIPModel`` state dict -> the openai layout."""
    out: StateDict = {}
    v, t = "vision_model", "text_model"
    out["visual.conv1.weight"] = sd[f"{v}.embeddings.patch_embedding.weight"]
    out["visual.class_embedding"] = sd[f"{v}.embeddings.class_embedding"]
    out["visual.positional_embedding"] = sd[f"{v}.embeddings.position_embedding.weight"]
    out["visual.proj"] = sd["visual_projection.weight"].T
    out["token_embedding.weight"] = sd[f"{t}.embeddings.token_embedding.weight"]
    out["positional_embedding"] = sd[f"{t}.embeddings.position_embedding.weight"]
    out["text_projection"] = sd["text_projection.weight"].T
    for n in ("weight", "bias"):
        out[f"visual.ln_pre.{n}"] = sd[f"{v}.pre_layrnorm.{n}"]  # HF's own spelling
        out[f"visual.ln_post.{n}"] = sd[f"{v}.post_layernorm.{n}"]
        out[f"ln_final.{n}"] = sd[f"{t}.final_layer_norm.{n}"]
    for tower, dst in ((v, "visual.transformer"), (t, "transformer")):
        src = f"{tower}.encoder.layers"
        for i in range(_count(sd, src + ".{}.layer_norm1.weight")):
            _hf_block(sd, f"{src}.{i}", f"{dst}.resblocks.{i}", out)
    return out


def load_clip_state_dict(path: PathLike) -> StateDict:
    """A ``.pt``/``.bin``/``.safetensors`` CLIP checkpoint in either layout
    -> fp32 CPU tensors in the openai layout, for
    ``CLIPModel.load_state_dict(strict=True)``."""
    sd = strip_prefixes(read_checkpoint(path))
    if not any(k.startswith("visual.conv1") for k in sd):
        sd = clip_state_dict_from_hf(sd)
    return {k: v.float().contiguous() for k, v in sd.items()
            if k not in _UNUSED and not k.endswith("position_ids")}
