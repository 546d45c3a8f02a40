"""JAX (flax) params -> this package's state dicts.

* ``unet_state_dict_from_jax``: the pixel ``CLIPCondUNet`` in the reference
  torch names and shapes, the port's own numpy copy of
  ``clip_codec_tpu.weights.export.export_unet`` (the port imports nothing of
  the JAX package); the 4x4 transposed conv's flax ``(kh, kw, out, in)``
  becomes torch's ``(in, out, kh, kw)`` by the same transpose as a conv;
* ``sd_unet_state_dict_from_jax``, ``sd_vae_state_dict_from_jax``,
  ``sd_adapter_state_dict_from_jax``: the SD-1.5 UNet, VAE and CLIP adapter
  in diffusers' (and the reference adapter's) names and shapes, written
  here in numpy as the exact inverses of ``convert_sd_unet``,
  ``convert_sd_vae`` and ``convert_sd_adapter``
  (``clip_codec_tpu/weights/convert_sd.py``). The GEGLU ``proj`` is the
  concatenation [proj_h | proj_g].
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from .sd_checkpoint import _count

StateDict = Dict[str, torch.Tensor]


def _put(sd: Dict[str, np.ndarray], key: str, a) -> None:
    sd[key] = np.array(a, dtype=np.float32)


def _conv(sd, prefix: str, p: Mapping) -> None:
    """flax (kh, kw, in, out) -> torch (out, in, kh, kw)."""
    _put(sd, f"{prefix}.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        _put(sd, f"{prefix}.bias", p["bias"])


def _linear(sd, prefix: str, p: Mapping) -> None:
    """flax (in, out) -> torch (out, in)."""
    _put(sd, f"{prefix}.weight", np.asarray(p["kernel"]).T)
    if "bias" in p:
        _put(sd, f"{prefix}.bias", p["bias"])


def _norm(sd, prefix: str, scale, bias) -> None:
    _put(sd, f"{prefix}.weight", scale)
    _put(sd, f"{prefix}.bias", bias)


def _resnet(sd, prefix: str, p: Mapping) -> None:
    _norm(sd, f"{prefix}.norm1", p["norm1_scale"], p["norm1_bias"])
    _norm(sd, f"{prefix}.norm2", p["norm2_scale"], p["norm2_bias"])
    _conv(sd, f"{prefix}.conv1", p["conv1"])
    _conv(sd, f"{prefix}.conv2", p["conv2"])
    if "time_emb_proj" in p:
        _linear(sd, f"{prefix}.time_emb_proj", p["time_emb_proj"])
    if "conv_shortcut" in p:
        _conv(sd, f"{prefix}.conv_shortcut", p["conv_shortcut"])


def _film_resblock(sd, prefix: str, p: Mapping) -> None:
    _resnet(sd, prefix, p)
    _linear(sd, f"{prefix}.film.to_scale", p["film"]["to_scale"])
    _linear(sd, f"{prefix}.film.to_shift", p["film"]["to_shift"])


def unet_state_dict_from_jax(params: Mapping, ch_mult: Sequence[int] = (1, 2, 2)) -> StateDict:
    """``load_state_dict(strict=True)``-ready tensors for ``CLIPCondUNet``."""
    sd: Dict[str, np.ndarray] = {}
    _linear(sd, "time_proj.0", params["time_proj_0"])
    _linear(sd, "time_proj.2", params["time_proj_2"])
    _linear(sd, "z_proj.0", params["z_proj_0"])
    _conv(sd, "in_conv", params["in_conv"])
    _film_resblock(sd, "mid1", params["mid1"])
    _film_resblock(sd, "mid2", params["mid2"])
    _norm(sd, "out_norm", params["out_norm_scale"], params["out_norm_bias"])
    _conv(sd, "out", params["out"])
    for i in range(len(ch_mult)):
        _film_resblock(sd, f"down.{3 * i}", params[f"down_{i}_rb0"])
        _film_resblock(sd, f"down.{3 * i + 1}", params[f"down_{i}_rb1"])
        _conv(sd, f"down.{3 * i + 2}", params[f"down_{i}_ds"])
        _film_resblock(sd, f"up.{3 * i}", params[f"up_{i}_rb0"])
        _film_resblock(sd, f"up.{3 * i + 1}", params[f"up_{i}_rb1"])
        _conv(sd, f"up.{3 * i + 2}", params[f"up_{i}_us"])
    return _tensors(sd)


def _transformer2d(sd, prefix: str, p: Mapping) -> None:
    _norm(sd, f"{prefix}.norm", p["norm_scale"], p["norm_bias"])
    _conv(sd, f"{prefix}.proj_in", p["proj_in"])
    _conv(sd, f"{prefix}.proj_out", p["proj_out"])
    blk, b = p["block_0"], f"{prefix}.transformer_blocks.0"
    for n in ("norm1", "norm2", "norm3"):
        _norm(sd, f"{b}.{n}", blk[n]["scale"], blk[n]["bias"])
    for a in ("attn1", "attn2"):
        for name in ("to_q", "to_k", "to_v"):
            _linear(sd, f"{b}.{a}.{name}", blk[a][name])
        _linear(sd, f"{b}.{a}.to_out.0", blk[a]["to_out"])
    gh, gg = blk["ff_geglu"]["proj_h"], blk["ff_geglu"]["proj_g"]
    _linear(sd, f"{b}.ff.net.0.proj", {
        "kernel": np.concatenate([np.asarray(gh["kernel"]), np.asarray(gg["kernel"])], axis=1),
        "bias": np.concatenate([np.asarray(gh["bias"]), np.asarray(gg["bias"])]),
    })
    _linear(sd, f"{b}.ff.net.2", blk["ff_out"])


def _tensors(sd: Dict[str, np.ndarray]) -> StateDict:
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def sd_unet_state_dict_from_jax(params: Mapping) -> StateDict:
    """JAX ``SDUNet`` params -> the port's ``SDUNet`` (diffusers) state dict."""
    n = _count(params, "down_{}_res_0")
    layers = _count(params, "down_0_res_{}")
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "conv_in", params["conv_in"])
    _linear(sd, "time_embedding.linear_1", params["time_linear_1"])
    _linear(sd, "time_embedding.linear_2", params["time_linear_2"])
    for i in range(n):
        for j in range(layers):
            _resnet(sd, f"down_blocks.{i}.resnets.{j}", params[f"down_{i}_res_{j}"])
            if f"down_{i}_attn_{j}" in params:
                _transformer2d(sd, f"down_blocks.{i}.attentions.{j}", params[f"down_{i}_attn_{j}"])
        if f"down_{i}_ds" in params:
            _conv(sd, f"down_blocks.{i}.downsamplers.0.conv", params[f"down_{i}_ds"]["conv"])
    _resnet(sd, "mid_block.resnets.0", params["mid_res_0"])
    _transformer2d(sd, "mid_block.attentions.0", params["mid_attn"])
    _resnet(sd, "mid_block.resnets.1", params["mid_res_1"])
    for k in range(n):
        for j in range(layers + 1):
            _resnet(sd, f"up_blocks.{k}.resnets.{j}", params[f"up_{k}_res_{j}"])
            if f"up_{k}_attn_{j}" in params:
                _transformer2d(sd, f"up_blocks.{k}.attentions.{j}", params[f"up_{k}_attn_{j}"])
        if f"up_{k}_us" in params:
            _conv(sd, f"up_blocks.{k}.upsamplers.0.conv", params[f"up_{k}_us"]["conv"])
    _norm(sd, "conv_norm_out", params["out_norm_scale"], params["out_norm_bias"])
    _conv(sd, "conv_out", params["conv_out"])
    return _tensors(sd)


def _vae_attn(sd, prefix: str, p: Mapping) -> None:
    _norm(sd, f"{prefix}.group_norm", p["norm_scale"], p["norm_bias"])
    for name in ("to_q", "to_k", "to_v"):
        _linear(sd, f"{prefix}.{name}", p[name])
    _linear(sd, f"{prefix}.to_out.0", p["to_out"])


def _vae_half(sd, half: str, p: Mapping, tag: str, resampler: str) -> None:
    """The encoder (``tag="down"``: down_i_res_j, down_i_ds) or decoder
    (``tag="up"``: up_k_res_j, up_k_us) tree."""
    _conv(sd, f"{half}.conv_in", p["conv_in"])
    _resnet(sd, f"{half}.mid_block.resnets.0", p["mid_res_0"])
    _vae_attn(sd, f"{half}.mid_block.attentions.0", p["mid_attn"])
    _resnet(sd, f"{half}.mid_block.resnets.1", p["mid_res_1"])
    short = "ds" if tag == "down" else "us"
    for i in range(_count(p, tag + "_{}_res_0")):
        for j in range(_count(p, f"{tag}_{i}_res_" + "{}")):
            _resnet(sd, f"{half}.{tag}_blocks.{i}.resnets.{j}", p[f"{tag}_{i}_res_{j}"])
        if f"{tag}_{i}_{short}" in p:
            _conv(sd, f"{half}.{tag}_blocks.{i}.{resampler}.0.conv", p[f"{tag}_{i}_{short}"]["conv"])
    _norm(sd, f"{half}.conv_norm_out", p["out_norm_scale"], p["out_norm_bias"])
    _conv(sd, f"{half}.conv_out", p["conv_out"])


def sd_vae_state_dict_from_jax(params: Mapping) -> StateDict:
    """JAX ``AutoencoderKL`` params -> the port's (diffusers) state dict.
    JAX keeps ``quant_conv`` in the encoder and ``post_quant_conv`` in the
    decoder; diffusers keeps both at the top level."""
    enc, dec = params["encoder"], params["decoder"]
    sd: Dict[str, np.ndarray] = {}
    _vae_half(sd, "encoder", enc, "down", "downsamplers")
    _vae_half(sd, "decoder", dec, "up", "upsamplers")
    _conv(sd, "quant_conv", enc["quant_conv"])
    _conv(sd, "post_quant_conv", dec["post_quant_conv"])
    return _tensors(sd)


def sd_adapter_state_dict_from_jax(params: Mapping) -> StateDict:
    """JAX ``SDClipAdapter`` params -> the reference ``proj.0/1/3`` state dict."""
    sd: Dict[str, np.ndarray] = {}
    _norm(sd, "proj.0", params["ln"]["scale"], params["ln"]["bias"])
    _linear(sd, "proj.1", params["fc1"])
    _linear(sd, "proj.3", params["fc2"])
    return _tensors(sd)
