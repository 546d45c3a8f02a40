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
  concatenation [proj_h | proj_g];
* ``clip_state_dict_from_jax``: the CLIP towers in the openai layout, the
  inverse of ``convert_clip_openai`` (``clip_codec_tpu/weights/convert_clip.py``):
  q/k/v fused into ``in_proj_weight`` (3D, D), the patch conv's flax HWIO
  kernel as torch's OIHW, the projections kept as ``x @ proj``;
* ``dino_state_dict_from_jax``: the DINOv2 tower in the port's names, the
  same block map plus the LayerScale vectors ``ls1``/``ls2``;
* ``clip_cond_decoder_state_dict_from_jax``, ``lite_decoder_state_dict_from_jax``,
  ``dwconv_state_dict_from_jax``, ``attn_block_state_dict_from_jax``: the
  direct decoders and their blocks in the reference names (the inverses of
  ``convert_clip_cond_decoder`` / ``convert_lite_decoder``);
* ``unet_quant_from_jax``, ``sd_unet_quant_from_jax``: a JAX int8
  ``'quant'`` collection (each int8 layer's calibrated ``x_absmax``) as the
  port's quant dict (``ops/int8.py``), keyed by the same module names as
  the state dicts. JAX's GEGLU has two projections, ``proj_h`` and
  ``proj_g``, that read the same input and so record the same absmax; the
  port's one fused ``proj`` takes it, after a check that the two agree.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

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


def unet_state_dict_from_jax(params: Mapping, ch_mult: Optional[Sequence[int]] = None) -> StateDict:
    """``load_state_dict(strict=True)``-ready tensors for ``CLIPCondUNet``;
    ``ch_mult`` gives the number of levels (None: counted in the tree)."""
    if ch_mult is None:
        ch_mult = range(_count(params, "down_{}_rb0"))
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


def _dwconv(sd, prefix: str, p: Mapping) -> None:
    _conv(sd, f"{prefix}.dw", p["dw"])
    _conv(sd, f"{prefix}.pw", p["pw"])
    _norm(sd, f"{prefix}.gn", p["gn_scale"], p["gn_bias"])


def dwconv_state_dict_from_jax(params: Mapping) -> StateDict:
    """JAX ``DWConvBlock`` params -> the port's (``dw``, ``pw``, ``gn``)."""
    sd: Dict[str, np.ndarray] = {}
    _dwconv(sd, "", params)
    return _tensors({k[1:]: v for k, v in sd.items()})


def attn_block_state_dict_from_jax(params: Mapping) -> StateDict:
    """JAX ``AttnBlock`` params -> the port's (``q``, ``kv``, ``proj``)."""
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "q", params["q"])
    _linear(sd, "kv", params["kv"])
    _conv(sd, "proj", params["proj"])
    return _tensors(sd)


def clip_cond_decoder_state_dict_from_jax(params: Mapping) -> StateDict:
    """JAX ``CLIPCondDecoder`` params -> the reference layout (stage i at
    ``up.{3i}`` and ``up.{3i+2}``)."""
    sd: Dict[str, np.ndarray] = {}
    _linear(sd, "fc.0", params["fc"])
    _conv(sd, "to_img.0", params["to_img"])
    for i in range(_count(params, "up_{}_a")):
        _dwconv(sd, f"up.{3 * i}", params[f"up_{i}_a"])
        _dwconv(sd, f"up.{3 * i + 2}", params[f"up_{i}_b"])
    return _tensors(sd)


def lite_decoder_state_dict_from_jax(params: Mapping) -> StateDict:
    """JAX ``FeatureToImageDecoderLite`` params -> the reference layout."""
    sd: Dict[str, np.ndarray] = {}
    _linear(sd, "fc.0", params["fc"])
    _conv(sd, "to_img.0", params["to_img"])
    for name in ("up1", "up2", "up3"):
        for k, (ci, gi) in enumerate([(0, 1), (3, 4)]):
            _conv(sd, f"{name}.{ci}", params[f"{name}_conv{k}"])
            _norm(sd, f"{name}.{gi}", params[f"{name}_gn{k}_scale"], params[f"{name}_gn{k}_bias"])
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


def _encoder_blocks(sd, prefix: str, blocks: Mapping) -> None:
    """A JAX ``Transformer`` (block_i: ln1, attn.{q,k,v,out}_proj, ln2,
    fc1, fc2, and ls1, ls2 with LayerScale) -> ``{prefix}resblocks.i.*``,
    q/k/v fused."""
    for i in range(_count(blocks, "block_{}")):
        b, p = f"{prefix}resblocks.{i}", blocks[f"block_{i}"]
        a = p["attn"]
        _norm(sd, f"{b}.ln_1", p["ln1"]["scale"], p["ln1"]["bias"])
        _put(sd, f"{b}.attn.in_proj_weight",
             np.concatenate([np.asarray(a[f"{n}_proj"]["kernel"]).T for n in "qkv"]))
        _put(sd, f"{b}.attn.in_proj_bias", np.concatenate([np.asarray(a[f"{n}_proj"]["bias"]) for n in "qkv"]))
        _linear(sd, f"{b}.attn.out_proj", a["out_proj"])
        _norm(sd, f"{b}.ln_2", p["ln2"]["scale"], p["ln2"]["bias"])
        _linear(sd, f"{b}.mlp.c_fc", p["fc1"])
        _linear(sd, f"{b}.mlp.c_proj", p["fc2"])
        for ls in ("ls1", "ls2"):
            if ls in p:
                _put(sd, f"{b}.{ls}", p[ls])


def clip_state_dict_from_jax(params: Mapping) -> StateDict:
    """JAX ``CLIPModel`` params ({"visual", "text"}, or under "params") ->
    the port's openai-layout ``CLIPModel`` state dict."""
    params = params.get("params", params)
    v, t = params["visual"], params["text"]
    sd: Dict[str, np.ndarray] = {}
    _put(sd, "visual.conv1.weight", np.asarray(v["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    _put(sd, "visual.class_embedding", v["class_embedding"])
    _put(sd, "visual.positional_embedding", v["position_embedding"])
    _norm(sd, "visual.ln_pre", v["pre_ln"]["scale"], v["pre_ln"]["bias"])
    _encoder_blocks(sd, "visual.transformer.", v["encoder"])
    _norm(sd, "visual.ln_post", v["post_ln"]["scale"], v["post_ln"]["bias"])
    _put(sd, "visual.proj", v["visual_projection"])
    _put(sd, "token_embedding.weight", t["token_embedding"]["embedding"])
    _put(sd, "positional_embedding", t["position_embedding"])
    _encoder_blocks(sd, "transformer.", t["encoder"])
    _norm(sd, "ln_final", t["final_ln"]["scale"], t["final_ln"]["bias"])
    _put(sd, "text_projection", t["text_projection"])
    return _tensors(sd)


def dino_state_dict_from_jax(params: Mapping) -> StateDict:
    """JAX ``DinoV2`` params (or under "params") -> the port's ``DinoV2``
    state dict."""
    p = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "patch_embed", p["patch_embed"])
    _put(sd, "cls_token", p["cls_token"])
    _put(sd, "position_embeddings", p["position_embeddings"])
    _encoder_blocks(sd, "encoder.", p["encoder"])
    _norm(sd, "final_ln", p["final_ln"]["scale"], p["final_ln"]["bias"])
    return _tensors(sd)


def _absmax(p: Mapping) -> torch.Tensor:
    return torch.from_numpy(np.array(p["x_absmax"], dtype=np.float32).reshape(()))


def _resnet_quant(q: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    for name in ("conv1", "conv2", "conv_shortcut"):
        if name in p:
            q[f"{prefix}.{name}"] = _absmax(p[name])


def unet_quant_from_jax(quant: Mapping, ch_mult: Sequence[int] = (1, 2, 2)) -> Dict[str, torch.Tensor]:
    """A JAX ``CLIPCondUNet`` quant collection -> the port's quant dict."""
    q: Dict[str, torch.Tensor] = {}
    _resnet_quant(q, "mid1", quant["mid1"])
    _resnet_quant(q, "mid2", quant["mid2"])
    for i in range(len(ch_mult)):
        for j in range(2):
            _resnet_quant(q, f"down.{3 * i + j}", quant[f"down_{i}_rb{j}"])
            _resnet_quant(q, f"up.{3 * i + j}", quant[f"up_{i}_rb{j}"])
        q[f"down.{3 * i + 2}"] = _absmax(quant[f"down_{i}_ds"])
    return q


def _transformer2d_quant(q: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    q[f"{prefix}.proj_in"] = _absmax(p["proj_in"])
    q[f"{prefix}.proj_out"] = _absmax(p["proj_out"])
    blk, b = p["block_0"], f"{prefix}.transformer_blocks.0"
    for a in ("attn1", "attn2"):
        for name in ("to_q", "to_k", "to_v"):
            q[f"{b}.{a}.{name}"] = _absmax(blk[a][name])
        q[f"{b}.{a}.to_out.0"] = _absmax(blk[a]["to_out"])
    h, g = _absmax(blk["ff_geglu"]["proj_h"]), _absmax(blk["ff_geglu"]["proj_g"])
    if not torch.equal(h, g):
        raise ValueError(f"{b}: GEGLU proj_h and proj_g recorded different absmax ({h.item()} vs {g.item()}); "
                         f"the fused projection takes one")
    q[f"{b}.ff.net.0.proj"] = h
    q[f"{b}.ff.net.2"] = _absmax(blk["ff_out"])


def sd_unet_quant_from_jax(quant: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``SDUNet`` quant collection -> the port's quant dict."""
    n = _count(quant, "down_{}_res_0")
    layers = _count(quant, "down_0_res_{}")
    q: Dict[str, torch.Tensor] = {}
    for i in range(n):
        for j in range(layers):
            _resnet_quant(q, f"down_blocks.{i}.resnets.{j}", quant[f"down_{i}_res_{j}"])
            if f"down_{i}_attn_{j}" in quant:
                _transformer2d_quant(q, f"down_blocks.{i}.attentions.{j}", quant[f"down_{i}_attn_{j}"])
        if f"down_{i}_ds" in quant:
            q[f"down_blocks.{i}.downsamplers.0.conv"] = _absmax(quant[f"down_{i}_ds"]["conv"])
    _resnet_quant(q, "mid_block.resnets.0", quant["mid_res_0"])
    _transformer2d_quant(q, "mid_block.attentions.0", quant["mid_attn"])
    _resnet_quant(q, "mid_block.resnets.1", quant["mid_res_1"])
    for k in range(n):
        for j in range(layers + 1):
            _resnet_quant(q, f"up_blocks.{k}.resnets.{j}", quant[f"up_{k}_res_{j}"])
            if f"up_{k}_attn_{j}" in quant:
                _transformer2d_quant(q, f"up_blocks.{k}.attentions.{j}", quant[f"up_{k}_attn_{j}"])
        if f"up_{k}_us" in quant:
            q[f"up_blocks.{k}.upsamplers.0.conv"] = _absmax(quant[f"up_{k}_us"]["conv"])
    return q
