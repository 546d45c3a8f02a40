"""Reference-layout torch state dicts -> the JAX package's flax parameter
trees, in numpy: the port of ``clip_codec_tpu/weights/convert.py``
(``convert_unet``, ``convert_clip_cond_decoder``, ``convert_lite_decoder``)
and of ``convert_sd.convert_sd_adapter``, so the card machine, which has no JAX, writes trees that the JAX package
loads (``utils.checkpoint.save_params`` of the result is what JAX's
``save_params`` writes for its own tree).

Layout rules, as the JAX module's:

* ``nn.Linear`` (out, in) -> Dense ``kernel`` (in, out);
* ``nn.Conv2d`` (out, in, kh, kw) -> Conv ``kernel`` (kh, kw, in, out);
* ``nn.ConvTranspose2d`` (in, out, kh, kw) -> ``kernel`` (kh, kw, out, in);
* GroupNorm weight/bias -> ``*_scale`` / ``*_bias``;

every array fp32 numpy. The port's own state dicts are in this layout.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().float().numpy()


def linear(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {
        "kernel": _np(sd[f"{prefix}.weight"]).T.astype(np.float32),
        "bias": _np(sd[f"{prefix}.bias"]).astype(np.float32),
    }


def conv(sd: Mapping, prefix: str, bias: bool = True) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0).astype(np.float32)}
    if bias:
        out["bias"] = _np(sd[f"{prefix}.bias"]).astype(np.float32)
    return out


conv_transpose = conv  # (in, out, kh, kw) -> (kh, kw, out, in): the same transpose


def group_norm_pair(sd: Mapping, prefix: str) -> Tuple[np.ndarray, np.ndarray]:
    return (_np(sd[f"{prefix}.weight"]).astype(np.float32), _np(sd[f"{prefix}.bias"]).astype(np.float32))


def _resblock(sd: Mapping, prefix: str) -> Dict:
    n1s, n1b = group_norm_pair(sd, f"{prefix}.norm1")
    n2s, n2b = group_norm_pair(sd, f"{prefix}.norm2")
    return {
        "norm1_scale": n1s,
        "norm1_bias": n1b,
        "norm2_scale": n2s,
        "norm2_bias": n2b,
        "conv1": conv(sd, f"{prefix}.conv1"),
        "conv2": conv(sd, f"{prefix}.conv2"),
        "film": {
            "to_scale": linear(sd, f"{prefix}.film.to_scale"),
            "to_shift": linear(sd, f"{prefix}.film.to_shift"),
        },
    }


def strip_prefixes(sd: Mapping) -> Dict[str, object]:
    """Container dicts (``state_dict``, ``model``, ``adapter``) unwrapped and
    ``module.`` / ``adapter.`` key prefixes dropped."""
    for key in ("state_dict", "model", "adapter"):
        if key in sd and isinstance(sd[key], Mapping):
            sd = sd[key]
    out = {}
    for k, v in sd.items():
        for pref in ("module.", "adapter."):
            if k.startswith(pref):
                k = k[len(pref):]
        out[k] = v
    return out


def convert_unet(sd: Mapping, ch_mult: Sequence[int] = (1, 2, 2)) -> Dict:
    """A ``CLIPCondUNet`` state dict -> the JAX ``CLIPCondUNet`` tree."""
    sd = strip_prefixes(sd)
    params: Dict = {
        "time_proj_0": linear(sd, "time_proj.0"),
        "time_proj_2": linear(sd, "time_proj.2"),
        "z_proj_0": linear(sd, "z_proj.0"),
        "in_conv": conv(sd, "in_conv"),
        "mid1": _resblock(sd, "mid1"),
        "mid2": _resblock(sd, "mid2"),
        "out": conv(sd, "out"),
    }
    params["out_norm_scale"], params["out_norm_bias"] = group_norm_pair(sd, "out_norm")
    for i in range(len(ch_mult)):
        params[f"down_{i}_rb0"] = _resblock(sd, f"down.{3 * i}")
        params[f"down_{i}_rb1"] = _resblock(sd, f"down.{3 * i + 1}")
        params[f"down_{i}_ds"] = conv(sd, f"down.{3 * i + 2}")
        params[f"up_{i}_rb0"] = _resblock(sd, f"up.{3 * i}")
        params[f"up_{i}_rb1"] = _resblock(sd, f"up.{3 * i + 1}")
        params[f"up_{i}_us"] = conv_transpose(sd, f"up.{3 * i + 2}")
    return params


def _dwconv(sd: Mapping, prefix: str) -> Dict:
    gs, gb = group_norm_pair(sd, f"{prefix}.gn")
    return {"dw": conv(sd, f"{prefix}.dw", bias=False), "pw": conv(sd, f"{prefix}.pw", bias=False),
            "gn_scale": gs, "gn_bias": gb}


def convert_clip_cond_decoder(sd: Mapping, base: int = 192, out_size: int = 512) -> Dict:
    """A ``CLIPCondDecoder`` state dict -> the JAX tree (stage i at
    ``up.{3i}`` and ``up.{3i+2}``; ``up.{3i+1}`` is the parameter-free
    upsample)."""
    from ..models.decoders import CLIPCondDecoder

    sd = strip_prefixes(sd)
    plan, _ = CLIPCondDecoder.stage_plan(base, out_size)
    params: Dict = {"fc": linear(sd, "fc.0"), "to_img": conv(sd, "to_img.0")}
    for i in range(len(plan)):
        params[f"up_{i}_a"] = _dwconv(sd, f"up.{3 * i}")
        params[f"up_{i}_b"] = _dwconv(sd, f"up.{3 * i + 2}")
    return params


def convert_lite_decoder(sd: Mapping) -> Dict:
    """A ``FeatureToImageDecoderLite`` state dict -> the JAX tree (each
    block's convs at indices 0 and 3, GroupNorms at 1 and 4)."""
    sd = strip_prefixes(sd)
    params: Dict = {"fc": linear(sd, "fc.0"), "to_img": conv(sd, "to_img.0")}
    for name in ("up1", "up2", "up3"):
        for k, (ci, gi) in enumerate([(0, 1), (3, 4)]):
            params[f"{name}_conv{k}"] = conv(sd, f"{name}.{ci}")
            params[f"{name}_gn{k}_scale"], params[f"{name}_gn{k}_bias"] = group_norm_pair(sd, f"{name}.{gi}")
    return params


def convert_sd_adapter(sd: Mapping) -> Dict:
    """A reference ``SDClipAdapter`` state dict (``proj.0/1/3``, bare or
    under ``adapter``) -> the JAX adapter tree
    (``clip_codec_tpu/weights/convert_sd.py`` ``convert_sd_adapter``)."""
    sd = strip_prefixes(sd)
    scale, bias = group_norm_pair(sd, "proj.0")
    return {"ln": {"scale": scale, "bias": bias}, "fc1": linear(sd, "proj.1"), "fc2": linear(sd, "proj.3")}
