"""Read Stable-Diffusion checkpoints for the port: diffusers ``UNet2DConditionModel``
and ``AutoencoderKL`` state dicts and the reference adapter's ``proj.0/1/3``.

The port's SD modules carry diffusers' names and shapes, so a checkpoint
loads with ``load_state_dict(strict=True)`` after the same tolerant
unwrapping the JAX converter applies (``clip_codec_tpu/weights/convert_sd.py``):
container dicts and ``module.``/``adapter.`` prefixes, the legacy VAE
attention names (``norm``/``query``/``key``/``value``/``proj_attn``) and
legacy 1x1-conv attention weights. The architecture is read off the weight
shapes; only the UNet's head count is not recoverable from them.

``load_unet``, ``load_vae`` and ``load_adapter`` also take the JAX
package's ``.msgpack`` trees: its converted UNet and VAE trees
(``save_params`` of ``convert_sd_unet`` / ``convert_sd_vae``, which its
``load_sd_params`` reads) and its trained adapters
(``sd_adapter_*.msgpack``), mapped by ``weights/from_jax.py``.

Nothing here imports jax: the card machine loads diffusers files directly.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from ..models.sd.unet import SDUNetConfig
from ..models.sd.vae import VAEConfig

PathLike = Union[str, Path]
UNET_ENV = "CLIP_CODEC_SD_UNET_WEIGHTS"
VAE_ENV = "CLIP_CODEC_SD_VAE_WEIGHTS"

_VAE_LEGACY = (("norm", "group_norm"), ("query", "to_q"), ("key", "to_k"), ("value", "to_v"),
               ("proj_attn", "to_out.0"))


def strip_prefixes(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Unwrap ``state_dict``/``model``/``adapter`` containers and drop
    ``module.``/``adapter.`` key prefixes (``convert.strip_prefixes``)."""
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


def read_checkpoint(path: PathLike) -> Dict[str, torch.Tensor]:
    """A torch ``.bin``/``.pt`` file, or ``.safetensors`` where the
    ``safetensors`` package is installed, as a dict of CPU tensors."""
    path = Path(path)
    if path.suffix == ".msgpack":
        raise ValueError(f"{path}: a flax (.msgpack) tree, not a torch checkpoint: read it with "
                         "load_unet / load_vae / load_adapter")
    if path.suffix == ".safetensors":
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError(f"{path}: reading .safetensors needs the safetensors package") from e
        return load_file(str(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path} does not hold a state dict")
    return dict(sd)


def _squeeze_1x1(sd: Dict[str, torch.Tensor], key: str) -> None:
    if sd[key].dim() == 4:  # legacy 1x1-conv attention weight
        sd[key] = sd[key][:, :, 0, 0]


def unet_state_dict(raw: Mapping) -> Dict[str, torch.Tensor]:
    """A diffusers UNet checkpoint as the port's ``SDUNet`` state dict."""
    sd = strip_prefixes(raw)
    for k in list(sd):
        if k.endswith((".to_q.weight", ".to_k.weight", ".to_v.weight")):
            _squeeze_1x1(sd, k)
    return sd


def vae_state_dict(raw: Mapping) -> Dict[str, torch.Tensor]:
    """A diffusers VAE checkpoint as the port's ``AutoencoderKL`` state
    dict; legacy mid-block attention names are renamed."""
    sd = strip_prefixes(raw)
    for half in ("encoder", "decoder"):
        p = f"{half}.mid_block.attentions.0"
        if f"{p}.query.weight" in sd:
            for old, new in _VAE_LEGACY:
                for leaf in ("weight", "bias"):
                    sd[f"{p}.{new}.{leaf}"] = sd.pop(f"{p}.{old}.{leaf}")
        for name in ("to_q", "to_k", "to_v", "to_out.0"):
            _squeeze_1x1(sd, f"{p}.{name}.weight")
    return sd


def adapter_state_dict(raw: Mapping) -> Dict[str, torch.Tensor]:
    """A reference adapter checkpoint (``{'adapter': ...}`` or bare) as the
    port's ``SDClipAdapter`` state dict."""
    return strip_prefixes(raw)


def _load(path: PathLike, from_jax: str, from_torch):
    path = Path(path)
    if path.suffix == ".msgpack":
        from ..utils.checkpoint import float_leaves, load_params
        from . import from_jax as fj

        return getattr(fj, from_jax)(float_leaves(load_params(path)))
    return from_torch(read_checkpoint(path))


def load_unet(path: PathLike) -> Dict[str, torch.Tensor]:
    """The port's ``SDUNet`` state dict from a diffusers checkpoint or a JAX ``.msgpack`` tree."""
    return _load(path, "sd_unet_state_dict_from_jax", unet_state_dict)


def load_vae(path: PathLike) -> Dict[str, torch.Tensor]:
    """The port's ``AutoencoderKL`` state dict from a diffusers checkpoint or a JAX ``.msgpack`` tree."""
    return _load(path, "sd_vae_state_dict_from_jax", vae_state_dict)


def load_adapter(path: PathLike) -> Dict[str, torch.Tensor]:
    """The ``SDClipAdapter`` state dict from a ``.pt`` (the port's trainer,
    the reference) or a JAX ``sd_adapter_*.msgpack``."""
    return _load(path, "sd_adapter_state_dict_from_jax", adapter_state_dict)


def _count(sd: Mapping, fmt: str) -> int:
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


def unet_config(sd: Mapping, heads: int = 8) -> SDUNetConfig:
    """The UNet architecture from a converted state dict's shapes."""
    n = _count(sd, "down_blocks.{}.resnets.0.conv1.weight")
    return SDUNetConfig(
        in_ch=int(sd["conv_in.weight"].shape[1]),
        out_ch=int(sd["conv_out.weight"].shape[0]),
        block_out=tuple(int(sd[f"down_blocks.{i}.resnets.0.conv1.weight"].shape[0]) for i in range(n)),
        layers_per_block=_count(sd, "down_blocks.0.resnets.{}.conv1.weight"),
        cross_dim=int(sd["mid_block.attentions.0.transformer_blocks.0.attn2.to_k.weight"].shape[1]),
        heads=heads,
        freq_dim=int(sd["time_embedding.linear_1.weight"].shape[1]),
    )


def vae_config(sd: Mapping) -> VAEConfig:
    """The VAE architecture from a converted state dict's shapes."""
    n = _count(sd, "encoder.down_blocks.{}.resnets.0.conv1.weight")
    return VAEConfig(
        block_out=tuple(int(sd[f"encoder.down_blocks.{i}.resnets.0.conv1.weight"].shape[0]) for i in range(n)),
        layers_per_block=_count(sd, "encoder.down_blocks.0.resnets.{}.conv1.weight"),
        latent_ch=int(sd["quant_conv.weight"].shape[0]) // 2,
    )


def adapter_dims(sd: Mapping) -> Tuple[int, int]:
    """(in_dim, hidden) of an adapter state dict."""
    fc1 = sd["proj.1.weight"]
    return int(fc1.shape[1]), int(fc1.shape[0])


def require_sd_weight_paths(model_name: Optional[str] = None) -> Tuple[str, str]:
    """The (unet, vae) checkpoint paths from the environment, or a
    RuntimeError that says how to set them."""
    unet_path, vae_path = os.environ.get(UNET_ENV), os.environ.get(VAE_ENV)
    if not unet_path or not vae_path:
        what = f" for {model_name}" if model_name else ""
        raise RuntimeError(
            f"SD weights not configured. Point {UNET_ENV} and {VAE_ENV} at the diffusers "
            f"SD-1.5 UNet and VAE checkpoints{what} (.bin/.pt, or .safetensors with the "
            "safetensors package installed).")
    return unet_path, vae_path
