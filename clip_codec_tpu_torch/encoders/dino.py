"""DINOv2 image tower — the port of ``clip_codec_tpu/encoders/dino.py``, the
alternative compression front end.

``DINOV2_BASE`` is DINOv2 ViT-B/14 (timm's ``vit_base_patch14_dinov2.lvd142m``):
518px, 14px patches (37 x 37 + CLS = 1370 tokens), a 12x768 tower with 12
heads, an exact-GELU MLP of 3072, LayerScale, LayerNorm eps 1e-6. The output
is the final LayerNorm's CLS row, unnormalized, as timm's ``num_classes=0``
pooling gives it. Images are NHWC; the patch embedding is a stride-14 conv
whose tokens come out in row-major (h, w) order, as flax's NHWC conv gives
them. The fp32 ``cls_token`` and ``position_embeddings`` are cast to the
compute dtype; from the first block on the residual stream is fp32
(``encoders/transformer.py``).

Parameter names: ``patch_embed``, ``cls_token``, ``position_embeddings``,
``encoder.resblocks.{i}`` (the CLIP blocks' openai names plus ``ls1``,
``ls2``) and ``final_ln``; ``weights/convert_dino.py`` maps a HuggingFace
``Dinov2Model`` state dict onto them.

Host preprocessing (``preprocess_dino``) is the reference's: a bilinear
resize to 518 with half-pixel centres and no antialias (``F.interpolate``'s
``align_corners=False``), then ImageNet mean/std, in fp32 on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.blocks import cast
from ..models.sd.decoder import clip_m11
from ..models.sd.layers import layer_norm
from .transformer import Transformer

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


@dataclass(frozen=True)
class DinoConfig:
    image_size: int = 518
    patch_size: int = 14
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    eps: float = 1e-6


DINOV2_BASE = DinoConfig()


def dino_flops(cfg: DinoConfig, batch: int) -> int:
    """Multiply-adds x 2 of one tower forward at ``batch`` images: the patch
    conv, each block's four projections, two MLP products and the two
    attention products over all 1 + (image/patch)^2 tokens."""
    n, d = (cfg.image_size // cfg.patch_size) ** 2, cfg.dim
    m = d * cfg.mlp_ratio
    patch = 2 * n * 3 * cfg.patch_size ** 2 * d
    block = 2 * (n + 1) * d * (4 * d + 2 * m) + 2 * 2 * (n + 1) ** 2 * d
    return batch * (patch + cfg.depth * block)


class DinoV2(nn.Module):
    """``dtype`` is the compute dtype; parameters stay fp32. Load a
    checkpoint (``weights/convert_dino.py``) or draw weights with
    ``init_params``."""

    def __init__(self, cfg: DinoConfig = DINOV2_BASE, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        c = cfg
        self.cfg, self.dtype = c, dtype
        n_pos = (c.image_size // c.patch_size) ** 2 + 1
        self.patch_embed = nn.Conv2d(3, c.dim, c.patch_size, stride=c.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.dim))
        self.position_embeddings = nn.Parameter(torch.zeros(1, n_pos, c.dim))
        self.encoder = Transformer(c.dim, c.depth, c.heads, c.dim * c.mlp_ratio, eps=c.eps, act=F.gelu,
                                   layer_scale=True)
        self.final_ln = nn.LayerNorm(c.dim, eps=c.eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: (B, H, W, 3) ImageNet-normalized -> (B, dim) CLS
        embedding in the compute dtype."""
        dtype = self.dtype
        B = pixels.shape[0]
        p = F.conv2d(pixels.to(dtype).permute(0, 3, 1, 2), cast(self.patch_embed, "weight", dtype),
                     cast(self.patch_embed, "bias", dtype), stride=self.cfg.patch_size)
        p = p.flatten(2).transpose(1, 2)  # (B, N, D), tokens in row-major (h, w)
        cls = cast(self, "cls_token", dtype).expand(B, 1, self.cfg.dim)
        x = torch.cat([cls, p], dim=1) + cast(self, "position_embeddings", dtype)
        x = self.encoder(x, None, dtype)
        return layer_norm(self.final_ln, x[:, 0], dtype)


@torch.no_grad()
def init_params(model: DinoV2, generator: Optional[torch.Generator] = None) -> DinoV2:
    """Random weights drawn from ``generator`` for a run without a
    checkpoint: ``encoders.clip.init_params`` (matrices and embeddings
    normal(0, 0.02), biases 0, LayerNorm 1 and 0), then LayerScale 1, the
    ``layerscale_value`` HuggingFace's ``Dinov2Config`` starts from."""
    from .clip import init_params as init_matrices

    init_matrices(model, generator)
    for blk in model.encoder.resblocks:
        blk.ls1.fill_(1.0)
        blk.ls2.fill_(1.0)
    return model


def _resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, size, size, C), bilinear with half-pixel centres
    and no antialias (``jax.image.resize(..., antialias=False)``)."""
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear", align_corners=False,
                      antialias=False)
    return x.permute(0, 2, 3, 1)


def preprocess_dino(img_m01: np.ndarray, image_size: int = 518) -> np.ndarray:
    """(H, W, 3) float in [0, 1] -> (image_size, image_size, 3) fp32:
    bilinear resize, then ImageNet mean/std, on the host."""
    x = _resize(torch.from_numpy(np.asarray(img_m01, np.float32))[None], image_size)[0].numpy()
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def embed_m11_images_dino(model: DinoV2, images_m11: torch.Tensor, image_size: int = 518) -> torch.Tensor:
    """The DINO-alignment input path of the SD trainer and the inversion
    backend: [-1, 1] NHWC images clipped (``clip_m11``: a tie's gradient is
    JAX's 0.5), mapped to [0, 1], resized bilinear to ``image_size`` (no
    antialias), ImageNet-normalized in fp32, then the tower's unnormalized
    CLS in fp32. Differentiable in the images."""
    x = _resize((clip_m11(images_m11.float()) + 1.0) / 2.0, image_size)
    x = (x - torch.from_numpy(IMAGENET_MEAN).to(x.device)) / torch.from_numpy(IMAGENET_STD).to(x.device)
    return model(x).float()
