"""CLIP (ViT image tower + causal text tower) — the port of
``clip_codec_tpu/encoders/clip.py``, the compression front-end.

``VIT_B_32`` is ViT-B/32: 224px, 32px patches (50 tokens), a 12x768 vision
tower with QuickGELU, a 12x512 causal text tower over a 77-token context
and a 49408-token vocabulary, a 512-d joint space. The modules carry the
openai / open_clip state-dict names (``visual.conv1``, ``visual.proj``,
``token_embedding``, ``ln_final``, ...), so such a checkpoint loads as it is
(``weights/convert_clip.py`` also maps HuggingFace's ``CLIPModel`` layout).
Images are NHWC; the patch embedding is a stride-p conv whose tokens come
out in row-major (h, w) order, as flax's NHWC conv gives them.

Host preprocessing is the open_clip eval transform (BICUBIC resize of the
short side, center crop, CLIP mean/std); ``clip_normalize_table`` is the
exact fp32 normalization of every uint8 value, which ``ClipEncoder``
gathers on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image
from torch import nn

from ..models.blocks import cast
from ..models.sd.layers import layer_norm
from .transformer import Transformer

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


@dataclass(frozen=True)
class CLIPConfig:
    image_size: int = 224
    patch_size: int = 32
    vision_dim: int = 768
    vision_depth: int = 12
    vision_heads: int = 12
    vision_mlp: int = 3072
    text_dim: int = 512
    text_depth: int = 12
    text_heads: int = 8
    text_mlp: int = 2048
    vocab_size: int = 49408
    context_length: int = 77
    embed_dim: int = 512
    eos_token_id: int = 49407


VIT_B_32 = CLIPConfig()


def vision_flops(cfg: CLIPConfig, batch: int) -> int:
    """Multiply-adds x 2 of one image-tower forward at ``batch`` images:
    the patch conv, each block's four projections, two MLP products and
    the two attention products, and the output projection."""
    n, d, m = (cfg.image_size // cfg.patch_size) ** 2, cfg.vision_dim, cfg.vision_mlp
    patch = 2 * n * 3 * cfg.patch_size ** 2 * d
    block = 2 * (n + 1) * d * (4 * d + 2 * m) + 2 * 2 * (n + 1) ** 2 * d
    return batch * (patch + cfg.vision_depth * block + 2 * d * cfg.embed_dim)


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        c = cfg
        self.cfg, self.dtype = c, dtype
        n_pos = (c.image_size // c.patch_size) ** 2 + 1
        self.conv1 = nn.Conv2d(3, c.vision_dim, c.patch_size, stride=c.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(c.vision_dim))
        self.positional_embedding = nn.Parameter(torch.zeros(n_pos, c.vision_dim))
        self.ln_pre = nn.LayerNorm(c.vision_dim)
        self.transformer = Transformer(c.vision_dim, c.vision_depth, c.vision_heads, c.vision_mlp)
        self.ln_post = nn.LayerNorm(c.vision_dim)
        self.proj = nn.Parameter(torch.zeros(c.vision_dim, c.embed_dim))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: (B, H, W, 3) normalized -> (B, embed_dim) unnormalized
        features in the compute dtype."""
        dtype = self.dtype
        B = pixels.shape[0]
        D = self.cfg.vision_dim
        p = F.conv2d(pixels.to(dtype).permute(0, 3, 1, 2), cast(self.conv1, "weight", dtype),
                     stride=self.cfg.patch_size)
        p = p.flatten(2).transpose(1, 2)  # (B, N, D), tokens in row-major (h, w)
        cls = cast(self, "class_embedding", dtype).expand(B, 1, D)
        x = torch.cat([cls, p], dim=1) + cast(self, "positional_embedding", dtype)[None]
        x = layer_norm(self.ln_pre, x, dtype)
        x = self.transformer(x, None, dtype)
        cls_out = layer_norm(self.ln_post, x[:, 0], dtype)
        return cls_out @ cast(self, "proj", dtype)


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        c = cfg
        self.cfg, self.dtype = c, dtype
        self.token_embedding = nn.Embedding(c.vocab_size, c.text_dim)
        self.positional_embedding = nn.Parameter(torch.zeros(c.context_length, c.text_dim))
        self.transformer = Transformer(c.text_dim, c.text_depth, c.text_heads, c.text_mlp)
        self.ln_final = nn.LayerNorm(c.text_dim)
        self.text_projection = nn.Parameter(torch.zeros(c.text_dim, c.embed_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, L) int -> (B, embed_dim) unnormalized features in the
        compute dtype, taken at the first position of the largest id (the EOT)."""
        dtype = self.dtype
        B, L = tokens.shape
        tokens = tokens.long()
        x = F.embedding(tokens, cast(self.token_embedding, "weight", dtype))
        x = x + cast(self, "positional_embedding", dtype)[None, :L]
        mask = torch.triu(torch.full((L, L), -math.inf, device=x.device), diagonal=1)
        x = self.transformer(x, mask, dtype)
        x = layer_norm(self.ln_final, x, dtype)
        feats = x[torch.arange(B, device=x.device), tokens.argmax(dim=-1)]
        return feats @ cast(self, "text_projection", dtype)


class CLIPModel(CLIPTextTower):
    """Both towers in the openai layout: the text tower's parameters at the
    top level (hence the base class), the image tower under ``visual``.
    ``dtype`` is the compute dtype; parameters stay fp32. Load a checkpoint
    (``weights/convert_clip.py``) or draw weights with ``init_params``."""

    def __init__(self, cfg: CLIPConfig = VIT_B_32, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(cfg, dtype)
        self.visual = CLIPVisionTower(cfg, dtype)

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.visual(pixels)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return CLIPTextTower.forward(self, tokens)

    def forward(self, pixels: torch.Tensor, tokens: torch.Tensor):
        return self.encode_image(pixels), self.encode_text(tokens)


@torch.no_grad()
def init_params(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Random weights drawn from ``generator`` for a run without a
    checkpoint: every matrix and embedding normal(0, 0.02) (positional
    embeddings 0.01), biases 0, LayerNorm scale 1 and shift 0, which keeps
    the activations O(1) through ViT-B/32's 12 blocks."""
    norms = {id(p) for m in model.modules() if isinstance(m, nn.LayerNorm) for p in (m.weight, m.bias)}
    for name, p in model.named_parameters():
        if id(p) in norms:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.normal_(0.0, 0.01 if "positional" in name else 0.02, generator=generator)
    return model


# ---------------------------------------------------------------- preprocessing

def preprocess_pil_u8(img: Image.Image, image_size: int = 224) -> np.ndarray:
    """open_clip eval transform, geometry only: short-side BICUBIC resize +
    center crop -> (H, W, 3) uint8."""
    w, h = img.size
    # torchvision truncates the scaled long side with int(), not round()
    if w <= h:
        new_w, new_h = image_size, int(image_size * h / w)
    else:
        new_w, new_h = int(image_size * w / h), image_size
    # resize -> center crop -> THEN convert to RGB, as open_clip orders them
    img = img.resize((new_w, new_h), Image.BICUBIC)
    w, h = img.size
    # torchvision center_crop rounds half to even: (dim - crop) % 4 == 3 differs from floor
    left = int(round((w - image_size) / 2.0))
    top = int(round((h - image_size) / 2.0))
    img = img.crop((left, top, left + image_size, top + image_size)).convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def clip_normalize_table() -> np.ndarray:
    """(256, 3) float32: ``table[v, c]`` is exactly the host's
    ``((v / 255.0) - CLIP_MEAN[c]) / CLIP_STD[c]`` for every uint8 value, so
    a device gather reproduces host normalization bit for bit."""
    v = (np.arange(256, dtype=np.float32) / 255.0)[:, None]
    return ((v - CLIP_MEAN) / CLIP_STD).astype(np.float32)


def preprocess_pil(img: Image.Image, image_size: int = 224) -> np.ndarray:
    """open_clip eval transform on the host -> (H, W, 3) float32."""
    arr = preprocess_pil_u8(img, image_size).astype(np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def normalize_u8(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 3) pixels -> fp32 CLIP-normalized, by a gather from the
    (256, 3) ``clip_normalize_table`` on x's device."""
    idx = x.long() * 3 + torch.arange(3, device=x.device)
    return table.reshape(-1)[idx]


def embed_m11_images(model: CLIPModel, images_m11: torch.Tensor) -> torch.Tensor:
    """The CLIP-alignment input path: raw [-1, 1] NHWC pixels resized
    bilinear (no antialias) to 224 with no mean/std normalization ->
    unnormalized image features."""
    x = F.interpolate(images_m11.permute(0, 3, 1, 2), size=(224, 224), mode="bilinear",
                      align_corners=False, antialias=False)
    return model.encode_image(x.permute(0, 2, 3, 1))
