"""SD AutoencoderKL (VAE) — the port of ``clip_codec_tpu/models/sd/vae.py``.

NHWC activations in ``dtype``; fp32 parameters under diffusers'
``AutoencoderKL`` names (``encoder.*``, ``decoder.*``, ``quant_conv``,
``post_quant_conv``; the mid-block attention as ``group_norm``, ``to_q``,
``to_k``, ``to_v``, ``to_out.0``), so a released checkpoint loads with
``strict=True`` (the legacy ``query/key/value/proj_attn`` names are renamed
by ``weights.sd_checkpoint.vae_state_dict``). At 512px the decoder's
mid-block attention is one flash-attention launch over 4096 pixels, D=512.
The latent scaling factor is applied by the caller. The VAE stays fp
whatever ``ops.int8``'s process default says: its blocks are called without
``int8``, as JAX pins ``int8=False`` here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (AttnBlockVAE, Block, Downsample2D, ResnetBlock2D, Upsample2D, conv, conv1x1, group_norm32,
                     groups_for)


@dataclass(frozen=True)
class VAEConfig:
    block_out: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_ch: int = 4


SD15_VAE = VAEConfig()


def _mid(ch: int) -> Block:
    return Block([ResnetBlock2D(ch, ch), ResnetBlock2D(ch, ch)], [AttnBlockVAE(ch)])


def _run_mid(mid: Block, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    h = mid.resnets[0](h, None, dt)
    h = mid.attentions[0](h, dt)
    return mid.resnets[1](h, None, dt)


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig = SD15_VAE) -> None:
        super().__init__()
        c = cfg
        self.conv_in = nn.Conv2d(3, c.block_out[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch_prev = c.block_out[0]
        for i, ch in enumerate(c.block_out):
            res = []
            for _ in range(c.layers_per_block):
                res.append(ResnetBlock2D(ch_prev, ch))
                ch_prev = ch
            extra = {"downsamplers": Downsample2D(ch, ch, asymmetric=True)} if i < len(c.block_out) - 1 else {}
            self.down_blocks.append(Block(res, **extra))
        ch = c.block_out[-1]
        self.mid_block = _mid(ch)
        self.conv_norm_out = nn.GroupNorm(groups_for(ch), ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * c.latent_ch, 3, padding=1)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        h = conv(self.conv_in, x, dt)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h, None, dt)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h, dt)
        h = _run_mid(self.mid_block, h, dt)
        return conv(self.conv_out, F.silu(group_norm32(h, self.conv_norm_out)), dt)


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig = SD15_VAE) -> None:
        super().__init__()
        c = cfg
        n = len(c.block_out)
        ch = c.block_out[-1]
        self.conv_in = nn.Conv2d(c.latent_ch, ch, 3, padding=1)
        self.mid_block = _mid(ch)
        self.up_blocks = nn.ModuleList()
        ch_prev = ch
        for k, i in enumerate(reversed(range(n))):
            ch = c.block_out[i]
            res = []
            for _ in range(c.layers_per_block + 1):
                res.append(ResnetBlock2D(ch_prev, ch))
                ch_prev = ch
            extra = {"upsamplers": Upsample2D(ch, ch)} if k < n - 1 else {}
            self.up_blocks.append(Block(res, **extra))
        self.conv_norm_out = nn.GroupNorm(groups_for(ch), ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, 3, 3, padding=1)

    def forward(self, z: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        h = conv(self.conv_in, z, dt)
        h = _run_mid(self.mid_block, h, dt)
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h, None, dt)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h, dt)
        return conv(self.conv_out, F.silu(group_norm32(h, self.conv_norm_out)), dt)


class AutoencoderKL(nn.Module):
    """Both halves under one state dict, NHWC images in [-1, 1]."""

    def __init__(self, cfg: VAEConfig = SD15_VAE, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.encoder = VAEEncoder(cfg)
        self.decoder = VAEDecoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_ch, 2 * cfg.latent_ch, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_ch, cfg.latent_ch, 1)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/f, W/f, 2*latent_ch) mean || logvar."""
        dt = self.compute_dtype
        return conv1x1(self.quant_conv, self.encoder(x, dt), dt)

    @staticmethod
    def sample_latents(moments: torch.Tensor, generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mean + exp(logvar / 2) * noise`` with logvar clipped to [-30, 20];
        the noise is drawn from ``generator`` unless given."""
        mean, logvar = moments.chunk(2, dim=-1)
        logvar = torch.clamp(logvar, -30.0, 20.0)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(0.5 * logvar) * noise

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, h, w, latent_ch) unscaled latents -> (B, H, W, 3) in ``dtype``."""
        dt = self.compute_dtype
        return self.decoder(conv1x1(self.post_quant_conv, z, dt), dt)
