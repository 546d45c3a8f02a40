"""The codec facade, the one-object compress/decompress API (port of
``clip_codec_tpu/codec.py``):

    codec = ClipCodec.load("store_dir", device="cuda")     # codebook + decoder
    blobs = codec.compress(pil_images)                      # .clp frame bytes
    images = codec.decompress(blobs, size=256)              # batched DDIM

``compress`` resizes and crops on the host, sends uint8 pixels, and runs the
CLIP image tower (``encoders.ClipEncoder``, CLIP weights needed), the
quantizer against the store's codebook on the device, then frames each row.
``decompress`` parses frames on the host, dequantizes and L2-normalizes the
codes on the device, and samples each batch by DDIM through the U-Net.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from PIL import Image

from .codecs.quantizer import dequantize_l2norm, dequantize_l2norm_host, quantize
from .diffusion import DDIMSampler, NoiseSchedule, make_sampler
from .io import bitstream
from .models import CLIPCondUNet
from .utils.checkpoint import load_unet_checkpoint
from .utils.config import ModelConfig

PathLike = Union[str, Path]
DEFAULT_WEIGHTS = "diffusion_unet_final.pt"
JAX_WEIGHTS = "diffusion_unet_final.msgpack"  # what the JAX trainer writes


class ClipCodec:
    """Compress images to ``.clp`` frames and reconstruct them via DDIM on
    ``device``; ``encoder`` is a ``ClipEncoder`` (made on first compress
    from ``CLIP_CODEC_CLIP_WEIGHTS`` when not given)."""

    def __init__(
        self,
        scale: np.ndarray,
        zero: np.ndarray,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        model_config: Optional[ModelConfig] = None,
        device: Union[str, torch.device] = "cuda",
        dtype: torch.dtype = torch.bfloat16,
        rng_seed: int = 0,
        encoder=None,
    ) -> None:
        self.device = torch.device(device)
        self.scale = np.asarray(scale, np.float32)
        self.zero = np.asarray(zero, np.float32)
        self.dim = int(self.scale.shape[0])
        self.encoder = encoder
        self.mc = model_config
        self.net: Optional[CLIPCondUNet] = None
        self.sched: Optional[NoiseSchedule] = None
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        if state_dict is not None and model_config is not None:
            mc = model_config
            net = CLIPCondUNet(z_dim=mc.z_dim, base=mc.base, ch_mult=mc.ch_mult,
                               time_dim=mc.time_dim, img_ch=mc.img_ch, dtype=dtype)
            net.load_state_dict(state_dict, strict=True)
            self.net = net.to(self.device).eval()
            self.sched = NoiseSchedule.create(mc.timesteps, mc.schedule, device=self.device)

    @classmethod
    def load(cls, store_dir: PathLike, weights: Optional[PathLike] = None,
             device: Union[str, torch.device] = "cuda",
             dtype: torch.dtype = torch.bfloat16, encoder=None) -> "ClipCodec":
        """From a store directory: ``codec_meta.npz`` plus a decoder
        checkpoint, ``.pt`` or the JAX package's ``.msgpack`` (default
        ``diffusion_unet_final.pt`` in the store, else
        ``diffusion_unet_final.msgpack``, when present) and the
        ``model_config.json`` beside it; without one the architecture is
        inferred from the weights."""
        store_dir = Path(store_dir)
        meta = np.load(store_dir / "codec_meta.npz")
        explicit = weights is not None
        if explicit:
            weights = Path(weights)
        else:
            weights = store_dir / DEFAULT_WEIGHTS
            if not weights.exists() and (store_dir / JAX_WEIGHTS).exists():
                weights = store_dir / JAX_WEIGHTS
        if explicit and not weights.exists():
            raise FileNotFoundError(f"decoder checkpoint not found: {weights}")
        sd, mc = None, None
        if weights.exists():
            sd = load_unet_checkpoint(weights)
            mc = ModelConfig.find_for_checkpoint(weights)
            if mc is None:
                mc = ModelConfig.infer_from_state_dict(sd)
                warnings.warn(
                    f"no model_config.json next to {weights}: inferred base={mc.base}, "
                    f"ch_mult={mc.ch_mult}; assuming timesteps={mc.timesteps}/{mc.schedule}")
        return cls(meta["scale"], meta["zero"], sd, mc, device=device, dtype=dtype, encoder=encoder)

    # ------------------------------------------------------------ compress

    def compress(self, images: Sequence[Image.Image], batch_size: int = 64) -> List[bytes]:
        """PIL images -> ``.clp`` frame bytes: CLIP encode in batches padded
        to ``batch_size``, quantize on the device, frame on the host."""
        if self.encoder is None:
            from .encoders import ClipEncoder

            self.encoder = ClipEncoder(device=self.device)
        from .encoders.clip import preprocess_pil_u8
        from .utils.batching import pad_rows

        if len(images) == 0:
            return []
        feats = []
        for s in range(0, len(images), batch_size):
            x = np.stack([preprocess_pil_u8(im, self.encoder.cfg.image_size) for im in images[s : s + batch_size]])
            feats.append(self.encoder.embed_images(torch.from_numpy(pad_rows(x, batch_size)))[: x.shape[0]])
        return bitstream.compress_frames(quantize(torch.cat(feats), self.scale, self.zero).cpu().numpy())

    # ---------------------------------------------------------- embeddings

    def codes(self, blobs: Sequence[bytes]) -> np.ndarray:
        """``.clp`` frames -> (N, dim) uint8 codes (host work, one batch).
        The frame carries no dim: a frame from another store raises a
        ValueError that says so."""
        return bitstream.decompress_frames(list(blobs), self.dim)

    def _embed(self, q: np.ndarray) -> torch.Tensor:
        return dequantize_l2norm(torch.from_numpy(np.ascontiguousarray(q)).to(self.device),
                                 torch.from_numpy(self.scale).to(self.device),
                                 torch.from_numpy(self.zero).to(self.device))

    def decode_embeddings(self, blobs: Sequence[bytes]) -> np.ndarray:
        """.clp frames -> L2-normalized fp32 embeddings, dequantized on the device."""
        return self._embed(self.codes(blobs)).cpu().numpy()

    def decode_embeddings_host(self, blobs: Sequence[bytes]) -> np.ndarray:
        """The same fp32 math in numpy, with no device work."""
        return dequantize_l2norm_host(self.codes(blobs), self.scale, self.zero)

    # ---------------------------------------------------------- decompress

    def decompress(
        self, blobs: Sequence[bytes], size: int = 256, steps: int = 50, eta: float = 0.0,
        batch_size: int = 16, sampler: str = "ddim", seed: Optional[int] = None,
    ) -> np.ndarray:
        """.clp frames -> (N, size, size, img_ch) float images in [-1, 1]."""
        return self.decompress_codes(self.codes(blobs), size, steps, eta, batch_size, sampler, seed)

    def decompress_codes(
        self, q: np.ndarray, size: int = 256, steps: int = 50, eta: float = 0.0,
        batch_size: int = 16, sampler: str = "ddim", seed: Optional[int] = None,
    ) -> np.ndarray:
        """:meth:`decompress` from the uint8 codes (N, dim) of parsed frames.

        Rows are sampled ``batch_size`` at a time, the last batch zero-padded.
        ``seed``: the first batch draws from a generator seeded with ``seed``
        itself, later batches from one seeded with (seed, batch index), so a
        request reproduces; without it, the codec's own generator advances
        and successive calls differ."""
        if self.net is None:
            raise RuntimeError("No decoder loaded (checkpoint and model config both "
                               "required); pass weights= to ClipCodec.load")
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"codes must be (N, {self.dim}), got {q.shape}")
        smp = make_sampler(sampler, self.sched, eta=eta)
        if q.shape[0] == 0:
            return np.zeros((0, size, size, self.mc.img_ch), np.float32)
        z = self._embed(q)
        outs = []
        for bi, s in enumerate(range(0, z.shape[0], batch_size)):
            zb = z[s : s + batch_size]
            k = zb.shape[0]
            if k < batch_size:
                zb = torch.cat([zb, zb.new_zeros(batch_size - k, zb.shape[1])])
            x = self._sample_batch(zb, size, steps, smp, self._generator(seed, bi))
            outs.append(torch.clamp(x[:k], -1.0, 1.0).cpu().numpy())
        return np.concatenate(outs)

    def _generator(self, seed: Optional[int], bi: int) -> torch.Generator:
        if seed is None:
            return self._gen
        if bi:
            seed = int(np.random.SeedSequence([seed, bi]).generate_state(1, np.uint64)[0] >> 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _sample_batch(self, z: torch.Tensor, size: int, steps: int, sampler: DDIMSampler,
                      generator: torch.Generator, x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One batch of DDIM from z (B, dim) on the device; ``x_T`` replaces
        the initial noise when given. Returns fp32 (B, size, size, img_ch)."""
        shape = (z.shape[0], size, size, self.mc.img_ch)
        return sampler.sample(self.net, z, shape, steps=steps, x_T=x_T, generator=generator)
