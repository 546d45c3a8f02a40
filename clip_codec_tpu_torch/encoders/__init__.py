"""Image and text encoders: files or token ids -> L2-normalized fp32
embeddings — the port of ``clip_codec_tpu/encoders/__init__.py`` (CLIP and
DINOv2).

Pretrained weights are not bundled. ``ClipEncoder`` reads a CLIP ViT-B/32
checkpoint (openai / open_clip ``.pt`` or HuggingFace ``CLIPModel``
``.bin``/``.safetensors``; ``weights/convert_clip.py``) from its argument or
``CLIP_CODEC_CLIP_WEIGHTS``, and the tokenizer's merges from ``bpe_path``
or ``CLIP_BPE_PATH``; ``DinoEncoder`` a HuggingFace ``Dinov2Model``
checkpoint (``weights/convert_dino.py``) from its argument or
``CLIP_CODEC_DINO_WEIGHTS``. Missing files raise with the variable's name.

``mesh=`` (a ``parallel.make_mesh`` mesh) makes the batched image encode
data-parallel: each batch is padded to a multiple of the data axis, every
rank embeds its rows on its own device, and the rows are gathered, so every
rank returns the whole result.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from PIL import Image

from .clip import (CLIPConfig, CLIPModel, VIT_B_32, clip_normalize_table, normalize_u8, preprocess_pil,
                   preprocess_pil_u8)
from .dino import DINOV2_BASE, DinoConfig, DinoV2, preprocess_dino
from .tokenizer import CLIPTokenizer

__all__ = ["CLIPConfig", "CLIPModel", "VIT_B_32", "preprocess_pil", "preprocess_pil_u8",
           "CLIPTokenizer", "ClipEncoder", "DINOV2_BASE", "DinoConfig", "DinoV2", "preprocess_dino",
           "DinoEncoder"]


def _require(path: Optional[str], env: str, what: str) -> Path:
    path = path or os.environ.get(env)
    if not path or not Path(path).exists():
        raise RuntimeError(
            f"{what} weights not found. Pass a pretrained checkpoint or set {env}=<path> "
            f"(see clip_codec_tpu_torch/weights/)."
        )
    return Path(path)


def _device(device, mesh) -> torch.device:
    """The encoder's device: the rank's under a mesh, else ``device``."""
    if mesh is not None:
        from ..parallel.mesh import rank_device

        return rank_device(mesh)
    return torch.device(device)


def _batched_encode(paths: Sequence[str], preprocess: Callable[[str], np.ndarray],
                    embed: Callable[[np.ndarray], np.ndarray], batch_size: int,
                    dim: int, mesh=None) -> Tuple[np.ndarray, List[str]]:
    """File -> embedding batching loop: every batch is zero-padded to
    ``batch_size`` rows, so a row's result does not depend on the size of
    the tail batch (the library would pick another GEMM for another row
    count); files that fail to open or decode are skipped.
    ``preprocess(path) -> (H, W, C)``; ``embed(pixels) -> (B, dim)``. Under
    ``mesh`` the padded batch is rounded up to a multiple of the data axis,
    each rank embeds its rows and the host rows are gathered (gloo serves
    CPU tensors on every backend layout). Returns (Z fp32, kept_paths)."""
    from ..utils.batching import pad_rows

    rows = slice(None)
    if mesh is not None:  # the padded batch must split evenly over the ranks
        from ..parallel.mesh import all_gather_rows, axis_size, local_rows

        n_data = axis_size(mesh)
        batch_size = -(-batch_size // n_data) * n_data
        rows = local_rows(mesh, batch_size)
    zs: List[np.ndarray] = []
    kept: List[str] = []
    batch: List[np.ndarray] = []
    bpaths: List[str] = []

    def flush():
        if not batch:
            return
        x = np.stack(batch)
        z = embed(pad_rows(x, batch_size)[rows])
        if mesh is not None:
            z = all_gather_rows(mesh, torch.from_numpy(np.ascontiguousarray(z))).numpy()
        zs.append(z[: x.shape[0]])
        kept.extend(bpaths)
        batch.clear()
        bpaths.clear()

    for p in paths:
        try:
            batch.append(preprocess(p))
            bpaths.append(str(p))
        except Exception:  # a corrupt or unreadable file is skipped, as the reference does
            continue
        if len(batch) == batch_size:
            flush()
    flush()
    if not zs:
        return np.zeros((0, dim), dtype=np.float32), []
    return np.concatenate(zs).astype(np.float32), kept


class ClipEncoder:
    """CLIP ViT-B/32 on ``device``: batched image encode (bf16 by default)
    and text encode, both giving L2-normalized fp32 embeddings.

    uint8 pixel batches (``preprocess_pil_u8``) cross to the device as they
    are and are normalized there by a gather from ``clip_normalize_table``,
    bit-equal to host ``preprocess_pil``. ``device="cuda"`` (the default)
    raises without a card: the encoder never falls back to the CPU. Under
    ``mesh`` it lives on the rank's device and ``encode_images`` is
    data-parallel."""

    def __init__(
        self,
        weights_path: Optional[str] = None,
        cfg: CLIPConfig = VIT_B_32,
        bpe_path: Optional[str] = None,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
        mesh=None,
    ) -> None:
        from ..weights.convert_clip import load_clip_state_dict

        self.mesh = mesh
        self.device = _device(device, mesh)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ClipEncoder: no CUDA device is available (pass device='cpu')")
        wpath = _require(weights_path, "CLIP_CODEC_CLIP_WEIGHTS", "CLIP")
        self.cfg = cfg
        model = CLIPModel(cfg, dtype=dtype)
        model.load_state_dict(load_clip_state_dict(wpath), strict=True)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self._table = torch.from_numpy(clip_normalize_table()).to(self.device)
        self._bpe_path = bpe_path
        self._tokenizer: Optional[CLIPTokenizer] = None

    @property
    def tokenizer(self) -> CLIPTokenizer:
        if self._tokenizer is None:
            self._tokenizer = CLIPTokenizer(self._bpe_path, self.cfg.context_length)
        return self._tokenizer

    @torch.no_grad()
    def embed_images(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8, or CLIP-normalized float, pixels -> (B, embed_dim)
        L2-normalized fp32 on the device."""
        x = pixels.to(self.device)
        if x.dtype == torch.uint8:
            x = normalize_u8(x, self._table)
        z = self.model.encode_image(x).float()
        return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)

    @torch.no_grad()
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, L) token ids -> (B, embed_dim) L2-normalized fp32 on the device."""
        z = self.model.encode_text(tokens.to(self.device)).float()
        return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)

    def encode_images(self, paths: Sequence[str], batch_size: int = 64) -> Tuple[np.ndarray, List[str]]:
        """Encode image files; corrupt files are skipped. Returns (Z, kept_paths)."""
        return _batched_encode(
            paths, lambda p: preprocess_pil_u8(Image.open(p), self.cfg.image_size),
            lambda x: self.embed_images(torch.from_numpy(x)).cpu().numpy(), batch_size, self.cfg.embed_dim,
            self.mesh)

    def encode_image_array(self, images_hwc: np.ndarray) -> np.ndarray:
        """Encode loaded HWC images: uint8 (``preprocess_pil_u8``'s output),
        normalized on the device, or float already CLIP-preprocessed."""
        return self.embed_images(torch.tensor(images_hwc)).cpu().numpy()

    def encode_text(self, texts) -> np.ndarray:
        return self.embed_tokens(torch.from_numpy(self.tokenizer(texts))).cpu().numpy()


class DinoEncoder:
    """DINOv2 ViT-B/14 on ``device``: batched image encode (bf16 by
    default) giving ``z / (||z|| + 1e-9)`` fp32 rows, as the JAX
    ``DinoEncoder``. Images are decoded, resized and normalized on the host
    (``preprocess_dino``); ``device="cuda"`` (the default) raises without a
    card. ``mesh`` as ``ClipEncoder``'s."""

    def __init__(self, weights_path: Optional[str] = None, cfg: DinoConfig = DINOV2_BASE,
                 dtype: torch.dtype = torch.bfloat16, device: Union[str, torch.device] = "cuda",
                 mesh=None) -> None:
        from ..weights.convert_dino import load_dino_state_dict

        self.mesh = mesh
        self.device = _device(device, mesh)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DinoEncoder: no CUDA device is available (pass device='cpu')")
        wpath = _require(weights_path, "CLIP_CODEC_DINO_WEIGHTS", "DINOv2")
        self.cfg = cfg
        model = DinoV2(cfg, dtype=dtype)
        model.load_state_dict(load_dino_state_dict(wpath), strict=True)
        self.model = model.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def embed_images(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) ImageNet-normalized pixels -> (B, dim) fp32 rows
        divided by their norm + 1e-9, on the device."""
        z = self.model(pixels.to(self.device)).float()
        return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-9)

    def encode_images(self, paths: Sequence[str], batch_size: int = 16) -> Tuple[np.ndarray, List[str]]:
        """Encode image files; corrupt files are skipped. Returns (Z, kept_paths)."""
        def preprocess(p):
            arr = np.asarray(Image.open(p).convert("RGB"), dtype=np.float32) / 255.0
            return preprocess_dino(arr, self.cfg.image_size)

        return _batched_encode(paths, preprocess, lambda x: self.embed_images(torch.from_numpy(x)).cpu().numpy(),
                               batch_size, self.cfg.dim, self.mesh)
