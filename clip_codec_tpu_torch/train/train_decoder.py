"""The direct decoders' inference helper and trainer, the port of
``clip_codec_tpu/train/train_decoder.py``: read a ``.clp`` frame,
dequantize it with the store's ``codec_meta.npz``, L2-normalize, run a
direct decoder (``models/decoders.py``) and return a PIL image; and a
minimal L1 + total-variation training loop.

``train_direct_decoder`` takes the decoder module as it is (its weights
are the starting point; JAX's initialises its own from ``seed``, which
here only orders the batches), trains it on ``device`` with AdamW
(``train/optim.py``: optax.adamw's defaults) and writes a ``.pt`` state
dict, as the port's other trainers do.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

PathLike = Union[str, Path]


def decode_embedding(bit_path: PathLike, store_dir: PathLike) -> np.ndarray:
    """.clp file -> dequantized, L2-normalized (1, D) fp32 embedding."""
    from ..codecs.quantizer import dequantize_l2norm_host
    from ..io.bitstream import read_bitstream

    meta = np.load(Path(store_dir) / "codec_meta.npz")
    q = read_bitstream(bit_path)
    return dequantize_l2norm_host(q[None, :], meta["scale"].astype(np.float32),
                                  meta["zero"].astype(np.float32)).astype(np.float32)


def to_pil(img_m11: np.ndarray):
    """(H, W, 3) float in [-1, 1] -> PIL uint8 image."""
    from PIL import Image

    arr = np.clip(np.asarray(img_m11), -1.0, 1.0)
    return Image.fromarray(((arr + 1.0) * 127.5).astype(np.uint8))


@torch.no_grad()
def reconstruct_image_from_bitstream(bit_path: PathLike, store_dir: PathLike, decoder: torch.nn.Module,
                                     out_size: int = 64):
    """Decode a bitstream and run a direct decoder ``z -> image`` on the
    decoder's device; ``out_size`` is accepted as JAX's is (the decoder's
    own configuration sets the size)."""
    del out_size
    device = next(decoder.parameters()).device
    z = torch.from_numpy(decode_embedding(bit_path, store_dir)).to(device)
    return to_pil(decoder(z)[0].float().cpu().numpy())


def train_direct_decoder(
    store_dir: PathLike,
    decoder: torch.nn.Module,
    out_size: int = 64,
    epochs: int = 10,
    batch_size: int = 16,
    lr: float = 2e-4,
    tv_w: float = 1e-4,
    seed: int = 0,
    save_path: Optional[PathLike] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[torch.nn.Module, Optional[float]]:
    """L1 + ``tv_w`` TV training of ``decoder`` on the store's images at
    ``out_size``: per-sample losses averaged over each batch's real rows,
    AdamW at ``lr``; batches in the order of ``np.random.default_rng(seed)``.
    Returns the decoder (on ``device``) and the last step's loss; with
    ``save_path`` its state dict is saved there."""
    from ..utils.checkpoint import save_state_dict
    from .data import StoreData
    from .losses import l1, total_variation, weighted_mean
    from .optim import make_optimizer

    device = torch.device(device)
    data = StoreData(store_dir, out_size=out_size)
    decoder = decoder.to(device).train()
    opt = make_optimizer(decoder, lr)
    rng = np.random.default_rng(seed)
    last = None
    for _ in range(epochs):
        for batch in data.epoch(batch_size, rng):
            x0, z, w = (torch.from_numpy(a).to(device) for a in (batch.x0, batch.z, batch.weight))
            y = decoder(z).float()
            loss = weighted_mean(l1(y, x0) + tv_w * total_variation(y), w)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            last = loss.detach()
    decoder.eval()
    if save_path is not None:
        save_state_dict(save_path, decoder.state_dict())
    return decoder, (float(last) if last is not None else None)

