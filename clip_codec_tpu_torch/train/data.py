"""Host-side data pipeline for training from a store — the port of
``clip_codec_tpu/train/data.py``.

* ``load_image_u8`` / ``load_image_m11``: PIL decode, BICUBIC resize, (H, W, 3)
  uint8 or float32 in [-1, 1] (PIL is imported when an image is loaded);
* ``scale_m11_u8``: uint8 -> [-1, 1] float32 on the tensor's device,
  bit-identical to the host's ``x.astype(np.float32) / 127.5 - 1``;
* ``StoreData``: the store's embeddings dequantized once up front, images
  decoded per batch (on a thread pool with ``workers > 0``, from a resized
  uint8 RAM cache with ``cache_images``) into fixed-shape batches whose
  padded tail rows carry weight 0; a prefetch thread overlaps the decode
  with the device's steps. Cached, pooled and plain decodes give the same
  bits. Under data parallelism (``local=``) a rank decodes only its rows
  of every global batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from ..io.store import Store
from ..utils.batching import padded_index_batches, prefetch_iter

PathLike = Union[str, Path]


def load_image_u8(path: PathLike, out_size: int) -> np.ndarray:
    """RGB image -> (H, W, 3) uint8, BICUBIC resize."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((out_size, out_size), Image.BICUBIC)
    return np.asarray(img, dtype=np.uint8)


def load_image_m11(path: PathLike, out_size: int) -> np.ndarray:
    """RGB image -> (H, W, 3) float32 in [-1, 1], BICUBIC resize."""
    return load_image_u8(path, out_size).astype(np.float32) / 127.5 - 1.0


_M11_TABLE = np.arange(256, dtype=np.float32) / 127.5 - 1.0  # the host math, exact
_tables: Dict[torch.device, torch.Tensor] = {}


def scale_m11_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [-1, 1] as a gather from a 256-entry table made
    with the host's numpy math, so the result is bit-identical to
    ``x.astype(np.float32) / 127.5 - 1.0`` on every device (a device divide
    need not round as the host's does). Float inputs pass through."""
    if x.dtype != torch.uint8:
        return x
    table = _tables.get(x.device)
    if table is None:
        table = _tables[x.device] = torch.from_numpy(_M11_TABLE).to(x.device)
    return table[x.long()]


class LazyPool:
    """Map a function over items on a thread pool built at first use when
    ``workers > 0`` (PIL releases the GIL while it decodes), else in order
    on the calling thread."""

    def __init__(self, workers: int) -> None:
        self.workers = int(workers)
        self._pool = None

    def map(self, fn, items) -> list:
        if self.workers > 0:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(max_workers=self.workers)
            return list(self._pool.map(fn, items))
        return [fn(i) for i in items]


@dataclass
class Batch:
    x0: np.ndarray  # (B, H, W, 3) float32 in [-1, 1] (uint8 under epoch(u8=True))
    z: np.ndarray  # (B, D) float32, L2-normalized
    weight: np.ndarray  # (B,) float32, 0.0 marks padding
    # real rows of the GLOBAL batch: weight.sum() except under local= rows,
    # where weight covers only this rank's rows
    wsum: float = 0.0


class StoreData:
    """Materialized store view feeding the train loop."""

    def __init__(self, store_dir: PathLike, out_size: int = 256, workers: int = 0,
                 cache_images: bool = False) -> None:
        self.store = Store.open(store_dir)
        self.out_size = out_size
        self.z = self.store.decode_all(renormalize=True)  # (N, D)
        self.image_paths = [rec["image"] for rec in self.store.manifest]
        self._pool = LazyPool(workers)
        self._cache: Optional[List[Optional[np.ndarray]]] = [None] * len(self.image_paths) if cache_images else None

    def __len__(self) -> int:
        return len(self.image_paths)

    @property
    def z_dim(self) -> int:
        return int(self.z.shape[1])

    def _decode_u8(self, i: int) -> np.ndarray:
        if self._cache is not None and self._cache[i] is not None:
            return self._cache[i]
        arr = load_image_u8(self.image_paths[i], self.out_size)
        if self._cache is not None:
            self._cache[i] = arr
        return arr

    def _load_images(self, idx: np.ndarray, u8: bool = False) -> np.ndarray:
        imgs = np.stack(self._pool.map(self._decode_u8, [int(i) for i in idx]))
        return imgs if u8 else imgs.astype(np.float32) / 127.5 - 1.0

    def _epoch_sync(self, batch_size: int, rng: np.random.Generator, shuffle: bool, local: Optional[tuple],
                    u8: bool) -> Iterator[Batch]:
        n = len(self)
        order = rng.permutation(n) if shuffle else np.arange(n)
        for idx, w in padded_index_batches(n, batch_size, order):
            wsum = float(w.sum())
            if local is not None:
                lo, hi = local
                idx, w = idx[lo:hi], w[lo:hi]
            yield Batch(x0=self._load_images(idx, u8=u8), z=self.z[idx], weight=w, wsum=wsum)

    def epoch(self, batch_size: int, rng: np.random.Generator, shuffle: bool = True, prefetch: int = 2,
              local: Optional[tuple] = None, u8: bool = False) -> Iterator[Batch]:
        """Fixed-shape batches over one epoch in ``rng``'s order, the tail
        padded with repeats of weight 0; ``prefetch`` batches are decoded
        ahead on a host thread (0: synchronous); ``u8`` yields raw uint8
        pixels for ``scale_m11_u8`` on the device.

        ``local=(lo, hi)``: data parallelism. The order and the padding stay
        global (the same on every rank for the same ``rng`` seed), but only
        rows ``[lo:hi)`` of each batch are decoded and yielded;
        ``Batch.wsum`` is still the global batch's real-row count."""
        yield from prefetch_iter(self._epoch_sync(batch_size, rng, shuffle, local, u8), prefetch)
