"""Fixed-shape batching helpers — the port's copy of ``clip_codec_tpu/utils/batching.py``.

Tails are padded and masked so every step sees the same batch shape and
losses average over real rows only.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


def pad_rows(x: np.ndarray, batch_size: int) -> np.ndarray:
    """Zero-pad the leading dim up to ``batch_size`` (no-op when full)."""
    n = x.shape[0]
    if n >= batch_size:
        return x
    return np.concatenate([x, np.zeros((batch_size - n,) + x.shape[1:], x.dtype)])


def padded_index_batches(
    n: int, batch_size: int, order: Optional[np.ndarray] = None
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(indices, weights)`` of fixed length ``batch_size`` covering
    ``order`` (default ``arange(n)``); tail indices repeat the first element
    of the tail with weight 0 so losses average over real samples only."""
    order = np.arange(n) if order is None else order
    for s in range(0, n, batch_size):
        idx = order[s : s + batch_size]
        w = np.ones(len(idx), dtype=np.float32)
        if len(idx) < batch_size:
            pad = batch_size - len(idx)
            idx = np.concatenate([idx, idx[np.zeros(pad, dtype=int)]])
            w = np.concatenate([w, np.zeros(pad, dtype=np.float32)])
        yield idx, w


def prefetch_iter(it: Iterator, prefetch: int = 2) -> Iterator:
    """Drain ``it`` on a daemon thread into a bounded queue so producer work
    (PIL decode, npz reads) overlaps the consumer's device steps.
    Exceptions propagate; ``prefetch <= 0`` is a passthrough."""
    if prefetch <= 0:
        yield from it
        return
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    _END = object()

    def producer():
        try:
            for item in it:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # propagate, never silently truncate
            q.put(e)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
