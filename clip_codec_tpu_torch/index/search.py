"""Retrieval index: exact inner-product search on one card — the port of
``clip_codec_tpu/index/search.py``.

The reference wraps FAISS ``IndexFlatIP`` (``index/faiss_index.py:13-31``);
here exact search is one product plus an exact top-k on the device.
``FlatIPIndex`` holds the (N, D) fp32 matrix and scores with
``torch.matmul`` in full fp32; ``U8FlatIPIndex`` holds the store's raw
uint8 codes and scores them with ``ops.u8_scan.u8_ip_scores`` (a
hand-written kernel on the card), the dequantize and renormalize folded
into the query side. Both rank with ``_rank``: ``lax.top_k``'s selection
and order, ties at the k-th place included. ``build_index``/``search_index``
keep the reference's API, k clamped to ntotal.

Constructors take ``device`` (default ``"cuda"``) and raise without a card:
the index never falls back to the CPU. ``search`` takes numpy or torch
queries and returns numpy ``(scores (Q, k) fp32, ids (Q, k) int32)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.u8_scan import CHUNK_ROWS, fold_query, full_fp32, u8_ip_scores

Device = Union[str, torch.device]
_NP_DTYPE = {torch.float32: np.float32, torch.uint8: np.uint8}


def _device(device: Device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("index: no CUDA device is available (pass device='cpu')")
    return dev


def _tensor(a, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """``a`` as a contiguous ``dtype`` tensor on ``dev``; numpy input is copied."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype).contiguous()
    return torch.from_numpy(np.array(a, dtype=_NP_DTYPE[dtype])).to(dev)


def _host(a, dtype=np.float32) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().astype(dtype, copy=False)
    return np.asarray(a, dtype)


def _queries(queries, dev: torch.device) -> torch.Tensor:
    q = _tensor(queries, torch.float32, dev)
    return q[None] if q.dim() == 1 else q


def _no_hits(nq: int) -> Tuple[np.ndarray, np.ndarray]:
    return np.zeros((nq, 0), np.float32), np.zeros((nq, 0), np.int32)


def _rank(sims: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k(sims, k)`` exactly: the k largest of each row, descending,
    the lower position first among equal values (``torch.topk`` promises no
    order among ties, and on the CPU keeps none). Values are compared as int32
    keys in the floats' total order (-0.0 below +0.0, as ``lax.top_k`` ranks
    them). One ``topk`` finds the k-th key t; a second selects every element
    above t and, of those equal to t, the lowest positions; the k selected
    are then sorted by position and stably by key. No host sync, so a CUDA
    graph captures it. Returns (values (Q, k), positions (Q, k) int64)."""
    bits = sims.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    n = sims.shape[1]
    t = torch.topk(key, k, dim=1).values[:, -1:]
    pos = torch.arange(n, device=sims.device, dtype=torch.int32)
    pick = torch.where(key > t, n, torch.where(key == t, n - 1 - pos, -1))
    idx = torch.sort(torch.topk(pick, k, dim=1).indices, dim=1).values
    order = torch.sort(key.gather(1, idx), dim=1, descending=True, stable=True).indices
    idx = idx.gather(1, order)
    return sims.gather(1, idx), idx


@dataclass
class FlatIPIndex:
    """Exact inner-product index over an (N, D) fp32 matrix on the device."""

    feats: torch.Tensor  # (N, D) float32

    @property
    def ntotal(self) -> int:
        return int(self.feats.shape[0])

    def search(self, queries, k: int, recall_target: float | None = None) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) queries -> (scores (Q, k), ids (Q, k)), descending.
        ``recall_target`` is accepted and ranked exactly, as the JAX package
        does on any backend but a TPU."""
        del recall_target
        q = _queries(queries, self.feats.device)
        if self.ntotal == 0:  # empty store: no candidates
            return _no_hits(q.shape[0])
        scores, ids = self._search(q, max(1, min(k, self.ntotal)))
        return scores.cpu().numpy(), ids.cpu().numpy()

    def _search(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device tensors in and out, no host sync (a CUDA graph captures it)."""
        with full_fp32():
            sims = q @ self.feats.T
        scores, ids = _rank(sims, k)
        return scores, ids.to(torch.int32)


def build_index(feats, use_gpu: bool = False, device: Device = "cuda") -> FlatIPIndex:
    """API-parity constructor (``faiss_index.py:13-19``); ``use_gpu`` is
    accepted and ignored: placement is ``device``."""
    del use_gpu
    return FlatIPIndex(feats=_tensor(feats, torch.float32, _device(device)))


def search_index(qvec, index, paths: Sequence[str], k: int = 10) -> List[Tuple[str, float]]:
    """Top-k (path, score) for one query vector (``faiss_index.py:23-31``);
    ids past the candidates (-1) are skipped."""
    scores, ids = index.search(_host(qvec)[None, :], k)
    return [(paths[int(i)], float(scores[0, j])) for j, i in enumerate(ids[0]) if i >= 0]


# ------------------------------------------------------------ uint8-resident


def _u8_inv_norms(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """1/|scale*u_i + zero| per row, on the codes' device, over row chunks
    (never more than a chunk of the matrix in fp32)."""
    inv = torch.empty((codes.shape[0],), dtype=torch.float32, device=codes.device)
    for lo in range(0, codes.shape[0], CHUNK_ROWS):
        x = codes[lo:lo + CHUNK_ROWS].to(torch.float32) * scale[None, :] + zero[None, :]
        inv[lo:lo + CHUNK_ROWS] = 1.0 / torch.clamp(torch.sqrt((x * x).sum(dim=1)), min=eps)
    return inv


@dataclass
class U8FlatIPIndex:
    """Exact inner-product index resident as the store's raw uint8 codes.

    The same hits as :class:`FlatIPIndex` over the dequantized, renormalized
    matrix (scores differ by fp32 summation order, ~1e-6) at a quarter of
    the resident bytes and of the bytes read per search: the score is
    ``((q*scale) . u_i + q . zero) / |x_i|`` (``ops.u8_scan``)."""

    codes: torch.Tensor      # (N, D) uint8
    scale: torch.Tensor      # (D,) float32
    zero: torch.Tensor       # (D,) float32
    inv_norms: torch.Tensor  # (N,) float32

    @property
    def ntotal(self) -> int:
        return int(self.codes.shape[0])

    def search(self, queries, k: int, recall_target: float | None = None) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) queries -> (scores (Q, k), ids (Q, k)), descending;
        ``recall_target`` as on :meth:`FlatIPIndex.search`."""
        del recall_target
        q = _queries(queries, self.codes.device)
        if self.ntotal == 0:
            return _no_hits(q.shape[0])
        scores, ids = self._search(q, max(1, min(k, self.ntotal)))
        return scores.cpu().numpy(), ids.cpu().numpy()

    def _search(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        qs, qz = fold_query(q, self.scale, self.zero)
        scores, ids = _rank(u8_ip_scores(self.codes, qs, qz, self.inv_norms), k)
        return scores, ids.to(torch.int32)


def build_index_u8(codes, scale, zero, device: Device = "cuda") -> U8FlatIPIndex:
    """The uint8-resident exact index from quantized codes and the codec meta
    (``Store.read_codes()``, ``codec_meta.npz``); row norms computed once on
    the device."""
    dev = _device(device)
    codes = _tensor(codes, torch.uint8, dev)
    scale, zero = _tensor(scale, torch.float32, dev), _tensor(zero, torch.float32, dev)
    return U8FlatIPIndex(codes=codes, scale=scale, zero=zero, inv_norms=_u8_inv_norms(codes, scale, zero))
