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

The sharded forms (``ShardedFlatIPIndex``, ``ShardedU8FlatIPIndex``) split
the rows over a mesh's ``data`` axis, one block a rank on the rank's
device; every rank calls ``search`` with the same queries and gets the
single index's hits.
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


# ------------------------------------------------------------------ sharded


def _local_candidates(sims: torch.Tensor, base: int, ntotal: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's (Q, rows) scores -> its top-k with global ids, on the
    device. Padded rows (global id >= ntotal) are masked to -inf BEFORE the
    top-k: a zero-padded row scores exactly 0, which would push a real row
    with a negative score out of the shard's candidates."""
    gids = base + torch.arange(sims.shape[1], device=sims.device, dtype=torch.int32)
    sims = torch.where(gids[None, :] < ntotal, sims, -torch.inf)
    s, i = _rank(sims, min(k, sims.shape[1]))
    return s, (i + base).to(torch.int32)


def _merge_candidates(mesh, scores: torch.Tensor, ids: torch.Tensor, ntotal: int, k: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Every shard's candidates gathered to every rank, (Q, k * n_shards)
    (only (Q, k) a shard crosses between ranks, never the (Q, N) scores),
    then merged on the host to (Q, k), dropping padded rows (id >= ntotal).
    The sort is stable over candidates laid out shard by shard, each
    shard's in ``_rank``'s order, so equal scores keep the lower id first:
    the single index's order."""
    from ..parallel.mesh import all_gather_rows

    scores = all_gather_rows(mesh, scores, dim=1).cpu().numpy()
    ids = all_gather_rows(mesh, ids, dim=1).cpu().numpy()
    scores = np.where(ids < ntotal, scores, -np.inf)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    rows = np.arange(scores.shape[0])[:, None]
    return scores[rows, order].astype(np.float32), ids[rows, order].astype(np.int32)


def _shard_block(a: np.ndarray, mesh) -> Tuple[np.ndarray, int]:
    """This rank's block of rows of ``a`` zero-padded to a multiple of the
    data axis, and the block's first global row."""
    from ..parallel.mesh import axis_index, axis_size

    if a.ndim != 2:  # an empty store's features
        a = a.reshape(0, 0)
    n = axis_size(mesh)
    per = -(-a.shape[0] // n)
    lo = axis_index(mesh) * per
    block = a[lo:lo + per]
    if block.shape[0] < per:
        block = np.concatenate([block, np.zeros((per - block.shape[0],) + a.shape[1:], a.dtype)])
    return np.ascontiguousarray(block), lo


@dataclass
class ShardedFlatIPIndex:
    """:class:`FlatIPIndex` with the feature ROWS split over a mesh's ``data``
    axis: each rank keeps its block on its device, scores it and takes its
    local top-k, and the ranks' candidates are merged on the host. The hits
    of :class:`FlatIPIndex` (exact search); every rank returns them."""

    feats: torch.Tensor  # (rows, D) float32: this rank's block, zero-padded
    base: int            # the block's first global row
    ntotal: int          # real rows (before padding)
    mesh: object

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = _queries(queries, self.feats.device)
        if self.ntotal == 0:  # empty store: no candidates
            return _no_hits(q.shape[0])
        k = max(1, min(k, self.ntotal))
        return _merge_candidates(self.mesh, *self._local(q, k), self.ntotal, k)

    def _local(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """This shard's candidates: device tensors, no host sync."""
        with full_fp32():
            sims = q @ self.feats.T
        return _local_candidates(sims, self.base, self.ntotal, k)


def build_sharded_index(feats, mesh) -> ShardedFlatIPIndex:
    """Split ``feats`` (host (N, D)) over ``mesh``'s ``data`` axis,
    zero-padded to a multiple of it (padded rows never win: they are masked
    before each shard's top-k and dropped by id at the merge)."""
    from ..parallel.mesh import rank_device

    feats = _host(feats)
    block, base = _shard_block(feats, mesh)
    return ShardedFlatIPIndex(feats=torch.from_numpy(block).to(rank_device(mesh)), base=base,
                              ntotal=int(feats.shape[0]), mesh=mesh)


@dataclass
class ShardedU8FlatIPIndex:
    """Row-sharded :class:`U8FlatIPIndex`: each rank keeps its block of the
    store's uint8 codes and their inverse norms, and scores it with
    ``u8_ip_scores`` (the hand-written kernel on the card); then the local
    top-k and the same host merge as :class:`ShardedFlatIPIndex`."""

    codes: torch.Tensor      # (rows, D) uint8: this rank's block, zero-padded
    scale: torch.Tensor      # (D,) float32
    zero: torch.Tensor       # (D,) float32
    inv_norms: torch.Tensor  # (rows,) float32, 0 on padding
    base: int
    ntotal: int
    mesh: object

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = _queries(queries, self.codes.device)
        if self.ntotal == 0:
            return _no_hits(q.shape[0])
        k = max(1, min(k, self.ntotal))
        return _merge_candidates(self.mesh, *self._local(q, k), self.ntotal, k)

    def _local(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """This shard's candidates: device tensors, no host sync."""
        qs, qz = fold_query(q, self.scale, self.zero)
        return _local_candidates(u8_ip_scores(self.codes, qs, qz, self.inv_norms), self.base, self.ntotal, k)


def build_sharded_index_u8(codes, scale, zero, mesh) -> ShardedU8FlatIPIndex:
    """Split the store's raw codes over ``mesh``'s ``data`` axis; each rank
    computes its block's row norms on its device (padding rows: all-zero
    codes with inverse norm 0, masked before the local top-k)."""
    from ..parallel.mesh import rank_device

    dev = rank_device(mesh)
    codes = np.ascontiguousarray(_host(codes, np.uint8))
    n = codes.shape[0]
    block, base = _shard_block(codes, mesh)
    real = max(0, min(block.shape[0], n - base))
    block_d = torch.from_numpy(block).to(dev)
    scale, zero = _tensor(scale, torch.float32, dev), _tensor(zero, torch.float32, dev)
    inv = torch.zeros((block.shape[0],), dtype=torch.float32, device=dev)
    if real:
        inv[:real] = _u8_inv_norms(block_d[:real], scale, zero)
    return ShardedU8FlatIPIndex(codes=block_d, scale=scale, zero=zero, inv_norms=inv, base=base, ntotal=n,
                                mesh=mesh)
