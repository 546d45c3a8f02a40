"""IVF (inverted-file) retrieval index: clustered ANN search on one card —
the port of ``clip_codec_tpu/index/ivf.py``.

FAISS's ``IndexIVFFlat`` analogue: k-means clusters the vectors into
``nlist`` inverted lists and a query scores only the ``nprobe`` lists whose
centroids score highest for it.

* **Training** is Lloyd k-means on the device: each iteration scores row
  chunks against the centroids (``torch.matmul`` in full fp32), keeps the
  first maximum (``argmax``, as ``jnp.argmax``), and sums each cluster's
  rows as a product with the chunk's one-hot assignment matrix. Where the
  JAX package's ``segment_sum`` would become ``index_add_``, whose fp32
  atomics on CUDA sum in another order each run, the product sums in one
  order: two builds of one store give bit-equal centroids and lists.
* **Storage** is one dense ``(nlist, cap, D)`` tensor of zero-padded lists
  (id -1 on padding, masked to -inf before ranking), fp32 or the store's
  raw uint8 codes with per-entry ``list_inv`` = 1/|x|.
* **Search**: the centroid product, the probe (``_rank``, ``lax.top_k``'s
  order), then the probed lists' scores (uint8: the hand-written kernel
  ``ops.u8_scan.u8_ip_probe``, which reads the lists where they lie; fp32:
  a gather and a batched product), then ``_rank_candidates`` over the
  flattened (nprobe, cap) pool by position, mapped to ids.

The bucketing, the rebalance and the seeded init are host numpy, copied
from the JAX package as they are, so the same data gives the same lists.
Semantics match FAISS IVF with ``METRIC_INNER_PRODUCT``; probing
``nprobe >= nlist`` is exact (every row lives in exactly one list).
``shard_ivf_index`` splits the lists over a mesh's ``data`` axis
(``ShardedIVFIndex``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops.u8_scan import CHUNK_ROWS, fold_query, full_fp32, u8_ip_probe
from .search import Device, _device, _host, _no_hits, _queries, _rank, _tensor

__all__ = ["IVFIndex", "build_ivf_index", "build_ivf_index_u8", "kmeans", "ShardedIVFIndex", "shard_ivf_index"]


# ------------------------------------------------------------------ k-means


def _lloyd_step(feats: torch.Tensor, centroids: torch.Tensor, chunk: int = CHUNK_ROWS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration. L2 assignment via the IP trick: argmin |x-c|^2 =
    argmax (x.c - |c|^2/2). Returns (new_centroids, assignments (N,) int64).
    Cluster sums are a one-hot product per row chunk, summed in chunk order:
    the same sums on every run, with no atomics."""
    nlist = centroids.shape[0]
    assign = torch.empty((feats.shape[0],), dtype=torch.int64, device=feats.device)
    sums = torch.zeros_like(centroids)
    with full_fp32():
        half_cn = 0.5 * torch.sum(centroids * centroids, dim=1)
        for lo in range(0, feats.shape[0], chunk):
            f = feats[lo:lo + chunk]
            a = torch.argmax(f @ centroids.T - half_cn, dim=1)
            assign[lo:lo + chunk] = a
            onehot = torch.zeros((f.shape[0], nlist), dtype=f.dtype, device=f.device)
            onehot.scatter_(1, a[:, None], 1.0)
            sums += onehot.T @ f
    counts = torch.bincount(assign, minlength=nlist).to(torch.float32)
    # empty cluster: keep the previous centroid (FAISS reassigns; for the
    # codec's scale an idle centroid simply never wins a probe)
    new = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], centroids)
    return new, assign


def kmeans(feats, nlist: int, iters: int = 10, seed: int = 0, device: Device = "cuda"
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Plain Lloyd k-means on ``device``. Returns (centroids (nlist, D) fp32,
    assignments (N,) int32). Deterministic: init takes ``nlist`` distinct
    rows with a seeded host RNG, the JAX package's draw."""
    x = _tensor(feats, torch.float32, _device(device))
    n = x.shape[0]
    if nlist > n:
        raise ValueError(f"nlist={nlist} > ntotal={n}")
    init = np.random.default_rng(seed).choice(n, size=nlist, replace=False)
    cent = x[torch.from_numpy(np.sort(init)).to(x.device)]
    assign = None
    for _ in range(max(1, int(iters))):
        cent, assign = _lloyd_step(x, cent)
    return cent.cpu().numpy(), assign.cpu().numpy().astype(np.int32)


# ------------------------------------------------------------------- search


def _rank_candidates(sims: torch.Tensor, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask padding rows to -inf, flatten the probed pool, rank by position
    with -inf / -1 padding where the pool is smaller than k."""
    sims = torch.where(ids >= 0, sims, -torch.inf)
    qn = sims.shape[0]
    sims, ids = sims.reshape(qn, -1), ids.reshape(qn, -1)
    if sims.shape[1] < k:
        pad = k - sims.shape[1]
        sims = torch.nn.functional.pad(sims, (0, pad), value=-torch.inf)
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    s, j = _rank(sims, k)
    return s, ids.gather(1, j)


@dataclass
class IVFIndex:
    """Clustered inner-product index (FAISS ``IndexIVFFlat`` analogue).

    ``lists``/``list_ids`` hold every vector exactly once, bucketed by
    nearest centroid and zero-padded to the common capacity, so searching
    with ``nprobe >= nlist`` is exact (the hits of
    :class:`~.search.FlatIPIndex`).

    uint8-resident variant (:func:`build_ivf_index_u8`): ``lists`` holds the
    store's raw codes with per-entry ``list_inv`` = 1/|x| and the codec
    ``scale``/``zero``: a quarter of the resident bytes, scored where the
    lists lie by ``u8_ip_probe``.
    """

    centroids: torch.Tensor   # (nlist, D) fp32
    lists: torch.Tensor       # (nlist, cap, D) fp32, or uint8 codes (u8 mode)
    list_ids: torch.Tensor    # (nlist, cap) int32, -1 = padding
    ntotal: int
    nprobe: int = 8           # default probe width for .search
    # u8 mode only (None in fp32 mode):
    scale: torch.Tensor | None = None     # (D,) fp32
    zero: torch.Tensor | None = None      # (D,) fp32
    list_inv: torch.Tensor | None = None  # (nlist, cap) fp32, 0 on padding

    @property
    def nlist(self) -> int:
        return int(self.centroids.shape[0])

    def search(self, queries, k: int, nprobe: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) queries -> (scores (Q, k), ids (Q, k)) descending; ids are
        -1 (scores -inf) past the candidates the probed lists held (FAISS
        semantics: callers skip negatives)."""
        q = _queries(queries, self.centroids.device)
        if self.ntotal == 0:
            return _no_hits(q.shape[0])
        np_ = self.nprobe if nprobe is None else int(nprobe)
        scores, ids = self._search(q, max(1, min(k, self.ntotal)), max(1, min(np_, self.nlist)))
        return scores.cpu().numpy(), ids.cpu().numpy()

    def _search(self, q: torch.Tensor, k: int, nprobe: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device tensors in and out, no host sync (a CUDA graph captures it)."""
        with full_fp32():
            cscores = q @ self.centroids.T                  # (Q, nlist)
        probe = _rank(cscores, nprobe)[1]                   # (Q, nprobe)
        if self.scale is not None:
            qs, qz = fold_query(q, self.scale, self.zero)
            sims = u8_ip_probe(self.lists, self.list_inv, probe.to(torch.int32), qs, qz)
        else:
            with full_fp32():
                sims = torch.einsum("qd,qpcd->qpc", q, self.lists[probe])
        return _rank_candidates(sims, self.list_ids[probe], k)


def _rebalance(
    feats: np.ndarray, centroids: np.ndarray, assign: np.ndarray, cap: int
) -> np.ndarray:
    """Spill rows of over-full clusters to their next-nearest centroid with
    room, keeping every row in exactly one list and every list <= cap.
    Host cost is O(spill * nlist) — scores are computed only for members of
    over-full clusters, never the full (N, nlist) matrix."""
    counts = np.bincount(assign, minlength=centroids.shape[0])
    half_cn = 0.5 * np.sum(centroids**2, axis=1)
    spill_rows = []
    for c in np.where(counts > cap)[0]:
        members = np.where(assign == c)[0]
        # keep the rows that like c most; spill the rest
        keep_rank = feats[members] @ centroids[c] - half_cn[c]
        spill = members[np.argsort(-keep_rank)[cap:]]
        counts[c] -= len(spill)
        spill_rows.append(spill)
    if not spill_rows:
        return assign
    spill = np.concatenate(spill_rows)
    order = np.argsort(-(feats[spill] @ centroids.T - half_cn), axis=1)
    for j, r in enumerate(spill):
        for alt in order[j]:
            if counts[alt] < cap:
                assign[r] = alt
                counts[alt] += 1
                break
    return assign


def build_ivf_index(
    feats,
    nlist: int | None = None,
    nprobe: int = 8,
    iters: int = 10,
    seed: int = 0,
    max_imbalance: float = 4.0,
    device: Device = "cuda",
) -> IVFIndex:
    """Train k-means and bucket ``feats`` into padded inverted lists.

    ``nlist`` defaults to ~sqrt(N) (FAISS guidance). ``max_imbalance`` caps
    list capacity at ``max_imbalance * ceil(N/nlist)``; overflow rows are
    reassigned to their next-nearest centroid. ``None`` keeps the raw
    assignments (cap = largest list)."""
    dev = _device(device)
    feats = _host(feats)
    n, d = feats.shape if feats.ndim == 2 else (0, 0)
    if n == 0:
        return _empty_ivf(d, dev)
    slots = _train_and_slot(feats, nlist, iters, seed, max_imbalance, dev)
    centroids, nlist, cap, sorted_assign, slot, row_order = slots
    lists = np.zeros((nlist, cap, d), np.float32)
    ids = np.full((nlist, cap), -1, np.int32)
    lists[sorted_assign, slot] = feats[row_order]
    ids[sorted_assign, slot] = row_order
    return IVFIndex(
        centroids=torch.from_numpy(centroids).to(dev), lists=torch.from_numpy(lists).to(dev),
        list_ids=torch.from_numpy(ids).to(dev), ntotal=n,
        nprobe=max(1, min(int(nprobe), nlist)),
    )


def _empty_ivf(d: int, dev: torch.device) -> IVFIndex:
    z = torch.zeros((1, max(d, 1)), dtype=torch.float32, device=dev)
    return IVFIndex(
        centroids=z, lists=z[:, None, :],
        list_ids=torch.full((1, 1), -1, dtype=torch.int32, device=dev), ntotal=0, nprobe=1,
    )


def _resolve_nlist(n: int, nlist) -> int:
    if nlist is None:
        nlist = max(1, min(n, int(round(np.sqrt(n)))))
    return max(1, min(int(nlist), n))


def _slot(assign: np.ndarray, nlist: int):
    """Vectorized slot assignment (stable-sort rows by cluster, slot = rank
    in run). Returns (cap, sorted_assign, slot, row_order)."""
    n = assign.shape[0]
    counts = np.bincount(assign, minlength=nlist)
    cap = max(1, int(counts.max()))
    row_order = np.argsort(assign, kind="stable")
    sorted_assign = assign[row_order]
    starts = np.searchsorted(sorted_assign, np.arange(nlist))
    slot = np.arange(n) - starts[sorted_assign]
    return cap, sorted_assign, slot, row_order


def _train_and_slot(feats, nlist, iters, seed, max_imbalance, dev):
    """k-means train + rebalance + slot assignment — shared by the fp32 and
    (small-store) u8 builders so both bucket identically."""
    n = feats.shape[0]
    nlist = _resolve_nlist(n, nlist)
    centroids, assign = kmeans(feats, nlist, iters=iters, seed=seed, device=dev)
    if max_imbalance is not None and nlist > 1:
        cap = int(np.ceil(max_imbalance * np.ceil(n / nlist)))
        assign = _rebalance(feats, centroids, assign.copy(), cap)
    cap, sorted_assign, slot, row_order = _slot(assign, nlist)
    return centroids, nlist, cap, sorted_assign, slot, row_order


def _assign_codes_batched(codes: np.ndarray, scale: np.ndarray, zero: np.ndarray, centroids: np.ndarray,
                          batch: int = CHUNK_ROWS, device: Device = "cuda") -> np.ndarray:
    """Assign every code row to its nearest centroid in device batches:
    dequantize and renormalize a chunk, then :func:`_lloyd_step`'s rule.
    Peak device fp32 is one (batch, D) chunk, never (N, D). (The JAX package
    pads the last chunk for XLA's compile cache; nothing here needs that.)"""
    dev = _device(device)
    cent = torch.from_numpy(centroids).to(dev)
    half = torch.from_numpy(0.5 * np.sum(centroids.astype(np.float32) ** 2, axis=1)).to(dev)
    scale_d, zero_d = _tensor(scale, torch.float32, dev), _tensor(zero, torch.float32, dev)
    out = np.empty((codes.shape[0],), np.int32)
    for lo in range(0, codes.shape[0], batch):
        x = _tensor(codes[lo:lo + batch], torch.float32, dev) * scale_d[None, :] + zero_d[None, :]
        xhat = x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)), min=1e-9)
        with full_fp32():
            out[lo:lo + batch] = torch.argmax(xhat @ cent.T - half[None, :], dim=1).cpu().numpy()
    return out


def build_ivf_index_u8(
    codes,
    scale,
    zero,
    nlist: int | None = None,
    nprobe: int = 8,
    iters: int = 10,
    seed: int = 0,
    max_imbalance: float = 4.0,
    device: Device = "cuda",
) -> IVFIndex:
    """IVF over the store's raw uint8 codes (``Store.read_codes()`` +
    ``codec_meta.npz``): k-means trains on the dequantized, renormalized
    vectors (the fp32 builder's clustering given the same data), but the
    resident lists hold the uint8 codes + per-entry 1/|x|. Where N >
    256 * nlist (FAISS's max_points_per_centroid) k-means trains on a seeded
    subsample and every row is assigned from its codes in device batches."""
    dev = _device(device)
    codes = np.ascontiguousarray(_host(codes, np.uint8))
    scale, zero = _host(scale), _host(zero)
    n, d = codes.shape if codes.ndim == 2 else (0, 0)
    if n == 0:
        idx = _empty_ivf(d, dev)  # ntotal=0 short-circuits .search before any math
        idx.scale = torch.ones((max(d, 1),), dtype=torch.float32, device=dev)
        idx.zero = torch.zeros((max(d, 1),), dtype=torch.float32, device=dev)
        idx.lists = torch.zeros(idx.lists.shape, dtype=torch.uint8, device=dev)
        idx.list_inv = torch.zeros((1, 1), dtype=torch.float32, device=dev)
        return idx
    x = codes.astype(np.float32) * scale + zero  # host fp32 (RAM, not device memory)
    inv = 1.0 / np.maximum(np.linalg.norm(x, axis=1), 1e-9)
    feats = x * inv[:, None]
    nlist = _resolve_nlist(n, nlist)
    train_cap = 256 * nlist  # FAISS max_points_per_centroid guidance
    if n > train_cap:
        # large store: train on a subsample, assign every row from its codes
        sel = np.sort(np.random.default_rng(seed).choice(n, train_cap, replace=False))
        centroids, _ = kmeans(feats[sel], nlist, iters=iters, seed=seed, device=dev)
        assign = _assign_codes_batched(codes, scale, zero, centroids, device=dev)
        if max_imbalance is not None and nlist > 1:
            lcap = int(np.ceil(max_imbalance * np.ceil(n / nlist)))
            assign = _rebalance(feats, centroids, assign, lcap)
        cap, sorted_assign, slot, row_order = _slot(assign, nlist)
    else:
        # small store: the fp32 builder's train/bucket path
        slots = _train_and_slot(feats, nlist, iters, seed, max_imbalance, dev)
        centroids, nlist, cap, sorted_assign, slot, row_order = slots
    lists = np.zeros((nlist, cap, d), np.uint8)
    list_inv = np.zeros((nlist, cap), np.float32)
    ids = np.full((nlist, cap), -1, np.int32)
    lists[sorted_assign, slot] = codes[row_order]
    list_inv[sorted_assign, slot] = inv[row_order]
    ids[sorted_assign, slot] = row_order
    return IVFIndex(
        centroids=torch.from_numpy(centroids).to(dev), lists=torch.from_numpy(lists).to(dev),
        list_ids=torch.from_numpy(ids).to(dev), ntotal=n,
        nprobe=max(1, min(int(nprobe), nlist)),
        scale=_tensor(scale, torch.float32, dev), zero=_tensor(zero, torch.float32, dev),
        list_inv=torch.from_numpy(list_inv).to(dev),
    )


# ------------------------------------------------------------------ sharded


@dataclass
class ShardedIVFIndex:
    """:class:`IVFIndex` with the inverted lists split over a mesh's ``data``
    axis, fp32 or uint8 (``scale``/``zero``/``list_inv`` set). The
    centroids are whole on every rank, so every rank computes the same
    probe set; each scores only the probed lists it owns (the uint8 form
    through ``u8_ip_probe``), takes its local top-k, and the ranks'
    candidates are merged on the host. Every real list lives on exactly one
    rank, so the hits are :class:`IVFIndex`'s (among equal scores held by
    different ranks the lower rank's come first). Build with
    :func:`shard_ivf_index`."""

    centroids: torch.Tensor  # (nlist, D) fp32, whole
    lists: torch.Tensor      # (local_nlist, cap, D) this rank's lists, zero-padded
    list_ids: torch.Tensor   # (local_nlist, cap) int32, -1 = padding
    base: int                # the first list this rank owns
    ntotal: int
    nlist_real: int
    mesh: object
    nprobe: int = 8
    scale: torch.Tensor | None = None
    zero: torch.Tensor | None = None
    list_inv: torch.Tensor | None = None  # (local_nlist, cap) in u8 mode

    def search(self, queries, k: int, nprobe: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) queries -> (scores (Q, k), ids (Q, k)) descending; past the
        candidates the probed lists held, ids are -1 and scores 0 (the JAX
        sharded index's contract), padded to exactly k columns."""
        from ..parallel.mesh import all_gather_rows

        q = _queries(queries, self.centroids.device)
        nq = q.shape[0]
        if self.ntotal == 0:
            return _no_hits(nq)
        k = max(1, min(k, self.ntotal))
        np_ = max(1, min(self.nprobe if nprobe is None else int(nprobe), self.nlist_real))
        local_nlist, cap = self.list_ids.shape
        with full_fp32():
            probe = _rank(q @ self.centroids.T, np_)[1]          # (Q, nprobe) global list ids
        lp = probe - self.base
        own = (lp >= 0) & (lp < local_nlist)
        lpc = torch.clamp(lp, 0, local_nlist - 1)
        if self.scale is not None:
            qs, qz = fold_query(q, self.scale, self.zero)
            sims = u8_ip_probe(self.lists, self.list_inv, lpc.to(torch.int32), qs, qz)
        else:
            with full_fp32():
                sims = torch.einsum("qd,qpcd->qpc", q, self.lists[lpc])
        ids = torch.where(own[..., None], self.list_ids[lpc], -1)
        sims = torch.where(ids >= 0, sims, -torch.inf).reshape(nq, -1)
        s, j = _rank(sims, min(k, np_ * cap))
        ids = ids.reshape(nq, -1).gather(1, j)
        s = all_gather_rows(self.mesh, s, dim=1).cpu().numpy()
        ids = all_gather_rows(self.mesh, ids, dim=1).cpu().numpy()
        s = np.where(ids >= 0, s, -np.inf)
        order = np.argsort(-s, axis=1, kind="stable")[:, :k]
        rows = np.arange(nq)[:, None]
        s, i = s[rows, order], ids[rows, order]
        i = np.where(np.isfinite(s), i, -1).astype(np.int32)
        s = np.where(np.isfinite(s), s, 0.0).astype(np.float32)
        if s.shape[1] < k:  # nprobe * cap * shards < k
            s = np.pad(s, ((0, 0), (0, k - s.shape[1])))
            i = np.pad(i, ((0, 0), (0, k - i.shape[1])), constant_values=-1)
        return s, i


def shard_ivf_index(index: IVFIndex, mesh) -> ShardedIVFIndex:
    """Split an :class:`IVFIndex`'s inverted lists over ``mesh``'s ``data``
    axis (fp32 or uint8) onto each rank's device. Lists are padded to a
    multiple of the axis with id -1 rows, masked before ranking and never
    probed (probe ids come from the real centroids)."""
    from ..parallel.mesh import axis_index, axis_size, rank_device

    dev = rank_device(mesh)
    n_sh = axis_size(mesh)
    nlist_real, cap = index.list_ids.shape
    per = -(-nlist_real // n_sh)
    lo = axis_index(mesh) * per
    hi = min(lo + per, nlist_real)

    def block(t: torch.Tensor, fill) -> torch.Tensor:
        got = t[lo:hi].to(dev)
        pad = per - got.shape[0]
        if pad:
            got = torch.cat([got, torch.full((pad,) + tuple(t.shape[1:]), fill, dtype=t.dtype, device=dev)])
        return got.contiguous()

    u8 = index.scale is not None
    return ShardedIVFIndex(
        centroids=index.centroids.to(dev), lists=block(index.lists, 0), list_ids=block(index.list_ids, -1),
        base=lo, ntotal=index.ntotal, nlist_real=nlist_real, mesh=mesh, nprobe=index.nprobe,
        scale=index.scale.to(dev) if u8 else None, zero=index.zero.to(dev) if u8 else None,
        list_inv=block(index.list_inv, 0.0) if u8 else None)
