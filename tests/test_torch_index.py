"""The port's retrieval layer (clip_codec_tpu_torch/index, ops/u8_scan.py)
against the JAX package on the same seeded numpy inputs, on the CPU, at
D = 16-100 and N <= 2000.

Tolerances: fp32 flat scores within 1e-6 (one product, another summation
order); uint8 scores within 1e-5 (the fold ``(qs . u + qz) * inv`` sums
values up to 255 * |qs|, and XLA fuses the dequantize into one multiply-add
where torch rounds twice); ids equal everywhere. Ties are held exactly:
``lax.top_k`` puts the lower index first among equal values, so stores
with duplicated rows and integer-valued scores (sums exact in fp32 in any
order) must give JAX's ids at k below, at and above the tie run, in the
flat, u8 and IVF indexes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_codec_tpu.codecs import fit_affine, quantize
from clip_codec_tpu.index import ivf as jivf
from clip_codec_tpu.index import search as jsearch
from clip_codec_tpu_torch import index as tindex
from clip_codec_tpu_torch.index import ivf as tivf
from clip_codec_tpu_torch.index import search as tsearch
from clip_codec_tpu_torch.ops import u8_scan

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _store(rng, n=2000, d=32):
    x = _unit(rng, n, d)
    scale, zero = fit_affine(x)
    return x, np.asarray(quantize(x, scale, zero)), np.asarray(scale), np.asarray(zero)


def _equal_hits(got, want, atol):
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0, atol=atol)
    assert got[1].dtype == np.int32 and got[0].dtype == np.float32


def test_flat_matches_jax(rng):
    x, q = _unit(rng, 2000, 32), _unit(rng, 7, 32)
    for k in (1, 10, 100):
        _equal_hits(tsearch.build_index(x, **CPU).search(q, k), jsearch.build_index(x).search(q, k), 1e-6)


def test_u8_flat_matches_jax(rng):
    x, codes, scale, zero = _store(rng)
    q = _unit(rng, 7, 32)
    got = tsearch.build_index_u8(codes, scale, zero, **CPU)
    want = jsearch.build_index_u8(codes, scale, zero)
    np.testing.assert_allclose(got.inv_norms.numpy(), np.asarray(want.inv_norms), rtol=1e-6, atol=0)
    for k in (1, 10, 100):
        _equal_hits(got.search(q, k), want.search(q, k), 1e-5)


@pytest.mark.parametrize("d", [16, 32, 100])
def test_u8_scores_plain_matches_jax(rng, d):
    """Every score of the plain u8_ip_scores against _u8_search_jit ranked in
    full (k = N), with the same fold of the query."""
    x, codes, scale, zero = _store(rng, 500, d)
    q = _unit(rng, 3, d)
    idx = tsearch.build_index_u8(codes, scale, zero, **CPU)
    qs, qz = u8_scan.fold_query(torch.from_numpy(q), idx.scale, idx.zero)
    s = u8_scan.u8_ip_scores(idx.codes, qs, qz, idx.inv_norms)
    assert s.shape == (3, 500) and s.dtype == torch.float32
    js, ji = jsearch._u8_search_jit(jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(zero),
                                    jsearch._u8_inv_norms(jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(zero)),
                                    jnp.asarray(q), 500)
    np.testing.assert_allclose(np.take_along_axis(s.numpy(), np.asarray(ji), 1), np.asarray(js), rtol=0, atol=1e-5)
    ts, ti = tsearch._rank(s, 500)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("d", [16, 32, 100])
def test_u8_probe_plain_matches_jax_einsum(rng, d):
    """u8_ip_probe_plain against _ivf_u8_search's einsum over the probed
    lists, and against u8_ip_scores of the same rows."""
    x, codes, scale, zero = _store(rng, 600, d)
    lists = rng.integers(0, 256, (9, 40, d), dtype=np.uint8)
    inv = rng.random((9, 40)).astype(np.float32)
    probe = rng.integers(0, 9, (4, 3)).astype(np.int32)
    q = _unit(rng, 4, d)
    qs, qz = u8_scan.fold_query(torch.from_numpy(q), torch.tensor(scale), torch.tensor(zero))
    got = u8_scan.u8_ip_probe(torch.from_numpy(lists), torch.from_numpy(inv), torch.from_numpy(probe), qs, qz)
    jqs, jqz = jnp.asarray(q) * jnp.asarray(scale)[None, :], jnp.asarray(q) @ jnp.asarray(zero)
    cand = jnp.asarray(lists)[jnp.asarray(probe)]
    want = (jnp.einsum("qd,qpcd->qpc", jqs, cand.astype(jnp.float32)) + jqz[:, None, None]) * jnp.asarray(inv)[
        jnp.asarray(probe)]
    assert got.shape == (4, 3, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    flat = u8_scan.u8_ip_scores(torch.from_numpy(lists[probe[1]].reshape(-1, d)), qs[1:2], qz[1:2],
                                torch.from_numpy(inv[probe[1]].reshape(-1)))
    torch.testing.assert_close(got[1].reshape(1, -1), flat, rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 5, 37, 120, 5000])
def test_rank_is_lax_top_k_with_ties(rng, k):
    """Integer-valued scores (runs of equal values), -inf and signed zeros:
    the same values, positions and order as lax.top_k."""
    s = np.floor(rng.standard_normal((3, 5000)) * 3).astype(np.float32)
    s[0, ::7] = -np.inf
    s[1, ::5] = -0.0
    s[2, 100:400] = 9.0  # a tie run across the k-th place
    jv, ji = jax.lax.top_k(jnp.asarray(s), k)
    tv, ti = tsearch._rank(torch.from_numpy(s), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32), np.asarray(jv).view(np.uint32))


def _tie_store(rng, d=16):
    """Codes whose scores are exact in fp32 in any summation order: small
    integers, a power-of-two scale, zero offset; rows 3, 10, 11, 40, 41, 42
    and 63 are one row seven times, and rows 20-29 are row 50 (identical
    rows also get identical 1/|x| in the u8 fold)."""
    codes = rng.integers(0, 4, (64, d)).astype(np.uint8)
    codes[[10, 11, 40, 41, 42, 63]] = codes[3]
    codes[20:30] = codes[50]
    scale, zero = np.full(d, 0.5, np.float32), np.zeros(d, np.float32)
    return codes, scale, zero


@pytest.mark.parametrize("k", [2, 7, 9, 64])
def test_tied_rows_rank_as_jax(rng, k):
    """Duplicated rows tie exactly; flat, u8 and IVF (full probe, and a
    partial one) give JAX's ids at k below, at and above the tie run."""
    codes, scale, zero = _tie_store(rng)
    x = codes.astype(np.float32) * 0.5
    q = np.stack([x[3], x[50], np.full(16, 0.25, np.float32)])  # dyadic: exact scores
    _equal_hits(tsearch.build_index(x, **CPU).search(q, k), jsearch.build_index(x).search(q, k), 0)
    u8_got = tsearch.build_index_u8(codes, scale, zero, **CPU).search(q, k)
    u8_want = jsearch.build_index_u8(codes, scale, zero).search(q, k)
    np.testing.assert_array_equal(u8_got[1], np.asarray(u8_want[1]))
    for nprobe in (2, 8):
        got = tivf.build_ivf_index(x, nlist=8, **CPU).search(q, k, nprobe=nprobe)
        want = jivf.build_ivf_index(x, nlist=8).search(q, k, nprobe=nprobe)
        _equal_hits(got, want, 0)
        got = tivf.build_ivf_index_u8(codes, scale, zero, nlist=8, **CPU).search(q, k, nprobe=nprobe)
        want = jivf.build_ivf_index_u8(codes, scale, zero, nlist=8).search(q, k, nprobe=nprobe)
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0, atol=1e-5)
    ids = tsearch.build_index(x, **CPU).search(x[3], 7)[1][0]
    assert ids.tolist() == [3, 10, 11, 40, 41, 42, 63]  # the seven copies, lowest index first


def test_edges_match_jax(rng):
    """k > ntotal (clamped), a 1-D query, an empty store of each kind, and
    IVF pools smaller than k padded with -1 and -inf as JAX pads them."""
    x, codes, scale, zero = _store(rng, 12, 16)
    q = _unit(rng, 1, 16)[0]
    _equal_hits(tsearch.build_index(x, **CPU).search(q, 50), jsearch.build_index(x).search(q, 50), 1e-6)
    _equal_hits(tsearch.build_index_u8(codes, scale, zero, **CPU).search(q, 50),
                jsearch.build_index_u8(codes, scale, zero).search(q, 50), 1e-5)
    empty_f, empty_u = np.zeros((0, 16), np.float32), np.zeros((0, 16), np.uint8)
    qq = np.stack([q, q])
    for got, want in ((tsearch.build_index(empty_f, **CPU), jsearch.build_index(empty_f)),
                      (tsearch.build_index_u8(empty_u, scale, zero, **CPU), jsearch.build_index_u8(empty_u, scale, zero)),
                      (tivf.build_ivf_index(empty_f, **CPU), jivf.build_ivf_index(empty_f)),
                      (tivf.build_ivf_index_u8(empty_u, scale, zero, **CPU),
                       jivf.build_ivf_index_u8(empty_u, scale, zero))):
        (gs, gi), (ws, wi) = got.search(qq, 5), want.search(qq, 5)
        assert gs.shape == ws.shape == gi.shape == wi.shape == (2, 0) and gi.dtype == np.int32
    # nlist 6 over 12 rows: lists of ~2, so a 1-list probe holds fewer than k = 8
    for tb, jb in ((lambda: tivf.build_ivf_index(x, nlist=6, nprobe=1, **CPU),
                    lambda: jivf.build_ivf_index(x, nlist=6, nprobe=1)),
                   (lambda: tivf.build_ivf_index_u8(codes, scale, zero, nlist=6, nprobe=1, **CPU),
                    lambda: jivf.build_ivf_index_u8(codes, scale, zero, nlist=6, nprobe=1))):
        got, want = tb().search(q, 8), jb().search(q, 8)
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        assert (got[1] == -1).any() and np.isneginf(got[0][got[1] == -1]).all()
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0, atol=1e-5)


def test_kmeans_matches_jax(rng):
    x = _unit(rng, 1500, 24)
    cj, aj = jivf.kmeans(x, 20, iters=6, seed=3)
    ct, at = tivf.kmeans(x, 20, iters=6, seed=3, **CPU)
    init = np.sort(np.random.default_rng(3).choice(1500, 20, replace=False))
    c1, _ = tivf.kmeans(x, 20, iters=1, seed=3, **CPU)
    first = tivf._lloyd_step(torch.from_numpy(x), torch.from_numpy(x[init]))[0].numpy()
    np.testing.assert_array_equal(c1, first)  # the same init rows
    np.testing.assert_allclose(ct, np.asarray(cj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(at, np.asarray(aj))
    assert at.dtype == np.int32
    with pytest.raises(ValueError, match="nlist=30 > ntotal=20"):
        tivf.kmeans(x[:20], 30, **CPU)


def _same_lists(got, want):
    np.testing.assert_array_equal(got.list_ids.numpy(), np.asarray(want.list_ids))
    np.testing.assert_array_equal(got.lists.numpy(), np.asarray(want.lists))
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids), rtol=0, atol=1e-5)
    assert got.nprobe == want.nprobe and got.ntotal == want.ntotal


@pytest.mark.parametrize("max_imbalance", [4.0, 1.0, None])
def test_ivf_fp32_matches_jax(rng, max_imbalance):
    """Lists and ids equal JAX's (1.0 rebalances); full probe equals flat."""
    x, q = _unit(rng, 1500, 24), _unit(rng, 6, 24)
    got = tivf.build_ivf_index(x, nlist=12, nprobe=3, max_imbalance=max_imbalance, **CPU)
    want = jivf.build_ivf_index(x, nlist=12, nprobe=3, max_imbalance=max_imbalance)
    _same_lists(got, want)
    _equal_hits(got.search(q, 10), want.search(q, 10), 1e-6)
    _equal_hits(got.search(q, 10, nprobe=12), tsearch.build_index(x, **CPU).search(q, 10), 1e-6)


@pytest.mark.parametrize("nlist,max_imbalance", [(12, 4.0), (12, 1.0), (4, 4.0), (4, 1.0)],
                         ids=["small_store", "small_store_rebalanced", "subsample", "subsample_rebalanced"])
def test_ivf_u8_matches_jax(rng, nlist, max_imbalance):
    """Both train paths of build_ivf_index_u8 (2000 rows: 256 * 12 covers
    them, 256 * 4 does not): lists, ids and list_inv equal JAX's; full probe
    equals the flat u8 index."""
    x, codes, scale, zero = _store(rng, 2000, 32)
    q = _unit(rng, 6, 32)
    got = tivf.build_ivf_index_u8(codes, scale, zero, nlist=nlist, nprobe=2, max_imbalance=max_imbalance, **CPU)
    want = jivf.build_ivf_index_u8(codes, scale, zero, nlist=nlist, nprobe=2, max_imbalance=max_imbalance)
    _same_lists(got, want)
    np.testing.assert_array_equal(got.list_inv.numpy(), np.asarray(want.list_inv))
    if max_imbalance == 1.0:
        assert got.lists.shape[1] == -(-2000 // nlist)  # capped at ceil(N / nlist)
    _equal_hits(got.search(q, 10), want.search(q, 10), 1e-5)
    flat = tsearch.build_index_u8(codes, scale, zero, **CPU).search(q, 10)
    _equal_hits(got.search(q, 10, nprobe=nlist), flat, 1e-5)


def test_rebalance_caps_as_jax(rng):
    x = _unit(rng, 400, 8)
    cent = _unit(rng, 5, 8)
    assign = np.zeros(400, np.int64)
    assign[:300] = 2
    assign[300:] = rng.integers(0, 5, 100)
    got = tivf._rebalance(x, cent, assign.copy(), 90)
    np.testing.assert_array_equal(got, jivf._rebalance(x, cent, assign.copy(), 90))
    assert np.bincount(got, minlength=5).max() <= 90


def test_assign_codes_batched_matches_jax(rng):
    """In batches of 300 over 1000 rows (the last one short: JAX pads it)."""
    x, codes, scale, zero = _store(rng, 1000, 16)
    cent = _unit(rng, 7, 16)
    got = tivf._assign_codes_batched(codes, scale, zero, cent, batch=300, **CPU)
    np.testing.assert_array_equal(got, jivf._assign_codes_batched(codes, scale, zero, cent, batch=300))


def test_constructors_refuse_cuda_without_a_card(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, codes, scale, zero = _store(rng, 20, 16)
    for build in (lambda: tindex.build_index(x), lambda: tindex.build_index_u8(codes, scale, zero),
                  lambda: tindex.build_ivf_index(x), lambda: tindex.build_ivf_index_u8(codes, scale, zero),
                  lambda: tindex.kmeans(x, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_search_index_skips_padding(rng):
    x = _unit(rng, 12, 16)
    paths = [f"/imgs/{i}.png" for i in range(12)]
    idx = tivf.build_ivf_index(x, nlist=6, nprobe=1, **CPU)
    got = tindex.search_index(x[0], idx, paths, k=8)
    want = jsearch.search_index(x[0], jivf.build_ivf_index(x, nlist=6, nprobe=1), paths, k=8)
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) < 8
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=1e-6)
