"""K1's port (clip_codec_tpu_torch/ops/groupnorm.py) against the JAX package.

Seeded numpy inputs go through JAX's jnp ``group_norm_silu``, its Pallas
kernel ``pallas_groupnorm._forward`` in TPU interpret mode, and the port's
plain versions: the two-pass ``group_norm_silu_plain`` (JAX's jnp function)
and the per-kernel plain pieces (the stats partials and the norm pass, the
kernel's raw-moment arithmetic). fp32 within 1e-5, as the JAX package holds
its own kernel to its jnp version (tests/test_pallas_ops.py); bf16 within
rtol = atol = 2e-2 (the jnp version rounds the normalised value to bf16
once more). The autograd Function, whose backward recomputes the plain
version, against ``jax.grad`` through ``group_norm_silu_pallas`` within 1e-4
of each gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_codec_tpu.ops import pallas_groupnorm as pg
from clip_codec_tpu.ops.groupnorm import group_norm_silu as jax_gn_silu
from clip_codec_tpu_torch.ops import groupnorm as gn

torch.set_num_threads(1)

# tests/test_pallas_ops.py's shapes, then groups of fewer than 8 channels
# (C/G = 4 and 3) and a ragged pixel count
SHAPES = [((2, 8, 8, 16), 8), ((1, 16, 8, 32), 4), ((2, 12, 4, 8), 8),
          ((2, 6, 5, 32), 8), ((3, 7, 9, 24), 8), ((1, 37, 29, 64), 8)]


def _inputs(rng, shape):
    C = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(C)).astype(np.float32)
    return x, scale, bias


def _pallas(x, scale, bias, groups):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pg._forward(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups, 1e-5),
                          dtype=np.float32)


def _kernel_pieces(x, scale, bias, groups):
    """The port's plain versions of the stats and norm kernels, chained."""
    part = gn.group_norm_silu_stats(x)
    assert part.shape == (x.shape[0], gn.n_chunks(x.shape[0], x.shape[1] * x.shape[2]), 2, x.shape[3])
    return gn.group_norm_silu_norm(x, part, scale, bias, groups)


@pytest.mark.parametrize("shape,groups", SHAPES)
def test_plain_versions_match_jax_fp32(rng, shape, groups):
    x, scale, bias = _inputs(rng, shape)
    want_jnp = np.asarray(jax_gn_silu(jnp.asarray(x), (jnp.asarray(scale), jnp.asarray(bias)), groups))
    want_pallas = _pallas(x, scale, bias, groups)
    tx, ts, tb = map(torch.from_numpy, (x, scale, bias))
    plain = gn.group_norm_silu_plain(tx, (ts, tb), groups).numpy()
    pieces = _kernel_pieces(tx, ts, tb, groups).numpy()
    dispatched = gn.group_norm_silu(tx, (ts, tb), groups).numpy()  # a CPU tensor takes the plain version
    np.testing.assert_array_equal(dispatched, plain)
    for got in (plain, pieces):
        np.testing.assert_allclose(got, want_jnp, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,groups", SHAPES[:1] + SHAPES[4:])
def test_plain_versions_match_jax_bf16(rng, shape, groups):
    x, scale, bias = _inputs(rng, shape)
    xb = jnp.asarray(x, jnp.bfloat16)
    want_jnp = np.asarray(jax_gn_silu(xb, (jnp.asarray(scale), jnp.asarray(bias)), groups), dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(pg._forward(xb, jnp.asarray(scale), jnp.asarray(bias), groups, 1e-5),
                                 dtype=np.float32)
    tx = torch.from_numpy(np.asarray(xb, dtype=np.float32)).to(torch.bfloat16)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    plain = gn.group_norm_silu_plain(tx, (ts, tb), groups)
    pieces = _kernel_pieces(tx, ts, tb, groups)
    assert plain.dtype == pieces.dtype == torch.bfloat16
    for got, want in ((plain, want_jnp), (pieces, want_pallas), (pieces, want_jnp)):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_stats_partials_are_the_chunk_sums(rng):
    """The stats kernel's plain version: per-chunk sums and sums of squares
    of ceil(HW / K) pixels, the last chunk ragged, in fp32."""
    x = torch.from_numpy(rng.standard_normal((2, 37, 29, 16)).astype(np.float32))
    K = gn.n_chunks(2, 37 * 29)
    part = gn.group_norm_silu_stats(x).numpy().astype(np.float64)
    flat = x.numpy().astype(np.float64).reshape(2, -1, 16)
    chunk = -(-flat.shape[1] // K)
    assert 1 < K and flat.shape[1] % chunk
    for k in range(K):
        sl = flat[:, k * chunk:(k + 1) * chunk]
        np.testing.assert_allclose(part[:, k, 0], sl.sum(1), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(part[:, k, 1], (sl * sl).sum(1), rtol=1e-5, atol=1e-4)


def test_chunk_rule():
    """One block per (chunk, sample); at the training shapes (B = 8) the
    grid stays within ~4 blocks per SM, and no chunk count exceeds
    sqrt(HW / 8)."""
    assert [gn.n_chunks(8, s * s) for s in (256, 128, 64, 32)] == [66, 45, 22, 11]
    assert gn.n_chunks(1, 3) == 1 and gn.n_chunks(2, 1) == 1


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 16), 8), ((3, 7, 9, 24), 8)])
def test_autograd_function_matches_jax_grad(rng, shape, groups):
    """The autograd Function (its forward takes the kernel pieces' plain
    versions on the CPU) against jax.grad through group_norm_silu_pallas,
    whose custom VJP differentiates the jnp version."""
    x, scale, bias = _inputs(rng, shape)
    g = rng.standard_normal(shape).astype(np.float32)

    def f(xx, ss, bb):
        return jnp.sum(pg.group_norm_silu_pallas(xx, ss, bb, groups, 1e-5) * g)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, scale, bias)))
    tx, ts, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias))
    y = gn._GroupNormSiLU.apply(tx, ts, tb, groups, 1e-5)
    (y * torch.from_numpy(g)).sum().backward()
    for t, w in zip((tx, ts, tb), want):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() <= 1e-4 * np.abs(w).max()
