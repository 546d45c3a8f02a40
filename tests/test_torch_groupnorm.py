"""K1's port (clip_codec_tpu_torch/ops/groupnorm.py) against the JAX package.

Seeded numpy inputs go through JAX's jnp ``group_norm_silu``, its Pallas
kernel ``pallas_groupnorm._forward`` in TPU interpret mode, and the port's
plain versions: the two-pass ``group_norm_silu_plain`` (JAX's jnp function)
and the kernel's plain pieces (its slab partials and the normalisation from
them, the kernel's raw-moment arithmetic). fp32 within 1e-5, as the JAX package holds
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
    """The port's plain version of the kernel: slab partials, then the
    normalisation from them."""
    part = gn.group_norm_silu_stats_plain(x, groups)
    B, H, W, C = x.shape
    assert part.shape == (B, -(-H * W // gn.slab_rows(H * W, C, x.element_size())), 2, groups)
    return gn.group_norm_silu_norm_plain(x, part, scale, bias, groups)


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
    """The kernel's slab partials: over each slab of ``slab_rows`` pixels,
    the last of a sample ragged, every group's sum and sum of squares in
    fp32 (C/G = 4 here)."""
    x = torch.from_numpy(rng.standard_normal((2, 37, 29, 16)).astype(np.float32))
    rows = gn.slab_rows(37 * 29, 16, 4)
    part = gn.group_norm_silu_stats_plain(x, 4).numpy().astype(np.float64)
    flat = x.numpy().astype(np.float64).reshape(2, -1, 4, 4)
    S = -(-flat.shape[1] // rows)
    assert part.shape == (2, S, 2, 4)
    # 512 rows of 64 bytes a slab: two full slabs and a ragged one
    assert rows == 512 and S == 3 and flat.shape[1] % rows
    for k in range(S):
        sl = flat[:, k * rows:(k + 1) * rows]
        np.testing.assert_allclose(part[:, k, 0], sl.sum((1, 3)), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(part[:, k, 1], (sl * sl).sum((1, 3)), rtol=1e-5, atol=1e-4)


def test_chunk_rule():
    """The slab cut is a function of the shape alone: chunks of 32 KB (one
    copy, one buffer), one a slab, or up to 4 where a sample has more than
    128 chunks. At the four batch-8 training shapes in bf16: 128 slabs of 4
    chunks at 256^2, 128, 64 and 32 slabs of one chunk below; 2 chunks a
    slab at 128^2 in fp32; a 512^2 sample (67 MB in bf16) is 512 slabs. The
    rounds and the grid that follow from the cut and the SM count are the
    kernel's own plan (tests/test_torch_cuda.py checks them on the card)."""
    want = {(256, 128): (128, 4, 128), (128, 128): (128, 1, 128), (64, 256): (64, 1, 64), (32, 512): (32, 1, 32)}
    for (s, C), (chunk_rows, chunks, S) in want.items():
        assert gn.slab_cut(s * s, C, 2) == (chunk_rows, chunks) and chunk_rows * C * 2 == 32768
        assert -(-s * s // gn.slab_rows(s * s, C, 2)) == S
    assert gn.slab_cut(128 * 128, 128, 4) == (64, 2)
    assert gn.slab_cut(512 * 512, 128, 2) == (128, 4) and 512 * 512 // gn.slab_rows(512 * 512, 128, 2) == 512
    assert gn.slab_cut(3, 8, 2) == (3, 1)
    assert gn.slab_cut(37 * 29, 64, 2) == (256, 1)  # 5 slabs, the last of 49 rows
    # the cut does not depend on the batch or the groups
    x = torch.zeros((2, 37, 29, 64), dtype=torch.bfloat16)
    assert gn.group_norm_silu_stats_plain(x, 8).shape == (2, 5, 2, 8)
    assert gn.group_norm_silu_stats_plain(x[:1], 64).shape == (1, 5, 2, 64)


HWS = [1, 3, 7 * 9, 37 * 29, 64 * 64, 100 * 100, 128 * 128, 256 * 256, 257 * 255, 512 * 512, 1024 * 1024]


@pytest.mark.parametrize("C", [8, 24, 64, 128, 200, 256, 512, 1000, 1024, 2040, 2048])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
def test_slab_cut_passes_the_kernels_checks(C, itemsize):
    """Every slab cut ``group_norm_silu`` may hand the kernel passes the
    argument checks of ``csrc/groupnorm_silu.cu`` (a chunk of at least one
    row and at most 32 KB, 1 to 4 chunks a slab), at every C the kernel
    takes and sample sizes from one pixel to 1024^2, and no slab is empty.
    That every such cut has a launch plan that fits a block's shared memory
    is checked against the kernel's own plan on the card."""
    for hw in HWS:
        rows, chunks = gn.slab_cut(hw, C, itemsize)
        assert 1 <= rows <= hw and rows <= 32768 // (C * itemsize) and 1 <= chunks <= 4
        slab = gn.slab_rows(hw, C, itemsize)
        S = -(-hw // slab)
        assert slab == rows * chunks and 0 < hw - (S - 1) * slab <= slab


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
