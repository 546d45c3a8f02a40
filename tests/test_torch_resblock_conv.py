"""Port of the fused affine(+SiLU)+conv3x3 op (clip_codec_tpu_torch/ops/resblock_conv.py)
against the JAX kernel.

On the CPU the port's wrappers run their plain PyTorch version; the JAX side
runs the Pallas kernel in TPU interpret mode. Inputs are made with numpy
from a seed and handed to both. Tolerances, fp32: y 1e-5 (same products,
other summation order), moments rtol 1e-4 / atol 1e-3 (sums of 256+ terms
of size ~10), the GroupNorm affines 1e-5.

The CUDA kernel itself is held against the plain version on a card in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_codec_tpu.ops import pallas_resblock as jpr
from clip_codec_tpu_torch.ops import resblock_conv as rc

torch.set_num_threads(1)


def _mk(rng, B, H, W, cin, cout, with_add):
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    A = (0.5 + rng.random((B, cin))).astype(np.float32)
    Bv = (rng.standard_normal((B, cin)) * 0.1).astype(np.float32)
    w9 = (rng.standard_normal((9, cin, cout)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    add = rng.standard_normal((B, H, W, cout)).astype(np.float32) if with_add else None
    return x, A, Bv, w9, bias, add


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("with_add", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("want_moments", [False, True], ids=["y", "moments"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 8), (1, 8, 8, 16, 8), (2, 24, 8, 8, 16)])
def test_affine_silu_conv3x3_matches_jax_kernel(rng, shape, with_add, want_moments):
    B, H, W, cin, cout = shape
    args = _mk(rng, B, H, W, cin, cout, with_add)
    with pltpu.force_tpu_interpret_mode():
        yj, mj = jpr.affine_silu_conv3x3(*map(_j, args), want_moments=want_moments)
    yt, mt = rc.affine_silu_conv3x3(*map(_t, args), want_moments=want_moments)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    if want_moments:
        assert mt.shape == (B, 2, cout)
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-4, atol=1e-3)
    else:
        assert mt is None


@pytest.mark.parametrize("cin,cout", [(8, 3), (8, 8), (16, 3)])
def test_affine_conv3x3_linear_matches_jax_kernel(rng, cin, cout):
    """The no-activation variant, incl. the 3-channel head width."""
    args = _mk(rng, 2, 16, 16, cin, cout, False)
    with pltpu.force_tpu_interpret_mode():
        yj, _ = jpr.affine_conv3x3(*map(_j, args))
    yt, _ = rc.affine_conv3x3(*map(_t, args))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)


def test_padding_is_zero_after_the_prologue(rng):
    """Out-of-image taps contribute 0, not silu(B): with x = 0 and w = 1 the
    corner output sums silu(B) over its 4 in-image taps only."""
    B = np.full((1, 1), 0.7, np.float32)
    x = np.zeros((1, 4, 4, 1), np.float32)
    w9 = np.ones((9, 1, 1), np.float32)
    zero = np.zeros(1, np.float32)
    y, _ = rc.affine_silu_conv3x3(_t(x), _t(np.ones((1, 1), np.float32)), _t(B), _t(w9), _t(zero))
    s = 0.7 / (1 + np.exp(-0.7))
    np.testing.assert_allclose(y[0, 0, 0, 0].item(), 4 * s, rtol=1e-6)
    np.testing.assert_allclose(y[0, 1, 1, 0].item(), 9 * s, rtol=1e-6)


def test_cpu_wrappers_count_no_launches(rng):
    args = map(_t, _mk(rng, 1, 8, 8, 8, 8, True))
    before = (rc.affine_silu_conv3x3.launches, rc.affine_conv3x3.launches)
    rc.affine_silu_conv3x3(*args)
    assert (rc.affine_silu_conv3x3.launches, rc.affine_conv3x3.launches) == before


def test_non_cpu_non_cuda_tensor_raises(rng):
    x, A, Bv, w9, bias = (_t(a).to("meta") for a in _mk(rng, 1, 8, 8, 32, 8, False)[:5])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rc.affine_silu_conv3x3(x, A, Bv, w9, bias)


def test_conv_weight_to_w9_matches_jax_layout(rng):
    """torch (Cout, Cin, 3, 3) -> (9, Cin, Cout) equals the JAX
    ``kernel(3, 3, Cin, Cout).reshape(9, Cin, Cout)`` of the same conv."""
    k = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)  # HWIO
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())     # export_unet's layout
    np.testing.assert_array_equal(rc.conv_weight_to_w9(w, torch.float32).numpy(), k.reshape(9, 5, 7))


@pytest.mark.parametrize("groups", [1, 4, 8])
def test_gn_affine_matches_jax(rng, groups):
    x = (rng.standard_normal((2, 8, 8, 16)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(16)).astype(np.float32)
    Aj, Bj = jpr.gn_affine(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups)
    At, Bt = rc.gn_affine(_t(x), _t(gamma), _t(beta), groups)
    np.testing.assert_allclose(At.numpy(), np.asarray(Aj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_film", [False, True], ids=["gn", "gn_of_film"])
def test_gn_affine_from_moments_matches_jax(rng, with_film):
    y = (rng.standard_normal((2, 8, 8, 16)) * 1.5 + 0.3).astype(np.float32)
    mom = np.stack([y.sum((1, 2)), (y * y).sum((1, 2))], 1)
    gamma = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(16)).astype(np.float32)
    film = tuple((0.2 * rng.standard_normal((2, 16))).astype(np.float32) for _ in range(2)) if with_film else None
    Aj, Bj = jpr.gn_affine_from_moments(jnp.asarray(mom), 64, jnp.asarray(gamma), jnp.asarray(beta), 8,
                                        film=None if film is None else tuple(map(jnp.asarray, film)))
    At, Bt = rc.gn_affine_from_moments(_t(mom), 64, _t(gamma), _t(beta), 8,
                                       film=None if film is None else tuple(map(_t, film)))
    np.testing.assert_allclose(At.numpy(), np.asarray(Aj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), rtol=1e-5, atol=1e-5)


def test_gn_affine_from_moments_clamps_negative_variance():
    """A constant channel's raw-moment variance can round below 0; it is
    clamped, so the affine stays finite (rsqrt(eps), not NaN)."""
    mom = torch.tensor([[[3.0], [8.999999]]])  # mean 3, E[y^2] a hair under 9
    A, B = rc.gn_affine_from_moments(mom, 1, torch.ones(1), torch.zeros(1), 1)
    assert torch.isfinite(A).all() and torch.isfinite(B).all()
    np.testing.assert_allclose(A.item(), 1 / np.sqrt(1e-5), rtol=1e-4)


@pytest.mark.parametrize("cout", [3, 8, 64, 70, 96, 129])
def test_pad_cout_pads_with_zero_columns_only_where_needed(rng, cout):
    """K2 takes Cout % 8 == 0: the wrapper pads w9, bias and the residual
    with zero columns (none when Cout is already a multiple of 8, the U-Net's
    case, so the main path copies nothing), and the padded conv's first Cout
    columns are the conv's."""
    w9 = torch.from_numpy(rng.standard_normal((9, 32, cout)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    add = torch.from_numpy(rng.standard_normal((2, 5, 6, cout)).astype(np.float32))
    w9p, bp, ap = rc.pad_cout(w9, bias, add)
    n = -(-cout // 8) * 8
    assert w9p.shape == (9, 32, n) and bp.shape == (n,) and ap.shape == (2, 5, 6, n)
    if n == cout:
        assert w9p is w9 and bp is bias and ap is add
    assert torch.equal(w9p[..., :cout], w9) and not w9p[..., cout:].any()
    assert torch.equal(bp[:cout], bias) and not bp[cout:].any()
    assert torch.equal(ap[..., :cout], add) and not ap[..., cout:].any()
    assert rc.pad_cout(w9, bias)[2] is None
    x = torch.from_numpy(rng.standard_normal((2, 5, 6, 32)).astype(np.float32))
    A = torch.from_numpy(0.5 + rng.random((2, 32)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((2, 32)).astype(np.float32))
    y, m = rc.affine_conv3x3_plain(x, A, B, w9, bias, add, True)
    yp, mp = rc.affine_conv3x3_plain(x, A, B, w9p, bp, ap, True)
    torch.testing.assert_close(yp[..., :cout], y, rtol=0, atol=1e-6)
    torch.testing.assert_close(mp[..., :cout], m, rtol=1e-6, atol=1e-6)
