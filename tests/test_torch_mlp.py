"""The port's fused transformer MLP (clip_codec_tpu_torch/ops/mlp.py) against the
JAX package's Pallas kernel and its jnp reference.

``mlp_plain`` (what the wrapper runs on a CPU tensor and what the CUDA
kernel is held against on the card) against ``_mlp_pallas`` in TPU
interpret mode, over one and several hidden tiles, and against
``mlp_reference``: fp32 within 1e-5; bf16 within one bf16 ulp of the
output's magnitude against the Pallas kernel, which rounds where
``mlp_plain`` does, and within two against ``mlp_reference``, which also
rounds each product to bf16 before adding its fp32 bias (a second rounding
of ``a`` and ``g``, measured at up to 1.25 ulp at the output). The kernel's packed weight layout is checked
against the m16n8k16 B-fragment definition. Inputs are made with numpy
from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_codec_tpu.ops.pallas_mlp import _mlp_pallas, mlp_reference
from clip_codec_tpu_torch.ops import mlp

torch.set_num_threads(1)


def _params(rng, C, F):
    a = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return dict(x=rng.standard_normal((32, C)).astype(np.float32), lns=a(C) + 1, lnb=a(C), wh=a(C, F),
                bh=a(F), wg=a(C, F), bg=a(F), wo=a(F, C))


ORDER = ("x", "lns", "lnb", "wh", "bh", "wg", "bg", "wo")
IN_DTYPE = ("x", "wh", "wg", "wo")  # the rest stays fp32


def _jax(p, dtype=jnp.float32):
    return [jnp.asarray(p[k]).astype(dtype if k in IN_DTYPE else jnp.float32) for k in ORDER]


def _torch(p, dtype=torch.float32):
    return [torch.from_numpy(p[k]).to(dtype if k in IN_DTYPE else torch.float32) for k in ORDER]


@pytest.mark.parametrize("C,F,tiles", [(32, 128, (32, 128)), (32, 256, (16, 128)), (64, 384, (32, 128))],
                         ids=["one_tile", "two_f_tiles", "three_f_tiles"])
def test_plain_matches_pallas_kernel_and_reference_fp32(rng, C, F, tiles):
    p = _params(rng, C, F)
    with pltpu.force_tpu_interpret_mode():
        yk = np.asarray(_mlp_pallas(*_jax(p), tiles))
    yr = np.asarray(mlp_reference(*_jax(p)))
    yt = mlp.mlp_plain(*_torch(p)).numpy()
    np.testing.assert_allclose(yt, yk, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yt, yr, rtol=1e-5, atol=1e-5)


def _bf16_ulp(a):
    """One bf16 ulp at |a| (8 significant bits)."""
    a = np.maximum(np.abs(a), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("C,F", [(32, 256), (64, 384)])
def test_plain_matches_pallas_kernel_and_reference_bf16(rng, C, F):
    p = _params(rng, C, F)
    with pltpu.force_tpu_interpret_mode():
        yk = np.asarray(_mlp_pallas(*_jax(p, jnp.bfloat16), (32, 128)), np.float32)
    yr = np.asarray(mlp_reference(*_jax(p, jnp.bfloat16)), np.float32)
    yt = mlp.mlp_plain(*_torch(p, torch.bfloat16))
    assert yt.dtype == torch.bfloat16
    yt = yt.float().numpy()
    scale = np.abs(yr).max()
    assert np.abs(yt - yk).max() <= _bf16_ulp(scale)
    assert np.abs(yt - yr).max() <= 2 * _bf16_ulp(scale)


def test_packed_layout_is_the_mma_b_fragment(rng):
    """packed[n16, k16, lane = 4g + t, 4 nh + 2 kh + e] holds
    w[16 k16 + 8 kh + 2 t + e, 16 n16 + 8 nh + g]: lane (g, t)'s b0/b1
    registers of the two 8-column n-tiles of a 16x16 tile."""
    K, N = 48, 32
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    packed, _, _ = mlp.pack_weights(w, w, w.t(), torch.float32)
    assert packed.shape == (N // 16, K // 16, 32, 8)
    n16, k16, g, t, nh, kh, e = np.meshgrid(*(np.arange(s) for s in (N // 16, K // 16, 8, 4, 2, 2, 2)),
                                            indexing="ij")
    got = packed.numpy()[n16, k16, 4 * g + t, 4 * nh + 2 * kh + e]
    want = w.numpy()[16 * k16 + 8 * kh + 2 * t + e, 16 * n16 + 8 * nh + g]
    np.testing.assert_array_equal(got, want)


def test_function_gradients_match_jax_vjp(rng):
    """Every argument's gradient through the port's MLP Function against
    ``jax.vjp`` of the JAX ``transformer_mlp`` (whose backward is the VJP of
    ``mlp_reference``), fp32, within 1e-5."""
    from clip_codec_tpu.ops.pallas_mlp import transformer_mlp as jax_mlp

    p = _params(rng, 32, 128)
    x3 = {**p, "x": p["x"].reshape(2, 16, 32)}
    g = rng.standard_normal((2, 16, 32)).astype(np.float32)
    _, vjp = jax.vjp(jax_mlp, *_jax(x3))
    want = vjp(jnp.asarray(g))
    args = [a.requires_grad_(True) for a in _torch(x3)]
    mlp.transformer_mlp(*args).backward(torch.from_numpy(g))
    for name, a, b in zip(ORDER, args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=name)


def test_wrapper_runs_plain_on_cpu_without_counting(rng):
    args = _torch(_params(rng, 32, 128))
    n0 = mlp.transformer_mlp.launches
    y = mlp.transformer_mlp(args[0].reshape(2, 16, 32), *args[1:])
    assert mlp.transformer_mlp.launches == n0
    assert torch.equal(y.reshape(32, 32), mlp.mlp_plain(*args))


def test_wrapper_never_falls_back_off_the_cpu(rng):
    args = [a.to("meta") for a in _torch(_params(rng, 32, 128), torch.bfloat16)]
    with pytest.raises(ValueError, match="CUDA or CPU tensor"):
        mlp.transformer_mlp(*args)
