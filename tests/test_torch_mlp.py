"""The port's fused transformer MLP (clip_codec_tpu_torch/ops/mlp.py) against the
JAX package's Pallas kernel and its jnp reference.

``mlp_plain`` (what the wrapper runs on a CPU tensor and what the CUDA
kernel is held against on the card) against ``_mlp_pallas`` in TPU
interpret mode, over one and several hidden tiles, and against
``mlp_reference``: fp32 within 1e-5; bf16 within one bf16 ulp of the
output's magnitude against the Pallas kernel, which rounds where
``mlp_plain`` does, and within two against ``mlp_reference``, which also
rounds each product to bf16 before adding its fp32 bias (a second rounding
of ``a`` and ``g``, measured at up to 1.25 ulp at the output). The two
stages' plain pieces compose to ``mlp_plain`` bit for bit; the kernels'
packed weight layout is pinned element by element, and the out-projection's
split rule is checked at every SD-1.5 shape. Inputs are made with numpy
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


def test_packed_layout_is_tma_ready(rng):
    """wup[128 t + j, k] = wh[k, 64 t + j] and wup[128 t + 64 + j, k] =
    wg[k, 64 t + j] (j < 64): one mlp_up tile holds a and g of the same 64
    hidden columns, depth contiguous; wdown[n, k] = wo[k, n]."""
    C, F = 48, 192
    wh, wg = (torch.from_numpy(rng.standard_normal((C, F)).astype(np.float32)) for _ in range(2))
    wo = torch.from_numpy(rng.standard_normal((F, C)).astype(np.float32))
    wup, wdown = mlp.pack_weights(wh, wg, wo, torch.float32)
    assert wup.shape == (2 * F, C) and wup.is_contiguous()
    assert wdown.shape == (C, F) and wdown.is_contiguous()
    t, j, k = np.meshgrid(np.arange(F // 64), np.arange(64), np.arange(C), indexing="ij")
    np.testing.assert_array_equal(wup.numpy()[128 * t + j, k], wh.numpy()[k, 64 * t + j])
    np.testing.assert_array_equal(wup.numpy()[128 * t + 64 + j, k], wg.numpy()[k, 64 * t + j])
    n, k = np.meshgrid(np.arange(C), np.arange(F), indexing="ij")
    np.testing.assert_array_equal(wdown.numpy()[n, k], wo.numpy()[k, n])
    assert mlp.pack_weights(wh, wg, wo)[0].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="F % 64"):
        mlp.pack_weights(wh[:, :160], wg[:, :160], wo[:160])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_up_and_down_pieces_compose_to_plain(rng, dtype):
    args = _torch(_params(rng, 64, 256), dtype)
    h = mlp.mlp_up_plain(*args[:7])
    assert h.dtype == dtype and h.shape == (32, 256)
    assert torch.equal(mlp.mlp_down_plain(h, args[7]), mlp.mlp_plain(*args))


# (R, C, F) of every SD-1.5 MLP at 512px: serving (UNet batches 2 and 8),
# training (batch 4), and ragged rows.
SD15_MLP_SHAPES = [(8192, 320, 1280), (2048, 640, 2560), (512, 1280, 5120), (128, 1280, 5120),
                   (32768, 320, 1280), (8192, 640, 2560), (2048, 1280, 5120),
                   (16384, 320, 1280), (4096, 640, 2560), (1024, 1280, 5120), (256, 1280, 5120),
                   (100, 320, 1280), (37, 640, 2560)]


@pytest.mark.parametrize("R,C,F", SD15_MLP_SHAPES)
def test_down_split_rule_has_no_empty_split(R, C, F):
    """The rule's count covers the F / 64 depth stages in equal runs with
    none empty, fills at most one wave of 132 SMs, and splits only where
    the 128 x 160 tiles leave at least half of them idle."""
    tiles = -(-R // 128) * (C // 160)
    depth = F // 64
    s = mlp.down_splits(R, C, F, 132)
    per = -(-depth // s)
    assert 1 <= s <= depth and (s - 1) * per < depth
    assert s * tiles <= max(132, tiles)
    assert (s > 1) == (2 * tiles <= 132)


def test_stage_wrappers_run_plain_on_cpu_without_counting(rng):
    args = _torch(_params(rng, 32, 128), torch.bfloat16)
    n0 = mlp.mlp_up.launches, mlp.mlp_down.launches
    h = mlp.mlp_up(*args[:7])
    y = mlp.mlp_down(h, args[7])
    assert (mlp.mlp_up.launches, mlp.mlp_down.launches) == n0
    assert torch.equal(h, mlp.mlp_up_plain(*args[:7]))
    assert torch.equal(y, mlp.mlp_plain(*args))


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
