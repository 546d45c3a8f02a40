"""The port's flash-attention backward (clip_codec_tpu_torch/ops/attention.py)
against the JAX package's.

``flash_attention_bwd_plain`` (what the wrapper runs on a CPU tensor and what
the two CUDA kernels are held against on the card) against ``_flash_backward``
in TPU interpret mode, from the same saved ``out`` and ``lse``: head dims 40
and 80 (SD-1.5's) over two query and two key tiles of the Pallas grid, normal
and extreme logits; then autograd through the port's ``flash_attention_heads``
Function against ``jax.vjp`` of the JAX ``flash_attention_heads``. fp32,
within 1e-5 of each gradient's largest magnitude (the two tile the sums
differently). Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_codec_tpu.ops import pallas_attention as jattn
from clip_codec_tpu_torch.ops import attention as attn

torch.set_num_threads(1)


def _arrays(rng, shape, n, q_scale=1.0):
    out = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    out[0] *= np.float32(q_scale)
    return out


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


# (N, D): two 512-row tiles at D = 40 and two 256-row tiles at D = 80 (the
# Pallas backward's tile targets), so dq and dk/dv accumulate across tiles.
@pytest.mark.parametrize("q_scale", [1.0, 30.0], ids=["normal", "extreme_logits"])
@pytest.mark.parametrize("N,D", [(1024, 40), (512, 80)])
def test_plain_backward_matches_pallas_kernels(rng, N, D, q_scale):
    q, k, v, g = _arrays(rng, (2, N, D), 4, q_scale)
    with pltpu.force_tpu_interpret_mode():
        out, lse = jattn._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), with_lse=True)
        want = jattn._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse, jnp.asarray(g),
                                     1.0 / float(D) ** 0.5)
    t = lambda a: torch.from_numpy(np.array(a))
    got = attn.flash_attention_bwd_plain(t(q), t(k), t(v), t(out), t(lse), t(g))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        _close(a.numpy(), b)


def test_heads_autograd_matches_jax_vjp(rng):
    """(B, H, N, Nk, D) = (2, 2, 256, 256, 40) self-attention and a
    cross-attention length Nk = 77 at D = 80."""
    for shape_q, shape_kv in (((2, 2, 256, 40), (2, 2, 256, 40)), ((1, 3, 128, 80), (1, 3, 77, 80))):
        q, g = _arrays(rng, shape_q, 2)
        k, v = _arrays(rng, shape_kv, 2)
        _, vjp = jax.vjp(jattn.flash_attention_heads, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(g))
        qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
        attn.flash_attention_heads(qt, kt, vt).backward(torch.from_numpy(g))
        for a, b in zip((qt.grad, kt.grad, vt.grad), want):
            _close(a.numpy(), b)


def test_backward_wrapper_runs_plain_on_cpu_without_counting(rng):
    q, k, v, g = map(torch.from_numpy, _arrays(rng, (3, 64, 40), 4))
    out, lse = attn.flash_attention_plain(q, k, v)
    n0 = attn.flash_attention_bwd_dq.launches, attn.flash_attention_bwd_dkv.launches
    got = attn.flash_attention_bwd(q, k, v, out, lse, g)
    want = attn.flash_attention_bwd_plain(q, k, v, out, lse, g)
    assert (attn.flash_attention_bwd_dq.launches, attn.flash_attention_bwd_dkv.launches) == n0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_backward_never_falls_back_off_the_cpu(rng):
    """A tensor on neither the CPU nor a card is refused by both backward
    kernels' wrappers, not sent to the plain version."""
    q = torch.from_numpy(_arrays(rng, (1, 8, 40), 1)[0]).to("meta")
    lse = torch.zeros((1, 8), device="meta")
    for fn in (attn.flash_attention_bwd_dq, attn.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA or CPU tensor"):
            fn(q, q, q, q, lse, lse)
