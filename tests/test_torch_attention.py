"""The port's flash attention (clip_codec_tpu_torch/ops/attention.py) against
the JAX package's Pallas kernel, and the CrossAttention block around it.

``flash_attention_plain`` (what the wrapper runs on a CPU tensor and what
the CUDA kernel is held against on the card) against ``_flash_forward`` in
TPU interpret mode with its lse: head dims 40 and 80 (the SD-1.5 ones, not
multiples of the MMA's 16), several q and k tiles, and extreme logits.
fp32, within 1e-5 (relative to the output's scale; the two compute the
softmax in exp2 and exp). Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_codec_tpu.ops.pallas_attention import _flash_forward
from clip_codec_tpu_torch.models.sd.layers import CrossAttention, _attention_plain
from clip_codec_tpu_torch.ops import attention as attn

torch.set_num_threads(1)


def _qkv(rng, BH, N, D, q_scale=1.0):
    q = (rng.standard_normal((BH, N, D)) * q_scale).astype(np.float32)
    k = rng.standard_normal((BH, N, D)).astype(np.float32)
    v = rng.standard_normal((BH, N, D)).astype(np.float32)
    return q, k, v


# (N, D): two 1024-row tiles at D=40; three 512-row tiles at D=80 and at
# N=1536, D=40 (the Pallas tile picker's 512 fallback).
@pytest.mark.parametrize("q_scale", [1.0, 30.0], ids=["normal", "extreme_logits"])
@pytest.mark.parametrize("N,D", [(2048, 40), (1536, 80), (1536, 40)])
def test_plain_matches_pallas_kernel(rng, N, D, q_scale):
    q, k, v = _qkv(rng, 2, N, D, q_scale)
    with pltpu.force_tpu_interpret_mode():
        oj, lj = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), with_lse=True)
    ot, lt = attn.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert ot.dtype == torch.float32 and lt.shape == (2, N)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5, atol=1e-5)


def test_wrapper_runs_plain_on_cpu_without_counting(rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, 6, 256, 40))
    n0 = attn.flash_attention_fwd.launches
    out = attn.flash_attention_heads(q.reshape(2, 3, 256, 40), k.reshape(2, 3, 256, 40),
                                     v.reshape(2, 3, 256, 40))
    ref, _ = attn.flash_attention_plain(q, k, v)
    assert attn.flash_attention_fwd.launches == n0
    assert torch.equal(out, ref.reshape(2, 3, 256, 40))


def test_wrapper_never_falls_back_off_the_cpu(rng):
    """A tensor on neither the CPU nor a card is refused, not sent to the
    plain version."""
    q = torch.from_numpy(_qkv(rng, 1, 8, 8)[0]).to("meta")
    with pytest.raises(ValueError, match="CUDA or CPU tensor"):
        attn.flash_attention_fwd(q, q, q)


def test_cross_attention_flash_branch_matches_module_math(rng):
    """Self-attention at N = 1024 takes the flash branch; the module-path
    math (logits / sqrt(d), fp32 softmax) gives the same result in fp32."""
    torch.manual_seed(0)
    blk = CrossAttention(16, heads=2).eval()
    x = torch.from_numpy(rng.standard_normal((2, 1024, 16)).astype(np.float32))
    with torch.no_grad():
        got = blk(x, None, torch.float32)
        q = torch.nn.functional.linear(x, blk.to_q.weight).view(2, 1024, 2, 8)
        k = torch.nn.functional.linear(x, blk.to_k.weight).view(2, 1024, 2, 8)
        v = torch.nn.functional.linear(x, blk.to_v.weight).view(2, 1024, 2, 8)
        want = blk.to_out[0](_attention_plain(q, k, v, 8, torch.float32).reshape(2, 1024, 16))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
