"""Ancestral DDPM (``diffusion/ddpm.py``, ``NoiseSchedule.p_mean_variance``)
against the JAX package's, on the CPU.

``p_mean_variance`` within 1e-6 on the same eps (a fixed function of x, z
and t, computed alike in both). ``ddpm_sample`` through the tiny pixel
U-Net (base 8, (1, 2), z 8, 16px, fp32, the same weights) on a 12-step
schedule within 1e-4 of JAX's: the test draws JAX's own noise, x_T and
then one draw a step, in ``ddpm.py``'s split order, and injects it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_codec_tpu.diffusion import NoiseSchedule as JaxSchedule
from clip_codec_tpu.diffusion import ddpm_sample as jax_ddpm_sample
from clip_codec_tpu.models import CLIPCondUNet as JaxUNet
from clip_codec_tpu_torch.diffusion import NoiseSchedule, ddpm_sample
from clip_codec_tpu_torch.models import CLIPCondUNet
from clip_codec_tpu_torch.weights.from_jax import unet_state_dict_from_jax

torch.set_num_threads(1)

CFG = dict(z_dim=8, base=8, ch_mult=(1, 2))
SHAPE = (2, 16, 16, 3)


def _eps_jax(x, z, t):
    return jnp.tanh(x * 0.7 + z[:, None, None, :3]) * (1.0 + t[:, None, None, None].astype(jnp.float32) / 50.0)


def _eps_port(x, z, t):
    return torch.tanh(x * 0.7 + z[:, None, None, :3]) * (1.0 + t[:, None, None, None].float() / 50.0)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_p_mean_variance_matches_jax(rng, schedule):
    x = rng.standard_normal(SHAPE).astype(np.float32) * 1.5
    z = rng.standard_normal((2, 8)).astype(np.float32)
    t = np.array([0, 37], np.int32)
    want = JaxSchedule.create(50, schedule).p_mean_variance(_eps_jax, jnp.asarray(x), jnp.asarray(z), jnp.asarray(t))
    got = NoiseSchedule.create(50, schedule).p_mean_variance(_eps_port, torch.from_numpy(x), torch.from_numpy(z),
                                                            torch.from_numpy(t))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    assert float(got[1][0].max()) == 0.0  # no variance at t = 0 (posterior_variance[0] is 0)


def _jax_draws(key, T):
    """x_T and the T per-step draws of JAX's ``ddpm_sample`` from ``key``."""
    rng, init_rng = jax.random.split(key)
    x_T = jax.random.normal(init_rng, SHAPE, dtype=jnp.float32)
    noise = []
    for _ in range(T):
        rng, nrng = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(jax.random.normal(nrng, SHAPE, dtype=jnp.float32))))
    return torch.from_numpy(np.array(x_T)), noise


def test_ddpm_sample_matches_jax(rng):
    T = 12
    params = JaxUNet(**CFG, fused_pallas=False).init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                                      jnp.zeros((1, 8)), jnp.zeros((1,), jnp.int32))["params"]
    net = CLIPCondUNet(**CFG, time_dim=256, fused_pallas=False)
    net.load_state_dict(unet_state_dict_from_jax(params), strict=True)
    net.eval()
    jnet = JaxUNet(**CFG, fused_pallas=False)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    key = jax.random.PRNGKey(7)

    def model_fn(x, zz, t):
        return jnet.apply({"params": params}, x, zz, t)

    want = np.asarray(jax_ddpm_sample(model_fn, JaxSchedule.create(T), jnp.asarray(z), SHAPE, rng=key))
    x_T, noise = _jax_draws(key, T)
    got = ddpm_sample(net, NoiseSchedule.create(T), torch.from_numpy(z), SHAPE, x_T=x_T, noise=noise)
    assert got.dtype == torch.float32 and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_ddpm_sample_draws_from_its_generator_and_checks_the_noise():
    sched = NoiseSchedule.create(5)
    z = torch.zeros((2, 8))
    a = ddpm_sample(_eps_port, sched, z, SHAPE, generator=torch.Generator().manual_seed(3))
    b = ddpm_sample(_eps_port, sched, z, SHAPE, generator=torch.Generator().manual_seed(3))
    c = ddpm_sample(_eps_port, sched, z, SHAPE, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()
    with pytest.raises(ValueError, match="noise holds 2 draws"):
        ddpm_sample(_eps_port, sched, z, SHAPE, noise=[torch.zeros(SHAPE)] * 2)


def test_ddpm_is_exported_beside_the_samplers():
    import clip_codec_tpu_torch.diffusion as d

    assert "ddpm_sample" in d.__all__ and d.SAMPLERS == ("ddim", "ddim_std", "dpmpp")
