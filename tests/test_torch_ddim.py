"""Port of the noise schedule and the DDIM and DPM-Solver++(2M) samplers
(clip_codec_tpu_torch/diffusion) against the JAX package.

The schedule tables are computed on the host in numpy in both packages and
must be bit-equal; the 2M coefficients, host numpy fp32 against jnp fp32,
agree within 1e-6 relative. Trajectories use a closed-form eps model written in both
frameworks and the same injected x_T (the two RNGs differ); fp32,
tolerance 1e-4 as the repo's fp32 network-output policy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_codec_tpu.diffusion import NoiseSchedule as JaxSchedule
from clip_codec_tpu.diffusion import ddim as jddim
from clip_codec_tpu.diffusion import dpm as jdpm
from clip_codec_tpu_torch.diffusion import (DDIMSampler, DPMSolverPP, NoiseSchedule, ddim_sample, ddim_timestep_grid,
                                            dpmpp_coefficients, dpmpp_sample, make_sampler)
from clip_codec_tpu_torch.diffusion.ddim import _step_coefficients

torch.set_num_threads(1)

TABLES = ("betas", "alphas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
          "sqrt_one_minus_alphas_cumprod", "posterior_variance")


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
@pytest.mark.parametrize("T", [1000, 50])
def test_schedule_tables_bit_equal_to_jax(schedule, T):
    sj = JaxSchedule.create(T, schedule)
    st = NoiseSchedule.create(T, schedule)
    assert st.timesteps == T
    for name in TABLES:
        a, b = getattr(st, name), np.asarray(getattr(sj, name))
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="Unknown schedule"):
        NoiseSchedule.create(10, "sigmoid")


def test_q_sample_and_predict_x0_match_jax(rng):
    sj, st = JaxSchedule.create(1000, "cosine"), NoiseSchedule.create(1000, "cosine")
    x0 = rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
    noise = rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
    t = np.array([0, 500, 999], np.int32)
    xj = np.asarray(sj.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    xt = st.q_sample(torch.from_numpy(x0), torch.from_numpy(t).long(), torch.from_numpy(noise))
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-6, atol=1e-6)
    pj = np.asarray(sj.predict_x0_from_eps(jnp.asarray(xj), jnp.asarray(t), jnp.asarray(noise)))
    pt = st.predict_x0_from_eps(xt, torch.from_numpy(t).long(), torch.from_numpy(noise))
    np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T,steps", [(1000, 50), (1000, 7), (50, 50), (50, 3), (10, 1)])
def test_timestep_grid_equal(T, steps):
    np.testing.assert_array_equal(ddim_timestep_grid(T, steps), jddim.ddim_timestep_grid(T, steps))


@pytest.mark.parametrize("standard", [False, True], ids=["ddim", "ddim_std"])
def test_step_coefficients_equal(standard):
    sj, st = JaxSchedule.create(1000, "cosine"), NoiseSchedule.create(1000, "cosine")
    for a, b in zip(_step_coefficients(st, 20, standard), jddim._step_coefficients(sj, 20, standard)):
        np.testing.assert_array_equal(a, np.asarray(b))


def _eps_np_params(rng, D=4, C=3):
    return (rng.standard_normal((D, C)) * 0.5).astype(np.float32)


def _models(P):
    """The same closed-form eps model in both frameworks."""
    Pj, Pt = jnp.asarray(P), torch.from_numpy(P)

    def jax_fn(x, z, t):
        c = (z @ Pj)[:, None, None, :] + (t.astype(jnp.float32) / 1000.0)[:, None, None, None]
        return jnp.tanh(0.7 * x + c)

    def torch_fn(x, z, t):
        c = (z @ Pt)[:, None, None, :] + (t.float() / 1000.0)[:, None, None, None]
        return torch.tanh(0.7 * x + c)

    return jax_fn, torch_fn


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
@pytest.mark.parametrize("standard", [False, True], ids=["ddim", "ddim_std"])
def test_five_step_trajectory_matches_jax(rng, schedule, standard):
    shape = (2, 8, 8, 3)
    z = rng.standard_normal((2, 4)).astype(np.float32)
    x_T = rng.standard_normal(shape).astype(np.float32)
    jax_fn, torch_fn = _models(_eps_np_params(rng))
    sj, st = JaxSchedule.create(1000, schedule), NoiseSchedule.create(1000, schedule)
    xj = np.asarray(jddim.ddim_sample(jax_fn, sj, jnp.asarray(z), shape, steps=5,
                                      x_T=jnp.asarray(x_T), standard=standard))
    xt = ddim_sample(torch_fn, st, torch.from_numpy(z), shape, steps=5,
                     x_T=torch.from_numpy(x_T), standard=standard)
    assert xt.dtype == torch.float32 and tuple(xt.shape) == shape
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-4, atol=1e-4)


def test_eta_one_nans_like_the_reference(rng):
    """Deviation (c): sqrt(al_bar_s - sigma^2) goes negative at eta = 1, so the
    parity sampler returns NaN in both packages; ddim_std stays finite."""
    shape = (1, 4, 4, 3)
    z = rng.standard_normal((1, 4)).astype(np.float32)
    x_T = rng.standard_normal(shape).astype(np.float32)
    jax_fn, torch_fn = _models(_eps_np_params(rng))
    sj, st = JaxSchedule.create(1000, "cosine"), NoiseSchedule.create(1000, "cosine")
    xj = np.asarray(jddim.ddim_sample(jax_fn, sj, jnp.asarray(z), shape, steps=10, eta=1.0,
                                      x_T=jnp.asarray(x_T), rng=jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    xt = ddim_sample(torch_fn, st, torch.from_numpy(z), shape, steps=10, eta=1.0,
                     x_T=torch.from_numpy(x_T), generator=gen)
    assert np.isnan(xj).any() and torch.isnan(xt).any()
    xs = ddim_sample(torch_fn, st, torch.from_numpy(z), shape, steps=10, eta=1.0,
                     x_T=torch.from_numpy(x_T), generator=gen, standard=True)
    assert torch.isfinite(xs).all()


def test_generator_drives_noise(rng):
    """x_T and, for eta > 0, the per-step noise come from the generator:
    equal seeds reproduce, other seeds differ, and eta = 0 with an injected
    x_T ignores the generator."""
    shape = (2, 4, 4, 3)
    z = torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32))
    _, torch_fn = _models(_eps_np_params(rng))
    st = NoiseSchedule.create(100, "cosine")
    # ddim_std: the parity form NaNs at this eta (deviation (c))
    run = lambda seed, eta: ddim_sample(torch_fn, st, z, shape, steps=4, eta=eta, standard=True,
                                        generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(1, 0.3), run(1, 0.3))
    assert not torch.equal(run(1, 0.3), run(2, 0.3))
    assert not torch.equal(run(1, 0.0), run(1, 0.3))
    x_T = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    a = ddim_sample(torch_fn, st, z, shape, steps=4, x_T=x_T, generator=torch.Generator().manual_seed(1))
    b = ddim_sample(torch_fn, st, z, shape, steps=4, x_T=x_T, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)


def test_make_sampler():
    st = NoiseSchedule.create(100, "cosine")
    assert make_sampler("ddim", st, eta=0.2) == DDIMSampler(st, eta=0.2)
    assert make_sampler("ddim_std", st).standard
    assert make_sampler("dpmpp", st) == DPMSolverPP(st)
    with pytest.raises(ValueError, match="deterministic"):
        make_sampler("dpmpp", st, eta=0.5)
    with pytest.raises(ValueError, match="unknown sampler"):
        make_sampler("euler", st)


@pytest.mark.parametrize("steps", [1, 2, 10, 50])
def test_dpmpp_coefficients_match_jax(steps):
    """Host numpy fp32 against the JAX jnp fp32 math, over the SD-style grid
    with the final target alpha-bar 1 (c_skip 0, c0 alpha_t, c1 0 there)."""
    ac = NoiseSchedule.create(1000, "linear").alphas_cumprod.numpy()
    src = ac[ddim_timestep_grid(1000, steps)]
    tgt = np.concatenate([src[1:], np.ones(1, np.float32)])
    for a, b in zip(dpmpp_coefficients(src, tgt), jdpm.dpmpp_coefficients(jnp.asarray(src), jnp.asarray(tgt))):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip_x0", [True, False])
def test_dpmpp_trajectory_matches_jax(rng, clip_x0):
    shape = (2, 8, 8, 3)
    z = rng.standard_normal((2, 4)).astype(np.float32)
    x_T = rng.standard_normal(shape).astype(np.float32)
    jax_fn, torch_fn = _models(_eps_np_params(rng))
    sj, st = JaxSchedule.create(1000, "linear"), NoiseSchedule.create(1000, "linear")
    xj = np.asarray(jdpm.dpmpp_sample(jax_fn, sj, jnp.asarray(z), shape, steps=6, x_T=jnp.asarray(x_T),
                                      clip_x0=clip_x0))
    xt = dpmpp_sample(torch_fn, st, torch.from_numpy(z), shape, steps=6, x_T=torch.from_numpy(x_T),
                      clip_x0=clip_x0)
    assert xt.dtype == torch.float32 and tuple(xt.shape) == shape
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-4, atol=1e-4)


def test_sampler_ignores_cfg_scale(rng):
    shape = (1, 4, 4, 3)
    z = torch.from_numpy(rng.standard_normal((1, 4)).astype(np.float32))
    x_T = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    _, torch_fn = _models(_eps_np_params(rng))
    s = DDIMSampler(NoiseSchedule.create(100, "linear"))
    assert torch.equal(s.sample(torch_fn, z, shape, steps=3, x_T=x_T, cfg_scale=1.0),
                       s.sample(torch_fn, z, shape, steps=3, x_T=x_T, cfg_scale=7.5))
