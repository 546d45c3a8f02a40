"""The pixel trainer's checks against the JAX package's U-Net and jitted step
(tests/test_torch_train.py's tiny config and tolerances): the direct-form
eps against JAX's and the port's fused form, the loss and every parameter
gradient against JAX's step (its GroupNorm+SiLU on the jnp version and on
the Pallas kernel in interpret mode), one AdamW step against optax.adamw's,
remat gradients equal to direct ones, and the fused form refused for
training. In a file of their own, so that a ``--dist loadfile`` run
spreads them over the workers."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_codec_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from clip_codec_tpu.models import CLIPCondUNet as JaxUNet
from clip_codec_tpu.ops import enable_pallas
from clip_codec_tpu.train import diffusion_train as jtrain
from clip_codec_tpu_torch.diffusion import NoiseSchedule
from clip_codec_tpu_torch.models import CLIPCondUNet
from clip_codec_tpu_torch.train import diffusion_train as ttrain
from clip_codec_tpu_torch.train.optim import make_optimizer
from clip_codec_tpu_torch.weights.from_jax import unet_state_dict_from_jax
from tests.test_torch_train import B, CFG, SIZE
from tests.test_torch_unet import flax_like_unet_params

torch.set_num_threads(1)


def _jax_init(cfg):
    return flax_like_unet_params(cfg)


@pytest.fixture(scope="module")
def jax_params():
    return _jax_init(CFG)


def _port(jax_params, cfg=CFG, **kw):
    net = CLIPCondUNet(**cfg, time_dim=256, **kw)
    net.load_state_dict(unet_state_dict_from_jax(jax_params, cfg["ch_mult"]), strict=True)
    return net


def _batch():
    rng = np.random.default_rng(11)
    x0 = rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    z = rng.standard_normal((B, 8)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    return x0, z, np.array([1.0, 1.0, 0.0], np.float32)  # the last row is padding


@pytest.fixture(scope="module", params=[False, True], ids=["jax_jnp_groupnorm", "jax_pallas_groupnorm"])
def jax_step(request, jax_params):
    """JAX's jitted step with an optimizer that hands back its gradients:
    (grads, loss, t, noise, x0, z, w); with the Pallas GroupNorm+SiLU in
    interpret mode for the second param."""
    x0, z, w = _batch()
    cfg = jtrain.DiffusionTrainConfig(base=16, ch_mult=(1, 2), bf16=False)
    grads_out = optax.GradientTransformation(lambda p: p, lambda g, s, p=None: (g, g))
    key = jax.random.PRNGKey(7)
    fresh = lambda: jax.tree_util.tree_map(jnp.array, jax_params)  # the step donates its first two
    enable_pallas(request.param)
    try:
        with pltpu.force_tpu_interpret_mode():
            step = jtrain.make_train_step(JaxUNet(**CFG, fused_pallas=False), JaxSchedule.create(1000, "cosine"),
                                          grads_out, cfg)
            _, grads, loss = step(fresh(), fresh(), jnp.asarray(x0), jnp.asarray(z), jnp.asarray(w), key, True)
    finally:
        enable_pallas(False)
    t_rng, n_rng = jax.random.split(key)  # as the step draws them
    t = np.array(jax.random.randint(t_rng, (B,), 0, 1000, dtype=jnp.int32))
    noise = np.array(jax.random.normal(n_rng, x0.shape, dtype=jnp.float32))
    return grads, float(loss), t, noise, x0, z, w


def test_direct_form_matches_jax_and_the_fused_form(rng):
    cfg = dict(CFG, base=8)
    params = _jax_init(cfg)
    x = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    t = np.array([3, 940], np.int32)
    ej = np.asarray(JaxUNet(**cfg, fused_pallas=False).apply({"params": params}, *map(jnp.asarray, (x, z, t))))
    args = tuple(map(torch.from_numpy, (x, z, t)))
    with torch.no_grad():
        direct = _port(params, cfg, fused_pallas=False)(*args).numpy()
        fused = _port(params, cfg)(*args).numpy()
        remat = _port(params, cfg, remat=True)(*args).numpy()
    np.testing.assert_allclose(direct, ej, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(direct, fused, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(remat, direct)  # remat forces the direct form


def test_loss_and_gradients_match_jax(jax_params, jax_step):
    grads, loss_j, t, noise, x0, z, w = jax_step
    net = _port(jax_params, fused_pallas=False)
    cfg = ttrain.DiffusionTrainConfig(base=16, ch_mult=(1, 2), bf16=False)
    step = ttrain.make_train_step(net, NoiseSchedule.create(1000, "cosine"), make_optimizer(net, cfg.lr), cfg)
    loss = step.loss_fn(*map(torch.from_numpy, (x0, z, w, t, noise)), clip_on=True)
    loss.backward()
    assert abs(loss.item() - loss_j) <= 1e-5 * abs(loss_j)
    want = unet_state_dict_from_jax(grads, CFG["ch_mult"])
    assert set(want) == {k for k, _ in net.named_parameters()}
    for name, p in net.named_parameters():
        wn = want[name].numpy()
        err = np.abs(p.grad.numpy() - wn).max() / np.abs(wn).max()
        assert err <= 1e-4, (name, err)


def test_adamw_step_on_the_unet_matches_optax(rng, jax_params):
    """One optax.adamw step on the U-Net's parameter tree and the port's
    AdamW on the same seeded gradients."""
    grads = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-2, jax_params)
    tx = optax.adamw(2e-4)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = unet_state_dict_from_jax(optax.apply_updates(params, updates), CFG["ch_mult"])
    net = _port(jax_params, fused_pallas=False)
    g = unet_state_dict_from_jax(grads, CFG["ch_mult"])
    for name, p in net.named_parameters():
        p.grad = g[name]
    make_optimizer(net, 2e-4).step()
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6, atol=1e-7, err_msg=name)


def test_remat_gradients_equal_direct_gradients(jax_params):
    x0, z, w = _batch()
    t, noise = np.array([5, 500, 999], np.int32), np.random.default_rng(3).standard_normal(x0.shape).astype(np.float32)
    grads = []
    for remat in (False, True):
        net = _port(jax_params, fused_pallas=False, remat=remat)
        cfg = ttrain.DiffusionTrainConfig(base=16, ch_mult=(1, 2), bf16=False, remat=remat)
        step = ttrain.make_train_step(net, NoiseSchedule.create(1000, "cosine"), make_optimizer(net, 1e-4), cfg)
        step.loss_fn(*map(torch.from_numpy, (x0, z, w, t, noise))).backward()
        grads.append({k: p.grad for k, p in net.named_parameters()})
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k


def test_fused_form_is_refused_for_training(jax_params):
    net = _port(jax_params)
    with pytest.raises(NotImplementedError, match="fused_pallas=False"):
        ttrain.make_train_step(net, NoiseSchedule.create(10, "cosine"), make_optimizer(net, 1e-4),
                               ttrain.DiffusionTrainConfig())
