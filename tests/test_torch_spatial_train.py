"""The port's spatially sharded pixel training (``train_diffusion(spatial=True)``,
``cli.train --spatial_shard``, the differentiable model-axis collectives of
``parallel/mesh.py``, K1's split form under autograd) against the port's
unsharded step and JAX's, on the CPU.

The port's side runs as gloo ranks with ``OMP_NUM_THREADS=1``, one launch a
mesh (tests/torch_dp_worker.py ``spatial_train``), importing no jax: a (1, 2)
mesh of two ranks, and a (2, 2) mesh of four, where the gradient is summed
over both axes. JAX runs the step in one process (its ``train_diffusion``
refuses spatial sharding under several); the port runs one process a rank,
and these launches pin that. The pixel U-Net at base 8, ch_mult (1, 2), z_dim
8, 16px, fp32, seeded weights in JAX's layout (the JAX package's
``weights/convert.py``) carried by ``weights/from_jax.py``; a global
batch of 4 whose last row is padding; ``t`` and the noise the JAX step draws
from its key, injected; recon, TV and CLIP terms on, the CLIP term through a
stand-in embed (tanh of a seeded projection of the pixels), stop-grad and
with ``clip_align_grad``, and with ``remat``.

Checks: each mesh's loss within 1e-5 (relative) and every parameter's summed
gradient within 1e-4 of the network's largest gradient magnitude, against the
port's unsharded step and against JAX's jitted step (``jax.grad``); the ranks'
parameters bit-equal after the AdamW step; ``cli.train --spatial_shard 2``'s
checkpoint after two AdamW steps within 1e-4 of the unsharded CLI's, the
bound tests/test_torch_parallel_train.py holds the data-parallel CLI to, at
base 16 as there (AdamW's first steps move a parameter by about lr x
g / (|g| + eps), so a gradient at rounding-noise size, as GroupNorm makes
some at base 8, or near eps moves by up to lr wherever the order of a sum
flips its sign: 2.2e-5 at base 16, 3e-4 at base 8); ``train_diffusion``'s refusals
with JAX's text; K1's split form under autograd (fp64, two ranks) within 1e-6
of autograd of the unsharded plain GroupNorm+SiLU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_codec_tpu import parallel as jpar
from clip_codec_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from clip_codec_tpu.models import CLIPCondUNet as JaxUNet
from clip_codec_tpu.train import diffusion_train as jtrain
from clip_codec_tpu.weights.convert import convert_unet
from clip_codec_tpu_torch.cli import train as train_cli
from clip_codec_tpu_torch.diffusion import NoiseSchedule
from clip_codec_tpu_torch.models import CLIPCondUNet, init_params
from clip_codec_tpu_torch.ops import groupnorm as gn
from clip_codec_tpu_torch.train import diffusion_train as ptrain
from clip_codec_tpu_torch.train.optim import make_optimizer
from clip_codec_tpu_torch.utils.checkpoint import load_state_dict
from clip_codec_tpu_torch.weights.from_jax import unet_state_dict_from_jax
from tests.torch_dp_worker import SPATIAL_STEPS, run_ranks, store_images

torch.set_num_threads(1)

CFG = dict(z_dim=8, base=8, ch_mult=(1, 2))
B, S = 4, 16
WEIGHT = np.array([1, 1, 1, 0], np.float32)  # the last row is padding
MESHES = {2: (1, 2), 4: (2, 2)}  # world -> (data, model)
TRAIN_ARGV = ["--out_size", "16", "--epochs", "1", "--batch_size", "4", "--base", "16", "--ch_mult", "1,2",
              "--no_bf16", "--device", "cpu", "--seed", "3"]


def _port_step(sd, **kw):
    """The port's unsharded U-Net and config for one of ``SPATIAL_STEPS``."""
    net = CLIPCondUNet(**CFG, time_dim=256, fused_pallas=False, remat=kw.get("remat", False))
    net.load_state_dict(sd, strict=True)
    cfg = ptrain.DiffusionTrainConfig(base=8, ch_mult=(1, 2), bf16=False, **kw)
    return net, cfg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's steps, the port's unsharded steps and CLI, then the two launches."""
    work = tmp_path_factory.mktemp("spatial_train")
    rng = np.random.default_rng(5)
    # flax-style random weights, through the JAX package's converter (cheaper than flax's init here)
    init = init_params(CLIPCondUNet(**CFG, time_dim=256), torch.Generator().manual_seed(0)).state_dict()
    jparams = convert_unet(init, CFG["ch_mult"])
    sd = unet_state_dict_from_jax(jparams, CFG["ch_mult"])
    torch.save(sd, work / "unet.pt")
    x0 = rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    z = rng.standard_normal((B, 8)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    proj = (rng.standard_normal((S * S * 3, 8)) / np.sqrt(S * S * 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    t_rng, n_rng = jax.random.split(key)  # as JAX's step draws them
    t = np.array(jax.random.randint(t_rng, (B,), 0, 1000, dtype=jnp.int32))
    noise = np.array(jax.random.normal(n_rng, x0.shape, dtype=jnp.float32))
    gn_x = rng.standard_normal((2, S, 12, 32)) * 2 + 0.5
    np.savez(work / "spatial_train_in.npz", x0=x0, z=z, w=WEIGHT, t=t, noise=noise, proj=proj, gn_x=gn_x,
             gn_scale=rng.standard_normal(32) * 0.2 + 1, gn_bias=rng.standard_normal(32) * 0.1,
             gn_g=rng.standard_normal(gn_x.shape))
    store_images(work / "store", rng)
    train_argv = ["--store_dir", str(work / "store")] + TRAIN_ARGV
    (work / "spatial_train_in.json").write_text(json.dumps({"cfg": CFG, "train_argv": train_argv}))

    res = {"work": work, "jax": {}, "one": {}}
    grads_out = optax.GradientTransformation(lambda p: p, lambda g, s, p=None: (g, g))
    fresh = lambda: jax.tree_util.tree_map(jnp.array, jparams)  # the step donates its first two
    for align in (False, True):
        cfg = jtrain.DiffusionTrainConfig(base=8, ch_mult=(1, 2), bf16=False, clip_align_grad=align)
        step = jtrain.make_train_step(JaxUNet(**CFG, fused_pallas=False), JaxSchedule.create(1000, "cosine"),
                                      grads_out, cfg, lambda cp, imgs: jnp.tanh(imgs.reshape(imgs.shape[0], -1) @ cp))
        _, grads, loss = step(fresh(), fresh(), jnp.asarray(x0), jnp.asarray(z), jnp.asarray(WEIGHT), key, True,
                              jnp.asarray(proj))
        res["jax"]["align_grad" if align else "stop_grad"] = (float(loss),
                                                               unet_state_dict_from_jax(grads, CFG["ch_mult"]))
    pt = torch.from_numpy(proj)
    embed = lambda images: torch.tanh(images.reshape(images.shape[0], -1) @ pt)
    for name, kw in SPATIAL_STEPS.items():
        net, cfg = _port_step(sd, **kw)
        step = ptrain.make_train_step(net, NoiseSchedule.create(1000, "cosine"), make_optimizer(net, cfg.lr), cfg,
                                      embed)
        loss = step(*map(torch.from_numpy, (x0, z, WEIGHT, t, noise)), clip_on=True)
        res["one"][name] = (float(loss), {k: p.grad.clone() for k, p in net.named_parameters()})
    train_cli.main(train_argv + ["--save_dir", str(work / "cli1")])
    res["outs"] = {world: run_ranks("spatial_train", work, world=world, timeout=150) for world in MESHES}
    return res


def _close_grads(got, want, tol=1e-4):
    """Every parameter's gradient within ``tol`` of the network's largest
    gradient magnitude (some gradients are rounding noise at base 8)."""
    assert set(got) == set(want)
    scale = max(v.abs().max().item() for v in want.values())
    for k in want:
        err = (got[k] - want[k]).abs().max().item()
        assert err <= tol * scale, (k, err, scale)


@pytest.mark.parametrize("name", list(SPATIAL_STEPS))
@pytest.mark.parametrize("world", list(MESHES))
def test_step_matches_the_unsharded_step_and_jax(run, world, name):
    loss_one, g_one = run["one"][name]
    loss_jax, g_jax = run["jax"]["stop_grad" if name == "stop_grad" else "align_grad"]
    assert abs(loss_one - loss_jax) <= 1e-5 * abs(loss_jax)
    _close_grads(g_one, g_jax)
    for o in run["outs"][world]:
        assert o["mesh"] == list(MESHES[world])
        got = o[name]
        assert abs(got["loss"] - loss_one) <= 1e-5 * abs(loss_one)
        assert abs(got["loss"] - loss_jax) <= 1e-5 * abs(loss_jax)
        _close_grads(got["grads"], g_one)
        _close_grads(got["grads"], g_jax)


@pytest.mark.parametrize("world", list(MESHES))
def test_ranks_bit_equal_after_adamw(run, world):
    outs = run["outs"][world]
    for name in SPATIAL_STEPS:
        first = outs[0][name]
        for o in outs[1:]:
            assert o[name]["loss"] == first["loss"]
            for k, v in first["params"].items():
                assert torch.equal(o[name]["params"][k], v), (name, k)
                assert torch.equal(o[name]["grads"][k], first["grads"][k]), (name, k)
    # the clip_align_grad term moves the gradient, and remat keeps it
    _close_grads(first["grads"], outs[0]["align_grad"]["grads"], tol=1e-6)
    assert any((outs[0]["stop_grad"]["grads"][k] - first["grads"][k]).abs().max() > 1e-6 for k in first["grads"])


@pytest.mark.parametrize("world", list(MESHES))
def test_cli_spatial_shard_matches_the_unsharded_cli(run, world):
    want = load_state_dict(run["work"] / "cli1" / "diffusion_unet_final.pt")
    got = load_state_dict(run["work"] / f"cli{world}" / "diffusion_unet_final.pt")
    assert set(got) == set(want)
    for k in want:
        err = (got[k] - want[k]).abs().max().item()
        assert err <= 1e-4, (k, err)
    assert "Final checkpoint" in run["outs"][world][0]["log"]
    assert all("Final checkpoint" not in o["log"] for o in run["outs"][world][1:])  # rank 0 alone prints


class _NoUNet:
    """Stands in for JAX's U-Net, which ``train_diffusion`` builds before
    its checks: the refusals' text is what is read here."""

    def __init__(self, **kw):
        pass

    def init(self, *args):
        return {"params": {}}


def test_refusals_keep_jax_text(run, monkeypatch):
    work = run["work"]
    monkeypatch.setattr(jtrain, "CLIPCondUNet", _NoUNet)

    def jax_error(**kw):
        cfg = jtrain.DiffusionTrainConfig(out_size=S, **kw.pop("cfg", {}))
        with pytest.raises(ValueError) as e:
            jtrain.train_diffusion(work / "store", config=cfg, save_dir=work / "jax", spatial=True, **kw)
        return f"ValueError: {e.value}"

    want = [jax_error(mesh=None), jax_error(mesh=jpar.make_mesh(2), cfg=dict(batch_size=3)),
            jax_error(mesh=jpar.make_mesh(2), cfg=dict(batch_size=2)),
            # JAX cannot build a U-Net at 15px to reach its check; the message is its format
            "ValueError: out_size=15 not divisible by model axis 2",
            "ValueError: spatial sharding: level 1 has 6 rows, 3 a rank over a model axis of 2, and its stride-2 "
            "downsample needs an even count a rank (the JAX package pads unevenly split levels through GSPMD; "
            "the port refuses them)"]
    for o in run["outs"][2]:
        assert o["errors"] == want


def test_k1_split_autograd_matches_the_unsharded_plain_autograd(run):
    """Each rank's half of H through ``group_norm_silu_spatial`` (fp64:
    the plain pair with the differentiable merge), its dx, and dscale, dbias
    summed over the ranks: autograd of the one-shot plain GroupNorm+SiLU
    on the whole x within 1e-6."""
    inp = dict(np.load(run["work"] / "spatial_train_in.npz"))
    x = torch.from_numpy(inp["gn_x"]).requires_grad_()
    scale, bias = (torch.from_numpy(inp[k]).requires_grad_() for k in ("gn_scale", "gn_bias"))
    y = gn.group_norm_silu_plain(x, (scale, bias), 8)
    y.backward(torch.from_numpy(inp["gn_g"]))
    outs = [o["gn"] for o in run["outs"][2]]
    torch.testing.assert_close(torch.cat([o["y"] for o in outs], dim=1), y.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([o["dx"] for o in outs], dim=1), x.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sum(o["dscale"] for o in outs), scale.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sum(o["dbias"] for o in outs), bias.grad, rtol=1e-6, atol=1e-6)
