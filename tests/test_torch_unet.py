"""Port of the pixel U-Net (clip_codec_tpu_torch/models) against the JAX package.

Weights cross through ``export_unet`` (the reference torch state-dict
layout). Tiny config: base=8, ch_mult=(1,2), z_dim=8, 16px, fp32. The JAX
kernel-bearing form (``fused_pallas=True``) runs its Pallas kernel in TPU
interpret mode. Tolerances: eps 2e-4 (the JAX package's own fused-vs-direct
bound, tests/test_pallas_resblock.py), ResBlock 1e-4, GroupNorm 1e-5, the
timestep embedding 1e-6 (plus the one-bit frequency term, see its test).
"""

import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_codec_tpu.models import CLIPCondUNet as JaxUNet
from clip_codec_tpu.models.blocks import ResBlock as JaxResBlock
from clip_codec_tpu.weights.export import export_unet
from clip_codec_tpu_torch.models import CLIPCondUNet, ResBlock, init_params, timestep_embedding
from clip_codec_tpu_torch.weights.from_jax import unet_state_dict_from_jax

torch.set_num_threads(1)

CFG = dict(z_dim=8, base=8, ch_mult=(1, 2))
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_params():
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    return JaxUNet(**CFG, fused_pallas=False).init(
        jax.random.PRNGKey(0), x, jnp.zeros((1, 8)), jnp.zeros((1,), jnp.int32))["params"]


def _inputs(rng):
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    t = np.array([3, 40], np.int32)
    return x, z, t


def _port(jax_params):
    net = CLIPCondUNet(**CFG, time_dim=256)
    net.load_state_dict(unet_state_dict_from_jax(jax_params, CFG["ch_mult"]), strict=True)
    return net.eval()


def test_state_dict_from_jax_equals_export_and_loads_strict(jax_params):
    sd = unet_state_dict_from_jax(jax_params, CFG["ch_mult"])
    ref = export_unet(jax_params, CFG["ch_mult"])
    assert sd.keys() == ref.keys()
    for k, v in ref.items():
        assert sd[k].dtype == torch.float32
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    net = CLIPCondUNet(**CFG, time_dim=256)
    assert set(net.state_dict()) == set(sd)
    net.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("ch_mult", [(1, 2), (1, 2, 2)])
def test_state_dict_from_jax_equals_export_unet(rng, ch_mult):
    """The port's own copy of the mapping against the JAX package's
    ``export_unet``, key for key and value for value, on a seeded tree of
    the U-Net's structure (``jax.eval_shape`` of its init, no compile)."""
    cfg = dict(CFG, ch_mult=ch_mult)
    shapes = jax.eval_shape(JaxUNet(**cfg, fused_pallas=False).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 8)), jnp.zeros((1,), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = unet_state_dict_from_jax(tree, ch_mult)
    ref = export_unet(tree, ch_mult)
    assert list(sd) == list(ref)
    for k, v in ref.items():
        assert sd[k].dtype == torch.float32
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    CLIPCondUNet(**cfg, time_dim=256).load_state_dict(sd, strict=True)


def test_from_jax_and_the_port_import_no_jax(tmp_path, jax_params):
    """The port (its JAX weight bridge and its pixel trainer and CLI
    included) runs in a process that loads nothing of jax, flax or the JAX
    package."""
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    (tmp_path / "params.pkl").write_bytes(pickle.dumps(tree))
    code = (
        "import pickle, sys\n"
        "import clip_codec_tpu_torch.codec, clip_codec_tpu_torch.cli.reconstruct_diffusion\n"
        "import clip_codec_tpu_torch.models.sd, clip_codec_tpu_torch.cli.reconstruct_sd_diffusion\n"
        "import clip_codec_tpu_torch.ops.attention, clip_codec_tpu_torch.ops.mlp, clip_codec_tpu_torch.cli.train\n"
        "import clip_codec_tpu_torch.train.data, clip_codec_tpu_torch.train.losses\n"
        "import torch\n"
        "from clip_codec_tpu_torch.diffusion import NoiseSchedule\n"
        "from clip_codec_tpu_torch.models import CLIPCondUNet\n"
        "from clip_codec_tpu_torch.train import diffusion_train as tr\n"
        "from clip_codec_tpu_torch.train.optim import make_optimizer\n"
        "from clip_codec_tpu_torch.weights.from_jax import unet_state_dict_from_jax\n"
        f"tree = pickle.load(open({str(tmp_path / 'params.pkl')!r}, 'rb'))\n"
        "sd = unet_state_dict_from_jax(tree, (1, 2))\n"
        "net = CLIPCondUNet(z_dim=8, base=8, ch_mult=(1, 2), time_dim=256, fused_pallas=False)\n"
        "net.load_state_dict(sd, strict=True)\n"
        "cfg = tr.DiffusionTrainConfig(base=8, ch_mult=(1, 2), bf16=False)\n"
        "step = tr.make_train_step(net, NoiseSchedule.create(50), make_optimizer(net, 1e-4), cfg)\n"
        "x = torch.zeros((2, 16, 16, 3))\n"
        "assert bool(torch.isfinite(step(x, torch.ones((2, 8)), torch.ones(2), torch.tensor([3, 40]), x + 1)))\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'clip_codec_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax', 'optax', 'clip_codec_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("fused_pallas", [True, False], ids=["jax_kernel_form", "jax_default_form"])
def test_eps_matches_jax(rng, jax_params, fused_pallas):
    x, z, t = _inputs(rng)
    net = JaxUNet(**CFG, fused_pallas=fused_pallas)
    with pltpu.force_tpu_interpret_mode():
        ej = np.asarray(net.apply({"params": jax_params}, jnp.asarray(x), jnp.asarray(z), jnp.asarray(t)))
    with torch.no_grad():
        et = _port(jax_params)(torch.from_numpy(x), torch.from_numpy(z), torch.from_numpy(t)).numpy()
    assert et.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(et, ej, rtol=2e-4, atol=2e-4)


def test_resblock_matches_jax_kernel_form(rng):
    """One ResBlock (two fused calls, GN2 stats from the moments) vs JAX
    ``ResBlock(fused_pallas=True)`` on the same params."""
    from clip_codec_tpu.weights.export import _resblock

    x = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
    h = rng.standard_normal((2, 32)).astype(np.float32)
    jb = JaxResBlock(16, fused_pallas=True)
    p = JaxResBlock(16, fused_pallas=False).init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(h))["params"]
    # non-trivial norm and FiLM params so every fold is exercised
    p = jax.tree_util.tree_map(lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(2), a.shape), p)
    with pltpu.force_tpu_interpret_mode():
        yj = np.asarray(jb.apply({"params": p}, jnp.asarray(x), jnp.asarray(h)))
    sd = {}
    _resblock(sd, "rb", p)
    blk = ResBlock(16, 32)
    blk.load_state_dict({k[3:]: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        yt = blk(torch.from_numpy(x), torch.from_numpy(h), torch.float32).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dim", [256, 7])
def test_timestep_embedding_matches_jax(dim):
    """Within 1e-6 plus what one fp32 bit of a frequency does at timestep t:
    XLA's CPU ``exp`` is not correctly rounded (1 ulp off the port's host
    table in most entries), and a 1-ulp frequency moves the fp32 argument
    ``t * f`` by up to 2 ulp of ``t``, i.e. ``cos`` by <= 2.5e-7 * t."""
    from clip_codec_tpu.models.unet import timestep_embedding as jax_emb

    t = np.array([0, 1, 3, 5, 17, 499, 999], np.int32)
    ej = np.asarray(jax_emb(jnp.asarray(t), dim))
    et = timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert et.dtype == np.float32 and et.shape == (len(t), dim)
    bound = 1e-6 + 2.5e-7 * t[:, None].astype(np.float64)
    assert np.all(np.abs(et - ej) <= bound)
    np.testing.assert_allclose(et[:4], ej[:4], rtol=0, atol=1e-6)


@pytest.mark.parametrize("groups", [1, 8])
def test_group_norm_matches_jax(rng, groups):
    from clip_codec_tpu.ops.groupnorm import group_norm as jax_gn
    from clip_codec_tpu_torch.ops.groupnorm import group_norm

    x = (rng.standard_normal((2, 8, 8, 16)) * 3 + 1).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    b = (0.1 * rng.standard_normal(16)).astype(np.float32)
    yj = np.asarray(jax_gn(jnp.asarray(x), (jnp.asarray(s), jnp.asarray(b)), groups))
    yt = group_norm(torch.from_numpy(x), (torch.from_numpy(s), torch.from_numpy(b)), groups).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_weights_follow_a_new_load(rng, jax_params, dtype):
    """The kernel's (9, Cin, Cout) weights and the compute-dtype casts are
    converted once per load: a second load_state_dict changes the output
    exactly as a fresh model with those weights computes it."""
    x, z, t = map(torch.from_numpy, _inputs(rng))
    net = CLIPCondUNet(**CFG, time_dim=256, dtype=dtype)
    net.load_state_dict(unet_state_dict_from_jax(jax_params, CFG["ch_mult"]), strict=True)
    other = init_params(CLIPCondUNet(**CFG, time_dim=256, dtype=dtype), torch.Generator().manual_seed(3)).eval()
    with torch.no_grad():
        y0 = net(x, z, t)
        assert torch.equal(net(x, z, t), y0)  # cached weights reused
        net.load_state_dict(other.state_dict(), strict=True)
        torch.testing.assert_close(net(x, z, t), other(x, z, t), rtol=0, atol=0)


def test_init_params_is_seeded_and_flax_like():
    a = init_params(CLIPCondUNet(**CFG, time_dim=16), torch.Generator().manual_seed(0))
    b = init_params(CLIPCondUNet(**CFG, time_dim=16), torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.all(a.out_norm.weight == 1) and torch.all(a.in_conv.bias == 0)
    w = a.down[0].conv1.weight
    assert abs(w.std().item() * np.sqrt(w[0].numel()) - 1) < 0.1


@pytest.mark.parametrize("layer", [torch.nn.Linear(1024, 1000), torch.nn.Conv2d(128, 128, 3),
                                   torch.nn.ConvTranspose2d(256, 128, 4)], ids=["linear", "conv", "conv_transpose"])
def test_init_params_draws_flax_truncated_normal(layer):
    """flax's lecun_normal: a normal cut at +-2 sigma, rescaled to std
    1/sqrt(fan_in) (sigma = that / 0.8796), fan_in = numel / shape[0]."""
    init_params(layer, torch.Generator().manual_seed(0))
    w = layer.weight.detach().double()
    std = 1 / np.sqrt(w[0].numel())
    assert abs(w.std().item() / std - 1) < 0.02
    assert w.abs().max().item() <= 2 / 0.87962566103423978 * std * (1 + 1e-6)
    assert w.abs().max().item() > 1.9 / 0.87962566103423978 * std  # the cut, not a narrower normal


def test_bf16_forward_tracks_fp32(rng, jax_params):
    """The bf16 compute dtype of the card path, here on the plain versions:
    eps within bf16 rounding of the fp32 forward."""
    x, z, t = map(torch.from_numpy, _inputs(rng))
    sd = unet_state_dict_from_jax(jax_params, CFG["ch_mult"])
    f32 = CLIPCondUNet(**CFG, time_dim=256)
    bf16 = CLIPCondUNet(**CFG, time_dim=256, dtype=torch.bfloat16)
    f32.load_state_dict(sd, strict=True)
    bf16.load_state_dict(sd, strict=True)
    with torch.no_grad():
        e32 = f32(x, z, t)
        e16 = bf16(x, z, t)
    assert e16.dtype == torch.bfloat16
    assert ((e16.float() - e32).norm() / e32.norm()).item() < 2e-2
