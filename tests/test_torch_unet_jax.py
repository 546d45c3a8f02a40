"""The pixel U-Net port's checks that run the JAX package's own U-Net or
ResBlock (tests/test_torch_unet.py's tiny config and tolerances): the state
dict from JAX's parameters, the port importing no jax, eps against both JAX
forms, a ResBlock against JAX's kernel form, the kernel weights following a
new load and the bf16 forward. In a file of their own, so that a
``--dist loadfile`` run spreads them over the workers."""

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
from clip_codec_tpu_torch.models import CLIPCondUNet, ResBlock, init_params
from clip_codec_tpu_torch.weights.from_jax import unet_state_dict_from_jax
from tests.test_torch_unet import CFG, flax_like_unet_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_params():
    return flax_like_unet_params(CFG)


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


def test_from_jax_and_the_port_import_no_jax(tmp_path, jax_params):
    """The port (its JAX weight bridge, its pixel trainer and CLI, and the
    compress side's encoders, quantizer, store writer and encode CLI, the
    retrieval indexes and search CLI, the native store codec, the msgpack
    reader, the direct decoders, DDPM and the utilities included) runs in a
    process that loads nothing of jax, flax, msgpack or the JAX package,
    and reads JAX's ``.msgpack`` U-Net there."""
    from clip_codec_tpu.utils.checkpoint import save_params

    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    (tmp_path / "params.pkl").write_bytes(pickle.dumps(tree))
    save_params(tmp_path / "diffusion_unet_final.msgpack", jax_params)
    code = (
        "import pickle, sys\n"
        "import clip_codec_tpu_torch.io.native, clip_codec_tpu_torch.io.bitstream, clip_codec_tpu_torch.weights.convert\n"
        "import clip_codec_tpu_torch.utils.flax_msgpack, clip_codec_tpu_torch.utils.checkpoint\n"
        "import clip_codec_tpu_torch.models.decoders, clip_codec_tpu_torch.train.train_decoder\n"
        "import clip_codec_tpu_torch.diffusion.ddpm, clip_codec_tpu_torch.utils.profiling\n"
        "import clip_codec_tpu_torch.utils.debug, clip_codec_tpu_torch.utils.logging\n"
        "import clip_codec_tpu_torch.codec, clip_codec_tpu_torch.cli.reconstruct_diffusion\n"
        "import clip_codec_tpu_torch.models.sd, clip_codec_tpu_torch.cli.reconstruct_sd_diffusion\n"
        "import clip_codec_tpu_torch.ops.attention, clip_codec_tpu_torch.ops.mlp, clip_codec_tpu_torch.cli.train\n"
        "import clip_codec_tpu_torch.train.data, clip_codec_tpu_torch.train.losses\n"
        "import clip_codec_tpu_torch.encoders, clip_codec_tpu_torch.cli.encode_images, clip_codec_tpu_torch.codecs\n"
        "import clip_codec_tpu_torch.weights.convert_clip, clip_codec_tpu_torch.io.store\n"
        "import clip_codec_tpu_torch.index, clip_codec_tpu_torch.cli.search_text, clip_codec_tpu_torch.ops.u8_scan\n"
        "from clip_codec_tpu_torch.encoders.clip import CLIPConfig, CLIPModel, init_params\n"
        "from clip_codec_tpu_torch.weights.from_jax import clip_state_dict_from_jax\n"
        "assert 'regex' not in sys.modules  # the tokenizer imports it at first use\n"
        "import torch\n"
        "m = init_params(CLIPModel(CLIPConfig(image_size=32, patch_size=8, vision_dim=32, vision_depth=1,\n"
        "    vision_heads=2, vision_mlp=64, text_dim=32, text_depth=1, text_heads=2, text_mlp=64,\n"
        "    vocab_size=100, context_length=12, embed_dim=16)))\n"
        "assert m.encode_image(torch.zeros((1, 32, 32, 3))).shape == (1, 16)\n"
        "from clip_codec_tpu_torch.diffusion import NoiseSchedule\n"
        "from clip_codec_tpu_torch.models import CLIPCondUNet\n"
        "from clip_codec_tpu_torch.train import diffusion_train as tr\n"
        "from clip_codec_tpu_torch.train.optim import make_optimizer\n"
        "from clip_codec_tpu_torch.weights.from_jax import unet_state_dict_from_jax\n"
        f"tree = pickle.load(open({str(tmp_path / 'params.pkl')!r}, 'rb'))\n"
        "sd = unet_state_dict_from_jax(tree, (1, 2))\n"
        "from clip_codec_tpu_torch.utils.checkpoint import load_unet_checkpoint\n"
        f"ms = load_unet_checkpoint({str(tmp_path / 'diffusion_unet_final.msgpack')!r})\n"
        "assert ms.keys() == sd.keys() and all(torch.equal(ms[k], sd[k]) for k in sd)\n"
        "net = CLIPCondUNet(z_dim=8, base=8, ch_mult=(1, 2), time_dim=256, fused_pallas=False)\n"
        "net.load_state_dict(sd, strict=True)\n"
        "cfg = tr.DiffusionTrainConfig(base=8, ch_mult=(1, 2), bf16=False)\n"
        "step = tr.make_train_step(net, NoiseSchedule.create(50), make_optimizer(net, 1e-4), cfg)\n"
        "x = torch.zeros((2, 16, 16, 3))\n"
        "assert bool(torch.isfinite(step(x, torch.ones((2, 8)), torch.ones(2), torch.tensor([3, 40]), x + 1)))\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'clip_codec_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax', 'optax', 'msgpack', 'clip_codec_tpu.')))\n"
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
