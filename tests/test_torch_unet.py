"""Port of the pixel U-Net (clip_codec_tpu_torch/models) against the JAX package.

Weights cross through ``export_unet`` (the reference torch state-dict
layout). Tiny config: base=8, ch_mult=(1,2), z_dim=8, 16px, fp32. The JAX
kernel-bearing form (``fused_pallas=True``) runs its Pallas kernel in TPU
interpret mode. Tolerances: eps 2e-4 (the JAX package's own fused-vs-direct
bound, tests/test_pallas_resblock.py), ResBlock 1e-4, GroupNorm 1e-5, the
timestep embedding 1e-6 (plus the one-bit frequency term, see its test).
The checks that run JAX's U-Net or ResBlock are tests/test_torch_unet_jax.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_codec_tpu.models import CLIPCondUNet as JaxUNet
from clip_codec_tpu.weights.export import export_unet
from clip_codec_tpu_torch.models import CLIPCondUNet, init_params, timestep_embedding
from clip_codec_tpu_torch.weights.from_jax import unet_state_dict_from_jax

torch.set_num_threads(1)

CFG = dict(z_dim=8, base=8, ch_mult=(1, 2))


def flax_like_unet_params(cfg: dict, seed: int = 0) -> dict:
    """A JAX ``CLIPCondUNet`` params tree drawn as flax's init draws one
    (``init_params``: LeCun-normal weights, zero biases, unit norm scales),
    through the JAX package's converter: the same statistics as
    ``JaxUNet(...).init`` without compiling it (~10-20 s on a CPU)."""
    from clip_codec_tpu.weights.convert import convert_unet

    init = init_params(CLIPCondUNet(**cfg, time_dim=256), torch.Generator().manual_seed(seed))
    return convert_unet(init.state_dict(), cfg["ch_mult"])


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


@pytest.mark.parametrize("ch_mult,size,batch", [((1, 2, 2), 16, 2), ((1, 2), 16, 1), ((2, 1, 2), 32, 3)])
def test_path_conv_shapes_are_the_fused_calls(rng, monkeypatch, ch_mult, size, batch):
    """``probes.conv_times.path_conv_shapes`` (the shape list of the conv
    probe and of chip_smoke) against the fused convs a serving forward of a
    tiny U-Net really calls, recorded on the CPU: shapes, counts, and the
    head as the one linear call."""
    from collections import Counter

    from clip_codec_tpu_torch.ops import resblock_conv as rc
    from clip_codec_tpu_torch.probes.conv_times import path_conv_shapes

    seen = Counter()

    def recording(linear):
        def call(x, A, B, w9, bias, add=None, want_moments=False):
            seen[(tuple(x.shape) + (w9.shape[2],), linear)] += 1
            return rc.affine_conv3x3_plain(x, A, B, w9, bias, add, want_moments, linear=linear)
        return call

    monkeypatch.setattr(rc, "affine_silu_conv3x3", recording(False))
    monkeypatch.setattr(rc, "affine_conv3x3", recording(True))
    net = init_params(CLIPCondUNet(z_dim=8, base=8, ch_mult=ch_mult, time_dim=16), torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.standard_normal((batch, size, size, 3)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((batch, 8)).astype(np.float32))
    with torch.no_grad():
        net.eval()(x, z, torch.arange(batch, dtype=torch.int32))
    shapes = path_conv_shapes(8, ch_mult, size, batch)
    want = Counter({(shape, i == len(shapes) - 1): calls for i, (shape, calls) in enumerate(shapes)})
    assert seen == want


def test_path_conv_shapes_of_the_reference_unet():
    """The pixel path's table: the reference U-Net at 256px, serving batch 4."""
    from clip_codec_tpu_torch.probes.conv_times import path_conv_shapes

    assert path_conv_shapes(128, (1, 2, 2), 256, 4) == [
        ((4, 256, 256, 128, 128), 4), ((4, 128, 128, 128, 128), 8), ((4, 64, 64, 256, 256), 8),
        ((4, 32, 32, 512, 512), 8), ((4, 256, 256, 128, 3), 1)]
