"""K1's codes-out form (``ops.groupnorm.group_norm_silu_int8``: GroupNorm+SiLU
writing the int8 codes of the conv after it) against the two-step form it
replaces and against the JAX package, on the CPU.

* Its plain version is K1's plain version then ``quantize_plain``, and the
  CPU path is ``group_norm_silu``'s then ``ops.int8.quantize``'s, bit for bit
  (codes and scale), bf16 and fp32, at a calibrated absmax and at half of it
  (codes clamped at +-127).
* Against JAX's ``group_norm_silu`` then ``static_int8_conv``
  (``clip_codec_tpu/ops/int8.py:80``), teacher-forced as
  ``tests/test_torch_int8.py`` holds every int8 layer: the scale bit-equal;
  the port's GroupNorm+SiLU output within ||delta|| / ||ref|| <= 1e-5 (fp32)
  or 3e-2 (bf16) of JAX's, so that its codes are JAX's within one code
  (int8 is discontinuous: a value within that rounding of a half flips); the
  conv on JAX's codes within one ulp of JAX's output.
* The static pixel U-Net forward takes the codes-out form for every
  ResBlock conv and equals the two-step form (the path before it) bit for
  bit; the dispatch rules: static int8 without a mesh takes it, dynamic,
  calibrating, a mesh or fp do not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from clip_codec_tpu.ops import groupnorm as jgn
from clip_codec_tpu.ops import int8 as ji
from clip_codec_tpu_torch.models import CLIPCondUNet, init_params
from clip_codec_tpu_torch.models import blocks
from clip_codec_tpu_torch.ops import groupnorm as gn
from clip_codec_tpu_torch.ops import int8 as q8

torch.set_num_threads(1)

G = 8
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rng, shape=(2, 8, 8, 32)):
    C = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(C)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("absmax", ["calibrated", "clamped"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_version_is_the_two_step_form(rng, dtype, absmax):
    x, scale, bias = _inputs(rng)
    xt = torch.from_numpy(x).to(DTYPES[dtype][1])
    sb = (torch.from_numpy(scale), torch.from_numpy(bias))
    y_k1 = gn.group_norm_silu_norm_plain(xt, gn.group_norm_silu_stats_plain(xt, G), *sb, G)  # K1's plain version
    am = y_k1.float().abs().amax() * (1.0 if absmax == "calibrated" else 0.5)
    xq, s = gn.group_norm_silu_int8_plain(xt, sb, G, am)
    xq2, s2 = q8.quantize_plain(y_k1, am)
    assert xq.dtype == torch.int8 and xq.shape == xt.shape and s.shape == ()
    assert torch.equal(xq, xq2) and torch.equal(s, s2)
    assert torch.equal(s, q8.act_scale_plain(am))
    clamped = int((xq.abs() == 127).sum())
    assert clamped > (100 if absmax == "clamped" else 0)
    # the CPU path: group_norm_silu's CPU branch, then quantize, bit for bit
    got, got_s = gn.group_norm_silu_int8(xt, sb, G, am)
    want, want_s = q8.quantize(gn.group_norm_silu(xt, sb, G), am)
    assert torch.equal(got, want) and torch.equal(got_s, want_s)
    # which differs from K1's plain version only where the two GroupNorms round apart
    assert int((got.int() - xq.int()).abs().max()) <= 1


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_matches_jax_group_norm_silu_then_static_int8_conv(rng, dtype):
    jd, td = DTYPES[dtype]
    x, scale, bias = _inputs(rng)
    C = x.shape[-1]
    kernel = (rng.standard_normal((3, 3, C, C)) / np.sqrt(9 * C)).astype(np.float32)  # HWIO
    cbias = (0.05 * rng.standard_normal(C)).astype(np.float32)
    xj = jnp.asarray(x).astype(jd)
    yj = jgn.group_norm_silu(xj, (jnp.asarray(scale), jnp.asarray(bias)), G)
    am = np.float32(0.8 * float(jnp.max(jnp.abs(yj.astype(jnp.float32)))))  # some codes clamp
    outj = np.asarray(ji.static_int8_conv(yj, jnp.asarray(kernel), jnp.asarray(cbias), jnp.float32(am)))
    s_j = jnp.maximum(jnp.float32(am), 1e-12) / 127.0  # static_int8_conv's scale and codes
    codes_j = np.asarray(jnp.clip(jnp.round(yj.astype(jnp.float32) / s_j), -127, 127).astype(jnp.int8))
    sj = np.float32(s_j)

    layer = nn.Conv2d(C, C, 3, padding=1)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        layer.bias.copy_(torch.from_numpy(cbias))
    xt = torch.from_numpy(x).to(td)
    xq, s = gn.group_norm_silu_int8(xt, (torch.from_numpy(scale), torch.from_numpy(bias)), G, torch.tensor(am))
    assert s.item() == sj
    # the glue: the port's GroupNorm+SiLU within the teacher-forced bound of JAX's, codes within one
    yt = gn.group_norm_silu(xt, (torch.from_numpy(scale), torch.from_numpy(bias)), G).float().numpy()
    yjf = np.asarray(yj.astype(jnp.float32))
    assert np.linalg.norm(yt - yjf) / np.linalg.norm(yjf) <= (1e-5 if dtype == "fp32" else 3e-2)
    assert np.abs(xq.numpy().astype(np.int32) - codes_j.astype(np.int32)).max() <= 1
    assert (np.abs(codes_j) == 127).sum() > 0
    # the layer, teacher-forced: the conv on JAX's codes and scale within one ulp of JAX's output
    out = q8.conv_codes(layer, torch.from_numpy(codes_j), torch.tensor(sj), torch.float32)
    ulp = float(np.spacing(np.float32(np.abs(outj).max())))
    assert out.shape == outj.shape and float(np.abs(out.numpy() - outj).max()) <= ulp


CFG = dict(z_dim=8, base=8, ch_mult=(1, 2))


@pytest.fixture(scope="module")
def static_net():
    """A seeded tiny pixel U-Net in int8 mode, calibrated as ``export_decoder --int8`` does."""
    net = init_params(CLIPCondUNet(**CFG, time_dim=256, dtype=torch.float32, int8=True),
                      torch.Generator().manual_seed(3)).eval()
    with torch.no_grad():
        quant = q8.calibrate_unet(net, size=16, z_dim=CFG["z_dim"], timesteps=50, batch=2)
    return net, quant


def _count(monkeypatch, module, name, calls):
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **kw: calls.append(name) or real(*a, **kw))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_static_unet_takes_the_codes_out_form_bit_equal_to_the_two_step_form(static_net, monkeypatch, dtype):
    net, quant = static_net
    net.compute_dtype = DTYPES[dtype][1]
    rng = np.random.default_rng(4)
    args = (torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)), torch.tensor([3, 40], dtype=torch.int32))
    calls = []
    for module, name in ((gn, "group_norm_silu_int8"), (blocks, "group_norm_silu"), (q8, "quantize")):
        _count(monkeypatch, module, name, calls)
    try:
        q8.load_quant(net, quant)
        with torch.no_grad():
            out = net(*args)
            resblock_convs = 2 * sum(isinstance(m, blocks.ResBlock) for m in net.modules())
            downsamples = len(q8.int8_layer_names(net)) - resblock_convs
            assert resblock_convs > 0 and downsamples > 0
            assert calls.count("group_norm_silu_int8") == resblock_convs
            assert calls.count("group_norm_silu") == 0 and calls.count("quantize") == downsamples
            calls.clear()
            monkeypatch.setattr(q8, "static_absmax", lambda layer: None)  # the two-step form
            two = net(*args)
            assert calls.count("group_norm_silu_int8") == 0
            assert calls.count("group_norm_silu") == resblock_convs == calls.count("quantize") - downsamples
    finally:
        q8.load_quant(net, None)
        net.compute_dtype = torch.float32
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, two)


def test_dispatch_rules(monkeypatch):
    """Static int8 and no mesh: the codes-out form. Dynamic, calibrating, a
    mesh, or no int8: K1's y, then the conv (quantizing it in int8)."""
    torch.manual_seed(0)
    block = blocks.ResBlock(32, 16).eval()
    x, h = torch.randn(2, 4, 4, 32), torch.randn(2, 16)
    calls = []
    for module, name in ((gn, "group_norm_silu_int8"), (blocks, "group_norm_silu"), (q8, "conv")):
        _count(monkeypatch, module, name, calls)

    def run(**kw):
        calls.clear()
        with torch.no_grad():
            block.direct(x, h, torch.float32, **kw)
        return {k: calls.count(k) for k in ("group_norm_silu_int8", "group_norm_silu", "conv")}

    static = {"group_norm_silu_int8": 2, "group_norm_silu": 0, "conv": 0}
    two_step = {"group_norm_silu_int8": 0, "group_norm_silu": 2, "conv": 2}
    assert run(int8=True) == two_step  # dynamic: no calibrated absmax
    q8.load_quant(block, {"conv1": torch.tensor(3.0), "conv2": torch.tensor(2.0)})
    assert run(int8=True) == static
    assert run(int8=False) == {"group_norm_silu_int8": 0, "group_norm_silu": 2, "conv": 0}
    with q8.calibrating(block) as quant:
        assert run(int8=True) == two_step
    assert sorted(quant) == ["conv1", "conv2"]
    # a mesh: the split form's GroupNorm (faked here by the unsharded one), then the conv
    monkeypatch.setattr(blocks, "group_norm_silu", lambda y, norm, mesh=None: calls.append("group_norm_silu") or
                        gn.group_norm_silu(y, (norm.weight, norm.bias), norm.num_groups))
    assert run(int8=True, mesh=object()) == two_step
