"""The port's spatially sharded pixel sampling (``CLIPCondUNet.forward_spatial``,
``parallel.sample_spatial_sharded``, ``export_sharded_decompressor(spatial=True)``)
and K1's split form against the JAX package on the CPU.

The port's side runs as two gloo ranks on a (1, 2) mesh, the image height
split over the model axis: two spawned processes with
``OMP_NUM_THREADS=1``, one launch for every check (tests/torch_dp_worker.py
``spatial``), importing no jax. The JAX side runs here on a (1, 2) mesh of
the 8 virtual CPU devices (tests/conftest.py). The pixel U-Net at base 8,
ch_mult (1, 2), z_dim 8, 16px, fp32, JAX's direct form
(``fused_pallas=False``), weights carried by ``weights/from_jax.py``; a
linear schedule and 3 DDIM steps, as tests/test_parallel.py holds JAX's
own spatial sampling (the cosine tail divides by ~1e-10 and turns fp32
reassociation into visible differences).

Checks: ``sample_spatial_sharded`` within rtol 1e-4 / atol 1e-5 of the
port's unsharded ``ddim_sample``, at eta 0 and, from one generator, at eta
0.5, and within rtol 1e-4 / atol 1e-4 of JAX's ``sample_spatial_sharded``
(its x_T injected), the bound the port's unsharded sampler meets against
JAX's here (~3e-5 apart: fp32 reassociation in the convs); the
divisibility errors with JAX's text; the uneven-level refusal naming the
level; the spatial artifact's header keys and values equal to JAX's, its
images equal to the sample's, its refusals; K1's split plain pair with
totals summed over the two halves of H equal to the one-shot plain result
within 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_codec_tpu import deploy as jdeploy
from clip_codec_tpu import parallel as jpar
from clip_codec_tpu.diffusion import NoiseSchedule as JaxSchedule
from clip_codec_tpu.models import CLIPCondUNet as JaxUNet
from clip_codec_tpu.utils.config import ModelConfig as JaxModelConfig
from clip_codec_tpu_torch.diffusion import NoiseSchedule, ddim_sample
from clip_codec_tpu_torch.models import CLIPCondUNet
from clip_codec_tpu_torch.ops import groupnorm as gn
from clip_codec_tpu_torch.weights.from_jax import unet_state_dict_from_jax
from tests.torch_dp_worker import run_ranks

torch.set_num_threads(1)

CFG = dict(z_dim=8, base=8, ch_mult=(1, 2))
MC = dict(z_dim=8, base=8, ch_mult=(1, 2), timesteps=50, schedule="linear", out_size=16)


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    """Inputs, the JAX params and the port's state dict, and the two ranks'
    results."""
    work = tmp_path_factory.mktemp("spatial")
    jparams = JaxUNet(**CFG, fused_pallas=False).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 8)), jnp.zeros((1,), jnp.int32))["params"]
    sd = unet_state_dict_from_jax(jparams, CFG["ch_mult"])
    torch.save(sd, work / "unet.pt")
    rng = np.random.default_rng(3)
    z = rng.standard_normal((4, 8)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    x_T = np.array(jax.random.normal(jax.random.split(key)[1], (4, 16, 16, 3), jnp.float32))  # as JAX draws it
    np.savez(work / "spatial_in.npz", z=z, x_T=x_T)
    (work / "spatial_in.json").write_text(json.dumps({"cfg": CFG, "mc": MC}))
    outs = run_ranks("spatial", work)
    net = CLIPCondUNet(**CFG, time_dim=256, fused_pallas=False)
    net.load_state_dict(sd, strict=True)
    return dict(work=work, outs=outs, jparams=jparams, sd=sd, net=net.eval(), z=z, key=key, x_T=x_T,
                jmesh=jpar.make_mesh(2, model_parallel=2))


def test_sample_matches_jax_spatial_and_the_unsharded_sampler(spatial):
    jnet = JaxUNet(**CFG, fused_pallas=False)
    jsched = JaxSchedule.create(50, "linear")
    want = jpar.sample_spatial_sharded(spatial["jmesh"], lambda x, zz, t: jnet.apply({"params": spatial["jparams"]},
                                                                                   x, zz, t),
                                       jsched, spatial["z"], 16, steps=3, rng=spatial["key"])
    sched = NoiseSchedule.create(50, "linear")
    whole = ddim_sample(spatial["net"], sched, torch.from_numpy(spatial["z"]), (4, 16, 16, 3), 3,
                        x_T=torch.from_numpy(spatial["x_T"])).numpy()
    whole_eta = ddim_sample(spatial["net"], sched, torch.from_numpy(spatial["z"]), (4, 16, 16, 3), 3, 0.5,
                            torch.Generator().manual_seed(9)).numpy()
    for o in spatial["outs"]:
        got = o["sample"]
        assert got.shape == (4, 16, 16, 3) and np.isfinite(got).all()
        np.testing.assert_allclose(got, whole, rtol=1e-4, atol=1e-5)
        # against JAX at the bound the port's unsharded sampler meets there (it sits up to ~3e-5 from JAX's
        # over these steps, through fp32 reassociation in the convs), as tests/test_torch_parallel.py holds
        # sample_sharded
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o["sample_eta"], whole_eta, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(whole, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(spatial["outs"][0]["sample"], spatial["outs"][1]["sample"])


def test_divisibility_and_uneven_level_errors(spatial):
    with pytest.raises(ValueError, match="not divisible") as e:
        jpar.sample_spatial_sharded(spatial["jmesh"], lambda x, zz, t: x, JaxSchedule.create(50, "linear"),
                                    spatial["z"], 15, steps=1)
    for o in spatial["outs"]:
        assert o["sample_errors"] == [
            "ValueError: batch 3 not divisible by data axis 2",
            f"ValueError: {e.value}",
            "ValueError: spatial sharding: level 1 has 6 rows, 3 a rank over a model axis of 2, and its stride-2 "
            "downsample needs an even count a rank (the JAX package pads unevenly split levels through GSPMD; "
            "the port refuses them)",
            "TypeError: sample_spatial_sharded runs the U-Net's spatial form (CLIPCondUNet.forward_spatial); got "
            "function"]
        assert o["export_errors"] == [o["sample_errors"][2]]


def test_spatial_artifact_header_images_and_refusals(spatial, tmp_path):
    jpath = jdeploy.export_sharded_decompressor(spatial["jparams"], JaxModelConfig(**MC), tmp_path / "s.jaxprog",
                                                spatial["jmesh"], spatial=True, size=16, steps=3, batch_size=4)
    jmeta = jdeploy.read_artifact_meta(jpath)
    for o in spatial["outs"]:
        meta = o["artifact_meta"]
        assert set(jmeta) <= set(meta) and {k: meta[k] for k in jmeta} == jmeta
        assert meta["spatial"] is True and meta["mesh"] == {"data": 1, "model": 2}
        assert o["artifact_replay"] == "eager"
        injected, seeded = o["artifact"]
        np.testing.assert_array_equal(injected, np.clip(o["sample"], -1, 1))
        assert seeded.shape == (4, 16, 16, 3) and np.isfinite(seeded).all() and not np.array_equal(seeded, injected)
        path = spatial["work"] / "spatial.torchprog"
        assert o["artifact_errors"] == [
            f"ValueError: {path}: exported for mesh {{'data': 1, 'model': 2}}, got {{'data': 2, 'model': 1}}"]
    np.testing.assert_array_equal(spatial["outs"][0]["artifact"][1], spatial["outs"][1]["artifact"][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_plain_pair_over_two_halves_equals_one_shot(dtype):
    """K1's split form as the spatial U-Net calls it: each half of H's slab
    partials, summed to totals, the two halves' totals added, then each half
    normalised over the whole count: the one-shot plain result within 1e-6."""
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(2, 64, 24, 32, generator=gen) * 2 + 0.5).to(dtype)
    scale, bias = torch.randn(32, generator=gen) * 0.2 + 1, torch.randn(32, generator=gen) * 0.1
    halves = x.chunk(2, dim=1)
    tot = sum(gn.group_norm_silu_stats(h.contiguous(), 8).sum(dim=1) for h in halves)
    got = torch.cat([gn.group_norm_silu_apply(h.contiguous(), tot, 64 * 24 * 4, (scale, bias), 8) for h in halves],
                    dim=1)
    one = gn.group_norm_silu_norm_plain(x, gn.group_norm_silu_stats_plain(x, 8), scale, bias, 8)
    assert got.dtype == dtype
    torch.testing.assert_close(got, one, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got.float(), gn.group_norm_silu_plain(x.float(), (scale, bias), 8), rtol=1e-5,
                               atol=1e-5)


def test_shifted_stats_hold_a_mean_that_dwarfs_the_spread():
    """The spatial GroupNorm's one statistics pass, as ``group_norm_silu_spatial``
    makes it: the sums of x minus one element of each group, the moments
    merged (one rank here), then apply about the mean with totals (0, M2):
    in fp32 within 1e-4 of the fp64 one-shot result on the same values
    where the mean is 1e3 times the spread, as raw moments are not."""
    from clip_codec_tpu_torch.parallel.mesh import merge_moments_model

    gen = torch.Generator().manual_seed(1)
    xf = torch.randn(2, 16, 12, 32, generator=gen) * 0.1 + 100.0
    scale, bias = torch.randn(32, generator=gen) * 0.2 + 1, torch.randn(32, generator=gen) * 0.1
    x, n = xf.double(), 16 * 12 * 4
    shift = xf[:, 0, 0].reshape(2, 8, 4)[:, :, 0].contiguous()
    tot = gn.group_norm_silu_stats(xf, 8, shift=shift).sum(dim=1)
    mean, m2 = merge_moments_model(None, shift, tot[:, 0], tot[:, 1], n)
    got = gn.group_norm_silu_apply(xf, torch.stack([torch.zeros_like(m2), m2], dim=1), n, (scale, bias), 8,
                                   shift=mean)
    want = gn.group_norm_silu_plain(x, (scale.double(), bias.double()), 8)
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-4)
    raw = gn.group_norm_silu_apply(xf, gn.group_norm_silu_stats(xf, 8).sum(dim=1), n, (scale, bias), 8)
    assert (raw.double() - want).abs().max() > 1e-2  # the raw moments cancel here
