"""The port's tensor-parallel SD UNet (clip_codec_tpu_torch/parallel/tp.py,
models/sd with a mesh, the tensor-parallel SD artifact) against the JAX
package on the CPU.

The port's side runs as two gloo ranks on a (1, 2) mesh: two spawned
processes with ``OMP_NUM_THREADS=1``, one launch for every check
(tests/torch_dp_worker.py ``tp``), importing no jax. The JAX side runs
here, on a (1, 2) mesh of the 8 virtual CPU devices (tests/conftest.py),
with tests/test_tp.py's TINY and TINY4 configs, fp32; the weights are the
port's seeded modules carried to JAX by its own converters.

Checks: each rank's slice of every UNet tensor equal, bit for bit, to JAX's
``shard_params_tp`` shard on the matching device, converted back
(``weights/from_jax.py``); the GEGLU's [hidden | gate] halves sliced each
on its own; ``validate_tp``'s errors with JAX's text; the TP forward within
1e-4 of JAX's TP forward (TINY, and TINY4 at 32x32 where the first level's
self-attention passes the flash gate on each rank's heads) and within 1e-5
of the port's one-rank forward (the all-reduce reassociates the
row-parallel sums in fp32); a model axis of one bit-equal to the plain
UNet; the int8 refusals; the TP SD artifact's header keys and values equal
to JAX's, ``replay`` eager on the CPU, its images on both ranks equal and
within 1e-5 of the single-device artifact's at two guidances, and its
mesh and loader refusals.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from clip_codec_tpu import deploy as jdeploy
from clip_codec_tpu import parallel as jpar
from clip_codec_tpu.models import sd as jsd
from clip_codec_tpu.weights.convert_sd import convert_sd_adapter, convert_sd_unet, convert_sd_vae
from clip_codec_tpu_torch import deploy, parallel
from clip_codec_tpu_torch.models import init_params
from clip_codec_tpu_torch.models import sd as tsd
from clip_codec_tpu_torch.weights.from_jax import sd_unet_state_dict_from_jax
from tests.torch_dp_worker import run_ranks

torch.set_num_threads(1)

TINY = dict(block_out=(8, 16), layers_per_block=1, cross_dim=16, heads=2, freq_dim=8)
TINY4 = dict(block_out=(8, 16), layers_per_block=1, cross_dim=16, heads=4, freq_dim=8)
VCFG = dict(block_out=(8, 16), layers_per_block=1, latent_ch=4)
SIZES = {"tiny": [8], "tiny4": [8, 32]}
CLIP_DIM = 8


def _seeded(module, gen):
    init_params(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Inputs, the weights of both packages, and the two ranks' results."""
    work = tmp_path_factory.mktemp("tp")
    gen = torch.Generator().manual_seed(19)
    unets = {name: _seeded(tsd.SDUNet(tsd.SDUNetConfig(**cfg)), gen) for name, cfg in (("tiny", TINY),
                                                                                      ("tiny4", TINY4))}
    vae = _seeded(tsd.AutoencoderKL(tsd.VAEConfig(**VCFG)), gen)
    adapter = _seeded(tsd.SDClipAdapter(in_dim=CLIP_DIM, ctx_dim=16, n_tokens=2), gen)
    for name, sd in unets.items():
        torch.save(sd, work / f"{name}_unet.pt")
    torch.save(vae, work / "vae.pt")
    torch.save(adapter, work / "adapter.pt")
    rng = np.random.default_rng(0)
    inp = {}
    for S in (8, 32):
        inp[f"lat{S}"] = rng.standard_normal((4, S, S, 4)).astype(np.float32)
        inp[f"t{S}"] = (np.arange(4) * 7).astype(np.int32)
        inp[f"ctx{S}"] = rng.standard_normal((4, 3, 16)).astype(np.float32)
    inp["z"] = rng.standard_normal((1, CLIP_DIM)).astype(np.float32)
    inp["x_T"] = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    np.savez(work / "tp_in.npz", **inp)
    (work / "tp_in.json").write_text(json.dumps({"tiny": TINY, "tiny4": TINY4, "vae": VCFG, "sizes": SIZES}))
    outs = run_ranks("tp", work)
    jparams = {name: convert_sd_unet(sd, n_blocks=2, layers_per_block=1) for name, sd in unets.items()}
    return dict(work=work, outs=outs, unets=unets, vae=vae, adapter=adapter, inp=inp, jparams=jparams,
                jmesh=jpar.make_mesh(2, model_parallel=2))


@pytest.mark.parametrize("name", ["tiny", "tiny4"])
def test_rank_slices_equal_jaxs_shards(tp, name):
    """JAX's ``shard_params_tp`` on the (1, 2) mesh, each device's shard
    carried back to torch names: the port's rank r holds exactly device r's
    tensors, the GEGLU's [hidden | gate] halves included."""
    sharded = jpar.shard_params_tp(tp["jmesh"], tp["jparams"][name])
    devices = tp["jmesh"].devices.reshape(-1)
    specs = parallel.sd_unet_tp_specs(tp["unets"][name])
    geglu = [k for k in specs if k.endswith("ff.net.0.proj.weight")]
    assert geglu and all(specs[k] == 0 for k in geglu)
    for r, o in enumerate(tp["outs"]):
        local = jax.tree_util.tree_map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards if s.device == devices[r])), sharded)
        want = sd_unet_state_dict_from_jax(local)
        got = o[f"{name}_shards"]
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        whole = tp["unets"][name]
        for k in geglu:  # rank r: hidden rows [rF/2, (r+1)F/2) and the same gate rows
            F = whole[k].shape[0] // 2
            half = F // 2
            rows = list(range(r * half, (r + 1) * half)) + list(range(F + r * half, F + (r + 1) * half))
            assert torch.equal(got[k], whole[k][rows])
        sliced = [k for k, d in specs.items() if d is not None]
        assert all(got[k].shape != whole[k].shape for k in sliced)
        assert all(torch.equal(got[k], whole[k]) for k in specs if specs[k] is None)


def test_validate_tp_errors_are_jaxs():
    cases = [(TINY, 4), (dict(TINY, block_out=(9, 12)), 2), (TINY, 1), (TINY4, 4)]
    for cfg, n in cases:
        got = want = ""
        try:
            parallel.validate_tp(tsd.SDUNetConfig(**cfg), n)
        except ValueError as e:
            got = str(e)
        try:
            jpar.validate_tp(jsd.SDUNetConfig(**cfg), n)
        except ValueError as e:
            want = str(e)
        assert got == want, (cfg, n)
    with pytest.raises(ValueError, match="heads=2 not divisible by model axis 4"):
        parallel.validate_tp(tsd.SDUNetConfig(**TINY), 4)


@pytest.mark.parametrize("name,S", [("tiny", 8), ("tiny4", 8), ("tiny4", 32)])
def test_tp_forward_matches_jax_tp_and_one_rank(tp, name, S):
    cfg = TINY if name == "tiny" else TINY4
    lat, t, ctx = (tp["inp"][f"{k}{S}"] for k in ("lat", "t", "ctx"))
    net = jsd.SDUNet(jsd.SDUNetConfig(**cfg))
    params = jpar.shard_params_tp(tp["jmesh"], tp["jparams"][name])
    ds = NamedSharding(tp["jmesh"], P("data"))
    jtp = np.asarray(jax.jit(lambda p, *a: net.apply({"params": p}, *a))(
        params, *(jax.device_put(a, ds) for a in (lat, t, ctx))))
    plain = tsd.SDUNet(tsd.SDUNetConfig(**cfg))
    plain.load_state_dict(tp["unets"][name], strict=True)
    with torch.no_grad():
        one = plain(*(torch.from_numpy(a) for a in (lat, t, ctx))).numpy()
    for o in tp["outs"]:
        got = o[f"{name}_fwd{S}"]
        assert got.shape == lat.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, jtp, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(o[f"{name}_one{S}"], one)  # a model axis of one: the plain UNet, bit for bit
    np.testing.assert_array_equal(tp["outs"][0][f"{name}_fwd{S}"], tp["outs"][1][f"{name}_fwd{S}"])


def test_int8_is_refused_under_tp(tp):
    for o in tp["outs"]:
        assert o["int8_errors"] == ["ValueError: tensor parallelism takes no int8 (JAX's tensor-parallel SD "
                                    "artifact takes no quant either)"]
        assert o["export_errors"][0] == o["int8_errors"][0]
        assert o["export_errors"][1] == "ValueError: heads=3 not divisible by model axis 2"


def test_tp_artifact_header_images_and_refusals(tp, tmp_path):
    work = tp["work"]
    ucfg, vcfg = jsd.SDUNetConfig(**TINY), jsd.VAEConfig(**VCFG)
    jp = (tp["jparams"]["tiny"], convert_sd_vae(tp["vae"], n_blocks=2, enc_layers=1),
          convert_sd_adapter({"adapter": tp["adapter"]}))
    jpath = jdeploy.export_sharded_sd_decompressor(*jp, tmp_path / "tp.jaxprog", tp["jmesh"], unet_cfg=ucfg,
                                                   vae_cfg=vcfg, size=16, steps=2, batch_size=1)
    jmeta = jdeploy.read_artifact_meta(jpath)
    sds = (tp["unets"]["tiny"], tp["vae"], tp["adapter"])
    single = deploy.load_sd_decompressor(deploy.export_sd_decompressor(
        *sds, tmp_path / "one.torchprog", unet_cfg=tsd.SDUNetConfig(**TINY), vae_cfg=tsd.VAEConfig(**VCFG),
        size=16, steps=2, batch_size=1, platforms=["cpu"], dtype="float32"), device="cpu")
    assert single.replay == "eager"
    for o in tp["outs"]:
        meta = o["sd_meta"]
        assert set(jmeta) <= set(meta) and {k: meta[k] for k in jmeta} == jmeta
        assert meta["mesh"] == {"data": 1, "model": 2} and meta["sharded"] is True and meta["int8"] is False
        assert o["sd_replay"] == "eager"
        for g, got in zip((4.0, 0.0), o["sd_images"]):
            want = single(*sds, tp["inp"]["z"], guidance_scale=g, x_T=tp["inp"]["x_T"]).numpy()
            assert got.shape == (1, 16, 16, 3) and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        path = work / "tp.torchprog"
        assert o["sd_errors"] == [
            f"ValueError: {path}: exported for mesh {{'data': 1, 'model': 2}}, got {{'data': 2, 'model': 1}}",
            f"ValueError: {path}: sharded artifact (mesh {{'data': 1, 'model': 2}}) — use "
            f"load_sharded_sd_decompressor(path, mesh)"]
    np.testing.assert_array_equal(tp["outs"][0]["sd_images"][0], tp["outs"][1]["sd_images"][0])
    assert not np.array_equal(tp["outs"][0]["sd_images"][0], tp["outs"][0]["sd_images"][1])
    with pytest.raises(ValueError, match="not a sharded artifact — use load_sd_decompressor"):
        deploy.load_sharded_sd_decompressor(tmp_path / "one.torchprog", None)
    with pytest.raises(ValueError, match="load_sharded_sd_decompressor"):
        jdeploy.load_sd_decompressor(jpath)
