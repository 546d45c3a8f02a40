"""The port's data axis of ``parallel/`` (clip_codec_tpu_torch/parallel,
the sharded indexes, the data-sharded pixel artifact) against the JAX
package on the CPU.

The port's side runs as two gloo ranks: two spawned processes with
``OMP_NUM_THREADS=1`` and a worker timeout, one launch for every check
(tests/torch_dp_worker.py ``lib``), importing no jax. The JAX side runs
here, on a mesh of two of the 8 virtual CPU devices (tests/conftest.py).
Tiny configs: the pixel U-Net at base 8, ch_mult (1, 2), z_dim 8, 16px,
fp32, weights carried by ``weights/from_jax.py``; stores of 5 images or 63
rows.

Checks: mesh shapes and JAX's errors; ``shard_batch``'s rows and its
divisibility error; ``StoreData.epoch(local=)`` bit-equal to slicing the
global batch of both packages (a padded tail on which rank 1 holds only
weight-0 rows); ``sample_sharded`` within 1e-4 of JAX's ``sample_sharded``
and ``ddim_sample`` with JAX's x_T injected, and within 1e-5 of the port's
``ddim_sample`` on the whole batch from one generator, at eta 0 and 0.5;
the sharded fp32 and u8 exact indexes and ``shard_ivf_index`` over 2 shards
of 63 rows and 3 lists: ids equal to the single index (JAX's and the
port's) with exact ties, scores within 1e-6 (fp32) or 1e-5 (u8); the IVF
form equal to JAX's ``ShardedIVFIndex``, pools smaller than k padded as
JAX pads them; an empty store; the sharded artifact's header keys and
values equal to JAX's, its mesh-shape refusal, each loader refusing the
other's file, and its images equal to the single-device artifact's at one
seed.
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
from clip_codec_tpu.diffusion.ddim import ddim_sample as jax_ddim_sample
from clip_codec_tpu.index import ivf as jivf
from clip_codec_tpu.index import search as jsearch
from clip_codec_tpu.models import CLIPCondUNet as JaxUNet
from clip_codec_tpu.utils.config import ModelConfig as JaxModelConfig
from clip_codec_tpu_torch import deploy, parallel
from clip_codec_tpu_torch.diffusion import NoiseSchedule, ddim_sample
from clip_codec_tpu_torch.index import search as tsearch
from clip_codec_tpu_torch.models import CLIPCondUNet
from clip_codec_tpu_torch.utils.config import ModelConfig
from clip_codec_tpu_torch.weights.from_jax import unet_state_dict_from_jax
from tests.torch_dp_worker import run_ranks, store_images

torch.set_num_threads(1)

CFG = dict(z_dim=8, base=8, ch_mult=(1, 2))
MC = dict(z_dim=8, base=8, ch_mult=(1, 2), timesteps=50, schedule="linear", out_size=16)
KS = [2, 7, 9, 63, 100]


def _tie_store(rng, n=63, d=16):
    """Scores exact in fp32 in any summation order (small integer codes, a
    power-of-two scale, zero offset, dyadic queries); rows 3, 10, 40, 41
    and 62 are one row, rows 20-29 are row 50, so tie runs cross the
    shards (rows 0-31 and 32-62)."""
    codes = rng.integers(0, 4, (n, d)).astype(np.uint8)
    codes[[10, 40, 41, 62]] = codes[3]
    codes[20:30] = codes[50]
    scale, zero = np.full(d, 0.5, np.float32), np.zeros(d, np.float32)
    x = codes.astype(np.float32) * 0.5
    q = np.stack([x[3], x[50], np.full(d, 0.25, np.float32), -x[7]])  # the last scores every row <= 0
    return codes, scale, zero, x, q


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """Inputs, the JAX references, and the two ranks' results."""
    work = tmp_path_factory.mktemp("lib")
    rng = np.random.default_rng(0)
    store_images(work / "store", rng)
    jparams = JaxUNet(**CFG, fused_pallas=False).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 8)), jnp.zeros((1,), jnp.int32))["params"]
    sd = unet_state_dict_from_jax(jparams, CFG["ch_mult"])
    torch.save(sd, work / "unet.pt")
    z = rng.standard_normal((4, 8)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    key = jax.random.PRNGKey(5)
    x_T = np.array(jax.random.normal(jax.random.split(key)[1], (4, 16, 16, 3), jnp.float32))  # as JAX draws it
    codes, scale, zero, feats, queries = _tie_store(rng)
    np.savez(work / "lib_in.npz", z=z, x_T=x_T, feats=feats, codes=codes, scale=scale, zero=zero, queries=queries)
    (work / "lib_in.json").write_text(json.dumps({"cfg": CFG, "mc": MC, "ks": KS}))
    outs = run_ranks("lib", work)
    return dict(work=work, outs=outs, jparams=jparams, sd=sd, z=z, key=key, x_T=x_T, codes=codes, scale=scale,
                zero=zero, feats=feats, queries=queries, jmesh=jpar.make_mesh(2))


def test_mesh_shapes_and_errors(lib):
    for r, o in enumerate(lib["outs"]):
        assert o["mesh"] == [[2, 1], ["data", "model"], 2, r, "cpu"]
        assert o["mesh_tp"] == [[1, 2], 2, r]
        assert o["mesh_errors"] == ["ValueError: 2 devices not divisible by model_parallel=3",
                                    "ValueError: n_devices=4: a mesh spans every rank of the process group (2)"]
        with pytest.raises(ValueError, match="2 devices not divisible by model_parallel=3"):
            jpar.make_mesh(2, model_parallel=3)


def test_shard_batch_rows_and_error(lib):
    for r, o in enumerate(lib["outs"]):
        assert o["rows"] == [4 * r, 4 * r + 4]
        mine = range(4 * r, 4 * r + 4)
        assert o["shard_batch"] == [list(mine), [[2 * i, 2 * i + 1] for i in mine]]
        assert o["shard_error"] == "ValueError: batch 5 not divisible by data axis 2; pad the batch"


def test_initialize_distributed_is_a_no_op_without_a_launcher(monkeypatch):
    import torch.distributed as dist

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    initialized = dist.is_initialized()
    assert parallel.initialize_distributed() is False and parallel.initialize_distributed() is False
    assert dist.is_initialized() == initialized
    monkeypatch.setenv("WORLD_SIZE", "2")
    if not initialized:
        with pytest.raises(RuntimeError, match="incomplete launcher environment"):
            parallel.initialize_distributed()


def test_exports_are_jax_minus_the_model_axis():
    """The model axis is ported (tests/test_torch_tp.py,
    tests/test_torch_spatial.py): the exports are JAX's but its two
    ``NamedSharding`` helpers, which have no meaning in the port."""
    assert set(parallel.__all__) == set(jpar.__all__) - {"batch_sharded", "replicated"}
    for name in ("sd_unet_tp_specs", "shard_params_tp", "validate_tp", "sample_spatial_sharded"):
        assert callable(getattr(parallel, name))


def test_store_epoch_local_rows_equal_the_sliced_global_batch(lib):
    from clip_codec_tpu.train.data import StoreData as JaxStoreData
    from clip_codec_tpu_torch.train.data import StoreData

    store = lib["work"] / "store"
    rj, rt = np.random.default_rng(4), np.random.default_rng(4)
    jd, td = JaxStoreData(store, out_size=12), StoreData(store, out_size=12)
    want_j = [b for _ in range(2) for b in jd.epoch(4, rj, u8=True)]
    want_t = [b for _ in range(2) for b in td.epoch(4, rt, u8=True)]
    for r, o in enumerate(lib["outs"]):
        got = o["epoch"]
        assert len(got) == len(want_j) == len(want_t) == 4
        for (x0, z, w, wsum), bj, bt in zip(got, want_j, want_t):
            for b in (bj, bt):
                np.testing.assert_array_equal(x0, b.x0[2 * r:2 * r + 2])
                np.testing.assert_array_equal(z, b.z[2 * r:2 * r + 2])
                np.testing.assert_array_equal(w, b.weight[2 * r:2 * r + 2])
                assert wsum == b.wsum
    assert lib["outs"][1]["epoch"][1][2].tolist() == [0.0, 0.0] and lib["outs"][1]["epoch"][1][3] == 1.0


def test_sample_sharded_matches_jax_and_the_whole_batch(lib):
    jsched = JaxSchedule.create(50, "linear")
    net = JaxUNet(**CFG, fused_pallas=False)
    model_fn = lambda p, x, zz, t: net.apply(p, x, zz, t)
    params = {"params": lib["jparams"]}
    want_sharded = jpar.sample_sharded(lib["jmesh"], model_fn, jsched, lib["z"], 16, steps=3, rng=lib["key"],
                                       model_params=params)
    want_ddim = np.asarray(jax_ddim_sample(model_fn, jsched, jnp.asarray(lib["z"]), (4, 16, 16, 3), 3,
                                           x_T=jnp.asarray(lib["x_T"]), model_params=params))
    tnet = CLIPCondUNet(**CFG, time_dim=256, fused_pallas=False)
    tnet.load_state_dict(lib["sd"], strict=True)
    sched = NoiseSchedule.create(50, "linear")
    z = torch.from_numpy(lib["z"])
    with torch.no_grad():
        whole_x_T = ddim_sample(tnet, sched, z, (4, 16, 16, 3), 3, x_T=torch.from_numpy(lib["x_T"])).numpy()
        whole_gen = ddim_sample(tnet, sched, z, (4, 16, 16, 3), 3, generator=torch.Generator().manual_seed(9)).numpy()
    for o in lib["outs"]:
        got = o["sample_x_T"]
        assert got.shape == (4, 16, 16, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want_sharded), rtol=0, atol=1e-4)
        np.testing.assert_allclose(got, want_ddim, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got, whole_x_T, rtol=0, atol=1e-5)
        np.testing.assert_allclose(o["sample_gen_0.0"], whole_gen, rtol=0, atol=1e-5)
        np.testing.assert_allclose(o["sample_gen_0.5"], o["whole_gen_0.5"], rtol=0, atol=1e-5)
        assert o["sample_error"] == "ValueError: batch 3 not divisible by data axis 2; pad the batch"
    np.testing.assert_array_equal(lib["outs"][0]["sample_gen_0.5"], lib["outs"][1]["sample_gen_0.5"])


def _distinct(scores, tol):
    """Places whose score differs from both neighbours by more than tol (the
    last place's next neighbour is unknown: a tie may run past k)."""
    s = np.asarray(scores)
    gap = np.abs(np.diff(s, axis=1)) > tol
    left = np.concatenate([np.ones((s.shape[0], 1), bool), gap], axis=1)
    right = np.concatenate([gap, np.zeros((s.shape[0], 1), bool)], axis=1)
    return left & right


def test_sharded_exact_indexes_match_jax_with_ties(lib):
    q, x = lib["queries"], lib["feats"]
    single = [jsearch.build_index(x), jsearch.build_index_u8(lib["codes"], lib["scale"], lib["zero"])]
    sharded = [jsearch.build_sharded_index(x, lib["jmesh"]),
               jsearch.build_sharded_index_u8(lib["codes"], lib["scale"], lib["zero"], lib["jmesh"])]
    port = [tsearch.build_index(x, device="cpu"),
            tsearch.build_index_u8(lib["codes"], lib["scale"], lib["zero"], device="cpu")]
    for o in lib["outs"]:
        assert o["index"]["fp32_rows"][1] == (32, 16) and o["index"]["u8_rows"][1] == (32, 16)
        for form, atol, js, jsh, ts in (("fp32", 1e-6, single[0], sharded[0], port[0]),
                                        ("u8", 1e-5, single[1], sharded[1], port[1])):
            for k, (s, i) in zip(KS, o["index"][form]):
                kk = min(k, 63)
                assert s.shape == i.shape == (4, kk) and s.dtype == np.float32 and i.dtype == np.int32
                for ref in (js.search(q, k), ts.search(q, k)):
                    np.testing.assert_array_equal(i, np.asarray(ref[1]), err_msg=f"{form} k={k}")
                    np.testing.assert_allclose(s, np.asarray(ref[0]), rtol=0, atol=atol)
                # JAX's sharded merge sorts candidates with an unstable argsort, so among equal scores
                # its order may differ from its own single index's; elsewhere the ids are the same
                ws, wi = jsh.search(q, k)
                np.testing.assert_allclose(s, np.asarray(ws), rtol=0, atol=atol)
                keep = _distinct(s, atol)
                np.testing.assert_array_equal(i[keep], np.asarray(wi)[keep])
        assert (o["index"]["fp32"][3][0][3] <= 0).all()  # the all-negative query still ranks real rows
        for s, i in o["index"]["empty"]:
            assert s.shape == i.shape == (4, 0)


def test_sharded_ivf_matches_jax(lib):
    q = lib["queries"]
    forms = {"ivf": jivf.build_ivf_index(lib["feats"], nlist=3, nprobe=2),
             "ivf_u8": jivf.build_ivf_index_u8(lib["codes"], lib["scale"], lib["zero"], nlist=3, nprobe=2)}
    padded = 0
    for name, single in forms.items():
        sharded = jivf.shard_ivf_index(single, lib["jmesh"])
        for o in lib["outs"]:
            assert o["index"][name + "_lists"][1][0] == 2  # 3 lists: 2 on each rank, one of them padding
            got = iter(o["index"][name])
            for k in KS:
                for nprobe in (1, 2, 3):
                    s, i = next(got)
                    ws, wi = sharded.search(q, k, nprobe=nprobe)
                    np.testing.assert_array_equal(i, np.asarray(wi), err_msg=f"{name} k={k} nprobe={nprobe}")
                    np.testing.assert_allclose(s, np.asarray(ws), rtol=0, atol=1e-5)
                    ss, si = single.search(q, k, nprobe=nprobe)
                    real = np.asarray(si) >= 0
                    np.testing.assert_allclose(s[real], np.asarray(ss)[real], rtol=0, atol=1e-5)
                    keep = _distinct(s, 1e-5) & real
                    np.testing.assert_array_equal(i[keep], np.asarray(si)[keep])
                    padded += int((i < 0).sum())
                    assert (s[i < 0] == 0).all() and s.shape == (4, min(k, 63))
    assert padded > 0  # some probe held fewer candidates than k


def test_sharded_artifact_matches_jax_header_and_single_images(lib, tmp_path):
    mc = ModelConfig(**MC)
    single = deploy.load_decompressor(deploy.export_decompressor(
        lib["sd"], mc, tmp_path / "one.torchprog", size=16, steps=3, batch_size=4, dtype="float32",
        platforms=["cpu"]), device="cpu")
    want = single(lib["sd"], lib["z"], seed=3).numpy()
    jpath = jdeploy.export_sharded_decompressor(lib["jparams"], JaxModelConfig(**MC), tmp_path / "j.prog",
                                                lib["jmesh"], size=16, steps=3, batch_size=4)
    jmeta = jdeploy.read_artifact_meta(jpath)
    for o in lib["outs"]:
        meta = o["artifact_meta"]
        assert set(jmeta) <= set(meta) and {k: meta[k] for k in jmeta} == jmeta
        assert meta["mesh"] == {"data": 2, "model": 1} and meta["sharded"] is True and meta["spatial"] is False
        a, b, c = o["artifact"]
        assert a.shape == (4, 16, 16, 3) and np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)
        np.testing.assert_allclose(a, want, rtol=0, atol=1e-5)
        assert o["export_error"] == "ValueError: batch_size 3 not divisible by data axis 2"
        path = lib["work"] / "sharded.torchprog"
        assert o["artifact_errors"] == [
            f"ValueError: {path}: exported for mesh {{'data': 2, 'model': 1}}, got {{'data': 1, 'model': 2}}",
            f"ValueError: {path}: sharded artifact (mesh {{'data': 2, 'model': 1}}) — use "
            f"load_sharded_decompressor(path, mesh)"]
    np.testing.assert_array_equal(lib["outs"][0]["artifact"][0], lib["outs"][1]["artifact"][0])
    with pytest.raises(ValueError, match="not a sharded artifact — use load_decompressor"):
        deploy.load_sharded_decompressor(tmp_path / "one.torchprog", None)
    with pytest.raises(ValueError, match="use load_sharded_decompressor"):
        jdeploy.load_decompressor(jpath)
