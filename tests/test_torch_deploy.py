"""The port's serving artifacts (clip_codec_tpu_torch/deploy.py and
cli/export_decoder.py) against the JAX package's (clip_codec_tpu/deploy.py).

On the CPU a loaded artifact runs the eager sampler (the card captures it in
one CUDA graph: tests/test_torch_cuda.py). Tiny configs (base 8, 16px, a few
steps), fp32: the pixel call with the initial noise injected equals JAX's
sampler from the same noise, clipped, within 1e-4 (uint8: bit for bit away
from a level boundary); the SD call equals JAX's ``_cfg_ddim_sample`` from
the same latent within 1e-4 of the largest magnitude, at two guidance values
from one artifact. Pixel weights come from JAX params through
``weights/from_jax.py``; SD weights are the port's seeded modules carried to
JAX by its own converters, as tests/test_torch_sd.py does.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_codec_tpu import deploy as jdeploy
from clip_codec_tpu.diffusion import NoiseSchedule as JaxSchedule
from clip_codec_tpu.diffusion import make_sampler as jax_make_sampler
from clip_codec_tpu.models import CLIPCondUNet as JaxUNet
from clip_codec_tpu.models import sd as jsd
from clip_codec_tpu.utils.config import ModelConfig as JaxModelConfig
from clip_codec_tpu.weights.convert_sd import convert_sd_adapter, convert_sd_unet, convert_sd_vae
from clip_codec_tpu_torch import deploy
from clip_codec_tpu_torch.codec import ClipCodec
from clip_codec_tpu_torch.diffusion import NoiseSchedule, make_sampler
from clip_codec_tpu_torch.models import init_params
from clip_codec_tpu_torch.models import sd as tsd
from clip_codec_tpu_torch.models.sd.decoder import cfg_combine
from clip_codec_tpu_torch.utils.config import ModelConfig
from clip_codec_tpu_torch.weights.from_jax import unet_state_dict_from_jax

torch.set_num_threads(1)

CFG = dict(z_dim=8, base=8, ch_mult=(1, 2))
# A linear schedule: the parity sampler divides eps by sqrt(al_bar_t), small
# at the first step of a cosine schedule, which turns fp32 reassociation into
# 1e-3-size differences (tests/test_torch_slice.py).
MC = dict(**CFG, timesteps=50, schedule="linear")
B, SIZE, STEPS = 2, 16, 3
UCFG = dict(block_out=(8, 16), layers_per_block=1, cross_dim=16, heads=2, freq_dim=8)
VCFG = dict(block_out=(8, 16), layers_per_block=1, latent_ch=4)
CLIP_DIM = 8


def jax_unet_params(cfg: dict, seed: int, size: int = SIZE) -> dict:
    """A JAX ``CLIPCondUNet`` params tree of seeded random values: the tree's
    shapes from ``eval_shape`` of its init (compiling the init takes ~10 s),
    weights normal(0, 1/fan_in), biases normal(0, 0.05), norm scales 1 +
    normal(0, 0.05)."""
    net = JaxUNet(**cfg, fused_pallas=False)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)),
                            jnp.zeros((1, cfg["z_dim"])), jnp.zeros((1,), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        x = rng.standard_normal(s.shape)
        name = path[-1].key
        if name == "scale":
            x = 1.0 + 0.05 * x
        elif name == "bias":
            x = 0.05 * x
        else:
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        return jnp.asarray(x, s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def pixel():
    """JAX params of the tiny U-Net and the port's state dict made from them."""
    params = jax_unet_params(CFG, 0)
    return dict(params=params, sd=unet_state_dict_from_jax(params, CFG["ch_mult"]),
                jmc=JaxModelConfig(**MC), mc=ModelConfig(**MC))


@pytest.fixture(scope="module")
def sd_weights():
    """The port's seeded tiny SD modules' state dicts and the JAX params made
    from them by the JAX package's converters."""
    gen = torch.Generator().manual_seed(10)
    mods = [tsd.SDUNet(tsd.SDUNetConfig(**UCFG)), tsd.AutoencoderKL(tsd.VAEConfig(**VCFG)),
            tsd.SDClipAdapter(in_dim=CLIP_DIM, ctx_dim=16, n_tokens=2)]
    sds = []
    for m in mods:
        init_params(m, gen)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
        sds.append({k: v.detach().clone() for k, v in m.state_dict().items()})
    jp = (convert_sd_unet(sds[0], n_blocks=2, layers_per_block=1), convert_sd_vae(sds[1], n_blocks=2, enc_layers=1),
          convert_sd_adapter({"adapter": sds[2]}))
    return dict(sd=sds, jax=jp)


def _export(pixel, path, **kw):
    kw = {"size": SIZE, "steps": STEPS, "batch_size": B, "platforms": ["cpu"], "dtype": "float32", **kw}
    return deploy.export_decompressor(pixel["sd"], pixel["mc"], path, **kw)


def _jax_sample(pixel, name, z, x_T, eta=0.0):
    net = JaxUNet(**CFG, fused_pallas=False)
    smp = jax_make_sampler(name, JaxSchedule.create(MC["timesteps"], MC["schedule"]), eta=eta)
    x = smp.sample(lambda p, x, zz, t: net.apply(p, x, zz, t), jnp.asarray(z), x_T.shape, steps=STEPS,
                   x_T=jnp.asarray(x_T), model_params={"params": pixel["params"]})
    return np.clip(np.asarray(x), -1, 1)


# ------------------------------------------------------------------ pixel


@pytest.mark.parametrize("sampler", ["ddim", "ddim_std", "dpmpp"])
def test_pixel_call_matches_jax_sampler(pixel, tmp_path, sampler):
    rng = np.random.default_rng(1)
    z = rng.standard_normal((B, 8)).astype(np.float32)
    x_T = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    call = deploy.load_decompressor(_export(pixel, tmp_path / "a.torchprog", sampler=sampler), device="cpu")
    out = call(pixel["sd"], z, x_T=x_T)
    assert out.shape == (B, SIZE, SIZE, 3) and out.dtype == torch.float32
    ref = _jax_sample(pixel, sampler, z, x_T)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_uint8_output_is_the_host_conversion(pixel, tmp_path):
    """``output="uint8"``: ``((clip(x) + 1) * 127.5)`` truncated, bit for bit
    with JAX's fp32 sampler wherever its value is more than 1e-4 from a
    level boundary (and within one level everywhere)."""
    rng = np.random.default_rng(2)
    z = rng.standard_normal((B, 8)).astype(np.float32)
    x_T = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    call = deploy.load_decompressor(_export(pixel, tmp_path / "u8.torchprog", output="uint8"), device="cpu")
    assert call.meta["output"] == "uint8"
    out = call(pixel["sd"], z, x_T=x_T).numpy()
    assert out.dtype == np.uint8
    ref = _jax_sample(pixel, "ddim", z, x_T)
    host = ((ref + 1.0) * 127.5).astype(np.uint8)
    level = (ref + 1.0) * 127.5
    clear = (np.abs(level - np.round(level)) > 1e-4 * 127.5) | (np.abs(ref) == 1.0)
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(out[clear], host[clear])
    assert np.abs(out.astype(int) - host.astype(int)).max() <= 1
    f32 = deploy.load_decompressor(_export(pixel, tmp_path / "f32.torchprog"), device="cpu")
    np.testing.assert_array_equal(out, ((f32(pixel["sd"], z, x_T=x_T).numpy() + 1.0) * 127.5).astype(np.uint8))


@pytest.mark.parametrize("eta", [0.0, 0.3])
def test_seeded_call_is_the_codecs_request(pixel, tmp_path, eta):
    """A seed reproduces the call, another seed does not, and the call is
    ``ClipCodec.decompress`` of the same rows at the artifact's batch and
    seed: the same initial noise and, at eta > 0, the same per-step draws."""
    from clip_codec_tpu_torch.io.bitstream import compress_frame

    rng = np.random.default_rng(3)
    scale = np.full(8, 2 / 255, np.float32)
    zero = np.full(8, -1.0, np.float32)
    codec = ClipCodec(scale, zero, pixel["sd"], pixel["mc"], device="cpu", dtype=torch.float32)
    blobs = [compress_frame(rng.integers(0, 256, 8, dtype=np.uint8).tobytes()) for _ in range(B)]
    call = deploy.load_decompressor(_export(pixel, tmp_path / "s.torchprog", eta=eta), device="cpu")
    a = call(pixel["sd"], codec.decode_embeddings(blobs), seed=9)
    np.testing.assert_array_equal(a.numpy(), call(pixel["sd"], codec.decode_embeddings(blobs), seed=9).numpy())
    assert not torch.equal(a, call(pixel["sd"], codec.decode_embeddings(blobs), seed=10))
    want = codec.decompress(blobs, size=SIZE, steps=STEPS, eta=eta, batch_size=B, seed=9)
    np.testing.assert_array_equal(a.numpy(), want)


def test_header_is_a_superset_of_jaxs(pixel, tmp_path):
    """The same export flags write JAX's header keys with JAX's values, plus
    the architecture, the dtype and the platforms."""
    flags = dict(size=SIZE, steps=2, sampler="dpmpp", batch_size=B, output="uint8")
    jpath = jdeploy.export_decompressor(pixel["params"], pixel["jmc"], tmp_path / "j.jaxprog", **flags)
    jmeta = jdeploy.read_artifact_meta(jpath)
    meta = deploy.read_artifact_meta(deploy.export_decompressor(pixel["sd"], pixel["mc"], tmp_path / "t.torchprog",
                                                                platforms=["cpu", "cuda"], **flags))
    assert set(jmeta) <= set(meta)
    assert {k: meta[k] for k in jmeta} == jmeta
    assert {k: meta[k] for k in ("base", "ch_mult", "time_dim", "timesteps", "schedule", "dtype", "platforms")} == dict(
        base=8, ch_mult=[1, 2], time_dim=256, timesteps=50, schedule="linear", dtype="bfloat16",
        platforms=["cpu", "cuda"])
    # each package's loader refuses the other's file with its own message
    with pytest.raises(ValueError, match="not a clip_codec_tpu_torch exported program"):
        deploy.load_decompressor(jpath, device="cpu")
    with pytest.raises(ValueError, match="not a clip_codec_tpu exported program"):
        jdeploy.load_decompressor(tmp_path / "t.torchprog")
    with pytest.raises(ValueError, match="not a clip_codec_tpu exported program"):
        jdeploy.read_artifact_meta(tmp_path / "t.torchprog")


def test_mismatches_and_foreign_files_raise(pixel, tmp_path):
    path = _export(pixel, tmp_path / "m.torchprog", steps=1)
    call = deploy.load_decompressor(path, device="cpu")
    with pytest.raises(ValueError, match="statics"):
        call(pixel["sd"], np.zeros((3, 8)))  # wrong batch
    with pytest.raises(ValueError, match="statics"):
        call(pixel["sd"], np.zeros((B, 9)))  # wrong dim
    with pytest.raises(ValueError, match="do not fit"):
        call({"nope": torch.zeros(1)}, np.zeros((B, 8)))
    with pytest.raises(TypeError, match="state dict"):
        call({"nope": 1.0}, np.zeros((B, 8)))
    with pytest.raises(ValueError, match="do not fit"):
        deploy.export_decompressor(pixel["sd"], ModelConfig(z_dim=16, base=8, ch_mult=(1, 2)), tmp_path / "x")
    with pytest.raises(ValueError, match="platforms"):
        deploy.load_decompressor(path, device="meta")
    with pytest.raises(ValueError, match="platforms must"):
        _export(pixel, tmp_path / "p.torchprog", platforms=["tpu"])
    with pytest.raises(ValueError, match="unknown sampler"):
        _export(pixel, tmp_path / "e.torchprog", sampler="euler")
    with pytest.raises(ValueError, match="deterministic"):
        _export(pixel, tmp_path / "e.torchprog", sampler="dpmpp", eta=0.5)
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="not a clip_codec_tpu_torch exported program"):
        deploy.load_decompressor(junk, device="cpu")
    bad = tmp_path / "bad.torchprog"
    bad.write_bytes(b"CLPTORCHPROG1\n{not json\n")
    with pytest.raises(ValueError, match="corrupt artifact header"):
        deploy.read_artifact_meta(bad)


def test_int8_and_sharded_are_refused(pixel, tmp_path):
    """int8 artifacts are served (static int8: the call takes the quant
    dict, and equals the eager sampler of the U-Net with those scales; a
    call without it raises naming the sidecar, a non-int8 artifact refuses
    one); a data-sharded or spatial file is refused by ``load_decompressor``
    with JAX's message, a file that is not sharded by the sharded loaders,
    and the tensor-parallel SD artifact refuses int8, naming it (the
    sharded artifacts themselves: tests/test_torch_parallel.py,
    tests/test_torch_tp.py, tests/test_torch_spatial.py)."""
    from clip_codec_tpu_torch.models import CLIPCondUNet
    from clip_codec_tpu_torch.ops import int8 as q8

    net = CLIPCondUNet(**CFG, time_dim=256, int8=True)
    net.load_state_dict(pixel["sd"], strict=True)
    quant = q8.calibrate_unet(net.eval(), SIZE, CFG["z_dim"], timesteps=MC["timesteps"], batch=B)
    with pytest.raises(ValueError, match="does not fit the architecture's int8 layers"):
        _export(pixel, tmp_path / "q.torchprog", quant={"q": torch.tensor(1.0)})
    call = deploy.load_decompressor(_export(pixel, tmp_path / "q.torchprog", quant=quant), device="cpu")
    assert call.meta["int8"] is True
    z = np.random.default_rng(1).standard_normal((B, CFG["z_dim"])).astype(np.float32)
    x_T = np.random.default_rng(2).standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    with pytest.raises(ValueError, match=r"int8 artifact: pass quant= .*<artifact>\.quant\.pt"):
        call(pixel["sd"], z)
    got = call(pixel["sd"], z, x_T=x_T, quant=quant)
    q8.load_quant(net, quant)
    want = deploy.make_decompress_fn(pixel["mc"], SIZE, STEPS)(net, torch.from_numpy(z), torch.from_numpy(x_T))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="not one"):
        deploy.load_decompressor(_export(pixel, tmp_path / "f.torchprog"), device="cpu")(pixel["sd"], z, quant=quant)
    meta = deploy.read_artifact_meta(tmp_path / "f.torchprog")
    forged = tmp_path / "sharded.torchprog"
    forged.write_bytes(b"CLPTORCHPROG1\n" + json.dumps({**meta, "sharded": True}).encode() + b"\n")
    with pytest.raises(ValueError, match="use load_sharded_decompressor"):
        deploy.load_decompressor(forged, device="cpu")
    spatial = tmp_path / "spatial.torchprog"
    spatial.write_bytes(b"CLPTORCHPROG1\n" + json.dumps({**meta, "sharded": True, "spatial": True}).encode() + b"\n")
    with pytest.raises(ValueError, match="use load_sharded_decompressor"):
        deploy.load_decompressor(spatial, device="cpu")
    with pytest.raises(ValueError, match="not a sharded artifact — use load_decompressor"):
        deploy.load_sharded_decompressor(tmp_path / "f.torchprog", None)
    sd_file = tmp_path / "sd.torchprog"
    sd_file.write_bytes(b"CLPTORCHPROG1\n" + json.dumps({**meta, "kind": "sd"}).encode() + b"\n")
    with pytest.raises(ValueError, match="not a sharded artifact — use load_sd_decompressor"):
        deploy.load_sharded_sd_decompressor(sd_file, None)
    with pytest.raises(ValueError, match="tensor parallelism takes no int8"):
        deploy.export_sharded_sd_decompressor({}, {}, {}, tmp_path / "tp.torchprog", None, quant=quant)


def test_schedule_host_tables_keep_the_samplers_bit_equal():
    """The samplers read the schedule's host copies: the same bits as the
    device tables copied back (what they read before), and the same
    sampled images."""
    sched = NoiseSchedule.create(50, "cosine")
    copied = NoiseSchedule(**{k: getattr(sched, k) for k in sched.host},
                           host={k: getattr(sched, k).cpu().numpy() for k in sched.host})
    for k in sched.host:
        np.testing.assert_array_equal(sched.numpy(k), copied.numpy(k))
    gen = torch.Generator().manual_seed(0)
    z, x_T = torch.randn(2, 4, generator=gen), torch.randn(2, 4, 4, 3, generator=gen)
    fn = lambda x, z, t: torch.tanh(x + z.mean() + t[:, None, None, None] * 1e-3)
    for name in ("ddim", "ddim_std", "dpmpp"):
        a = make_sampler(name, sched).sample(fn, z, x_T.shape, steps=7, x_T=x_T)
        b = make_sampler(name, copied).sample(fn, z, x_T.shape, steps=7, x_T=x_T)
        assert torch.equal(a, b), name


def test_export_cli_writes_a_loadable_artifact(pixel, tmp_path):
    from clip_codec_tpu_torch.cli.export_decoder import main

    ckpt = tmp_path / "ckpt" / "unet.pt"
    ckpt.parent.mkdir()
    torch.save(pixel["sd"], ckpt)
    pixel["mc"].save(ckpt.parent)
    out = tmp_path / "dec.torchprog"
    main(["--weights", str(ckpt), "--out", str(out), "--size", "16", "--steps", "2", "--batch_size", "1",
          "--device", "cpu", "--output", "uint8"])
    call = deploy.load_decompressor(out, device="cpu")
    assert {k: call.meta[k] for k in ("size", "steps", "batch_size", "z_dim", "output", "platforms", "timesteps")} == \
        dict(size=16, steps=2, batch_size=1, z_dim=8, output="uint8", platforms=["cpu"], timesteps=50)
    img = call(pixel["sd"], np.ones((1, 8), np.float32), seed=1)
    assert img.shape == (1, 16, 16, 3) and img.dtype == torch.uint8
    # --int8: the static-int8 artifact, calibrated here, its sidecar beside it
    main(["--weights", str(ckpt), "--out", str(tmp_path / "q.torchprog"), "--size", "16", "--steps", "2",
          "--batch_size", "1", "--device", "cpu", "--int8"])
    from clip_codec_tpu_torch.ops import int8 as q8

    quant = q8.read_quant(tmp_path / "q.torchprog.quant.pt")
    call = deploy.load_decompressor(tmp_path / "q.torchprog", device="cpu")
    assert call.meta["int8"] is True and len(quant) == 22 and all(v.item() > 0 for v in quant.values())
    img = call(pixel["sd"], np.ones((1, 8), np.float32), seed=1, quant=quant)
    assert img.shape == (1, 16, 16, 3) and bool(torch.isfinite(img).all())
    # without model_config.json the architecture comes from the weights; defaults as JAX's
    (ckpt.parent / "model_config.json").unlink()
    main(["--weights", str(ckpt), "--out", str(out), "--device", "cpu", "--platforms", "cpu,cuda"])
    meta = deploy.read_artifact_meta(out)
    assert (meta["size"], meta["steps"], meta["batch_size"], meta["base"], meta["ch_mult"], meta["platforms"]) == \
        (256, 50, 16, 8, [1, 2], ["cpu", "cuda"])


# --------------------------------------------------------------------- SD


def _sd_export(sd_weights, path, **kw):
    kw = {"unet_cfg": tsd.SDUNetConfig(**UCFG), "vae_cfg": tsd.VAEConfig(**VCFG), "size": SIZE, "steps": STEPS,
          "batch_size": B, "platforms": ["cpu"], "dtype": "float32", **kw}
    return deploy.export_sd_decompressor(*sd_weights["sd"], path, **kw)


def test_sd_call_matches_jax_at_two_guidances(sd_weights, tmp_path):
    from clip_codec_tpu.models.sd.decoder import SD_SCALING_FACTOR, _cfg_ddim_sample

    call = deploy.load_sd_decompressor(_sd_export(sd_weights, tmp_path / "sd.torchprog"), device="cpu")
    assert (call.meta["z_dim"], call.meta["n_tokens"], call.meta["cfg_batched"]) == (CLIP_DIM, 2, True)
    z = np.random.default_rng(4).standard_normal((B, CLIP_DIM)).astype(np.float32)
    shape, key = (B, 8, 8, 4), jax.random.PRNGKey(5)
    x_T = np.array(jax.random.normal(jax.random.split(key)[1], shape, jnp.float32))
    unet = jsd.SDUNet(jsd.SDUNetConfig(**UCFG))
    vae = jsd.AutoencoderKL(jsd.VAEConfig(**VCFG))
    adapter = jsd.SDClipAdapter(in_dim=CLIP_DIM, ctx_dim=16, n_tokens=2)
    up, vp, ap = sd_weights["jax"]
    for g in (4.0, 0.0):
        ref = np.clip(np.asarray(_cfg_ddim_sample(
            unet, vae, adapter, {"params": up}, vp, ap, jnp.asarray(z), jnp.asarray(z), key, jnp.float32(g),
            embed_fn=None, shape=shape, steps=STEPS, eta=0.0, inv_weight=0.0, inv_every=1, decode_pixels=True,
            scaling=SD_SCALING_FACTOR, cfg_batched=True, sampler="ddim")), -1, 1)
        out = call(*sd_weights["sd"], z, guidance_scale=g, x_T=x_T).numpy()
        assert out.shape == (B, SIZE, SIZE, 3)
        assert np.abs(out - ref).max() / np.abs(ref).max() <= 1e-4, g


def test_sd_header_and_cli(sd_weights, tmp_path, monkeypatch):
    """The SD header holds JAX's keys with JAX's values for the same flags;
    the CLI reads the weights from the variables and the adapter geometry
    from its weights; a seed reproduces; guidance changes the image."""
    from clip_codec_tpu_torch.cli.export_decoder import main

    ucfg, vcfg = jsd.SDUNetConfig(**UCFG), jsd.VAEConfig(**VCFG)
    jpath = jdeploy.export_sd_decompressor(*sd_weights["jax"], tmp_path / "sd.jaxprog", unet_cfg=ucfg,
                                           vae_cfg=vcfg, size=SIZE, steps=2, batch_size=1)
    jmeta = jdeploy.read_artifact_meta(jpath)
    for name, state in zip(("unet", "vae", "adapter"), sd_weights["sd"]):
        torch.save({"adapter": state} if name == "adapter" else state, tmp_path / f"{name}.pt")
    argv = ["--sd", "--adapter", str(tmp_path / "adapter.pt"), "--out", str(tmp_path / "sd.torchprog"),
            "--size", "16", "--steps", "2", "--heads", "2", "--device", "cpu"]
    monkeypatch.delenv("CLIP_CODEC_SD_UNET_WEIGHTS", raising=False)
    with pytest.raises(RuntimeError, match="CLIP_CODEC_SD_UNET_WEIGHTS"):
        main(argv)
    monkeypatch.setenv("CLIP_CODEC_SD_UNET_WEIGHTS", str(tmp_path / "unet.pt"))
    monkeypatch.setenv("CLIP_CODEC_SD_VAE_WEIGHTS", str(tmp_path / "vae.pt"))
    with pytest.raises(SystemExit, match="--adapter"):
        main(argv[:1] + argv[3:])
    main(argv)
    meta = deploy.read_artifact_meta(tmp_path / "sd.torchprog")
    assert set(jmeta) <= set(meta) and {k: meta[k] for k in jmeta} == jmeta
    assert meta["unet"]["heads"] == 2 and meta["adapter_hidden"] == 1024 and meta["dtype"] == "bfloat16"
    call = deploy.load_sd_decompressor(tmp_path / "sd.torchprog", device="cpu")
    with pytest.raises(ValueError, match="'sd' artifact"):
        deploy.load_decompressor(tmp_path / "sd.torchprog", device="cpu")
    z = np.random.default_rng(6).standard_normal((1, CLIP_DIM)).astype(np.float32)  # LayerNorm maps a constant z to 0
    a = call(*sd_weights["sd"], z, seed=4)
    assert a.shape == (1, 16, 16, 3) and bool(torch.isfinite(a).all())
    assert torch.equal(a, call(*sd_weights["sd"], z, seed=4))
    assert not torch.equal(a, call(*sd_weights["sd"], z, seed=4, guidance_scale=0.0))
    # --int8: the UNet calibrated on both CFG branches, the sidecar beside the artifact
    from clip_codec_tpu_torch.ops import int8 as q8

    main(argv[:4] + [str(tmp_path / "sdq.torchprog")] + argv[5:] + ["--int8"])
    call = deploy.load_sd_decompressor(tmp_path / "sdq.torchprog", device="cpu")
    quant = q8.read_quant(tmp_path / "sdq.torchprog.quant.pt")
    assert call.meta["int8"] is True and set(quant) == set(q8.int8_layer_names(tsd.SDUNet(tsd.SDUNetConfig(**UCFG))))
    with pytest.raises(ValueError, match="pass quant="):
        call(*sd_weights["sd"], z, seed=4)
    b = call(*sd_weights["sd"], z, seed=4, quant=quant)
    assert b.shape == (1, 16, 16, 3) and bool(torch.isfinite(b).all()) and not torch.equal(a, b)


def test_cfg_combine_tensor_form_equals_the_float_form(sd_weights):
    gen = torch.Generator().manual_seed(0)
    eu, ec = torch.randn(2, 8, 8, 4, generator=gen), torch.randn(2, 8, 8, 4, generator=gen)
    for g in (5.0, 7.3, 0.0, 1 / 3):
        assert torch.equal(cfg_combine(eu, ec, g), cfg_combine(eu, ec, torch.tensor(np.float32(g))))
    mods = [tsd.SDUNet(tsd.SDUNetConfig(**UCFG)), tsd.AutoencoderKL(tsd.VAEConfig(**VCFG)),
            tsd.SDClipAdapter(in_dim=CLIP_DIM, ctx_dim=16, n_tokens=2)]
    for m, state in zip(mods, sd_weights["sd"]):
        m.load_state_dict(state)
    dec = tsd.StableDiffusionDecoder(*mods)
    z = torch.randn(1, CLIP_DIM, generator=gen)
    x_T = torch.randn(1, 8, 8, 4, generator=gen)
    for batched in (True, False):
        a = dec.sample(z, (1, 8, 8, 4), steps=2, guidance_scale=7.3, x_T=x_T, cfg_batched=batched,
                       decode_pixels=False)
        b = dec.sample(z, (1, 8, 8, 4), steps=2, guidance_scale=torch.tensor(np.float32(7.3)), x_T=x_T,
                       cfg_batched=batched, decode_pixels=False)
        assert torch.equal(a, b)
