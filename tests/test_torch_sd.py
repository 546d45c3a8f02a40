"""The port's SD-1.5 latent path (clip_codec_tpu_torch/models/sd, the SD CLI and
the SD weight maps) against the JAX package.

Tiny configs as tests/test_sd.py, with 32x32 latents so that the UNet's
first stage (N = 1024) and the VAE's mid-block take the flash-attention
branch (its plain version on the CPU). The port's modules get seeded
weights, moved off their init so that every norm and bias is exercised,
and the JAX package's converters (``convert_sd_*``) carry them across. fp32 throughout: UNet eps, VAE decode and the
adapter within 1e-4 relative to the output's largest magnitude; sampling
with the JAX initial noise injected within 1e-4; scheduler tables
bit-equal; the weight round trip exact.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_codec_tpu.models import sd as jsd
from clip_codec_tpu.weights.convert_sd import convert_sd_adapter, convert_sd_unet, convert_sd_vae
from clip_codec_tpu_torch.models import init_params
from clip_codec_tpu_torch.models import sd as tsd
from clip_codec_tpu_torch.models.sd.decoder import sd_step_coefficients
from clip_codec_tpu_torch.weights import sd_checkpoint as ckpt
from clip_codec_tpu_torch.weights.from_jax import (
    sd_adapter_state_dict_from_jax,
    sd_unet_state_dict_from_jax,
    sd_vae_state_dict_from_jax,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
UCFG = dict(block_out=(8, 16), layers_per_block=1, cross_dim=16, heads=2, freq_dim=8)
VCFG = dict(block_out=(8, 16), layers_per_block=1, latent_ch=4)
CLIP_DIM = 32


def _seeded(module, seed):
    """Flax-like fresh parameters, then every one (norms and biases too)
    moved by 0.05 N(0, 1), all drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    init_params(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return module.eval()


@pytest.fixture(scope="module")
def port():
    """The port's modules, and the JAX params made from them by the JAX
    package's own converters."""
    unet = _seeded(tsd.SDUNet(tsd.SDUNetConfig(**UCFG)), 10)
    vae = _seeded(tsd.AutoencoderKL(tsd.VAEConfig(**VCFG)), 11)
    adapter = _seeded(tsd.SDClipAdapter(in_dim=CLIP_DIM, ctx_dim=16, n_tokens=8), 12)
    sds = {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
           for name, m in (("unet", unet), ("vae", vae), ("adapter", adapter))}
    jp = dict(unet=convert_sd_unet(sds["unet"], n_blocks=2, layers_per_block=1),
              vae=convert_sd_vae(sds["vae"], n_blocks=2, enc_layers=1),
              adapter=convert_sd_adapter({"adapter": sds["adapter"]}))
    return dict(unet=unet, vae=vae, adapter=adapter, sd=sds, jax=jp)


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


# ------------------------------------------------------------------ weights


def _assert_trees_equal(a, b):
    fa, ta = jax.tree_util.tree_flatten_with_path(a)
    fb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert ta == tb
    for (path, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=jax.tree_util.keystr(path))


def test_weight_maps_invert_the_jax_converters(port):
    """convert_sd_* and sd_*_state_dict_from_jax are exact inverses, both
    ways, and the port's state dicts carry the config that made them."""
    for name, back in (("unet", sd_unet_state_dict_from_jax), ("vae", sd_vae_state_dict_from_jax),
                       ("adapter", sd_adapter_state_dict_from_jax)):
        sd = back(port["jax"][name])
        assert sd.keys() == port["sd"][name].keys(), name
        for k, v in port["sd"][name].items():
            assert sd[k].dtype == torch.float32 and torch.equal(sd[k], v), k
    _assert_trees_equal(convert_sd_unet(sd_unet_state_dict_from_jax(port["jax"]["unet"]), 2, 1),
                        port["jax"]["unet"])
    _assert_trees_equal(convert_sd_vae(sd_vae_state_dict_from_jax(port["jax"]["vae"]), 2, 1),
                        port["jax"]["vae"])
    _assert_trees_equal(convert_sd_adapter(sd_adapter_state_dict_from_jax(port["jax"]["adapter"])),
                        port["jax"]["adapter"])
    assert ckpt.unet_config(port["sd"]["unet"], heads=2) == tsd.SDUNetConfig(**UCFG)
    assert ckpt.vae_config(port["sd"]["vae"]) == tsd.VAEConfig(**VCFG)
    assert ckpt.adapter_dims(port["sd"]["adapter"]) == (CLIP_DIM, 1024)


def test_checkpoint_reader_accepts_legacy_and_wrapped_layouts(port):
    """Legacy VAE attention names with 1x1-conv weights, and a
    ``{'state_dict': {'module.' ...}}`` container, load as the new layout."""
    vsd = port["sd"]["vae"]
    legacy = {}
    for k, v in vsd.items():
        for old, new in (("group_norm", "norm"), ("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                         ("to_out.0", "proj_attn")):
            if ".mid_block.attentions.0." in k and f".{old}." in k:
                k = k.replace(f".{old}.", f".{new}.")
                v = v[:, :, None, None] if v.dim() == 2 else v
                break
        legacy["module." + k] = v
    assert legacy.keys() != {"module." + k for k in vsd}
    got = ckpt.vae_state_dict({"state_dict": legacy})
    assert got.keys() == vsd.keys()
    for k in vsd:
        assert torch.equal(got[k], vsd[k]), k


# ------------------------------------------------------------------ modules


def test_unet_eps_matches_jax(rng, port):
    lat = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    t = np.array([981, 41], np.int32)
    ctx = rng.standard_normal((2, 8, 16)).astype(np.float32)
    net = jsd.SDUNet(jsd.SDUNetConfig(**UCFG))
    ej = jax.jit(net.apply)({"params": port["jax"]["unet"]}, jnp.asarray(lat), jnp.asarray(t),
                            jnp.asarray(ctx))
    with torch.no_grad():
        et = port["unet"](torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx))
    _close(et.numpy(), ej)


def test_vae_decode_and_encode_match_jax(rng, port):
    """Decode from 32x32 latents (the mid-block attention at N = 1024 takes
    the flash branch) and encode moments from 32x32 images."""
    z = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    vae = jsd.AutoencoderKL(jsd.VAEConfig(**VCFG))
    run = jax.jit(lambda p, a, method: vae.apply({"params": p}, a, method=method), static_argnums=2)
    yj = run(port["jax"]["vae"], jnp.asarray(z), jsd.AutoencoderKL.decode)
    mj = run(port["jax"]["vae"], jnp.asarray(x), jsd.AutoencoderKL.encode_moments)
    with torch.no_grad():
        yt = port["vae"].decode(torch.from_numpy(z))
        mt = port["vae"].encode_moments(torch.from_numpy(x))
    assert yt.shape == (1, 64, 64, 3) and mt.shape == (1, 16, 16, 8)
    _close(yt.numpy(), yj)
    _close(mt.numpy(), mj)
    noise = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    lat = tsd.AutoencoderKL.sample_latents(mt, noise=torch.from_numpy(noise))
    mean, logvar = np.split(np.asarray(mj), 2, axis=-1)
    _close(lat.numpy(), mean + np.exp(0.5 * np.clip(logvar, -30, 20)) * noise)


def test_adapter_matches_jax(rng, port):
    z = rng.standard_normal((3, CLIP_DIM)).astype(np.float32)
    cj = jsd.SDClipAdapter(in_dim=CLIP_DIM, ctx_dim=16, n_tokens=8).apply(
        {"params": port["jax"]["adapter"]}, jnp.asarray(z))
    with torch.no_grad():
        ct = port["adapter"](torch.from_numpy(z))
    assert ct.shape == (3, 8, 16)
    _close(ct.numpy(), cj)


def test_timestep_embedding_matches_jax():
    t = np.array([1, 41, 501, 981], np.int32)
    ej = np.asarray(jsd.unet.sd_timestep_embedding(jnp.asarray(t), 320))
    et = tsd.sd_timestep_embedding(torch.from_numpy(t), 320).numpy()
    # one fp32 bit of a frequency moves cos(t f) by <= 2.5e-7 t (see test_torch_unet)
    assert np.all(np.abs(et - ej) <= 1e-6 + 2.5e-7 * t[:, None])


# ---------------------------------------------------------------- scheduler


@pytest.mark.parametrize("steps", [1, 10, 30, 50, 7])
def test_scheduler_tables_bit_equal(steps):
    np.testing.assert_array_equal(tsd.sd_alphas_cumprod(1000), jsd.sd_alphas_cumprod(1000))
    np.testing.assert_array_equal(tsd.sd_ddim_timesteps(steps), jsd.sd_ddim_timesteps(steps))
    a, b = tsd.SDSchedulerTables.create(1000), jsd.SDSchedulerTables.create(1000)
    np.testing.assert_array_equal(a.alphas_cumprod, b.alphas_cumprod)
    assert a.final_alpha_cumprod == b.final_alpha_cumprod
    ts, co = sd_step_coefficients(steps, 1000, "dpmpp")
    assert ts.dtype == np.int64 and all(v.dtype == np.float32 and v.shape == (steps,) for v in co.values())
    assert co["c_skip"][-1] == 0 and co["c1"][0] == 0 and co["c1"][-1] == 0


# ----------------------------------------------------------------- sampling


def _decoders(port):
    jp = port["jax"]
    jdec = jsd.StableDiffusionDecoder(
        jp["vae"], jp["unet"], adapter_params=jp["adapter"], clip_dim=CLIP_DIM, n_tokens=8,
        unet_cfg=jsd.SDUNetConfig(**UCFG), vae_cfg=jsd.VAEConfig(**VCFG), dtype=jnp.float32)
    return jdec, tsd.StableDiffusionDecoder(port["unet"], port["vae"], port["adapter"])


@pytest.mark.parametrize("sampler,cfg_batched", [("ddim", True), ("ddim", False), ("dpmpp", True),
                                                 ("dpmpp", False)])
def test_sample_matches_jax_with_injected_noise(rng, port, sampler, cfg_batched):
    """Three CFG steps over 8x8 latents, the JAX initial noise handed to the
    port; the latents, then the decoded images."""
    jdec, tdec = _decoders(port)
    z = rng.standard_normal((2, CLIP_DIM)).astype(np.float32)
    shape, key = (2, 8, 8, 4), jax.random.PRNGKey(5)
    kw = dict(steps=3, guidance_scale=2.5, cfg_batched=cfg_batched, sampler=sampler)
    lj = jdec.sample(jnp.asarray(z), shape, rng=key, decode_pixels=False, **kw)
    x_T = np.array(jax.random.normal(jax.random.split(key)[1], shape, jnp.float32))
    lt = tdec.sample(torch.from_numpy(z), shape, x_T=torch.from_numpy(x_T), decode_pixels=False, **kw)
    assert lt.dtype == torch.float32
    _close(lt.numpy(), lj)
    _close(tdec.decode(lt).numpy(), jdec.decode(lj))


def test_sample_draws_from_the_generator_and_checks_its_arguments(port):
    _, tdec = _decoders(port)
    z = torch.zeros((1, CLIP_DIM))
    lat, t = torch.randn((1, 8, 8, 4), generator=torch.Generator().manual_seed(0)), torch.tensor([501])
    with torch.no_grad():
        assert torch.equal(tdec.forward(lat, z, t), port["unet"](lat, t, port["adapter"](z)))
    run = lambda seed: tdec.sample(z, (1, 8, 8, 4), steps=2, sampler="dpmpp", decode_pixels=False,
                                   generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    with pytest.raises(ValueError, match="deterministic"):
        tdec.sample(z, (1, 8, 8, 4), steps=2, eta=0.5, sampler="dpmpp")
    with pytest.raises(ValueError, match="unknown sampler"):
        tdec.sample(z, (1, 8, 8, 4), steps=2, sampler="euler")


# ---------------------------------------------------------------------- CLI


def test_cli_writes_a_png_from_a_pt_store(tmp_path, port, monkeypatch):
    from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as cli
    from clip_codec_tpu_torch.io.bitstream import write_bitstream

    rng = np.random.default_rng(3)
    scale = np.full(CLIP_DIM, 1 / 127.5, np.float32)
    zero = np.full(CLIP_DIM, -1.0, np.float32)
    np.savez(tmp_path / "codec_meta.npz", scale=scale, zero=zero)
    write_bitstream(rng.integers(0, 256, CLIP_DIM, dtype=np.uint8).tobytes(), CLIP_DIM, tmp_path / "img.clp")
    torch.save(port["sd"]["unet"], tmp_path / "unet.bin")
    torch.save(port["sd"]["vae"], tmp_path / "vae.bin")
    torch.save({"adapter": port["sd"]["adapter"]}, tmp_path / "adapter.pt")
    argv = ["--store_dir", str(tmp_path), "--bitstream", str(tmp_path / "img.clp"), "--adapter",
            str(tmp_path / "adapter.pt"), "--steps", "2", "--sampler", "dpmpp", "--size", "16",
            "--heads", "2", "--device", "cpu"]
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        cli.main(argv)  # the JAX CLI's default --inv_weight 1.0 asks for inversion
    with pytest.raises(RuntimeError, match="CLIP_CODEC_SD_UNET_WEIGHTS"):
        cli.main(argv + ["--inv_weight", "0"])
    monkeypatch.setenv("CLIP_CODEC_SD_UNET_WEIGHTS", str(tmp_path / "unet.bin"))
    monkeypatch.setenv("CLIP_CODEC_SD_VAE_WEIGHTS", str(tmp_path / "vae.bin"))
    cli.main(argv + ["--inv_weight", "0"])
    img = Image.open(tmp_path / "img-2-5-0.png")
    assert img.size == (16, 16) and img.mode == "RGB"
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        cli.main(argv + ["--inv_weight", "0", "--int8"])


def test_sd_modules_import_no_jax(tmp_path, port):
    """The SD path loads and runs a tiny decoder in a process with no jax."""
    for name, sd in port["sd"].items():
        torch.save(sd, tmp_path / f"{name}.pt")
    code = (
        "import sys, torch\n"
        "import clip_codec_tpu_torch.models.sd, clip_codec_tpu_torch.cli.reconstruct_sd_diffusion as cli\n"
        "import clip_codec_tpu_torch.ops.attention, clip_codec_tpu_torch.ops.mlp\n"
        f"d = cli.load_decoder(*[{str(tmp_path)!r} + f'/{{n}}.pt' for n in ('unet', 'vae', 'adapter')], 'cpu', heads=2)\n"
        "img = cli.sample_images(d, torch.zeros((1, 32)).numpy(), 16, steps=1)\n"
        "assert img.shape == (1, 16, 16, 3) and bool(torch.isfinite(img.float()).all())\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'clip_codec_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax', 'optax', 'clip_codec_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
