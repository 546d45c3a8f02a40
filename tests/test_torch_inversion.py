"""The port's feature-inversion guidance (``StableDiffusionDecoder.sample_with_inversion``
and the SD CLI's inversion branch) against the JAX package, on the CPU.

The tiny SD decoder of tests/test_torch_sd.py (its weights carried to JAX
by the JAX package's converters), 32x32 latents so that the UNet's first
stage and the VAE's mid-block take flash attention (its plain forward and
backward on the CPU), fp32, the JAX initial noise injected. Three embedding
functions, each given to both packages: JAX's toy pooled embed
(tests/test_sd_train.py), a tiny CLIP tower read by both packages'
``ClipEncoder`` from one HuggingFace-layout file, behind the JAX CLI's
preprocessing (clip, bilinear 224, mean/std), and the tiny DINOv2 tower of
tests/test_torch_dino.py behind the JAX CLI's DINO preprocessing (clip,
bilinear to its 28, ImageNet mean/std). Latents within 1e-4 of their
largest magnitude; the guidance must move them well past that. The latent
gradient's clip ties (exact +-1.0 in the decoded image) are split as
``jnp.clip`` splits them, pinned against ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import clip_codec_tpu.encoders as jax_encoders
import clip_codec_tpu_torch.encoders as encoders
from clip_codec_tpu.encoders import dino as jdino
from clip_codec_tpu.encoders.clip import CLIP_MEAN, CLIP_STD
from clip_codec_tpu.encoders.clip import CLIPConfig as JaxConfig
from clip_codec_tpu.encoders.clip import CLIPModel as JaxCLIPModel
from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as cli
from clip_codec_tpu_torch.encoders.clip import CLIPConfig
from clip_codec_tpu_torch.encoders.dino import DinoConfig
from clip_codec_tpu_torch.models import sd as tsd
from clip_codec_tpu_torch.models.sd.decoder import inversion_loss
from clip_codec_tpu_torch.ops import int8 as q8
from tests.test_torch_clip import TINY, random_clip_sd
from tests.test_torch_compress import hf_layout
from tests.test_torch_dino import TINY as DINO_TINY
from tests.test_torch_dino import port_dino, random_hf_dino
from tests.test_torch_sd import CLIP_DIM, _close, _decoders, _seeded, port  # noqa: F401  (port: a fixture)

torch.set_num_threads(1)

# The CLIP tower at the JAX CLI's fixed 224 input: 7x7 patches of 32.
TOWER = dict(TINY, image_size=224, patch_size=32, embed_dim=CLIP_DIM)


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """The tiny tower read by the JAX and by the port's ClipEncoder from one
    HuggingFace-layout file, fp32."""
    p = tmp_path_factory.mktemp("clip") / "tower_hf.bin"
    torch.save(hf_layout(random_clip_sd(TOWER, 4)), p)
    jenc = jax_encoders.ClipEncoder(weights_path=str(p), cfg=JaxConfig(**TOWER), dtype=jnp.float32)
    tenc = encoders.ClipEncoder(weights_path=str(p), cfg=CLIPConfig(**TOWER), dtype=torch.float32, device="cpu")
    return jenc, tenc


def jax_clip_embed(enc):
    """The JAX CLI's CLIP embed_fn (clip_codec_tpu/cli/reconstruct_sd_diffusion.py)."""
    def embed_fn(x_m11):
        x = (jnp.clip(x_m11, -1, 1) + 1.0) / 2.0
        B = x.shape[0]
        x = jax.image.resize(x, (B, 224, 224, 3), method="bilinear", antialias=False)
        x = (x - jnp.asarray(CLIP_MEAN)) / jnp.asarray(CLIP_STD)
        return enc.model.apply(enc.params, x, method=JaxCLIPModel.encode_image).astype(jnp.float32)

    return embed_fn


@pytest.fixture(scope="module")
def dino_towers():
    """The tiny DINOv2 (embed dim 32) as JAX params and as the port's module."""
    from clip_codec_tpu_torch.weights.convert_dino import dino_state_dict_from_hf

    hf = random_hf_dino(DINO_TINY, 4)
    jp = {"params": jdino.convert_dino_hf({k: v.numpy() for k, v in hf.items()}, depth=DINO_TINY["depth"])}
    return jp, port_dino(dino_state_dict_from_hf(hf))


def jax_dino_embed(params):
    """The JAX CLI's DINO embed_fn (clip_codec_tpu/cli/reconstruct_sd_diffusion.py)."""
    model, size = jdino.DinoV2(jdino.DinoConfig(**DINO_TINY)), DINO_TINY["image_size"]

    def embed_fn(x_m11):
        x = (jnp.clip(x_m11, -1, 1) + 1.0) / 2.0
        B = x.shape[0]
        x = jax.image.resize(x, (B, size, size, 3), method="bilinear", antialias=False)
        x = (x - jnp.asarray(jdino.IMAGENET_MEAN)) / jnp.asarray(jdino.IMAGENET_STD)
        return model.apply(params, x).astype(jnp.float32)

    return embed_fn


def jax_toy_embed(x_m11):  # tests/test_sd_train.py's cheap differentiable encoder
    pooled = jnp.mean(x_m11, axis=(1, 2))
    return jnp.tile(pooled, (1, 11))[:, :32]


def toy_embed(x_m11):
    return x_m11.mean(dim=(1, 2)).tile(1, 11)[:, :32]


def _embeds(kind, towers):
    if kind == "toy":
        return jax_toy_embed, toy_embed
    jenc, tenc = towers
    return jax_clip_embed(jenc), cli.clip_embed_fn(tenc.model)


@pytest.mark.parametrize("cfg_batched", [True, False], ids=["cfg_batched", "cfg_sequential"])
@pytest.mark.parametrize("inv_every", [1, 2])
@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
@pytest.mark.parametrize("embed", ["toy", "clip"])
def test_sample_with_inversion_matches_jax(rng, port, towers, embed, sampler, inv_every, cfg_batched):
    """Three guided CFG steps over (2, 32, 32, 4) latents; the target is a
    second embedding, so the loss is not at its minimum."""
    _check_guided_sampling(rng, port, _embeds(embed, towers), sampler, inv_every, cfg_batched)


def test_sample_with_inversion_through_dino_matches_jax(rng, port, dino_towers):
    """The same through the tiny DINOv2 tower and the CLI's ``dino_embed_fn``
    (the 64px decode resized down to 28), at the CLI's default sampler, two
    guided steps."""
    jp, model = dino_towers
    _check_guided_sampling(rng, port, (jax_dino_embed(jp), cli.dino_embed_fn(model)), "ddim", 1, True, steps=2)


def _check_guided_sampling(rng, port, embeds, sampler, inv_every, cfg_batched, steps=3):
    jdec, tdec = _decoders(port)
    jembed, tembed = embeds
    z = rng.standard_normal((2, CLIP_DIM)).astype(np.float32)
    z_tgt = rng.standard_normal((2, CLIP_DIM)).astype(np.float32)
    shape, key = (2, 32, 32, 4), jax.random.PRNGKey(11)
    kw = dict(steps=steps, guidance_scale=2.5, inv_weight=3.0, inv_every=inv_every, cfg_batched=cfg_batched,
              sampler=sampler)
    lj = np.asarray(jdec.sample_with_inversion(jnp.asarray(z), jnp.asarray(z_tgt), jembed, shape, rng=key,
                                               decode_pixels=False, **kw))
    x_T = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[1], shape, jnp.float32)))
    lt = tdec.sample_with_inversion(torch.from_numpy(z), torch.from_numpy(z_tgt), tembed, shape, x_T=x_T,
                                    decode_pixels=False, **kw)
    assert lt.dtype == torch.float32 and not lt.requires_grad
    _close(lt.numpy(), lj)
    plain = tdec.sample(torch.from_numpy(z), shape, x_T=x_T, decode_pixels=False,
                        **{k: kw[k] for k in ("steps", "guidance_scale", "cfg_batched", "sampler")})
    moved = np.abs(lt.numpy() - plain.numpy()).max() / np.abs(lj).max()
    assert moved > 1e-2, moved  # the guidance moves the latents 100x past the tolerance
    assert all(not p.requires_grad for m in (tdec.unet, tdec.vae) for p in m.parameters())


@pytest.mark.parametrize("embed,tie_factor", [("toy", 0.5), ("clip", 0.25)])
def test_clip_ties_split_the_gradient_as_jax(rng, towers, embed, tie_factor):
    """A decoded image in [-1, 1] with a third of its values exactly +-1.0
    (a bf16 VAE output rounds to them often): the loss's gradient in the
    image equals jax.grad of JAX's, and at the ties it is ``tie_factor``
    of the unclipped loss's (0.5 through the loss's clip, 0.25 when the CLI's
    embed clips again; ``torch.clamp`` would pass 1)."""
    jembed, tembed = _embeds(embed, towers)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    tie = rng.random(x.shape) < 1 / 3
    x[tie] = np.sign(x[tie])
    z_tgt = rng.standard_normal((2, CLIP_DIM)).astype(np.float32)
    z_tgt /= np.linalg.norm(z_tgt, axis=-1, keepdims=True)

    def jax_loss(img):  # feat_loss after the decode (clip_codec_tpu/models/sd/decoder.py)
        y = jembed(jnp.clip(img, -1.0, 1.0))
        y = y / (jnp.linalg.norm(y, axis=-1, keepdims=True) + 1e-9)
        return 1.0 - jnp.mean(jnp.sum(y * z_tgt, axis=-1))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(x)))
    img = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(inversion_loss(img, tembed, torch.from_numpy(z_tgt)), img)
    _close(got.numpy(), want)

    def unclipped(t):  # the same forward values: every entry is already in [-1, 1]
        if embed == "toy":
            return toy_embed(t)
        m = cli.clip_embed_fn(towers[1].model)
        saved, cli.clip_m11 = cli.clip_m11, lambda v: v
        try:
            return m(t)
        finally:
            cli.clip_m11 = saved

    img2 = torch.from_numpy(x).requires_grad_(True)
    y = unclipped(img2)
    y = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + 1e-9)
    (free,) = torch.autograd.grad(1.0 - (y * torch.from_numpy(z_tgt)).sum(-1).mean(), img2)
    t = torch.from_numpy(tie)
    torch.testing.assert_close(got[t], tie_factor * free[t], rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(got[~t], free[~t], rtol=1e-5, atol=1e-9)
    assert float(free[t].abs().max()) > 0


# ---------------------------------------------------------------------- CLI


def _store(tmp_path, port, dim):
    """A .pt store of one frame at ``dim``, the tiny SD weights and an adapter for ``dim``."""
    from clip_codec_tpu_torch.io.bitstream import write_bitstream

    rng = np.random.default_rng(3)
    np.savez(tmp_path / "codec_meta.npz", scale=np.full(dim, 1 / 127.5, np.float32),
             zero=np.full(dim, -1.0, np.float32))
    write_bitstream(rng.integers(0, 256, dim, dtype=np.uint8).tobytes(), dim, tmp_path / "img.clp")
    torch.save(port["sd"]["unet"], tmp_path / "unet.bin")
    torch.save(port["sd"]["vae"], tmp_path / "vae.bin")
    adapter = _seeded(tsd.SDClipAdapter(in_dim=dim, ctx_dim=16, n_tokens=8), 13)
    torch.save({"adapter": adapter.state_dict()}, tmp_path / "adapter.pt")
    return ["--store_dir", str(tmp_path), "--bitstream", str(tmp_path / "img.clp"), "--adapter",
            str(tmp_path / "adapter.pt"), "--steps", "2", "--size", "16", "--heads", "2", "--device", "cpu"]


@pytest.fixture
def sd_env(tmp_path, monkeypatch):
    monkeypatch.setenv("CLIP_CODEC_SD_UNET_WEIGHTS", str(tmp_path / "unet.bin"))
    monkeypatch.setenv("CLIP_CODEC_SD_VAE_WEIGHTS", str(tmp_path / "vae.bin"))


def test_cli_default_flags_run_inversion_at_dim_512(tmp_path, port, sd_env, monkeypatch, capsys):
    """The CLI's inversion defaults (weight 1, every step, backend auto ->
    clip at dim 512) on a tiny tower of embed dim 512: the PNG equals
    ``sample_with_inversion`` called directly with ``clip_embed_fn``."""
    argv = _store(tmp_path, port, 512)
    cfg = CLIPConfig(**dict(TOWER, embed_dim=512))
    torch.save(hf_layout(random_clip_sd(dict(TOWER, embed_dim=512), 5)), tmp_path / "clip.bin")
    monkeypatch.setenv("CLIP_CODEC_CLIP_WEIGHTS", str(tmp_path / "clip.bin"))
    real = encoders.ClipEncoder
    made = []

    def tiny_encoder(**kw):
        made.append(real(**kw, cfg=cfg, dtype=torch.float32))
        return made[-1]

    monkeypatch.setattr(encoders, "ClipEncoder", tiny_encoder)
    cli.main(argv)
    assert "img-2-5-1.png" in capsys.readouterr().out
    got = np.asarray(Image.open(tmp_path / "img-2-5-1.png"))

    from clip_codec_tpu_torch.cli.reconstruct_diffusion import decode_embedding, to_pil

    dec = cli.load_decoder(tmp_path / "unet.bin", tmp_path / "vae.bin", tmp_path / "adapter.pt", "cpu", heads=2)
    z = torch.from_numpy(decode_embedding(tmp_path / "img.clp", tmp_path))
    embed = cli.clip_embed_fn(made[0].model)
    img = dec.sample_with_inversion(z, z, embed, (1, 8, 8, 4), steps=2, inv_weight=1.0,
                                    generator=torch.Generator().manual_seed(0))
    want = np.asarray(to_pil(img[0].float().numpy()))
    np.testing.assert_array_equal(got, want)
    plain = dec.sample(z, (1, 8, 8, 4), steps=2, generator=torch.Generator().manual_seed(0))
    assert not np.array_equal(np.asarray(to_pil(plain[0].float().numpy())), want)


def test_cli_default_flags_run_dino_inversion_at_dim_32(tmp_path, port, sd_env, monkeypatch, capsys):
    """The CLI's inversion defaults at dim 32: backend auto -> dino, the
    DINOv2 tower read from ``$CLIP_CODEC_DINO_WEIGHTS`` (a HuggingFace-layout
    file of the tiny tower, dim 32); the PNG equals ``sample_with_inversion``
    called directly with ``dino_embed_fn``, and differs from the unguided one."""
    argv = _store(tmp_path, port, CLIP_DIM)
    torch.save(random_hf_dino(DINO_TINY, 6), tmp_path / "dino.bin")
    monkeypatch.setenv("CLIP_CODEC_DINO_WEIGHTS", str(tmp_path / "dino.bin"))
    real = encoders.DinoEncoder
    made = []

    def tiny_encoder(**kw):
        made.append(real(**kw, cfg=DinoConfig(**DINO_TINY), dtype=torch.float32))
        return made[-1]

    monkeypatch.setattr(encoders, "DinoEncoder", tiny_encoder)
    monkeypatch.setattr(encoders, "ClipEncoder", None)  # auto must not reach the CLIP tower
    cli.main(argv)
    assert "img-2-5-1.png" in capsys.readouterr().out and len(made) == 1
    got = np.asarray(Image.open(tmp_path / "img-2-5-1.png"))

    from clip_codec_tpu_torch.cli.reconstruct_diffusion import decode_embedding, to_pil

    dec = cli.load_decoder(tmp_path / "unet.bin", tmp_path / "vae.bin", tmp_path / "adapter.pt", "cpu", heads=2)
    z = torch.from_numpy(decode_embedding(tmp_path / "img.clp", tmp_path))
    img = dec.sample_with_inversion(z, z, cli.dino_embed_fn(made[0].model), (1, 8, 8, 4), steps=2, inv_weight=1.0,
                                    generator=torch.Generator().manual_seed(0))
    want = np.asarray(to_pil(img[0].float().numpy()))
    np.testing.assert_array_equal(got, want)
    plain = dec.sample(z, (1, 8, 8, 4), steps=2, generator=torch.Generator().manual_seed(0))
    assert not np.array_equal(np.asarray(to_pil(plain[0].float().numpy())), want)
    assert cli.resolve_backend("auto", 768) == "dino" and cli.resolve_backend("auto", 512) == "clip"


def test_cli_inversion_refusals(tmp_path, port, sd_env, monkeypatch):
    argv = _store(tmp_path, port, CLIP_DIM)
    monkeypatch.delenv("CLIP_CODEC_DINO_WEIGHTS", raising=False)
    for extra in ([], ["--inv_backend", "dino"], ["--inv_backend", "auto"], ["--inv_dino_model", "unused"]):
        with pytest.raises(RuntimeError, match="CLIP_CODEC_DINO_WEIGHTS"):
            cli.main(argv + extra)  # auto at dim 32 is dino, whose weights are missing: no fall back to clip
    with pytest.raises(ValueError, match="inv_backend=clip but bitstream dim is 32"):
        cli.main(argv + ["--inv_backend", "clip"])
    with pytest.raises(SystemExit, match="incompatible with inversion guidance"):
        cli.main(argv + ["--int8"])
    try:  # without inversion --int8 runs: the static-int8 UNet, no tower needed
        cli.main(argv + ["--int8", "--inv_weight", "0"])
    finally:
        q8.set_int8_conv(False)
    assert Image.open(tmp_path / "img-2-5-0.png").size == (16, 16)
