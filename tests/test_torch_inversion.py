"""The port's feature-inversion guidance (``StableDiffusionDecoder.sample_with_inversion``)
against the JAX package, on the CPU (the SD CLI's inversion branch:
tests/test_torch_inversion_cli.py; DPM-Solver++(2M): tests/test_torch_inversion_dpmpp.py).

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

import clip_codec_tpu.encoders as jax_encoders
import clip_codec_tpu_torch.encoders as encoders
from clip_codec_tpu.encoders import dino as jdino
from clip_codec_tpu.encoders.clip import CLIP_MEAN, CLIP_STD
from clip_codec_tpu.encoders.clip import CLIPConfig as JaxConfig
from clip_codec_tpu.encoders.clip import CLIPModel as JaxCLIPModel
from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as cli
from clip_codec_tpu_torch.encoders.clip import CLIPConfig
from clip_codec_tpu_torch.models.sd.decoder import inversion_loss
from tests.test_torch_clip import TINY, random_clip_sd
from tests.test_torch_compress import hf_layout
from tests.test_torch_dino import TINY as DINO_TINY
from tests.test_torch_dino import port_dino, random_hf_dino
from tests.test_torch_sd import CLIP_DIM, _close, _decoders, port  # noqa: F401  (port: a fixture)

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


@pytest.fixture(scope="module")
def unguided():
    """The port's unguided latents by sampler, CFG form, steps and inputs:
    the guided cases of a file that share them compare against one run."""
    return {}


# The dpmpp cases are tests/test_torch_inversion_dpmpp.py's, so that the
# workers of a --dist loadfile run take the two halves at once.
@pytest.mark.parametrize("cfg_batched", [True, False], ids=["cfg_batched", "cfg_sequential"])
@pytest.mark.parametrize("inv_every", [1, 2])
@pytest.mark.parametrize("sampler", ["ddim"])
@pytest.mark.parametrize("embed", ["toy", "clip"])
def test_sample_with_inversion_matches_jax(rng, port, towers, unguided, embed, sampler, inv_every, cfg_batched):
    """Three guided CFG steps over (2, 32, 32, 4) latents; the target is a
    second embedding, so the loss is not at its minimum."""
    _check_guided_sampling(rng, port, _embeds(embed, towers), sampler, inv_every, cfg_batched, unguided=unguided)


def test_sample_with_inversion_through_dino_matches_jax(rng, port, dino_towers):
    """The same through the tiny DINOv2 tower and the CLI's ``dino_embed_fn``
    (the 64px decode resized down to 28), at the CLI's default sampler, two
    guided steps."""
    jp, model = dino_towers
    _check_guided_sampling(rng, port, (jax_dino_embed(jp), cli.dino_embed_fn(model)), "ddim", 1, True, steps=2)


def _check_guided_sampling(rng, port, embeds, sampler, inv_every, cfg_batched, steps=3, unguided=None):
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
    plain_kw = {k: kw[k] for k in ("steps", "guidance_scale", "cfg_batched", "sampler")}
    cache = {} if unguided is None else unguided
    key = (tuple(sorted(plain_kw.items())), z.tobytes(), x_T.numpy().tobytes())
    if key not in cache:
        cache[key] = tdec.sample(torch.from_numpy(z), shape, x_T=x_T, decode_pixels=False, **plain_kw)
    plain = cache[key]
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
