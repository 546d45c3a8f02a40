"""The port's decompress path end to end (clip_codec_tpu_torch.codec / .cli)
against the JAX package.

The JAX package writes the store (codec_meta.npz, the decoder exported as a
torch ``.pt`` state dict, model_config.json) and the ``.clp`` frames; the
port's ``ClipCodec`` reads them and decompresses with the initial noise
injected per batch, and must match JAX ``decode_embeddings`` followed by
JAX ``ddim_sample`` from the same noise. Tiny config (base=8,
ch_mult=(1,2), z_dim=8, 16px), fp32; images within 1e-3 after the clip
(five sampler steps compound the 2e-4 eps bound), embeddings within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_codec_tpu.codec import ClipCodec as JaxCodec
from clip_codec_tpu.codecs.quantizer import fit_affine, quantize
from clip_codec_tpu.diffusion import NoiseSchedule as JaxSchedule
from clip_codec_tpu.diffusion.ddim import ddim_sample as jax_ddim_sample
from clip_codec_tpu.io.bitstream import compress_frame as jax_compress_frame
from clip_codec_tpu.models import CLIPCondUNet as JaxUNet
from clip_codec_tpu.utils.config import ModelConfig as JaxModelConfig
from clip_codec_tpu.weights.export import save_torch_unet
from clip_codec_tpu_torch.codec import ClipCodec
from clip_codec_tpu_torch.io import bitstream as tb

torch.set_num_threads(1)

CFG = dict(z_dim=8, base=8, ch_mult=(1, 2))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A store written by the JAX package: meta, decoder, config, frames."""
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("store")
    feats = rng.standard_normal((5, 8)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    scale, zero = fit_affine(feats)
    q = np.asarray(quantize(jnp.asarray(feats), scale, zero))
    np.savez(root / "codec_meta.npz", scale=np.asarray(scale), zero=np.asarray(zero))
    params = JaxUNet(**CFG, fused_pallas=False).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 8)), jnp.zeros((1,), jnp.int32))["params"]
    save_torch_unet(str(root / "diffusion_unet_final.pt"), params, CFG["ch_mult"])
    # A linear 50-step schedule: the parity sampler divides eps by
    # sqrt(al_bar_t), 3.1e-4 at the first step of a 50-step cosine schedule
    # (0.78 for linear), which turns fp32 reassociation noise into 1e-3-size
    # differences.
    mc = JaxModelConfig(z_dim=8, base=8, ch_mult=(1, 2), timesteps=50, schedule="linear", out_size=16)
    mc.save(root)
    blobs = [jax_compress_frame(row.tobytes()) for row in q]
    return dict(root=root, params=params, mc=mc, blobs=blobs, q=q,
                scale=np.asarray(scale), zero=np.asarray(zero))


def _port(store):
    return ClipCodec.load(store["root"], device="cpu", dtype=torch.float32)


def test_decompress_matches_jax_with_injected_noise(store, monkeypatch):
    blobs, batch, steps = store["blobs"][:4], 3, 5
    rng = np.random.default_rng(11)
    noise = [rng.standard_normal((batch, 16, 16, 3)).astype(np.float32) for _ in range(2)]

    codec = _port(store)
    sample, seen = codec._sample_batch, []

    def inject(z, size, steps, sampler, generator, x_T=None):
        seen.append(z.clone())
        return sample(z, size, steps, sampler, generator, x_T=torch.from_numpy(noise[len(seen) - 1]))

    monkeypatch.setattr(codec, "_sample_batch", inject)
    imgs = codec.decompress(blobs, size=16, steps=steps, batch_size=batch, seed=0)
    assert imgs.shape == (4, 16, 16, 3) and imgs.dtype == np.float32
    assert len(seen) == 2 and torch.all(seen[1][1:] == 0)  # tail batch zero-padded

    jc = JaxCodec(store["scale"], store["zero"])
    zj = jc.decode_embeddings(blobs)
    zj = np.concatenate([zj, np.zeros((2, 8), np.float32)])
    net = JaxUNet(**CFG, fused_pallas=False)
    sched = JaxSchedule.create(store["mc"].timesteps, store["mc"].schedule)
    ref = []
    for b in range(2):
        x = jax_ddim_sample(lambda p, x, z, t: net.apply(p, x, z, t), sched,
                            jnp.asarray(zj[b * batch:(b + 1) * batch]), (batch, 16, 16, 3), steps=steps,
                            x_T=jnp.asarray(noise[b]), model_params={"params": store["params"]})
        ref.append(np.clip(np.asarray(x), -1, 1))
    ref = np.concatenate(ref)[:4]
    np.testing.assert_allclose(imgs, ref, rtol=0, atol=1e-3)


def test_embeddings_match_jax(store):
    codec = _port(store)
    zj = JaxCodec(store["scale"], store["zero"]).decode_embeddings(store["blobs"])
    np.testing.assert_allclose(codec.decode_embeddings(store["blobs"]), zj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(codec.decode_embeddings_host(store["blobs"]), zj, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(codec.codes(store["blobs"]), store["q"])
    assert codec.decode_embeddings([]).shape == (0, 8)


def test_frame_from_another_store_is_rejected(store):
    codec = _port(store)
    with pytest.raises(ValueError, match="different store"):
        codec.decode_embeddings_host([tb.compress_frame(bytes(16))])
    with pytest.raises(ValueError, match="different store"):
        codec.decompress([tb.compress_frame(bytes(4))], size=16, steps=1)


@pytest.mark.parametrize("payload", [bytes(8), bytes(range(256)) * 3])
def test_frames_byte_identical_to_jax(payload):
    from clip_codec_tpu.io.bitstream import decompress_frame as jax_decompress_frame

    frame = tb.compress_frame(payload)
    assert frame == jax_compress_frame(payload)
    np.testing.assert_array_equal(tb.decompress_frame(frame), jax_decompress_frame(frame))
    assert tb.decompress_frame(frame).tobytes() == payload


def test_bad_frames_raise(tmp_path):
    import struct

    import zstandard as zstd

    with pytest.raises(ValueError, match="Bad magic"):
        tb.decompress_frame(b"XXXX" + bytes(8))
    with pytest.raises(ValueError, match="Truncated"):
        tb.decompress_frame(b"CLPF\x01")
    bomb = zstd.ZstdCompressor().compress(bytes(1 << 21))
    with pytest.raises(zstd.ZstdError, match="decompression-bomb"):
        tb.decompress_frame(b"CLPF" + struct.pack("<I", len(bomb)) + bomb, max_output=1 << 20)
    tb.write_bitstream(b"\x01\x02", 2, tmp_path / "a.clp")
    assert tb.read_bitstream(tmp_path / "a.clp").tolist() == [1, 2]


def test_seeded_requests_reproduce(store):
    codec = _port(store)
    a = codec.decompress(store["blobs"][:3], size=16, steps=2, batch_size=2, seed=3)
    b = codec.decompress(store["blobs"][:3], size=16, steps=2, batch_size=2, seed=3)
    c = codec.decompress(store["blobs"][:3], size=16, steps=2, batch_size=2, seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # unseeded calls advance the codec's own generator
    d = codec.decompress(store["blobs"][:1], size=16, steps=2, batch_size=2)
    e = codec.decompress(store["blobs"][:1], size=16, steps=2, batch_size=2)
    assert not np.array_equal(d, e)
    assert np.all(np.isfinite(a)) and np.abs(a).max() <= 1.0
    assert codec.decompress([], size=16).shape == (0, 16, 16, 3)


def test_codes_entry_matches_frames(store):
    codec = _port(store)
    a = codec.decompress(store["blobs"][:2], size=16, steps=2, batch_size=2, seed=1)
    b = codec.decompress_codes(store["q"][:2], size=16, steps=2, batch_size=2, seed=1)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="codes must be"):
        codec.decompress_codes(store["q"][:, :4], size=16, steps=1)


def test_load_errors_and_inferred_config(store, tmp_path):
    import shutil

    with pytest.raises(FileNotFoundError):
        ClipCodec.load(store["root"], weights=tmp_path / "missing.pt", device="cpu")
    with pytest.raises(RuntimeError, match="No decoder"):
        ClipCodec(store["scale"], store["zero"], device="cpu").decompress(store["blobs"][:1], size=16)
    with pytest.raises(ValueError, match="msgpack"):
        (tmp_path / "w.msgpack").write_bytes(b"")
        ClipCodec.load(store["root"], weights=tmp_path / "w.msgpack", device="cpu")
    # no model_config.json beside the weights: the architecture is inferred
    shutil.copy(store["root"] / "diffusion_unet_final.pt", tmp_path / "w.pt")
    with pytest.warns(UserWarning, match="inferred base=8"):
        codec = ClipCodec.load(store["root"], weights=tmp_path / "w.pt", device="cpu")
    assert (codec.mc.base, codec.mc.ch_mult, codec.mc.z_dim, codec.mc.time_dim) == (8, (1, 2), 8, 256)
    with pytest.raises(ValueError, match="unknown sampler"):
        codec.decompress(store["blobs"][:1], size=16, steps=1, sampler="euler")
    img = codec.decompress(store["blobs"][:1], size=16, steps=2, sampler="dpmpp")
    assert img.shape == (1, 16, 16, 3) and np.isfinite(img).all()


def test_reconstruct_cli_writes_an_image(store, tmp_path):
    from PIL import Image

    from clip_codec_tpu_torch.cli.reconstruct_diffusion import main

    bit = tmp_path / "img.clp"
    bit.write_bytes(store["blobs"][0])
    out = tmp_path / "recon.png"
    main(["--store_dir", str(store["root"]), "--bitstream", str(bit),
          "--weights", str(store["root"] / "diffusion_unet_final.pt"), "--out", str(out),
          "--steps", "2", "--size", "16", "--device", "cpu", "--sampler", "ddim_std"])
    img = Image.open(out)
    assert img.size == (16, 16) and img.mode == "RGB"
