"""The port's compress side against the JAX package, on the CPU: the quantizer
(codebook, codes and ties integer-exact), the store writer (``codec_meta.npz``,
manifest and every ``.clp`` byte-equal), ``ClipEncoder`` at the tiny config
(embeddings within 1e-4 in fp32, corrupt files skipped, tail batches padded),
``ClipCodec.compress``, ``cli.encode_images`` (with ``--append``) and its
refusals, and the pixel-training CLI's ``--clip_weights``.

Where bytes are compared end to end (``compress``, the CLI), both packages
get the same stand-in encoder, a numpy function of the pixels, so the
codebook sees bit-equal embeddings; the towers' own agreement (1e-4, not
bits) is held here and in tests/test_torch_clip.py.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import clip_codec_tpu.encoders as jax_encoders
import clip_codec_tpu_torch.encoders as encoders
from clip_codec_tpu.codec import ClipCodec as JaxCodec
from clip_codec_tpu.codecs import quantizer as jq
from clip_codec_tpu.encoders.clip import CLIPConfig as JaxConfig
from clip_codec_tpu.io import store as jstore
from clip_codec_tpu_torch.codec import ClipCodec
from clip_codec_tpu_torch.codecs import quantizer as tq
from clip_codec_tpu_torch.encoders.clip import CLIPConfig, preprocess_pil_u8
from clip_codec_tpu_torch.io import store as tstore
from tests.test_torch_clip import ALIGN, TINY, random_clip_sd

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "clip_embeddings_fp32.npz"


@pytest.fixture(scope="module")
def Z():
    return np.load(FIXTURE)["Z"]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _numpy_codes(x, scale, zero):
    """IEEE fp32 (x - zero) / scale, numpy's round half to even, clamp."""
    return np.clip(np.round((x - zero) / scale), 0, 255).astype(np.uint8)


def test_codebook_is_bit_equal_to_jax_and_numpy(Z):
    scale, zero = tq.fit_affine(Z)
    js, jz = jq.fit_affine(Z)
    np.testing.assert_array_equal(_bits(scale), _bits(js))
    np.testing.assert_array_equal(_bits(zero), _bits(jz))
    rng_ = np.maximum(Z.max(0) - Z.min(0), np.float32(1e-8))
    np.testing.assert_array_equal(_bits(scale), _bits(rng_ / np.float32(255)))
    ts, tz = tq.fit_affine(torch.from_numpy(Z))  # a tensor: min/max on its own device
    np.testing.assert_array_equal(_bits(ts), _bits(scale))
    np.testing.assert_array_equal(_bits(tz), _bits(zero))


def test_codes_are_integer_exact_with_ties(Z):
    """The fixture's codes, ties near the .5 boundary among them, and
    constructed exact ties (quotients k + 0.5 round to the even k)."""
    scale, zero = tq.fit_affine(Z)
    y = (Z - zero) / scale
    assert int((np.abs(np.abs(y - np.floor(y)) - 0.5) < 1e-4).sum()) >= 10  # the test has teeth
    got = tq.quantize(Z, scale, zero)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.quantize(Z, scale, zero)))
    np.testing.assert_array_equal(got.numpy(), _numpy_codes(Z, scale, zero))

    half = np.full(8, 0.5, np.float32)
    x = (np.arange(-2, 518, dtype=np.float32)[:, None] * 0.25 + np.zeros(8, np.float32))  # k/2 + 0.25 steps
    t = tq.quantize(x, half, np.zeros(8, np.float32)).numpy()
    np.testing.assert_array_equal(t, _numpy_codes(x, half, 0))
    np.testing.assert_array_equal(t, np.asarray(jq.quantize(x, half, np.zeros(8, np.float32))))
    assert t[:, 0].tolist().count(0) >= 3 and t[-1, 0] == 255  # clamped both ways
    assert tq.quantize(np.float32([[1.25, 1.75]]), half[:2], half[:2] * 0).tolist() == [[2, 4]]


def test_quantizer_class_matches_jax(Z):
    ours = tq.PerChannelAffineQuantizer(device="cpu").fit(Z)
    theirs = jq.PerChannelAffineQuantizer().fit(Z)
    np.testing.assert_array_equal(_bits(ours.scale), _bits(theirs.scale))
    q = ours.encode(Z[:17])
    np.testing.assert_array_equal(q, theirs.encode(Z[:17]))
    # numpy's two roundings exactly; XLA fuses JAX's into one multiply-add (an ulp apart)
    np.testing.assert_array_equal(ours.decode(q), q.astype(np.float32) * ours.scale + ours.zero)
    np.testing.assert_allclose(ours.decode(q), theirs.decode(q), rtol=0, atol=3e-8)
    with pytest.raises(RuntimeError, match="not been fitted"):
        tq.PerChannelAffineQuantizer(device="cpu").encode(Z)


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir()) if p.is_file()}


def _same_store(tmp_path: Path, write_jax, write_port) -> None:
    """Run ``write_jax(store)``, move the store aside, run ``write_port(store)``
    into the same path (manifests hold paths), then compare every file."""
    store = tmp_path / "store"
    write_jax(store)
    store.rename(tmp_path / "jax_store")
    write_port(store)
    want, got = _files(tmp_path / "jax_store"), _files(store)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_store_bytes_equal_jax(Z, tmp_path):
    """write_store then append_store (colliding stems, values past the
    fitted range): codec_meta.npz, manifest.json and every .clp equal."""
    feats, extra = Z[:6], np.concatenate([Z[6:9], 2 * Z[9:10]])
    paths = [f"/imgs/a/im{i}.png" for i in range(5)] + ["/imgs/b/im0.png"]
    more = ["/imgs/c/im1.png", "/imgs/c/new.png", "/imgs/c/new.png", "/imgs/c/x.png"]
    scale, zero = tq.fit_affine(feats)
    q = tq.quantize(feats, scale, zero).numpy()

    def jax_side(store):
        jstore.write_store(store, feats, paths, scale, zero, q)
        jstore.append_store(store, extra, more)

    def port_side(store):
        tstore.write_store(store, feats, paths, scale, zero, q)
        (store / "decoded.npy").write_bytes(b"stale")
        recs = tstore.append_store(store, torch.from_numpy(extra), more)
        assert [Path(r["bitstream"]).name for r in recs] == ["im1__1.clp", "new.clp", "new__1.clp", "x.clp"]

    _same_store(tmp_path, jax_side, port_side)
    st = tstore.Store.open(tmp_path / "store")
    assert len(st) == 10 and not (tmp_path / "store" / "decoded.npy").exists()
    with pytest.raises(ValueError, match="16-shaped|-d store"):
        tstore.append_store(tmp_path / "store", np.zeros((1, 16), np.float32), ["y.png"])


# ------------------------------------------------------------------ encoders


def hf_layout(sd: dict) -> dict:
    """An openai-layout CLIP state dict in HuggingFace ``CLIPModel`` names
    (the layout whose depth and widths JAX's ``ClipEncoder`` reads)."""
    v, t = "vision_model", "text_model"
    out = {f"{v}.embeddings.patch_embedding.weight": sd["visual.conv1.weight"],
           f"{v}.embeddings.class_embedding": sd["visual.class_embedding"],
           f"{v}.embeddings.position_embedding.weight": sd["visual.positional_embedding"],
           "visual_projection.weight": sd["visual.proj"].T.contiguous(),
           f"{t}.embeddings.token_embedding.weight": sd["token_embedding.weight"],
           f"{t}.embeddings.position_embedding.weight": sd["positional_embedding"],
           "text_projection.weight": sd["text_projection"].T.contiguous()}
    for n in ("weight", "bias"):
        out[f"{v}.pre_layrnorm.{n}"] = sd[f"visual.ln_pre.{n}"]
        out[f"{v}.post_layernorm.{n}"] = sd[f"visual.ln_post.{n}"]
        out[f"{t}.final_layer_norm.{n}"] = sd[f"ln_final.{n}"]
    for tower, pre in ((v, "visual.transformer"), (t, "transformer")):
        for i in range(2):
            a, b = f"{tower}.encoder.layers.{i}", f"{pre}.resblocks.{i}"
            for n in ("weight", "bias"):
                for j, qkv in enumerate("qkv"):
                    out[f"{a}.self_attn.{qkv}_proj.{n}"] = sd[f"{b}.attn.in_proj_{n}"].chunk(3)[j].contiguous()
                out[f"{a}.self_attn.out_proj.{n}"] = sd[f"{b}.attn.out_proj.{n}"]
                out[f"{a}.layer_norm1.{n}"] = sd[f"{b}.ln_1.{n}"]
                out[f"{a}.layer_norm2.{n}"] = sd[f"{b}.ln_2.{n}"]
                out[f"{a}.mlp.fc1.{n}"] = sd[f"{b}.mlp.c_fc.{n}"]
                out[f"{a}.mlp.fc2.{n}"] = sd[f"{b}.mlp.c_proj.{n}"]
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny random checkpoint in HuggingFace names, which both packages read."""
    p = tmp_path_factory.mktemp("clip") / "tiny_hf.bin"
    torch.save(hf_layout(random_clip_sd(TINY, 3)), p)
    return str(p)


@pytest.fixture(scope="module")
def encs(ckpt):
    """The JAX and the port's ClipEncoder on one tiny fp32 checkpoint."""
    jenc = jax_encoders.ClipEncoder(weights_path=ckpt, cfg=JaxConfig(**TINY), dtype=jnp.float32)
    tenc = encoders.ClipEncoder(weights_path=ckpt, cfg=CLIPConfig(**TINY), dtype=torch.float32, device="cpu")
    return jenc, tenc


def _images(d: Path, rng, sizes, stem="im") -> list:
    d.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, (w, h) in enumerate(sizes):
        p = d / f"{stem}{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    return paths


def test_encode_images_matches_jax(encs, tmp_path, rng):
    """Five images of mixed sizes and a corrupt file, batch 2 (the tail
    padded): the same kept paths, embeddings within 1e-4 and unit norm."""
    jenc, tenc = encs
    paths = _images(tmp_path, rng, [(40, 50), (35, 32), (32, 67), (50, 40), (33, 33)])
    bad = tmp_path / "broken.png"
    bad.write_bytes(b"not an image")
    paths.insert(2, str(bad))
    want, kept_j = jenc.encode_images(paths, batch_size=2)
    got, kept = tenc.encode_images(paths, batch_size=2)
    assert kept == kept_j and str(bad) not in kept and got.shape == (5, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_tail_batch_padding_leaves_rows_unchanged(encs, tmp_path, rng):
    """A row's embedding does not depend on the size of the batch it
    lands in (every batch is padded to batch_size): bit-equal."""
    _, tenc = encs
    paths = _images(tmp_path, rng, [(40, 40)] * 5)
    full, _ = tenc.encode_images(paths, batch_size=4)  # 4 + a padded 1
    tail, _ = tenc.encode_images(paths[4:], batch_size=4)
    head, _ = tenc.encode_images(paths[1:4], batch_size=4)
    np.testing.assert_array_equal(full[4:], tail)
    np.testing.assert_array_equal(full[1:4], head)


def test_u8_input_is_bit_equal_to_host_normalized_input(encs, rng):
    from clip_codec_tpu_torch.encoders.clip import preprocess_pil

    _, tenc = encs
    imgs = [Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)) for _ in range(3)]
    u8 = np.stack([preprocess_pil_u8(im, 32) for im in imgs])
    f32 = np.stack([preprocess_pil(im, 32) for im in imgs])
    np.testing.assert_array_equal(tenc.encode_image_array(u8), tenc.encode_image_array(f32))


def test_encoder_refusals(ckpt, monkeypatch):
    monkeypatch.delenv("CLIP_CODEC_CLIP_WEIGHTS", raising=False)
    with pytest.raises(RuntimeError, match="CLIP_CODEC_CLIP_WEIGHTS"):
        encoders.ClipEncoder(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encoders.ClipEncoder(weights_path=ckpt, cfg=CLIPConfig(**TINY))


# ------------------------------------------------- compress and the encode CLI


class StandInEncoder:
    """Both packages' encoder interface over one numpy function of the
    pixels, so both codebooks see bit-equal embeddings."""

    cfg = CLIPConfig(**TINY)
    device = torch.device("cpu")
    _w = np.random.default_rng(5).standard_normal((32 * 32 * 3, 16))

    @classmethod
    def _embed(cls, x: np.ndarray) -> np.ndarray:
        z = np.asarray(x, np.float64).reshape(len(x), -1) @ cls._w / 255.0 + 1.0
        return (z / np.linalg.norm(z, axis=1, keepdims=True)).astype(np.float32)

    def _embed_images(self, x):  # JAX's ClipCodec.compress
        return self._embed(np.asarray(x))

    def embed_images(self, x):  # the port's
        return torch.from_numpy(self._embed(x.numpy()))

    def encode_images(self, paths, batch_size=64):
        from clip_codec_tpu_torch.encoders import _batched_encode

        return _batched_encode(paths, lambda p: preprocess_pil_u8(Image.open(p), 32), self._embed,
                               batch_size, 16)


def test_compress_frames_equal_jax(Z, rng):
    """Seven images at batch 4: the same .clp bytes, which decode back."""
    imgs = [Image.fromarray(rng.integers(0, 256, (40 + i, 50, 3), dtype=np.uint8)) for i in range(7)]
    scale, zero = tq.fit_affine(StandInEncoder._embed(rng.integers(0, 256, (64, 32, 32, 3))))
    want = JaxCodec(scale, zero, encoder=StandInEncoder()).compress(imgs, batch_size=4)
    codec = ClipCodec(scale, zero, device="cpu", encoder=StandInEncoder())
    got = codec.compress(imgs, batch_size=4)
    assert got == want and len(got) == 7 and codec.compress([]) == []
    z = StandInEncoder._embed(np.stack([preprocess_pil_u8(im, 32) for im in imgs]))
    np.testing.assert_array_equal(codec.codes(got), tq.quantize(z, scale, zero).numpy())


def test_compress_through_the_tower_decodes_back(encs, rng):
    """The tiny tower: frames decode to cosine >= 0.99 with the embeddings."""
    _, tenc = encs
    imgs = [Image.fromarray(rng.integers(0, 256, (40, 30 + i, 3), dtype=np.uint8)) for i in range(5)]
    z = tenc.encode_image_array(np.stack([preprocess_pil_u8(im, 32) for im in imgs]))
    scale, zero = tq.fit_affine(z)
    codec = ClipCodec(scale, zero, device="cpu", encoder=tenc)
    back = codec.decode_embeddings_host(codec.compress(imgs, batch_size=2))
    assert np.all(np.sum(back * z, axis=1) >= 0.99)


def _jax_cli(argv, monkeypatch):
    from clip_codec_tpu.cli.encode_images import main

    monkeypatch.setattr(sys, "argv", ["encode_images"] + argv)
    main()


def test_encode_cli_with_append_equals_jax(tmp_path, rng, monkeypatch, capsys):
    """cli.encode_images, then --append, through both packages' CLIs with
    one stand-in encoder: every file of the two stores byte-equal."""
    from clip_codec_tpu_torch.cli.encode_images import main

    d1, d2 = tmp_path / "a", tmp_path / "b"
    _images(d1 / "sub", rng, [(40, 50), (32, 35), (60, 33)])
    _images(d1, rng, [(50, 40)])
    (d1 / "notes.txt").write_text("not an image")
    (d1 / "broken.jpg").write_bytes(b"\xff\xd8 corrupt")
    _images(d2, rng, [(45, 45), (33, 70)])
    monkeypatch.setattr(jax_encoders, "ClipEncoder", lambda **kw: StandInEncoder())
    monkeypatch.setattr(encoders, "ClipEncoder", lambda **kw: StandInEncoder())

    def run(cli, store):
        cli(["--img_dir", str(d1), "--out_dir", str(store), "--device", "cpu", "--batch_size", "2"])
        cli(["--img_dir", str(d2), "--out_dir", str(store), "--device", "cpu", "--append"])

    _same_store(tmp_path, lambda s: run(lambda a: _jax_cli(a, monkeypatch), s), lambda s: run(main, s))
    out = capsys.readouterr().out
    assert "Stored 4 vectors" in out and "Appended 2 vectors" in out
    assert len(json.loads((tmp_path / "store" / "manifest.json").read_text())) == 6


def test_encode_cli_refusals(tmp_path, ckpt, monkeypatch):
    from clip_codec_tpu_torch.cli.encode_images import main

    base = ["--img_dir", str(tmp_path), "--out_dir", str(tmp_path / "s"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="Only ViT-B-32"):
        main(base + ["--model", "ViT-L-14"])
    with pytest.raises(SystemExit, match="existing store"):
        main(base + ["--append"])
    tstore.write_store(tmp_path / "s", np.ones((1, 8), np.float32), ["x.png"], np.ones(8), np.zeros(8),
                       np.zeros((1, 8), np.uint8))
    monkeypatch.setattr(encoders, "ClipEncoder", lambda **kw: StandInEncoder())
    with pytest.raises(SystemExit, match="8-d but this encoder emits 16-d"):
        main(base + ["--append"])
    with pytest.raises(SystemExit, match="No images"):
        main(["--img_dir", str(tmp_path / "empty"), "--out_dir", str(tmp_path / "t"), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--img_dir", str(tmp_path), "--out_dir", str(tmp_path / "t")])


def test_train_cli_runs_the_clip_term(tmp_path, rng, monkeypatch):
    """cli.train --clip_weights: the CLIP image tower in bf16 on the chosen
    device feeds the alignment term on the even epoch (one of two)."""
    from clip_codec_tpu_torch.cli import train
    from clip_codec_tpu_torch.encoders import clip as tclip
    from tests.test_torch_train import _store

    p = tmp_path / "clip.pt"
    torch.save(random_clip_sd(ALIGN, 4), p)
    made, calls, real = [], [], encoders.ClipEncoder

    def make(**kw):
        made.append(kw)
        return real(weights_path=kw["weights_path"], cfg=CLIPConfig(**ALIGN), dtype=kw["dtype"],
                    device=kw["device"])

    embed = tclip.embed_m11_images
    monkeypatch.setattr(encoders, "ClipEncoder", make)
    monkeypatch.setattr(tclip, "embed_m11_images", lambda m, x: calls.append(x.shape) or embed(m, x))
    _store(tmp_path, rng, n=3, dim=16)
    train.main(["--store_dir", str(tmp_path), "--device", "cpu", "--base", "8", "--ch_mult", "1,2",
                "--out_size", "16", "--timesteps", "50", "--batch_size", "2", "--no_bf16", "--epochs", "2",
                "--clip_weights", str(p)])
    assert made == [dict(weights_path=str(p), dtype=torch.bfloat16, device="cpu")]
    assert calls == [(2, 16, 16, 3)] * 2  # epoch 0's two batches; epoch 1 has the term off
    assert (tmp_path / "diffusion_unet_final.pt").exists()
