"""The port's DINOv2 front end (encoders/dino.py, the LayerScale blocks of
encoders/transformer.py, weights/convert_dino.py, ``DinoEncoder``,
cli/encode_images_dino.py, ``write_store``'s ``dim_dtype``) against the JAX
package on the same seeded inputs, on the CPU.

A tiny config (image 28, patch 14, width 32, depth 2, heads 2, as
tests/test_encoders.py builds HF's) with a seeded HuggingFace-named state
dict drawn with numpy (LayerScale near 1, not HF's all-ones init, so the
scales are held): JAX reads it through ``convert_dino_hf``, the port
through ``convert_dino.py`` and through ``from_jax.py`` from JAX's params.
Towers within 1e-4 in fp32 and ||delta|| / ||ref|| < 2e-2 in bf16 (the
CLIP towers' bound; JAX's own tests hold its tower to HF's ``Dinov2Model``);
``preprocess_dino`` within 1e-6; ``embed_m11_images_dino``
and its gradient in the images (exact +-1 ties present) within 1e-4;
``DinoEncoder`` rows within 1e-4; the CLI's store and ``write_store``'s
files byte-equal to JAX's, ``dim`` an int64 scalar.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import clip_codec_tpu.encoders as jax_encoders
import clip_codec_tpu_torch.encoders as encoders
from clip_codec_tpu.encoders import dino as jdino
from clip_codec_tpu.io import store as jstore
from clip_codec_tpu_torch.codecs import quantizer as tq
from clip_codec_tpu_torch.encoders import dino as tdino
from clip_codec_tpu_torch.io import store as tstore
from clip_codec_tpu_torch.weights.convert_dino import (dino_state_dict_from_hf, dino_state_dict_to_hf,
                                                       load_dino_state_dict)
from clip_codec_tpu_torch.weights.from_jax import dino_state_dict_from_jax
from tests.test_torch_compress import _same_store

torch.set_num_threads(1)

TINY = dict(image_size=28, patch_size=14, dim=32, depth=2, heads=2)


def random_hf_dino(cfg: dict, seed: int) -> dict:
    """A seeded HuggingFace ``Dinov2Model`` state dict (fp32 CPU tensors):
    LayerNorm scales and LayerScale near 1, small biases, weights with
    unit-variance outputs."""
    rng = np.random.default_rng(seed)
    d, p, m = cfg["dim"], cfg["patch_size"], 4 * cfg["dim"]
    n_pos = (cfg["image_size"] // p) ** 2 + 1
    shapes = {"embeddings.cls_token": (1, 1, d), "embeddings.mask_token": (1, d),
              "embeddings.position_embeddings": (1, n_pos, d),
              "embeddings.patch_embeddings.projection.weight": (d, 3, p, p),
              "embeddings.patch_embeddings.projection.bias": (d,), "layernorm.weight": (d,), "layernorm.bias": (d,)}
    for i in range(cfg["depth"]):
        b = f"encoder.layer.{i}"
        for name, (o, n) in {"attention.attention.query": (d, d), "attention.attention.key": (d, d),
                             "attention.attention.value": (d, d), "attention.output.dense": (d, d),
                             "mlp.fc1": (m, d), "mlp.fc2": (d, m)}.items():
            shapes[f"{b}.{name}.weight"], shapes[f"{b}.{name}.bias"] = (o, n), (o,)
        for name in ("norm1", "norm2"):
            shapes[f"{b}.{name}.weight"], shapes[f"{b}.{name}.bias"] = (d,), (d,)
        shapes[f"{b}.layer_scale1.lambda1"] = shapes[f"{b}.layer_scale2.lambda1"] = (d,)
    out = {}
    for k, shp in shapes.items():
        n = rng.standard_normal(shp)
        if k.endswith(("norm1.weight", "norm2.weight", "layernorm.weight", "lambda1")):
            a = 1.0 + 0.3 * n
        elif k.endswith("bias"):
            a = 0.05 * n
        elif k.startswith("embeddings.") and "patch" not in k:
            a = 0.5 * n
        else:  # (out, in) linear or (out, 3, p, p) conv weights
            a = n / np.sqrt(np.prod(shp[1:]))
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


def port_dino(sd: dict, dtype=torch.float32, cfg: dict = TINY) -> tdino.DinoV2:
    m = tdino.DinoV2(tdino.DinoConfig(**cfg), dtype=dtype)
    m.load_state_dict(sd, strict=True)
    return m.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def hf_sd():
    return random_hf_dino(TINY, 0)


@pytest.fixture(scope="module")
def jparams(hf_sd):
    return {"params": jdino.convert_dino_hf({k: v.numpy() for k, v in hf_sd.items()}, depth=TINY["depth"])}


@pytest.fixture(scope="module")
def dino_file(hf_sd, tmp_path_factory):
    p = tmp_path_factory.mktemp("dino") / "dinov2_hf.bin"
    torch.save(hf_sd, p)
    return p


def _rel_rows(a, b) -> float:
    return float((np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)).max())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_towers_match_jax(hf_sd, jparams, rng, dtype):
    """The port's tower on weights carried from JAX's params: fp32 within
    1e-4; bf16 within 2e-2 of JAX's bf16 and of fp32 (row ||delta|| / ||ref||).
    The bf16 tower's residual stream is fp32 after the first LayerScale."""
    x = rng.standard_normal((3, 28, 28, 3)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    apply = jax.jit(lambda p, v, dt: jdino.DinoV2(jdino.DinoConfig(**TINY), dtype=dt).apply(p, v), static_argnums=2)
    want = np.asarray(apply(jparams, jnp.asarray(x), jdt), np.float32)
    model = port_dino(dino_state_dict_from_jax(jparams), tdt)
    seen = []
    hook = model.encoder.resblocks[0].register_forward_hook(lambda m, a, out: seen.append(out.dtype))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    hook.remove()
    assert got.dtype == tdt and got.shape == (3, 32) and seen == [torch.float32]
    got = got.float().numpy()
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        f32 = np.asarray(apply(jparams, jnp.asarray(x), jnp.float32))
        assert _rel_rows(got, want) < 2e-2 and _rel_rows(got, f32) < 2e-2


def test_hf_weights_load_as_jax_reads_them(hf_sd, jparams, dino_file, rng):
    """The HF-named dict through ``convert_dino.py`` (from the file, with its
    ``mask_token``) and through JAX's ``convert_dino_hf`` -> ``from_jax``:
    the same state dict bit for bit, so the same outputs; ``to_hf`` inverts
    the map; the CLIP block still has no LayerScale."""
    a, b = load_dino_state_dict(dino_file), dino_state_dict_from_jax(jparams)
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    back = dino_state_dict_to_hf(a)
    assert sorted(back) == sorted(hf_sd) and all(torch.equal(back[k], hf_sd[k]) for k in hf_sd if "mask" not in k)
    assert dino_state_dict_from_hf(back).keys() == a.keys()
    from clip_codec_tpu_torch.encoders.transformer import TransformerBlock

    assert "ls1" not in TransformerBlock(32, 2, 64).state_dict()


@pytest.mark.parametrize("hw", [(37, 53), (900, 700)], ids=["upscale", "downscale"])
def test_preprocess_matches_jax(rng, hw):
    """At the tower's 518: ``F.interpolate`` and ``jax.image.resize`` round
    differently (a few ulp before the mean/std, which scale them by ~4.4)."""
    img = rng.random(hw + (3,), dtype=np.float32)
    got, want = tdino.preprocess_dino(img), jdino.preprocess_dino(img)
    assert got.shape == (518, 518, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_embed_m11_and_its_gradient_match_jax(jparams, hf_sd, rng):
    """[-1, 1] images at 20 and 40px (the resize up and down to 28) with a
    third of the values past or exactly at +-1: the embedding within 1e-4 and
    the gradient of a weighted sum of it in the images within 1e-4 of
    ``jax.grad``'s (0.5 of the unclipped gradient at a tie, as ``jnp.clip``)."""
    jm = jdino.DinoV2(jdino.DinoConfig(**TINY))
    model = port_dino(dino_state_dict_from_hf(hf_sd))
    w = rng.standard_normal((2, 32)).astype(np.float32)
    for size in (20, 40):
        x = rng.uniform(-1.2, 1.2, (2, size, size, 3)).astype(np.float32)
        tie = rng.random(x.shape) < 1 / 6
        x[tie] = np.sign(x[tie])

        def jloss(img):
            y = jdino.embed_m11_images_dino(jm, jparams, img, 28)
            return jnp.sum(y * w), y

        want_g, want = (np.asarray(a) for a in jax.jit(jax.grad(jloss, has_aux=True))(jnp.asarray(x)))
        img = torch.from_numpy(x).requires_grad_(True)
        got = tdino.embed_m11_images_dino(model, img, 28)
        (g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), img)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)
        scale = np.abs(want_g).max()
        assert np.abs(g.numpy() - want_g).max() <= 1e-4 * scale and scale > 0


def _images(d: Path, rng, sizes, ext=".png"):
    d.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, (w, h) in enumerate(sizes):
        paths.append(d / f"im{i}{ext}")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(paths[-1])
    return [str(p) for p in paths]


@pytest.fixture(scope="module")
def encs(dino_file):
    jenc = jax_encoders.DinoEncoder(weights_path=str(dino_file), cfg=jdino.DinoConfig(**TINY), dtype=jnp.float32)
    tenc = encoders.DinoEncoder(weights_path=str(dino_file), cfg=tdino.DinoConfig(**TINY), dtype=torch.float32,
                                device="cpu")
    return jenc, tenc


def test_dino_encoder_matches_jax(encs, tmp_path, rng):
    """Five images of mixed sizes and a corrupt file at batch 2 (the tail
    padded): the same kept paths, rows within 1e-4 and of unit norm."""
    jenc, tenc = encs
    paths = _images(tmp_path, rng, [(40, 50), (35, 20), (32, 67), (50, 40), (33, 33)])
    bad = tmp_path / "broken.png"
    bad.write_bytes(b"not an image")
    paths.insert(2, str(bad))
    want, kept_j = jenc.encode_images(paths, batch_size=2)
    got, kept = tenc.encode_images(paths, batch_size=2)
    assert kept == kept_j and str(bad) not in kept and got.shape == (5, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    assert tenc.model.dtype == torch.float32 and not any(p.requires_grad for p in tenc.model.parameters())


def test_encoder_defaults_and_refusals(dino_file, monkeypatch):
    import inspect

    sig = inspect.signature(encoders.DinoEncoder)
    assert sig.parameters["device"].default == "cuda" and sig.parameters["dtype"].default == torch.bfloat16
    assert inspect.signature(encoders.DinoEncoder.encode_images).parameters["batch_size"].default == 16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encoders.DinoEncoder(weights_path=str(dino_file))
    monkeypatch.delenv("CLIP_CODEC_DINO_WEIGHTS", raising=False)
    with pytest.raises(RuntimeError, match="CLIP_CODEC_DINO_WEIGHTS"):
        encoders.DinoEncoder(device="cpu")


class StandInDino:
    """Both packages' ``DinoEncoder`` interface over one numpy function of
    the host-preprocessed pixels (JAX's ``preprocess_dino``, which the port's
    matches within 1e-6), so both codebooks see bit-equal embeddings."""

    cfg = tdino.DinoConfig(**TINY)
    device = torch.device("cpu")
    _w = np.random.default_rng(6).standard_normal((28 * 28 * 3, 24))

    @classmethod
    def _embed(cls, x: np.ndarray) -> np.ndarray:
        z = np.asarray(x, np.float64).reshape(len(x), -1) @ cls._w / 100.0 + 0.5
        return (z / np.linalg.norm(z, axis=1, keepdims=True)).astype(np.float32)

    def encode_images(self, paths, batch_size=16):
        from clip_codec_tpu_torch.encoders import _batched_encode

        def pre(p):
            return jdino.preprocess_dino(np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0, 28)

        return _batched_encode(paths, pre, self._embed, batch_size, 24)


def _jax_cli(argv, monkeypatch):
    from clip_codec_tpu.cli.encode_images_dino import main

    monkeypatch.setattr(sys, "argv", ["encode_images_dino"] + argv)
    main()


def test_encode_cli_equals_jax(tmp_path, rng, monkeypatch, capsys):
    """cli.encode_images_dino through both packages' CLIs with one stand-in
    encoder: the sorted, non-recursive listing over ``DINO_EXTS`` (a .gif
    kept, a .webp, a text file and a subdirectory's image left out, a corrupt
    .jpg skipped), eps 1e-6: every file byte-equal, ``dim`` an int64 scalar."""
    from clip_codec_tpu_torch.cli import encode_images_dino as cli

    d = tmp_path / "imgs"
    _images(d, rng, [(40, 50), (32, 35), (60, 33)])
    _images(d, rng, [(30, 30)], ext=".gif")
    _images(d, rng, [(30, 31)], ext=".webp")
    _images(d / "sub", rng, [(50, 40)])
    (d / "notes.txt").write_text("not an image")
    (d / "broken.jpg").write_bytes(b"\xff\xd8 corrupt")
    monkeypatch.setattr(jax_encoders, "DinoEncoder", lambda **kw: StandInDino())
    monkeypatch.setattr(encoders, "DinoEncoder", lambda **kw: StandInDino())
    argv = ["--img_dir", str(d), "--device", "cpu"]
    _same_store(tmp_path, lambda s: _jax_cli(argv + ["--out_dir", str(s)], monkeypatch),
                lambda s: cli.main(argv + ["--out_dir", str(s)]))
    assert capsys.readouterr().out.count(f"Encoded 4 images to {tmp_path / 'store'}") == 2
    meta = np.load(tmp_path / "store" / "codec_meta.npz")
    assert meta["dim"].dtype == np.int64 and meta["dim"].shape == () and int(meta["dim"]) == 24
    st = tstore.Store.open(tmp_path / "store")
    z = StandInDino().encode_images(sorted(str(p) for p in d.glob("im*.*") if p.suffix in (".png", ".gif")))[0]
    scale, zero = tq.fit_affine(z, eps=1e-6)
    np.testing.assert_array_equal(st.read_codes(), tq.quantize(z, scale, zero).numpy())
    assert cli.DINO_EXTS == {".jpg", ".jpeg", ".png", ".bmp", ".gif"}


def test_encode_cli_refusals(tmp_path, rng, monkeypatch):
    from clip_codec_tpu_torch.cli import encode_images_dino as cli

    base = ["--img_dir", str(tmp_path), "--out_dir", str(tmp_path / "s"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="Only vit_base_patch14_dinov2"):
        cli.main(base + ["--model_name", "vit_large_patch14_dinov2.lvd142m"])
    with pytest.raises(ValueError, match="No supported image files"):
        cli.main(base)
    (tmp_path / "bad.png").write_bytes(b"not a png")
    monkeypatch.setattr(encoders, "DinoEncoder", lambda **kw: StandInDino())
    with pytest.raises(SystemExit, match="No images encoded"):
        cli.main(base)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(base[:-2])  # --device defaults to cuda


@pytest.mark.parametrize("dim_dtype", ["int32", "int64"])
def test_write_store_dim_dtype_bytes_equal_jax(tmp_path, rng, dim_dtype):
    feats = rng.standard_normal((4, 24)).astype(np.float32)
    paths = [f"/imgs/a/im{i}.png" for i in range(3)] + ["/imgs/b/im0.png"]
    scale, zero = tq.fit_affine(feats, eps=1e-6)
    q = tq.quantize(feats, scale, zero).numpy()
    kw = {} if dim_dtype == "int32" else {"dim_dtype": "int64"}
    _same_store(tmp_path, lambda s: jstore.write_store(s, feats, paths, scale, zero, q, **kw),
                lambda s: tstore.write_store(s, feats, paths, scale, zero, q, **kw))
    assert np.load(tmp_path / "store" / "codec_meta.npz")["dim"].dtype == np.dtype(dim_dtype)
