"""The port's evaluation (clip_codec_tpu_torch/eval, cli/eval.py) against the
JAX package's ``eval.metrics`` and ``eval.lpips``, on the CPU.

Same seeded numpy images into both packages: ``to_uint8`` (truncation) and
the uint8 quantization on a tensor bit-equal; PSNR within 1e-5 dB; SSIM
within 1e-6; LPIPS at full VGG16 widths on 2 x 32^2 images within 1e-4
relative, both packages reading one file in the ``lpips`` package's layout
(JAX through ``convert_lpips_torch``, the port with ``strict=True``); CLIP
similarity within 1e-4 on the tiny tower of tests/test_torch_compress.py
read by both ``ClipEncoder``s from one HuggingFace-layout file; NaN where a
weights variable is unset, an error where it names a broken file. Then
``cli.eval`` end to end on a tiny pixel store (base 8, 16px): its records
and printed means equal the port's metric functions on the reconstructions
it made, and its refusals hold.
"""

import json
import pickle
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import clip_codec_tpu.encoders as jax_encoders
import clip_codec_tpu_torch.encoders as encoders
from clip_codec_tpu.encoders.clip import CLIPConfig as JaxConfig
from clip_codec_tpu.eval import lpips as jlpips
from clip_codec_tpu.eval import metrics as jm
from clip_codec_tpu_torch.encoders.clip import CLIPConfig
from clip_codec_tpu_torch.eval import lpips as tlpips
from clip_codec_tpu_torch.eval import metrics as tm
from clip_codec_tpu_torch.ops import int8 as q8
from tests.test_torch_clip import TINY, random_clip_sd
from tests.test_torch_compress import hf_layout

torch.set_num_threads(1)


def _pair(rng, shape, noise=0.2):
    """[-1, 1] images and a noisy copy, with values past the range and on
    the quantizer's steps (v / 127.5 - 1 for integer v) mixed in."""
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    steps = rng.random(shape) < 0.2
    a[steps] = rng.integers(0, 256, int(steps.sum())).astype(np.float32) / np.float32(127.5) - 1
    b = np.clip(a + rng.normal(0, noise, shape), -1.1, 1.1).astype(np.float32)
    return a, b


def test_to_uint8_is_bit_equal(rng):
    a, b = _pair(rng, (3, 20, 24, 3))
    for x in (a, b, np.array([-1.0, 1.0, 1.0001, -1.0001, 0.9, 0.0], np.float32)):
        np.testing.assert_array_equal(tm.to_uint8(x), jm.to_uint8(x))
        np.testing.assert_array_equal(tm._u8_float(torch.from_numpy(x)).numpy(), jm.to_uint8(x).astype(np.float32))
    assert tm._to_uint8 is tm.to_uint8 and tm.to_uint8(np.float32(0.9)) == 242


def test_psnr_matches_jax(rng):
    a, b = _pair(rng, (3, 24, 20, 3))
    got = tm.psnr_batch(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jm.psnr_batch(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for i in range(3):
        assert abs(tm.psnr(a[i], b[i]) - jm.psnr(a[i], b[i])) <= 1e-5
        chw = a[i].transpose(2, 0, 1), b[i].transpose(2, 0, 1)
        assert abs(tm.psnr(*chw) - jm.psnr(*chw)) <= 1e-5
    same = tm.psnr_batch(torch.from_numpy(a), torch.from_numpy(a + 1e-4))  # quantizes equal at most places
    assert tm.psnr(a[0], a[0]) == float("inf") and bool(torch.isinf(tm.psnr_batch(*(torch.from_numpy(a),) * 2)).all())
    np.testing.assert_allclose(same.numpy(), np.asarray(jm.psnr_batch(jnp.asarray(a), jnp.asarray(a + 1e-4))),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 24, 24, 3), (1, 16, 21, 3)])
def test_ssim_matches_jax(rng, shape):
    a, b = _pair(rng, shape)
    got = tm.ssim_batch(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jm.ssim_batch(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    chw = a[0].transpose(2, 0, 1)
    assert abs(tm.ssim(chw, b[0]) - jm.ssim(chw, b[0])) <= 1e-6
    assert tm.ssim(a[0], a[0]) == pytest.approx(1.0, abs=1e-6)


@pytest.fixture(scope="module")
def lpips_file(tmp_path_factory):
    """A seeded random LPIPS-VGG16 at full widths, saved as the ``lpips``
    package saves its state dict (with the ``lins.{i}`` aliases of ``lin{i}``)."""
    sd = tlpips.init_params(tlpips.LPIPS(), torch.Generator().manual_seed(7)).state_dict()
    sd.update({f"lins.{i}.model.1.weight": sd[f"lin{i}.model.1.weight"] for i in range(5)})
    p = tmp_path_factory.mktemp("lpips") / "lpips_vgg.pt"
    torch.save(sd, p)
    return p


def test_lpips_matches_jax(rng, lpips_file):
    a, b = _pair(rng, (2, 32, 32, 3), noise=0.3)
    model = tlpips.LPIPSModel.from_checkpoint(lpips_file, device="cpu")
    assert set(torch.load(lpips_file, weights_only=True)) - set(model.model.state_dict()) == {
        f"lins.{i}.model.1.weight" for i in range(5)}
    got = tm.lpips_batch(a, b, lpips_model=model)
    want = np.asarray(jlpips.LPIPSModel.from_checkpoint(lpips_file).distance(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == np.float32 and got.shape == (2,) and float(want.min()) > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert tm.lpips_distance(a[1].transpose(2, 0, 1), b[1], lpips_model=model) == pytest.approx(float(want[1]),
                                                                                                rel=1e-4)
    assert float(tm.lpips_batch(a, a, lpips_model=model).max()) == 0.0


def test_lpips_strict_load_names_what_is_missing(lpips_file, tmp_path):
    sd = torch.load(lpips_file, weights_only=True)
    del sd["net.slice3.12.bias"]
    torch.save(sd, tmp_path / "short.pt")
    with pytest.raises(RuntimeError, match="net.slice3.12.bias"):
        tlpips.LPIPSModel.from_checkpoint(tmp_path / "short.pt", device="cpu")


@pytest.fixture(scope="module")
def clip_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("clip") / "tiny_hf.bin"
    torch.save(hf_layout(random_clip_sd(TINY, 3)), p)
    return str(p)


def test_clip_similarity_matches_jax(rng, clip_file):
    a, b = _pair(rng, (2, 40, 48, 3), noise=0.3)
    jenc = jax_encoders.ClipEncoder(weights_path=clip_file, cfg=JaxConfig(**TINY), dtype=jnp.float32)
    tenc = encoders.ClipEncoder(weights_path=clip_file, cfg=CLIPConfig(**TINY), dtype=torch.float32, device="cpu")
    got = tm.clip_similarity_batch(a, b, encoder=tenc)
    want = jm.clip_similarity_batch(a, b, encoder=jenc)
    assert got.shape == (2,) and float(np.abs(want).max()) < 0.9999
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert abs(tm.clip_similarity(a[0], b[0], encoder=tenc) - jm.clip_similarity(a[0], b[0], encoder=jenc)) <= 1e-4


def test_metrics_read_nan_without_weights_and_raise_on_a_broken_file(rng, monkeypatch, tmp_path):
    a, b = _pair(rng, (2, 16, 16, 3))
    monkeypatch.delenv("CLIP_CODEC_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("CLIP_CODEC_CLIP_WEIGHTS", raising=False)
    assert np.isnan(tm.lpips_batch(a, b, device="cpu")).all() and np.isnan(tm.lpips_distance(a[0], b[0]))
    assert np.isnan(tm.clip_similarity_batch(a, b, device="cpu")).all()
    assert np.isnan(tm.clip_similarity(a[0], b[0]))
    (tmp_path / "broken.pt").write_bytes(b"not a checkpoint")
    monkeypatch.setenv("CLIP_CODEC_LPIPS_WEIGHTS", str(tmp_path / "broken.pt"))
    with pytest.raises(pickle.UnpicklingError):
        tm.lpips_batch(a, b, device="cpu")
    monkeypatch.setenv("CLIP_CODEC_LPIPS_WEIGHTS", str(tmp_path / "missing.pt"))
    with pytest.raises(FileNotFoundError):
        tm.lpips_batch(a, b, device="cpu")
    monkeypatch.setenv("CLIP_CODEC_CLIP_WEIGHTS", str(tmp_path / "missing.bin"))
    with pytest.raises(RuntimeError, match="CLIP_CODEC_CLIP_WEIGHTS"):
        tm.clip_similarity_batch(a, b, device="cpu")


# ---------------------------------------------------------------------- CLI


def _pixel_store(root, rng, n=5, dim=8):
    """A tiny store (PNG images, .clp frames, codec_meta) and a seeded base-8
    U-Net checkpoint with its model_config.json beside it."""
    from clip_codec_tpu_torch.io.bitstream import write_bitstream
    from clip_codec_tpu_torch.models import CLIPCondUNet, init_params
    from clip_codec_tpu_torch.utils.config import ModelConfig

    recs = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)).save(root / f"im{i}.png")
        write_bitstream(rng.integers(0, 256, dim, dtype=np.uint8).tobytes(), dim, root / f"im{i}.clp")
        recs.append({"image": str(root / f"im{i}.png"), "bitstream": str(root / f"im{i}.clp")})
    (root / "manifest.json").write_text(json.dumps(recs))
    np.savez(root / "codec_meta.npz", scale=np.full(dim, 1 / 127.5, np.float32), zero=np.full(dim, -1.0, np.float32))
    mc = ModelConfig(z_dim=dim, base=8, ch_mult=(1, 2), timesteps=50, out_size=16)
    net = init_params(CLIPCondUNet(z_dim=dim, base=8, ch_mult=(1, 2), time_dim=mc.time_dim),
                      torch.Generator().manual_seed(1))
    torch.save(net.state_dict(), root / "unet.pt")
    mc.save(root)
    return root / "unet.pt"


def _means(out: str) -> dict:
    keys = {"PSNR": "psnr", "SSIM": "ssim", "LPIPS": "lpips", "CLIP similarity": "clip_sim"}
    return {keys[k]: float(v) for k, v in re.findall(r"^Average (PSNR|SSIM|LPIPS|CLIP similarity): (\S+)", out, re.M)}


def test_eval_cli_equals_the_metric_functions(tmp_path, rng, lpips_file, clip_file, monkeypatch, capsys):
    """5 frames at batch 2 (the last batch padded), DDIM-3 at 16px: the
    records equal the metric functions on the reconstructions the CLI made,
    the first batch's reconstructions equal the sampler's from a generator
    seeded with --seed, and the printed means are the records' means."""
    from clip_codec_tpu_torch.cli import eval as cli_eval
    from clip_codec_tpu_torch.diffusion import NoiseSchedule, make_sampler
    from clip_codec_tpu_torch.io.store import Store
    from clip_codec_tpu_torch.models import CLIPCondUNet

    weights = _pixel_store(tmp_path, rng)
    real = encoders.ClipEncoder
    monkeypatch.setattr(encoders, "ClipEncoder", lambda **kw: real(**kw, cfg=CLIPConfig(**TINY), dtype=torch.float32))
    monkeypatch.setenv("CLIP_CODEC_LPIPS_WEIGHTS", str(lpips_file))
    monkeypatch.setenv("CLIP_CODEC_CLIP_WEIGHTS", clip_file)
    seen = []
    psnr_batch = cli_eval.psnr_batch
    monkeypatch.setattr(cli_eval, "psnr_batch", lambda o, r: (seen.append((o, r)), psnr_batch(o, r))[1])
    argv = ["--store_dir", str(tmp_path), "--weights", str(weights), "--size", "16", "--steps", "3",
            "--batch_size", "2", "--device", "cpu", "--seed", "3", "--out_json", str(tmp_path / "m.json")]
    cli_eval.main(argv)
    printed = _means(capsys.readouterr().out)
    recs = json.loads((tmp_path / "m.json").read_text())
    assert [r["image"] for r in recs] == [str(tmp_path / f"im{i}.png") for i in range(5)]
    assert [len(r) for _, r in seen] == [2, 2, 1]
    lp = tlpips.LPIPSModel.from_checkpoint(lpips_file, device="cpu")
    enc = real(weights_path=clip_file, cfg=CLIPConfig(**TINY), dtype=torch.float32, device="cpu")
    want = {k: [] for k in ("psnr", "ssim", "lpips", "clip_sim")}
    for orig, rec in seen:  # batch by batch, as the CLI scored them
        want["psnr"].append(tm.psnr_batch(orig, rec).numpy())
        want["ssim"].append(tm.ssim_batch(orig, rec).numpy())
        want["lpips"].append(tm.lpips_batch(orig, rec, lpips_model=lp))
        want["clip_sim"].append(tm.clip_similarity_batch(orig.numpy(), rec.numpy(), encoder=enc))
    for key, vals in want.items():
        vals = np.concatenate(vals)
        assert np.isfinite(vals).all(), key
        np.testing.assert_array_equal(np.array([r[key] for r in recs], np.float32), vals, err_msg=key)
        fmt = "{:.2f}" if key == "psnr" else "{:.4f}"
        assert fmt.format(np.mean([r[key] for r in recs])) == fmt.format(printed[key]), key

    net = CLIPCondUNet(z_dim=8, base=8, ch_mult=(1, 2), time_dim=256, dtype=torch.bfloat16)
    net.load_state_dict(torch.load(weights, weights_only=True))
    store = Store.open(tmp_path)
    z = torch.from_numpy(np.stack([store.decode_vector(i) for i in range(2)]))
    x = make_sampler("ddim", NoiseSchedule.create(50, "cosine")).sample(
        net.eval(), z, (2, 16, 16, 3), steps=3, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(seen[0][1], torch.clamp(x, -1, 1), rtol=0, atol=0)


def test_eval_cli_skips_nan_metrics_and_refuses_what_is_not_ported(tmp_path, rng, monkeypatch, capsys):
    from clip_codec_tpu_torch.cli import eval as cli_eval

    weights = _pixel_store(tmp_path, rng, n=3)
    monkeypatch.delenv("CLIP_CODEC_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("CLIP_CODEC_CLIP_WEIGHTS", raising=False)
    argv = ["--store_dir", str(tmp_path), "--weights", str(weights), "--size", "16", "--steps", "2", "--device", "cpu"]
    cli_eval.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[2:] == ["Average LPIPS: nan", "Average CLIP similarity: nan"]
    assert re.fullmatch(r"Average PSNR: \d+\.\d\d dB", out[0]) and re.fullmatch(r"Average SSIM: -?\d\.\d{4}", out[1])
    with pytest.raises(SystemExit, match="reference-parity ddim"):
        cli_eval.main(argv + ["--data_parallel", "--sampler", "dpmpp"])
    try:  # --int8: the static-int8 U-Net, calibrated first; the same four lines
        cli_eval.main(argv + ["--int8"])
    finally:
        q8.set_int8_conv(False)
    out8 = capsys.readouterr().out.splitlines()
    assert out8[2:] == out[2:] and re.fullmatch(r"Average PSNR: \d+\.\d\d dB", out8[0]) and out8[:2] != out[:2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_eval.main(argv[:-2])
