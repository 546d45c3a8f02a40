"""The SD CLI's feature-inversion branch (``cli/reconstruct_sd_diffusion.py``)
on the CPU: its default flags run CLIP inversion at dim 512 and DINOv2
inversion at dim 32, each PNG equal to ``sample_with_inversion`` called
directly, and its refusals keep the JAX CLI's text. The tiny SD decoder and
towers of tests/test_torch_inversion.py, in a file of their own so that a
``--dist loadfile`` run spreads them over the workers."""

import numpy as np
import pytest
import torch
from PIL import Image

import clip_codec_tpu_torch.encoders as encoders
from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as cli
from clip_codec_tpu_torch.encoders.clip import CLIPConfig
from clip_codec_tpu_torch.encoders.dino import DinoConfig
from clip_codec_tpu_torch.models import sd as tsd
from clip_codec_tpu_torch.ops import int8 as q8
from tests.test_torch_clip import random_clip_sd
from tests.test_torch_compress import hf_layout
from tests.test_torch_dino import TINY as DINO_TINY
from tests.test_torch_dino import random_hf_dino
from tests.test_torch_inversion import TOWER
from tests.test_torch_sd import CLIP_DIM, _seeded, port  # noqa: F401  (port: a fixture)

torch.set_num_threads(1)


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
