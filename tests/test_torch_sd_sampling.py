"""The SD-1.5 decoder's sampling against the JAX package, and the SD CLI
(tests/test_torch_sd.py's tiny configs, seeded weights and bounds): DDIM
and DPM-Solver++(2M) with CFG batched and sequential, the JAX initial noise
injected, latents then decoded images within 1e-4 relative; the sampler's
generator and argument checks; the CLI writing a PNG from a .pt store, with
and without --int8. In a file of their own, so that a ``--dist loadfile``
run spreads them over the workers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_codec_tpu_torch.ops import int8 as q8
from tests.test_torch_sd import CLIP_DIM, _close, _decoders, port  # noqa: F401  (port: a fixture)

torch.set_num_threads(1)


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
    with pytest.raises(RuntimeError, match="CLIP_CODEC_SD_UNET_WEIGHTS"):
        cli.main(argv + ["--inv_weight", "0"])
    monkeypatch.setenv("CLIP_CODEC_SD_UNET_WEIGHTS", str(tmp_path / "unet.bin"))
    monkeypatch.setenv("CLIP_CODEC_SD_VAE_WEIGHTS", str(tmp_path / "vae.bin"))
    monkeypatch.delenv("CLIP_CODEC_DINO_WEIGHTS", raising=False)
    with pytest.raises(RuntimeError, match="CLIP_CODEC_DINO_WEIGHTS"):
        cli.main(argv)  # the default --inv_weight 1.0 at dim 32 asks for the DINOv2 backend, here without weights
    cli.main(argv + ["--inv_weight", "0"])
    img = Image.open(tmp_path / "img-2-5-0.png")
    assert img.size == (16, 16) and img.mode == "RGB"
    img = np.asarray(img)
    try:  # --int8: the UNet calibrated on both CFG branches, then sampled in static int8
        cli.main(argv + ["--inv_weight", "0", "--int8"])
    finally:
        q8.set_int8_conv(False)
    got = np.asarray(Image.open(tmp_path / "img-2-5-0.png"))
    from clip_codec_tpu_torch.cli.reconstruct_diffusion import decode_embedding, to_pil

    dec = cli.load_decoder(tmp_path / "unet.bin", tmp_path / "vae.bin", tmp_path / "adapter.pt", "cpu", heads=2,
                           int8=True)
    z = decode_embedding(tmp_path / "img.clp", tmp_path)
    dec.calibrate_int8_scales(torch.from_numpy(z), (1, 8, 8, 4))
    want = np.asarray(to_pil(cli.sample_images(dec, z, 16, 2, "dpmpp")[0].float().numpy()))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, np.asarray(img))
