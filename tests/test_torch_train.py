"""The port's pixel-decoder training path (clip_codec_tpu_torch/train,
cli/train) against the JAX package's.

Tiny config: ch_mult=(1,2), z_dim=8, 16px, fp32; base=8 for the forward,
base=16 for gradients (at base 8 the first stage's 8 groups hold one channel
each, so GroupNorm makes some gradients exactly zero in theory and rounding
noise in practice). Weights cross by
``weights/from_jax.py``; ``t`` and the noise are the ones the JAX step draws
from its key, injected into the port's loss. The direct-form U-Net's eps
within 1e-4 of JAX's ``fused_pallas=False`` forward and within 2e-4 of the
port's own fused form (the JAX package's fused-vs-direct bound); the loss
within 1e-5 relative and every parameter gradient within 1e-4 of its largest
magnitude, with JAX's GroupNorm+SiLU on its jnp version and on its Pallas
kernel (interpret mode); one AdamW step within 1e-6 of optax.adamw's; remat
gradients equal to direct ones (those checks against JAX's U-Net and step:
tests/test_torch_train_jax.py); store batches bit-equal; the CLIP term
within 1e-6. Then the CLI end to end on a tiny store on the CPU.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_codec_tpu_torch.models import CLIPCondUNet, init_params
from clip_codec_tpu_torch.train import diffusion_train as ttrain

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(z_dim=8, base=16, ch_mult=(1, 2))
B, SIZE = 3, 16


@pytest.mark.parametrize("stop_grad", [True, False])
def test_clip_alignment_matches_jax(rng, stop_grad):
    """A toy linear embed fn: the value, and the gradient (zero under
    stop-grad, the reference's quirk)."""
    from clip_codec_tpu.train.losses import clip_alignment as jax_align
    from clip_codec_tpu_torch.train.losses import clip_alignment

    x = rng.uniform(-1, 1, (3, 4, 4, 3)).astype(np.float32)
    z = rng.standard_normal((3, 8)).astype(np.float32)
    W = rng.standard_normal((48, 8)).astype(np.float32)
    f = lambda xx: jnp.sum(jax_align(xx, jnp.asarray(z), lambda im: im.reshape(3, -1) @ W, stop_grad)
                           * jnp.arange(1.0, 4.0))
    want, gx = jax.value_and_grad(f)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    per = clip_alignment(tx, torch.from_numpy(z), lambda im: im.reshape(3, -1) @ torch.from_numpy(W), stop_grad)
    got = (per * torch.arange(1.0, 4.0)).sum()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    if stop_grad:
        assert not got.requires_grad and not np.any(np.asarray(gx))
    else:
        got.backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-6)


def _store(root: Path, rng, n=5, size=(20, 24), dim=8):
    """A tiny store: PNG images, .clp frames of random codes, codec_meta."""
    from clip_codec_tpu_torch.io.bitstream import write_bitstream

    root.mkdir(parents=True, exist_ok=True)
    recs = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(root / f"im{i}.png")
        write_bitstream(rng.integers(0, 256, dim, dtype=np.uint8).tobytes(), dim, root / f"im{i}.clp")
        recs.append({"image": str(root / f"im{i}.png"), "bitstream": str(root / f"im{i}.clp")})
    (root / "manifest.json").write_text(json.dumps(recs))
    np.savez(root / "codec_meta.npz", scale=np.full(dim, 1 / 127.5, np.float32),
             zero=np.full(dim, -1.0, np.float32), dim=np.int32(dim))


@pytest.mark.parametrize("u8", [True, False], ids=["u8", "fp32"])
@pytest.mark.parametrize("cache,workers", [(False, 0), (True, 2)], ids=["plain", "cached_pooled"])
def test_store_data_batches_match_jax(tmp_path, rng, u8, cache, workers):
    """Two epochs at batch 2 over 5 images (a padded tail each epoch), the
    second epoch reading the cache when it is on."""
    from clip_codec_tpu.train.data import StoreData as JaxStoreData
    from clip_codec_tpu_torch.train.data import StoreData

    _store(tmp_path, rng)
    ours = StoreData(tmp_path, out_size=12, workers=workers, cache_images=cache)
    ref = JaxStoreData(tmp_path, out_size=12)
    assert ours.z_dim == ref.z_dim == 8 and len(ours) == len(ref) == 5
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(2):
        got = list(ours.epoch(2, r1, u8=u8))
        want = list(ref.epoch(2, r2, u8=u8))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.x0.dtype == b.x0.dtype == (np.uint8 if u8 else np.float32)
            for f in ("x0", "z", "weight"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert a.wsum == b.wsum
        assert got[-1].wsum == 1.0 and got[-1].weight.tolist() == [1.0, 0.0]
    assert (ours._cache is not None) == cache


def test_cli_trains_resumes_and_reconstructs(tmp_path, rng):
    """cli.train for 1 epoch on the CPU (with an EMA), --resume to a second,
    and the final checkpoint drives cli.reconstruct_diffusion to a PNG;
    --spatial_shard and --distributed stop without a launcher, and
    train_diffusion(spatial=True) without a mesh refuses with JAX's text
    (--clip_weights runs in tests/test_torch_compress.py, --data_parallel in
    tests/test_torch_parallel_train.py, --spatial_shard under a launcher in
    tests/test_torch_spatial_train.py)."""
    from clip_codec_tpu_torch.cli import reconstruct_diffusion, train

    _store(tmp_path, rng)
    base = ["--store_dir", str(tmp_path), "--device", "cpu", "--base", "8", "--ch_mult", "1,2", "--out_size", "16",
            "--timesteps", "50", "--batch_size", "2", "--no_bf16", "--data_workers", "2", "--cache_images"]
    train.main(base + ["--epochs", "1", "--ema_decay", "0.9"])
    names = {p.name for p in tmp_path.iterdir()}
    assert {"diffusion_unet_ep1.pt", "diffusion_unet_final.pt", "diffusion_unet_ema_final.pt",
            "model_config.json"} <= names
    mc = json.loads((tmp_path / "model_config.json").read_text())
    assert (mc["base"], mc["ch_mult"], mc["timesteps"], mc["out_size"], mc["z_dim"]) == (8, [1, 2], 50, 16, 8)
    first = torch.load(tmp_path / "diffusion_unet_final.pt", weights_only=True)
    train.main(base + ["--epochs", "2", "--resume"])
    assert (tmp_path / "diffusion_unet_ep2.pt").exists() and not (tmp_path / "diffusion_unet_ep3.pt").exists()
    assert sorted(p.name for p in (tmp_path / "state").iterdir()) == ["state_1.pt", "state_2.pt"]
    assert torch.load(tmp_path / "state" / "state_2.pt", weights_only=True)["epoch"] == 2
    second = torch.load(tmp_path / "diffusion_unet_final.pt", weights_only=True)
    assert set(second) == set(CLIPCondUNet(**dict(CFG, base=8), time_dim=256).state_dict())
    assert any(not torch.equal(first[k], second[k]) for k in first)
    out = tmp_path / "recon.png"
    reconstruct_diffusion.main(["--store_dir", str(tmp_path), "--bitstream", str(tmp_path / "im0.clp"),
                                "--weights", str(tmp_path / "diffusion_unet_final.pt"), "--steps", "2",
                                "--size", "16", "--device", "cpu", "--out", str(out)])
    assert Image.open(out).size == (16, 16)
    for flags, match in ((["--distributed"], "launcher's environment"),
                         (["--spatial_shard", "2"], "--spatial_shard 2 needs the launcher's environment.*torchrun")):
        with pytest.raises(SystemExit, match=match):
            train.main(base + flags)
    with pytest.raises(ValueError, match=r"spatial=True requires a mesh \(make_mesh\(model_parallel=k\)\)"):
        ttrain.train_diffusion(tmp_path, device="cpu", spatial=True)


def test_train_diffusion_is_seeded(tmp_path, rng):
    """Two runs from one seed write the same parameters; the init is
    init_params' from a generator seeded with ``seed``."""
    _store(tmp_path, rng, n=3)
    cfg = ttrain.DiffusionTrainConfig(out_size=16, epochs=1, batch_size=2, timesteps=20, base=8, ch_mult=(1, 2),
                                      bf16=False, seed=5)
    a = torch.load(ttrain.train_diffusion(tmp_path, config=cfg, save_dir=tmp_path / "a", device="cpu"),
                   weights_only=True)
    b = torch.load(ttrain.train_diffusion(tmp_path, config=cfg, save_dir=tmp_path / "b", device="cpu"),
                   weights_only=True)
    init = init_params(CLIPCondUNet(**dict(CFG, base=8), time_dim=256), torch.Generator().manual_seed(5)).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert any(not torch.equal(a[k], init[k]) for k in a)
