"""The port's SD adapter training path (clip_codec_tpu_torch/train,
cli/precompute_latents, cli/train_sd) against the JAX package's.

The tiny SD config of tests/test_sd.py (``TINY_UNET``, ``TINY_VAE``) with
seeded JAX parameters carried to the port by ``weights/from_jax.py``.
fp32 throughout. The training loss and the adapter's gradients for the same
injected ``t`` and noise (computed from a PRNG key exactly as the JAX step
does): loss within 1e-5 relative, each gradient within 1e-4 of its largest
magnitude; AdamW against ``optax.adamw`` over three identical gradients
within 1e-6 relative; the EMA update exactly; the uint8 -> [-1, 1] table
bit-equal; batching and store decoding exactly; VAE moments within 1e-4.
Then the two CLIs end to end on a tiny store on the CPU.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from clip_codec_tpu.models import sd as jsd
from clip_codec_tpu.train import sd_diffusion_train as jtrain
from clip_codec_tpu_torch.models import sd as tsd
from clip_codec_tpu_torch.train import sd_diffusion_train as ttrain
from clip_codec_tpu_torch.weights.from_jax import (
    sd_adapter_state_dict_from_jax,
    sd_unet_state_dict_from_jax,
    sd_vae_state_dict_from_jax,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
UCFG = dict(block_out=(8, 16), layers_per_block=1, cross_dim=16, heads=2, freq_dim=8)  # TINY_UNET
VCFG = dict(block_out=(8, 16), layers_per_block=1, latent_ch=4)  # TINY_VAE
CLIP_DIM = 32


def _random_params(module, *args, seed):
    """A JAX parameter tree of ``module``'s structure (``jax.eval_shape`` of
    its init, no compile), drawn with numpy: kernels N(0, 1/fan_in), norm
    scales 1 + 0.05 N(0, 1), biases 0.05 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if len(s.shape) >= 2:  # flax kernels end in (in, out)
            return rng.standard_normal(s.shape).astype(np.float32) / np.sqrt(np.prod(s.shape[:-1]))
        base = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return (base + 0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(module.init, *args)["params"])


@pytest.fixture(scope="module")
def models():
    """Seeded JAX parameters and the port's modules made from them."""
    unet, vae = jsd.SDUNet(jsd.SDUNetConfig(**UCFG)), jsd.AutoencoderKL(jsd.VAEConfig(**VCFG))
    adapter = jsd.SDClipAdapter(in_dim=CLIP_DIM, ctx_dim=16, n_tokens=8)
    key = jax.random.PRNGKey(0)
    jp = dict(
        unet=_random_params(unet, key, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8, 16)),
                            seed=0),
        vae=_random_params(vae, key, jnp.zeros((1, 16, 16, 3)), key, seed=1),
        adapter=_random_params(adapter, key, jnp.zeros((1, CLIP_DIM)), seed=2),
    )
    tu, tv = tsd.SDUNet(tsd.SDUNetConfig(**UCFG)), tsd.AutoencoderKL(tsd.VAEConfig(**VCFG))
    ta = tsd.SDClipAdapter(CLIP_DIM, 16, 1024, 8)
    tu.load_state_dict(sd_unet_state_dict_from_jax(jp["unet"]), strict=True)
    tv.load_state_dict(sd_vae_state_dict_from_jax(jp["vae"]), strict=True)
    ta.load_state_dict(sd_adapter_state_dict_from_jax(jp["adapter"]), strict=True)
    return jp, tsd.StableDiffusionDecoder(tu, tv, ta)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


def test_loss_and_adapter_gradients_match_jax(rng, models):
    """One step of the default loss (eps-MSE + recon_w + tv_w through two
    VAE decodes) at batch 3 with a zero-weight padded row: JAX's step with
    an optimizer that hands back its gradients, and the port's loss with
    the JAX step's ``t`` and noise injected."""
    jp, dec = models
    B = 3
    z = rng.standard_normal((B, CLIP_DIM)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    lat0 = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    w = np.array([1.0, 1.0, 0.0], np.float32)
    cfg_j = jtrain.SDTrainConfig()
    jdec = jsd.StableDiffusionDecoder(jp["vae"], jp["unet"], adapter_params=jp["adapter"], clip_dim=CLIP_DIM,
                                      n_tokens=8, unet_cfg=jsd.SDUNetConfig(**UCFG),
                                      vae_cfg=jsd.VAEConfig(**VCFG), dtype=jnp.float32)
    grads_out = optax.GradientTransformation(lambda p: p, lambda g, s, p=None: (g, g))
    step = jtrain.make_sd_train_step(jdec, grads_out, cfg_j)
    key = jax.random.PRNGKey(7)
    fresh = lambda: jax.tree_util.tree_map(jnp.array, jp["adapter"])  # the step donates its first two
    _, grads, loss_j = step(fresh(), fresh(), {"unet": jp["unet"], "vae": jp["vae"]},
                            jnp.asarray(z), jnp.asarray(lat0), jnp.zeros((B, 16, 16, 3)), jnp.asarray(w), key,
                            perc_on=False)
    t_rng, n_rng = jax.random.split(key)  # as step_fn draws them
    t = np.array(jax.random.randint(t_rng, (B,), 0, cfg_j.timesteps, dtype=jnp.int32))
    noise = np.array(jax.random.normal(n_rng, lat0.shape, dtype=jnp.float32))

    opt = ttrain.make_optimizer(dec.adapter, 1e-4)
    loss_fn = ttrain.make_sd_train_step(dec, opt, ttrain.SDTrainConfig()).loss_fn
    dec.adapter.zero_grad(set_to_none=True)
    loss_t = loss_fn(*(torch.from_numpy(a) for a in (z, lat0, w, t, noise)))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = sd_adapter_state_dict_from_jax(grads)
    for name, p in dec.adapter.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), 1e-4)
    assert all(not p.requires_grad for m in (dec.unet, dec.vae) for p in m.parameters())


@pytest.fixture(scope="module")
def loss_towers():
    """The tiny DINOv2 of tests/test_torch_dino.py and a seeded full-width
    LPIPS-VGG16, each given to both packages."""
    from clip_codec_tpu.encoders import dino as jdino
    from clip_codec_tpu.eval.lpips import convert_lpips_torch
    from clip_codec_tpu_torch.eval import lpips as tlpips
    from clip_codec_tpu_torch.weights.convert_dino import dino_state_dict_from_hf
    from tests.test_torch_dino import TINY, port_dino, random_hf_dino

    hf = random_hf_dino(TINY, 1)
    jdp = {"params": jdino.convert_dino_hf({k: v.numpy() for k, v in hf.items()}, depth=TINY["depth"])}
    lp = tlpips.init_params(tlpips.LPIPS(), torch.Generator().manual_seed(3))
    jm = jdino.DinoV2(jdino.DinoConfig(**TINY))
    jembed = lambda dp, imgs: jdino.embed_m11_images_dino(jm, dp, imgs, TINY["image_size"])
    return dict(jdino=jdp, jlpips=convert_lpips_torch(lp.state_dict()), jembed=jembed,
                dino=port_dino(dino_state_dict_from_hf(hf)), lpips=lp)


@pytest.mark.parametrize("perc_on", [True, False], ids=["perc_on", "perc_off"])
def test_loss_with_dino_and_lpips_matches_jax(rng, models, loss_towers, perc_on):
    """The default loss with both terms of JAX's ``make_sd_train_step(...,
    dino_embed_fn=..., use_lpips=True)`` at batch 3 with a padded row: clip_w
    0.1 through the tiny DINO tower (decoded 16px and ground-truth 20px
    images, both resized to 28), perc_w 0.1 LPIPS against the ground truth
    resized to 16px on a ``perc_on`` step only; loss within 1e-5, adapter
    gradients within 1e-4, as the default loss's."""
    jp, dec = models
    T = loss_towers
    B = 3
    z = rng.standard_normal((B, CLIP_DIM)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    lat0 = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    gt = rng.uniform(-1, 1, (B, 20, 20, 3)).astype(np.float32)
    w = np.array([1.0, 1.0, 0.0], np.float32)
    cfg_j = jtrain.SDTrainConfig()
    assert (cfg_j.clip_w, cfg_j.perc_w) == (0.1, 0.1)
    jdec = jsd.StableDiffusionDecoder(jp["vae"], jp["unet"], adapter_params=jp["adapter"], clip_dim=CLIP_DIM,
                                      n_tokens=8, unet_cfg=jsd.SDUNetConfig(**UCFG),
                                      vae_cfg=jsd.VAEConfig(**VCFG), dtype=jnp.float32)
    grads_out = optax.GradientTransformation(lambda p: p, lambda g, s, p=None: (g, g))
    step = jtrain.make_sd_train_step(jdec, grads_out, cfg_j, dino_embed_fn=T["jembed"], use_lpips=True)
    key = jax.random.PRNGKey(5)
    fresh = lambda: jax.tree_util.tree_map(jnp.array, jp["adapter"])
    frozen = {"unet": jp["unet"], "vae": jp["vae"], "dino": T["jdino"], "lpips": T["jlpips"]}
    _, grads, loss_j = step(fresh(), fresh(), frozen, jnp.asarray(z), jnp.asarray(lat0), jnp.asarray(gt),
                            jnp.asarray(w), key, perc_on=perc_on)
    t_rng, n_rng = jax.random.split(key)
    t = np.array(jax.random.randint(t_rng, (B,), 0, cfg_j.timesteps, dtype=jnp.int32))
    noise = np.array(jax.random.normal(n_rng, lat0.shape, dtype=jnp.float32))

    opt = ttrain.make_optimizer(dec.adapter, 1e-4)
    loss_fn = ttrain.make_sd_train_step(dec, opt, ttrain.SDTrainConfig(), dino=T["dino"], lpips=T["lpips"]).loss_fn
    dec.adapter.zero_grad(set_to_none=True)
    args = [torch.from_numpy(a) for a in (z, lat0, w, t, noise)]
    loss_t = loss_fn(*args, gt_img=torch.from_numpy(gt), perc_on=perc_on)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = sd_adapter_state_dict_from_jax(grads)
    for name, p in dec.adapter.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), 1e-4)
    with torch.no_grad():  # the terms are in the loss: it moves without them
        plain = ttrain.make_sd_train_step(dec, opt, ttrain.SDTrainConfig()).loss_fn(*args)
    assert abs(plain.item() - loss_t.item()) > 1e-3 * abs(loss_t.item())
    assert not any(p.requires_grad for m in (T["dino"], T["lpips"]) for p in m.parameters())


def test_adamw_matches_optax(rng):
    lr = 1e-3
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()} for _ in range(3)]
    tx = optax.adamw(lr)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    mod = torch.nn.Module()
    for k, v in params.items():
        mod.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = ttrain.make_optimizer(mod, lr)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in mod.named_parameters():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in mod.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=0)


def test_ema_update_is_the_jax_formula(rng):
    d = 0.999
    e = {"a": rng.standard_normal(64).astype(np.float32)}
    p = {"a": rng.standard_normal(64).astype(np.float32)}
    ema = {k: torch.from_numpy(v.copy()) for k, v in e.items()}
    ttrain.ema_update(ema, {k: torch.from_numpy(v) for k, v in p.items()}, d)
    df = np.float32(d)
    np.testing.assert_array_equal(ema["a"].numpy(), e["a"] * df + p["a"] * (np.float32(1.0) - df))


def test_losses_match_jax(rng):
    from clip_codec_tpu.train import losses as jl
    from clip_codec_tpu_torch.train import losses as tl

    a, b = (rng.standard_normal((3, 6, 5, 4)).astype(np.float32) for _ in range(2))
    w = np.array([1.0, 0.0, 1.0], np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("eps_mse", "l1"):
        np.testing.assert_allclose(getattr(tl, name)(ta, tb).numpy(), np.asarray(getattr(jl, name)(a, b)), rtol=1e-6)
    np.testing.assert_allclose(tl.total_variation(ta).numpy(), np.asarray(jl.total_variation(a)), rtol=1e-6)
    per = tl.eps_mse(ta, tb)
    np.testing.assert_allclose(tl.weighted_mean(per, torch.from_numpy(w)).item(),
                               float(jl.weighted_mean(jnp.asarray(per.numpy()), jnp.asarray(w))), rtol=1e-6)
    assert tl.weighted_mean(per, torch.zeros(3)).item() == 0.0  # an all-padding batch divides by 1


def test_host_data_helpers_match_jax(tmp_path, rng):
    from clip_codec_tpu.train import data as jdata
    from clip_codec_tpu.utils.batching import padded_index_batches as j_batches
    from clip_codec_tpu_torch.train import data as tdata
    from clip_codec_tpu_torch.utils.batching import pad_rows, padded_index_batches

    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    host = u8.astype(np.float32) / 127.5 - 1.0
    np.testing.assert_array_equal(tdata.scale_m11_u8(torch.from_numpy(u8)).numpy(), host)
    np.testing.assert_array_equal(np.asarray(jdata.scale_m11_u8(jnp.asarray(u8))), host)
    Image.fromarray(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)).save(tmp_path / "a.png")
    np.testing.assert_array_equal(tdata.load_image_u8(tmp_path / "a.png", 24), jdata.load_image_u8(tmp_path / "a.png", 24))
    np.testing.assert_array_equal(tdata.load_image_m11(tmp_path / "a.png", 24),
                                  jdata.load_image_m11(tmp_path / "a.png", 24))
    order = rng.permutation(10)
    for n, b in ((10, 4), (10, 5), (3, 4)):
        got, want = list(padded_index_batches(n, b, order[:n] if n < 10 else order)), \
            list(j_batches(n, b, order[:n] if n < 10 else order))
        assert len(got) == len(want)
        for (i1, w1), (i2, w2) in zip(got, want):
            np.testing.assert_array_equal(i1, i2)
            np.testing.assert_array_equal(w1, w2)
    assert pad_rows(np.ones((3, 2)), 4).tolist() == [[1, 1]] * 3 + [[0, 0]]


def _store(root: Path, rng, n=5, size=(20, 24)):
    """A tiny store: PNG images, .clp frames of random codes, codec_meta."""
    from clip_codec_tpu_torch.io.bitstream import write_bitstream

    root.mkdir(parents=True, exist_ok=True)
    recs = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(root / f"im{i}.png")
        write_bitstream(rng.integers(0, 256, CLIP_DIM, dtype=np.uint8).tobytes(), CLIP_DIM, root / f"im{i}.clp")
        recs.append({"image": str(root / f"im{i}.png"), "bitstream": str(root / f"im{i}.clp")})
    (root / "manifest.json").write_text(json.dumps(recs))
    np.savez(root / "codec_meta.npz", scale=np.full(CLIP_DIM, 1 / 127.5, np.float32),
             zero=np.full(CLIP_DIM, -1.0, np.float32), dim=np.int32(CLIP_DIM))
    return recs


def test_store_decoding_matches_jax(tmp_path, rng):
    from clip_codec_tpu.io.store import Store as JStore
    from clip_codec_tpu.io.store import dedupe_stems as j_dedupe
    from clip_codec_tpu_torch.io.store import Store, dedupe_stems

    _store(tmp_path, rng)
    a, b = Store.open(tmp_path), JStore.open(tmp_path)
    assert a.dim == b.dim == CLIP_DIM and len(a) == len(b) == 5
    np.testing.assert_array_equal(a.read_codes(), b.read_codes())
    np.testing.assert_array_equal(a.decode_all(), b.decode_all())
    np.testing.assert_array_equal(a.decode_vector(2), b.decode_vector(2))
    paths = ["x/a.png", "y/a.png", "a.jpg", "b.png"]
    assert dedupe_stems(paths) == j_dedupe(paths) == ["a", "a__1", "a__2", "b"]


def test_precompute_latents_matches_jax_encoder(tmp_path, rng, models):
    """Moments and latents for the same injected noise against the JAX VAE;
    the files: fp16 CHW under the key ``lat`` and the manifest."""
    from clip_codec_tpu_torch.cli.precompute_latents import encode_latents, precompute_latents

    jp, dec = models
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    vae = jsd.AutoencoderKL(jsd.VAEConfig(**VCFG))
    mj = np.asarray(vae.apply({"params": jp["vae"]}, jnp.asarray(x), method=jsd.AutoencoderKL.encode_moments))
    with torch.no_grad():
        mt = dec.vae.encode_moments(torch.from_numpy(x))
        lat = encode_latents(dec.vae, torch.from_numpy(x), noise=torch.from_numpy(noise))
    _close(mt.numpy(), mj, 1e-4)
    mean, logvar = np.split(mj, 2, axis=-1)
    _close(lat.numpy(), (mean + np.exp(0.5 * np.clip(logvar, -30, 20)) * noise) * jsd.SD_SCALING_FACTOR, 1e-4)

    recs = _store(tmp_path, rng, n=3)
    meta = precompute_latents(tmp_path, dec.vae, size=16, batch_size=2, generator=torch.Generator().manual_seed(0))
    on_disk = json.loads((tmp_path / "manifest_latents.json").read_text())
    assert on_disk == meta and [r["image"] for r in meta] == [r["image"] for r in recs]
    for r in on_disk:
        assert r["latent"] == str(tmp_path / "latents" / (Path(r["image"]).stem + ".npz"))
        with np.load(r["latent"]) as f:
            assert list(f.keys()) == ["lat"] and f["lat"].dtype == np.float16 and f["lat"].shape == (4, 8, 8)


def test_cli_trains_resumes_and_reconstructs(tmp_path, rng, models, monkeypatch):
    """precompute_latents then train_sd for 1 epoch on the CPU, --resume to
    a second epoch, and the final adapter drives the SD reconstruct CLI to a
    PNG; --distributed without a launcher is refused; a DINO or LPIPS
    variable that names a missing file is an error where its term is on."""
    from clip_codec_tpu_torch.cli import precompute_latents, reconstruct_sd_diffusion, train_sd

    _, dec = models
    _store(tmp_path, rng)
    torch.save(dec.unet.state_dict(), tmp_path / "unet.bin")
    torch.save(dec.vae.state_dict(), tmp_path / "vae.bin")
    monkeypatch.setenv("CLIP_CODEC_SD_UNET_WEIGHTS", str(tmp_path / "unet.bin"))
    monkeypatch.setenv("CLIP_CODEC_SD_VAE_WEIGHTS", str(tmp_path / "vae.bin"))
    precompute_latents.main(["--store_dir", str(tmp_path), "--size", "16", "--device", "cpu"])
    base = ["--store_dir", str(tmp_path), "--heads", "2", "--device", "cpu", "--batch_size", "2"]
    train_sd.main(base + ["--epochs", "1", "--ema_decay", "0.9"])
    names = {p.name for p in tmp_path.iterdir()}
    assert {"sd_adapter_ep1.pt", "sd_adapter_final.pt", "sd_adapter_ema_final.pt"} <= names
    first = torch.load(tmp_path / "sd_adapter_final.pt", weights_only=True)
    train_sd.main(base + ["--epochs", "2", "--resume"])
    assert (tmp_path / "sd_adapter_ep2.pt").exists() and not (tmp_path / "sd_adapter_ep3.pt").exists()
    assert sorted(p.name for p in (tmp_path / "state_sd").iterdir()) == ["state_1.pt", "state_2.pt"]
    assert torch.load(tmp_path / "state_sd" / "state_2.pt", weights_only=True)["epoch"] == 2
    second = torch.load(tmp_path / "sd_adapter_final.pt", weights_only=True)
    assert any(not torch.equal(first[k], second[k]) for k in first)
    reconstruct_sd_diffusion.main(["--store_dir", str(tmp_path), "--bitstream", str(tmp_path / "im0.clp"),
                                   "--adapter", str(tmp_path / "sd_adapter_final.pt"), "--steps", "2",
                                   "--sampler", "dpmpp", "--size", "16", "--heads", "2", "--device", "cpu",
                                   "--inv_weight", "0"])
    assert Image.open(tmp_path / "im0-2-5-0.png").size == (16, 16)
    with pytest.raises(SystemExit, match="launcher's environment"):
        train_sd.main(base + ["--distributed"])
    monkeypatch.setenv("CLIP_CODEC_DINO_WEIGHTS", str(tmp_path / "dino.pt"))
    with pytest.raises(RuntimeError, match="CLIP_CODEC_DINO_WEIGHTS"):
        train_sd.main(base)
    train_sd.main(base + ["--epochs", "2", "--clip_w", "0", "--resume"])  # the term is off: its file is not read
    monkeypatch.setenv("CLIP_CODEC_LPIPS_WEIGHTS", str(tmp_path / "lpips.pt"))
    with pytest.raises(FileNotFoundError, match="lpips.pt"):
        train_sd.main(base + ["--clip_w", "0"])


def test_cli_trains_with_dino_and_lpips(tmp_path, rng, models, monkeypatch):
    """train_sd with both variables set (the tiny DINOv2 as a HuggingFace-
    layout file, a seeded LPIPS-VGG16 in the ``lpips`` layout) and both
    weights at their defaults: every step gets the frozen tower and the
    ground-truth images at ``--out_size``, LPIPS on steps 0 and 2 of three
    (``--perc_every 2``), and the adapter trains."""
    import clip_codec_tpu_torch.encoders as encoders
    from clip_codec_tpu_torch.cli import precompute_latents, train_sd
    from clip_codec_tpu_torch.encoders.dino import DinoConfig, DinoV2
    from clip_codec_tpu_torch.eval import lpips as tlpips
    from tests.test_torch_dino import TINY, random_hf_dino

    _, dec = models
    _store(tmp_path, rng)
    torch.save(dec.unet.state_dict(), tmp_path / "unet.bin")
    torch.save(dec.vae.state_dict(), tmp_path / "vae.bin")
    torch.save(random_hf_dino(TINY, 2), tmp_path / "dino.bin")
    torch.save(tlpips.init_params(tlpips.LPIPS(), torch.Generator().manual_seed(4)).state_dict(),
               tmp_path / "lpips.pt")
    for env, name in (("SD_UNET", "unet.bin"), ("SD_VAE", "vae.bin"), ("DINO", "dino.bin"), ("LPIPS", "lpips.pt")):
        monkeypatch.setenv(f"CLIP_CODEC_{env}_WEIGHTS", str(tmp_path / name))
    real = encoders.DinoEncoder
    monkeypatch.setattr(encoders, "DinoEncoder",
                        lambda **kw: real(**kw, cfg=DinoConfig(**TINY), dtype=torch.float32))
    calls = []
    make = ttrain.make_sd_train_step

    def recording(decoder, optimizer, cfg, ema=None, dino=None, lpips=None):
        step = make(decoder, optimizer, cfg, ema, dino=dino, lpips=lpips)

        def wrapped(z, lat0, weight, t, noise, gt_img=None, perc_on=False):
            calls.append((type(dino), type(lpips), tuple(gt_img.shape), gt_img.dtype, perc_on))
            return step(z, lat0, weight, t, noise, gt_img, perc_on)

        return wrapped

    monkeypatch.setattr(ttrain, "make_sd_train_step", recording)
    precompute_latents.main(["--store_dir", str(tmp_path), "--size", "16", "--device", "cpu"])
    train_sd.main(["--store_dir", str(tmp_path), "--heads", "2", "--device", "cpu", "--batch_size", "2",
                   "--epochs", "1", "--out_size", "20", "--perc_every", "2", "--save_dir", str(tmp_path / "out")])
    assert calls == [(DinoV2, tlpips.LPIPS, (2, 20, 20, 3), torch.float32, on) for on in (True, False, True)]
    from clip_codec_tpu_torch.models import init_params

    start = init_params(tsd.SDClipAdapter(CLIP_DIM, 16, n_tokens=8), torch.Generator().manual_seed(0)).state_dict()
    final = torch.load(tmp_path / "out" / "sd_adapter_final.pt", weights_only=True)
    assert final.keys() == start.keys() and any(not torch.equal(final[k], start[k]) for k in start)


def test_training_modules_import_no_jax(tmp_path, models):
    """In a process with no jax: a DINO encode of two images through
    cli.encode_images_dino (a seeded tiny tower written as a HuggingFace-
    layout file), one training step with the DINO term on, and a VAE encode."""
    from tests.test_torch_dino import TINY as DINO_TINY

    _, dec = models
    for i, hw in enumerate([(30, 40), (50, 20)]):
        (tmp_path / "imgs").mkdir(exist_ok=True)
        Image.fromarray(np.full(hw + (3,), 40 * i + 20, np.uint8)).save(tmp_path / "imgs" / f"im{i}.png")
    torch.save(dec.unet.state_dict(), tmp_path / "unet.pt")
    torch.save(dec.vae.state_dict(), tmp_path / "vae.pt")
    code = (
        "import sys, torch\n"
        "from clip_codec_tpu_torch.cli import precompute_latents, train_sd\n"
        "from clip_codec_tpu_torch.cli.reconstruct_sd_diffusion import load_frozen\n"
        "from clip_codec_tpu_torch.models.sd import SDClipAdapter, StableDiffusionDecoder\n"
        "from clip_codec_tpu_torch.train import sd_diffusion_train as tr\n"
        "import clip_codec_tpu_torch.io.store, clip_codec_tpu_torch.train.data, clip_codec_tpu_torch.utils.logging\n"
        f"u, v = load_frozen({str(tmp_path / 'unet.pt')!r}, {str(tmp_path / 'vae.pt')!r}, 'cpu', heads=2)\n"
        "d = StableDiffusionDecoder(u, v, SDClipAdapter(32, 16, 64, 8))\n"
        "from clip_codec_tpu_torch.encoders import dino\n"
        "from clip_codec_tpu_torch.weights import convert_dino\n"
        "from clip_codec_tpu_torch.cli import encode_images_dino\n"
        "import clip_codec_tpu_torch.encoders as E\n"
        "g = torch.Generator().manual_seed(0)\n"
        f"cfg = dino.DinoConfig(**{DINO_TINY!r})\n"
        "tower = dino.init_params(dino.DinoV2(cfg), g)\n"
        f"torch.save(convert_dino.dino_state_dict_to_hf(tower.state_dict()), {str(tmp_path / 'dino.bin')!r})\n"
        "real = E.DinoEncoder\n"
        "E.DinoEncoder = lambda **kw: real(**kw, cfg=cfg, dtype=torch.float32)\n"
        f"encode_images_dino.main(['--img_dir', {str(tmp_path / 'imgs')!r}, '--out_dir', {str(tmp_path / 's')!r},\n"
        f"                         '--weights', {str(tmp_path / 'dino.bin')!r}, '--device', 'cpu'])\n"
        "step = tr.make_sd_train_step(d, tr.make_optimizer(d.adapter, 1e-4), tr.SDTrainConfig(), dino=tower)\n"
        "lat = torch.randn((2, 8, 8, 4), generator=g)\n"
        "loss = step(torch.randn((2, 32), generator=g), lat, torch.ones(2), torch.tensor([3, 500]), torch.randn_like(lat),\n"
        "            torch.rand((2, 20, 20, 3), generator=g) * 2 - 1)\n"
        "assert bool(torch.isfinite(loss))\n"
        "x = precompute_latents.encode_latents(v, torch.zeros((1, 16, 16, 3)), generator=g)\n"
        "assert x.shape == (1, 8, 8, 4)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'clip_codec_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax', 'clip_codec_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok" and "Encoded 2 images" in out.stdout
