"""The port's data-parallel training (train/diffusion_train.py,
train/sd_diffusion_train.py, cli/train.py, cli/train_sd.py with a mesh)
against the JAX package's single-device steps and the port's one-rank runs,
on the CPU.

The port runs as two gloo ranks in one launch (tests/torch_dp_worker.py
``train``). Two steps of each trainer on a global batch of 4 with ``t`` and
the noise the JAX step draws from its key injected, fp32, weights from
``weights/from_jax.py``; the second step's tail is padding, so rank 1
holds only weight-0 rows there. The pixel U-Net at base 16 (at base 8 some
gradients are rounding noise, which AdamW would scale up to lr), the SD
adapter through the tiny SD config with its DINO and LPIPS terms on: losses
within 1e-5 relative and updated parameters within 1e-4 of JAX's
``optax.adamw`` steps and of the port's steps on one rank; both ranks'
parameters bit-equal. Then ``cli.train --data_parallel`` and
``cli.train_sd --data_parallel`` leave checkpoints within 1e-4 of the
one-rank CLIs', and a global batch that does not divide refuses with JAX's
message. ``cli.train --spatial_shard`` without a launcher's environment
stops naming torchrun (the spatial trainer's own checks:
tests/test_torch_spatial_train.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_codec_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from clip_codec_tpu.models import CLIPCondUNet as JaxUNet
from clip_codec_tpu.models import sd as jsd
from clip_codec_tpu.train import diffusion_train as jtrain
from clip_codec_tpu.train import sd_diffusion_train as jsdtrain
from clip_codec_tpu_torch.diffusion import NoiseSchedule
from clip_codec_tpu_torch.models import CLIPCondUNet
from clip_codec_tpu_torch.models import sd as tsd
from clip_codec_tpu_torch.train import diffusion_train as ptrain
from clip_codec_tpu_torch.train import sd_diffusion_train as strain
from clip_codec_tpu_torch.train.optim import make_optimizer
from clip_codec_tpu_torch.weights.from_jax import (sd_adapter_state_dict_from_jax, sd_unet_state_dict_from_jax,
                                                   sd_vae_state_dict_from_jax, unet_state_dict_from_jax)
from tests.test_torch_unet import flax_like_unet_params
from tests.torch_dp_worker import run_ranks, store_images

torch.set_num_threads(1)

CFG = dict(z_dim=8, base=16, ch_mult=(1, 2))
UCFG = dict(block_out=(8, 16), layers_per_block=1, cross_dim=16, heads=2, freq_dim=8)
VCFG = dict(block_out=(8, 16), layers_per_block=1, latent_ch=4)
CLIP_DIM, B = 32, 4
WEIGHTS = [np.ones(B, np.float32), np.array([1, 1, 0, 0], np.float32)]  # step 2: rank 1 holds only padding


def _draws(key, shape, timesteps=1000):
    """The t and noise JAX's steps draw from ``key``."""
    t_rng, n_rng = jax.random.split(key)
    return (np.array(jax.random.randint(t_rng, (shape[0],), 0, timesteps, dtype=jnp.int32)),
            np.array(jax.random.normal(n_rng, shape, dtype=jnp.float32)))


def _close_state(got, want, atol):
    assert set(got) == set(want)
    for k in want:
        err = (got[k].float() - want[k].float()).abs().max().item()
        assert err <= atol, (k, err)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's two steps of each trainer, the port's on one rank, then the
    port's two ranks (steps and CLIs)."""
    from clip_codec_tpu_torch.cli import precompute_latents
    from clip_codec_tpu_torch.eval import lpips as tlpips
    from clip_codec_tpu_torch.weights.convert_dino import dino_state_dict_from_hf
    from tests.test_torch_dino import TINY, random_hf_dino
    from tests.test_torch_sd_train import _random_params

    work = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(3)
    res = {"work": work}

    # the pixel trainer: JAX's steps with optax.adamw
    jparams = flax_like_unet_params(CFG)
    torch.save(unet_state_dict_from_jax(jparams, CFG["ch_mult"]), work / "unet16.pt")
    x0 = rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((B, 8)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    cfg_j = jtrain.DiffusionTrainConfig(base=16, ch_mult=(1, 2), bf16=False)
    tx = optax.adamw(cfg_j.lr)
    step = jtrain.make_train_step(JaxUNet(**CFG, fused_pallas=False), JaxSchedule.create(1000, "cosine"), tx, cfg_j)
    params = jax.tree_util.tree_map(jnp.array, jparams)
    opt_state = tx.init(params)
    ts, noises, res["px_loss_jax"] = [], [], []
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(11), 2)):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(x0), jnp.asarray(z), jnp.asarray(WEIGHTS[i]),
                                       key, False)
        t, noise = _draws(key, x0.shape)
        ts.append(t)
        noises.append(noise)
        res["px_loss_jax"].append(float(loss))
    res["px_params_jax"] = unet_state_dict_from_jax(params, CFG["ch_mult"])
    np.savez(work / "px_in.npz", x0=x0, z=z, w=np.stack(WEIGHTS), t=np.stack(ts), noise=np.stack(noises))
    net = CLIPCondUNet(**CFG, time_dim=256, fused_pallas=False)
    net.load_state_dict(torch.load(work / "unet16.pt", weights_only=True), strict=True)
    pcfg = ptrain.DiffusionTrainConfig(base=16, ch_mult=(1, 2), bf16=False)
    pstep = ptrain.make_train_step(net, NoiseSchedule.create(1000, "cosine"), make_optimizer(net, pcfg.lr), pcfg)
    res["px_loss_one"] = [float(pstep(*map(torch.from_numpy, (x0, z, WEIGHTS[i], ts[i], noises[i]))))
                          for i in range(2)]
    res["px_params_one"] = net.state_dict()

    # the SD adapter trainer with DINO and LPIPS
    unet, vae = jsd.SDUNet(jsd.SDUNetConfig(**UCFG)), jsd.AutoencoderKL(jsd.VAEConfig(**VCFG))
    key = jax.random.PRNGKey(0)
    jp = dict(
        unet=_random_params(unet, key, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8, 16)),
                            seed=0),
        vae=_random_params(vae, key, jnp.zeros((1, 16, 16, 3)), key, seed=1),
        adapter=_random_params(jsd.SDClipAdapter(in_dim=CLIP_DIM, ctx_dim=16, n_tokens=8), key,
                               jnp.zeros((1, CLIP_DIM)), seed=2))
    for name, conv in (("unet", sd_unet_state_dict_from_jax), ("vae", sd_vae_state_dict_from_jax),
                       ("adapter", sd_adapter_state_dict_from_jax)):
        torch.save(conv(jp[name]), work / f"sd_{name}.pt")
    from clip_codec_tpu.encoders import dino as jdino
    from clip_codec_tpu.eval.lpips import convert_lpips_torch

    hf = random_hf_dino(TINY, 1)
    torch.save(dino_state_dict_from_hf(hf), work / "dino.pt")
    lp = tlpips.init_params(tlpips.LPIPS(), torch.Generator().manual_seed(3))
    torch.save(lp.state_dict(), work / "lpips.pt")
    jm = jdino.DinoV2(jdino.DinoConfig(**TINY))
    frozen = {"unet": jp["unet"], "vae": jp["vae"],
              "dino": {"params": jdino.convert_dino_hf({k: v.numpy() for k, v in hf.items()}, depth=TINY["depth"])},
              "lpips": convert_lpips_torch(lp.state_dict())}
    jdec = jsd.StableDiffusionDecoder(jp["vae"], jp["unet"], adapter_params=jp["adapter"], clip_dim=CLIP_DIM,
                                      n_tokens=8, unet_cfg=jsd.SDUNetConfig(**UCFG), vae_cfg=jsd.VAEConfig(**VCFG),
                                      dtype=jnp.float32)
    stx = optax.adamw(1e-4)
    sstep = jsdtrain.make_sd_train_step(
        jdec, stx, jsdtrain.SDTrainConfig(),
        dino_embed_fn=lambda dp, imgs: jdino.embed_m11_images_dino(jm, dp, imgs, TINY["image_size"]), use_lpips=True)
    sz = rng.standard_normal((B, CLIP_DIM)).astype(np.float32)
    sz /= np.linalg.norm(sz, axis=1, keepdims=True)
    lat0 = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    gt = rng.uniform(-1, 1, (B, 20, 20, 3)).astype(np.float32)
    a = jax.tree_util.tree_map(jnp.array, jp["adapter"])
    st = stx.init(a)
    ts, noises, res["sd_loss_jax"] = [], [], []
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(12), 2)):
        a, st, loss = sstep(a, st, frozen, jnp.asarray(sz), jnp.asarray(lat0), jnp.asarray(gt),
                            jnp.asarray(WEIGHTS[i]), key, perc_on=True)
        t, noise = _draws(key, lat0.shape)
        ts.append(t)
        noises.append(noise)
        res["sd_loss_jax"].append(float(loss))
    res["sd_params_jax"] = sd_adapter_state_dict_from_jax(a)
    np.savez(work / "sd_in.npz", z=sz, lat0=lat0, gt=gt, w=np.stack(WEIGHTS), t=np.stack(ts), noise=np.stack(noises))
    mods = [tsd.SDUNet(tsd.SDUNetConfig(**UCFG)), tsd.AutoencoderKL(tsd.VAEConfig(**VCFG)),
            tsd.SDClipAdapter(CLIP_DIM, 16, 1024, 8)]
    for m, name in zip(mods, ("unet", "vae", "adapter")):
        m.load_state_dict(torch.load(work / f"sd_{name}.pt", weights_only=True), strict=True)
    from clip_codec_tpu_torch.encoders.dino import DinoConfig, DinoV2

    dino = DinoV2(DinoConfig(**TINY), dtype=torch.float32)
    dino.load_state_dict(torch.load(work / "dino.pt", weights_only=True), strict=True)
    dec = tsd.StableDiffusionDecoder(*mods)
    one = strain.make_sd_train_step(dec, make_optimizer(dec.adapter, 1e-4), strain.SDTrainConfig(), dino=dino,
                                    lpips=lp)
    res["sd_loss_one"] = [float(one(*map(torch.from_numpy, (sz, lat0, WEIGHTS[i], ts[i], noises[i])),
                                    gt_img=torch.from_numpy(gt), perc_on=True)) for i in range(2)]
    res["sd_params_one"] = dec.adapter.state_dict()

    # the CLIs' stores, and their one-rank runs
    from clip_codec_tpu_torch.cli import train as train_cli
    from clip_codec_tpu_torch.cli import train_sd as train_sd_cli

    store_images(work / "px", rng)
    store_images(work / "sd", rng, dim=CLIP_DIM)
    env = {"CLIP_CODEC_SD_UNET_WEIGHTS": str(work / "sd_unet.pt"), "CLIP_CODEC_SD_VAE_WEIGHTS": str(work / "sd_vae.pt")}
    mp = pytest.MonkeyPatch()
    try:
        for k, v in env.items():
            mp.setenv(k, v)
        for k in ("CLIP_CODEC_DINO_WEIGHTS", "CLIP_CODEC_LPIPS_WEIGHTS"):
            mp.delenv(k, raising=False)
        precompute_latents.main(["--store_dir", str(work / "sd"), "--size", "16", "--device", "cpu"])
        train_argv = ["--store_dir", str(work / "px"), "--device", "cpu", "--base", "16", "--ch_mult", "1,2",
                      "--out_size", "16", "--timesteps", "50", "--batch_size", "4", "--epochs", "2", "--no_bf16"]
        train_sd_argv = ["--store_dir", str(work / "sd"), "--heads", "2", "--device", "cpu", "--batch_size", "4",
                         "--epochs", "2"]
        train_cli.main(train_argv + ["--save_dir", str(work / "px_one")])
        train_sd_cli.main(train_sd_argv + ["--save_dir", str(work / "sd_one")])
    finally:
        mp.undo()
    (work / "train_in.json").write_text(json.dumps({
        "cfg": CFG, "ucfg": UCFG, "vcfg": VCFG, "clip_dim": CLIP_DIM, "dino": TINY,
        "train_argv": train_argv + ["--save_dir", str(work / "px_dp")],
        "train_sd_argv": train_sd_argv + ["--save_dir", str(work / "sd_dp")]}))
    res["outs"] = run_ranks("train", work, env={**env, "CLIP_CODEC_DINO_WEIGHTS": "", "CLIP_CODEC_LPIPS_WEIGHTS": ""})
    return res


@pytest.mark.parametrize("trainer", ["px", "sd"])
def test_two_rank_steps_match_jax_and_one_rank(run, trainer):
    for o in run["outs"]:
        for want in (run[f"{trainer}_loss_jax"], run[f"{trainer}_loss_one"]):
            for got, w in zip(o[f"{trainer}_loss"], want):
                assert abs(got - w) <= 1e-5 * abs(w), (got, w)
        _close_state(o[f"{trainer}_params"], run[f"{trainer}_params_jax"], 1e-4)
        _close_state(o[f"{trainer}_params"], run[f"{trainer}_params_one"], 1e-4)
    a, b = (o[f"{trainer}_params"] for o in run["outs"])
    assert all(torch.equal(a[k], b[k]) for k in a)  # the replicas hold the same bits


def test_a_data_parallel_step_needs_the_global_row_count(run):
    for o in run["outs"]:
        assert o["px_error"] == "ValueError: a data-parallel step needs wsum, the global batch's real-row count"


@pytest.mark.parametrize("cli,name", [("px", "diffusion_unet_final.pt"), ("sd", "sd_adapter_final.pt")])
def test_cli_data_parallel_checkpoints_match_one_rank(run, cli, name):
    work = run["work"]
    got = torch.load(work / f"{cli}_dp" / name, weights_only=True)
    _close_state(got, torch.load(work / f"{cli}_one" / name, weights_only=True), 1e-4)
    ep = "diffusion_unet_ep2.pt" if cli == "px" else "sd_adapter_ep2.pt"
    assert (work / f"{cli}_dp" / ep).exists()
    if cli == "px":
        assert json.loads((work / "px_dp" / "model_config.json").read_text()) == \
            json.loads((work / "px_one" / "model_config.json").read_text())
        assert sorted(p.name for p in (work / "px_dp" / "state").iterdir()) == ["state_1.pt", "state_2.pt"]
    logs = [o["log"] for o in run["outs"]]
    assert "[parallel] 2 rank(s), backend cpu:gloo (CPU ranks)" in logs[0]
    assert "epoch 2/2" in logs[0] and "epoch" not in logs[1] and "Final checkpoint" not in logs[1]
    for o in run["outs"]:
        assert o["cli_errors"] == ["ValueError: batch_size=3 not divisible by data axis 2"]


def test_cli_without_a_launcher_stops_naming_torchrun(tmp_path):
    from clip_codec_tpu_torch.cli import train as train_cli
    from tests.test_torch_spatial_train import TRAIN_ARGV

    with pytest.raises(SystemExit, match="--spatial_shard 2 needs the launcher's environment .* torchrun"):
        train_cli.main(["--store_dir", str(tmp_path)] + TRAIN_ARGV + ["--spatial_shard", "2"])
