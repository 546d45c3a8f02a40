"""One rank of the port's multi-rank CPU tests (gloo), started by
tests/test_torch_parallel*.py, tests/test_torch_tp.py and
tests/test_torch_spatial*.py through ``clip_codec_tpu_torch.parallel.launch``:

    python tests/torch_dp_worker.py <task> <workdir>

with the launcher's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
The parent writes the inputs under <workdir>; each task runs several checks
in this one process and writes this rank's results as
``<workdir>/rank<r>_<task>.pt`` (a dict torch.load reads). No jax is
imported here: the parent holds the port's results against the JAX package.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, TypeError, RuntimeError, NotImplementedError, SystemExit) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def store_images(root: Path, rng, n=5, dim=8):
    """A tiny store: PNG images, .clp frames of random codes, codec_meta."""
    from PIL import Image

    from clip_codec_tpu_torch.io.bitstream import write_bitstream

    root.mkdir(parents=True, exist_ok=True)
    recs = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)).save(root / f"im{i}.png")
        write_bitstream(rng.integers(0, 256, dim, dtype=np.uint8).tobytes(), dim, root / f"im{i}.clp")
        recs.append({"image": str(root / f"im{i}.png"), "bitstream": str(root / f"im{i}.clp")})
    (root / "manifest.json").write_text(json.dumps(recs))
    np.savez(root / "codec_meta.npz", scale=np.full(dim, 1 / 127.5, np.float32),
             zero=np.full(dim, -1.0, np.float32), dim=np.int32(dim))


def run_ranks(task: str, work: Path, world: int = 2, env: dict = None, timeout: float = 240) -> list:
    """The worker's ``task`` as ``world`` gloo ranks (``env`` added to this
    process's); each rank's results."""
    import os

    from clip_codec_tpu_torch.parallel.launch import spawn_ranks

    root = Path(__file__).resolve().parents[1]
    full = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(root), **(env or {})}
    runs = spawn_ranks([str(Path(__file__).resolve()), task, str(work)], world, timeout, env=full, cwd=str(root))
    for r, (rc, log) in enumerate(runs):
        assert rc == 0, f"rank {r} exited {rc}:\n{log[-4000:]}"
    outs = [torch.load(work / f"rank{r}_{task}.pt", weights_only=False) for r in range(world)]
    for o, (_, log) in zip(outs, runs):
        assert o["world"] == world and o["jax_modules"] == []
        o["log"] = log
    return outs


def _tiny_unet(path, cfg, **kw):
    from clip_codec_tpu_torch.models import CLIPCondUNet

    net = CLIPCondUNet(**cfg, time_dim=256, fused_pallas=False, **kw)
    net.load_state_dict(torch.load(path, weights_only=True), strict=True)
    return net


def lib(work: Path, rank: int) -> dict:
    """make_mesh, shard_batch, StoreData.epoch(local=), sample_sharded, the
    three sharded indexes and the sharded pixel artifact."""
    from clip_codec_tpu_torch import deploy
    from clip_codec_tpu_torch.diffusion import NoiseSchedule, ddim_sample
    from clip_codec_tpu_torch.index import (build_ivf_index, build_ivf_index_u8, build_sharded_index,
                                            build_sharded_index_u8, shard_ivf_index)
    from clip_codec_tpu_torch.parallel import make_mesh, sample_sharded, shard_batch
    from clip_codec_tpu_torch.parallel.mesh import axis_index, axis_size, local_rows
    from clip_codec_tpu_torch.train.data import StoreData
    from clip_codec_tpu_torch.utils.config import ModelConfig

    inp = dict(np.load(work / "lib_in.npz"))
    spec = json.loads((work / "lib_in.json").read_text())
    out = {}
    mesh = make_mesh(device_type="cpu")
    out["mesh"] = [list(mesh.shape), list(mesh.mesh_dim_names), axis_size(mesh), axis_index(mesh), mesh.device_type]
    tp = make_mesh(model_parallel=2, device_type="cpu")
    out["mesh_tp"] = [list(tp.shape), axis_size(tp, "model"), axis_index(tp, "model")]
    out["mesh_errors"] = [_error(lambda: make_mesh(model_parallel=3, device_type="cpu")),
                          _error(lambda: make_mesh(n_devices=4, device_type="cpu"))]
    out["shard_batch"] = [t.tolist() for t in shard_batch(mesh, np.arange(8), torch.arange(16).reshape(8, 2))]
    out["shard_error"] = _error(lambda: shard_batch(mesh, np.arange(5)))
    out["rows"] = [local_rows(mesh, 8).start, local_rows(mesh, 8).stop]

    data = StoreData(work / "store", out_size=12)
    rng = np.random.default_rng(4)
    rows = local_rows(mesh, 4)
    out["epoch"] = [(b.x0, b.z, b.weight, b.wsum) for _ in range(2)
                    for b in data.epoch(4, rng, local=(rows.start, rows.stop), u8=True)]

    net = _tiny_unet(work / "unet.pt", spec["cfg"])
    sched = NoiseSchedule.create(50, "linear")
    z, x_T = inp["z"], inp["x_T"]
    with torch.no_grad():
        out["sample_x_T"] = sample_sharded(mesh, net, sched, z, 16, steps=3, x_T=x_T)
        for eta in (0.0, 0.5):
            out[f"sample_gen_{eta}"] = sample_sharded(mesh, net, sched, z, 16, steps=3, eta=eta,
                                                      generator=torch.Generator().manual_seed(9))
        out["sample_error"] = _error(lambda: sample_sharded(mesh, net, sched, z[:3], 16, steps=1))
        out["whole_gen_0.5"] = ddim_sample(net, sched, torch.from_numpy(z), (4, 16, 16, 3), 3, 0.5,
                                           torch.Generator().manual_seed(9)).numpy()

    idx = {}
    for name, build in (("fp32", lambda: build_sharded_index(inp["feats"], mesh)),
                        ("u8", lambda: build_sharded_index_u8(inp["codes"], inp["scale"], inp["zero"], mesh)),
                        ("empty", lambda: build_sharded_index(np.zeros((0, 8), np.float32), mesh))):
        index = build()
        idx[name] = [index.search(inp["queries"], k) for k in spec["ks"]]
        idx[name + "_rows"] = (index.base, tuple(getattr(index, "feats", getattr(index, "codes", None)).shape))
    for name, single in (("ivf", build_ivf_index(inp["feats"], nlist=3, nprobe=2, device="cpu")),
                         ("ivf_u8", build_ivf_index_u8(inp["codes"], inp["scale"], inp["zero"], nlist=3, nprobe=2,
                                                       device="cpu"))):
        index = shard_ivf_index(single, mesh)
        idx[name] = [index.search(inp["queries"], k, nprobe=p) for k in spec["ks"] for p in (1, 2, 3)]
        idx[name + "_lists"] = (index.base, tuple(index.lists.shape))
    out["index"] = idx

    mc = ModelConfig(**spec["mc"])
    params = torch.load(work / "unet.pt", weights_only=True)
    path = work / "sharded.torchprog"
    kw = dict(size=16, steps=3, batch_size=4, dtype="float32", platforms=["cpu"])
    out["export_error"] = _error(lambda: deploy.export_sharded_decompressor(params, mc, path, mesh, **dict(
        kw, batch_size=3)))
    deploy.export_sharded_decompressor(params, mc, path, mesh, **kw)
    call = deploy.load_sharded_decompressor(path, mesh)
    out["artifact_meta"] = dict(call.meta)
    out["artifact"] = [call(params, z, seed=3).numpy(), call(params, z, seed=3).numpy(),
                       call(params, z, seed=4).numpy()]
    out["artifact_errors"] = [_error(lambda: deploy.load_sharded_decompressor(path, tp)),
                              _error(lambda: deploy.load_decompressor(path, device="cpu"))]
    return out


def train(work: Path, rank: int) -> dict:
    """Two data-parallel steps of the pixel trainer and of the SD adapter
    trainer (DINO and LPIPS on) with injected t and noise, then the two
    training CLIs with --data_parallel."""
    from clip_codec_tpu_torch.cli import train as train_cli
    from clip_codec_tpu_torch.cli import train_sd as train_sd_cli
    from clip_codec_tpu_torch.diffusion import NoiseSchedule
    from clip_codec_tpu_torch.encoders.dino import DinoConfig, DinoV2
    from clip_codec_tpu_torch.eval import lpips as tlpips
    from clip_codec_tpu_torch.models import sd as tsd
    from clip_codec_tpu_torch.parallel import make_mesh
    from clip_codec_tpu_torch.parallel.mesh import local_rows
    from clip_codec_tpu_torch.train import diffusion_train as ptrain
    from clip_codec_tpu_torch.train import sd_diffusion_train as strain
    from clip_codec_tpu_torch.train.optim import make_optimizer

    spec = json.loads((work / "train_in.json").read_text())
    px = dict(np.load(work / "px_in.npz"))
    sd = dict(np.load(work / "sd_in.npz"))
    mesh = make_mesh(device_type="cpu")
    out = {}

    net = _tiny_unet(work / "unet16.pt", spec["cfg"])
    cfg = ptrain.DiffusionTrainConfig(base=spec["cfg"]["base"], ch_mult=tuple(spec["cfg"]["ch_mult"]), bf16=False)
    step = ptrain.make_train_step(net, NoiseSchedule.create(1000, "cosine"), make_optimizer(net, cfg.lr), cfg,
                                  mesh=mesh)
    rows = local_rows(mesh, px["x0"].shape[0])
    out["px_loss"] = []
    for i in range(2):
        w = px["w"][i]
        args = (px["x0"], px["z"], w, px["t"][i], px["noise"][i])
        out["px_loss"].append(float(step(*(torch.from_numpy(a[rows]) for a in args), wsum=float(w.sum()))))
    out["px_params"] = {k: v.clone() for k, v in net.state_dict().items()}
    out["px_error"] = _error(lambda: step(*(torch.from_numpy(a[rows]) for a in args)))

    ucfg = tsd.SDUNetConfig(**{**spec["ucfg"], "block_out": tuple(spec["ucfg"]["block_out"])})
    vcfg = tsd.VAEConfig(**{**spec["vcfg"], "block_out": tuple(spec["vcfg"]["block_out"])})
    unet, vae = tsd.SDUNet(ucfg), tsd.AutoencoderKL(vcfg)
    adapter = tsd.SDClipAdapter(spec["clip_dim"], ucfg.cross_dim, 1024, 8)
    for m, name in ((unet, "unet"), (vae, "vae"), (adapter, "adapter")):
        m.load_state_dict(torch.load(work / f"sd_{name}.pt", weights_only=True), strict=True)
    dino = DinoV2(DinoConfig(**spec["dino"]), dtype=torch.float32)
    dino.load_state_dict(torch.load(work / "dino.pt", weights_only=True), strict=True)
    lpips = tlpips.LPIPS()
    lpips.load_state_dict(torch.load(work / "lpips.pt", weights_only=True), strict=True)
    dec = tsd.StableDiffusionDecoder(unet, vae, adapter)
    sstep = strain.make_sd_train_step(dec, make_optimizer(adapter, 1e-4), strain.SDTrainConfig(), dino=dino,
                                      lpips=lpips, mesh=mesh)
    rows = local_rows(mesh, sd["z"].shape[0])
    out["sd_loss"] = []
    for i in range(2):
        w = sd["w"][i]
        args = (sd["z"], sd["lat0"], w, sd["t"][i], sd["noise"][i])
        loss = sstep(*(torch.from_numpy(a[rows]) for a in args), gt_img=torch.from_numpy(sd["gt"][rows]),
                     perc_on=True, wsum=float(w.sum()))
        out["sd_loss"].append(float(loss))
    out["sd_params"] = {k: v.clone() for k, v in adapter.state_dict().items()}

    train_cli.main(spec["train_argv"] + ["--data_parallel"])
    train_sd_cli.main(spec["train_sd_argv"] + ["--data_parallel"])
    out["cli_errors"] = [_error(lambda: train_cli.main(spec["train_argv"] + ["--data_parallel", "--batch_size", "3"]))]
    return out


def _printed(fn) -> list:
    """What ``fn()`` prints, as lines."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def tiny_towers(spec) -> None:
    """The CLIs' CLIP and DINOv2 towers at the tests' tiny fp32 configs."""
    import clip_codec_tpu_torch.encoders as E
    from clip_codec_tpu_torch.encoders.clip import CLIPConfig
    from clip_codec_tpu_torch.encoders.dino import DinoConfig

    clip, dino = E.ClipEncoder, E.DinoEncoder
    E.ClipEncoder = lambda **kw: clip(**kw, cfg=CLIPConfig(**spec["clip"]), dtype=torch.float32)
    E.DinoEncoder = lambda **kw: dino(**kw, cfg=DinoConfig(**spec["dino"]), dtype=torch.float32)


def cli(work: Path, rank: int) -> dict:
    """encode_images (and --append), encode_images_dino, eval and
    search_text (fp32 and --u8), each with --data_parallel; what rank 0
    prints and the refusals."""
    from clip_codec_tpu_torch.cli import encode_images, encode_images_dino, search_text
    from clip_codec_tpu_torch.cli import eval as eval_cli

    spec = json.loads((work / "cli_in.json").read_text())
    tiny_towers(spec)
    dp = ["--data_parallel"]
    out = {"encode": _printed(lambda: encode_images.main(spec["encode"] + dp)),
           "append": _printed(lambda: encode_images.main(spec["append"] + dp)),
           "dino": _printed(lambda: encode_images_dino.main(spec["dino_argv"] + dp)),
           "eval": _printed(lambda: eval_cli.main(spec["eval"] + dp)),
           "search": [_printed(lambda: search_text.main(argv + dp)) for argv in spec["search"]],
           "errors": [_error(lambda: eval_cli.main(spec["eval"] + dp + ["--batch_size", "3"]))]}
    return out


def _sd_modules(work: Path, spec: dict, name: str):
    from clip_codec_tpu_torch.models import sd as tsd

    ucfg = tsd.SDUNetConfig(**{**spec[name], "block_out": tuple(spec[name]["block_out"])})
    return ucfg, torch.load(work / f"{name}_unet.pt", weights_only=True)


def tp(work: Path, rank: int) -> dict:
    """The tensor-parallel SD UNet on a (1, 2) mesh: each rank's slices,
    its forwards (TINY at 8x8, TINY4 at 8x8 and at 32x32, where the
    self-attention of the first level passes the flash gate), the UNet on a
    model axis of one, the int8 refusals, and the tensor-parallel SD
    artifact (header, replay, images, refusals)."""
    from clip_codec_tpu_torch import deploy
    from clip_codec_tpu_torch.models import sd as tsd
    from clip_codec_tpu_torch.parallel import make_mesh, shard_params_tp

    spec = json.loads((work / "tp_in.json").read_text())
    inp = dict(np.load(work / "tp_in.npz"))
    mesh = make_mesh(model_parallel=2, device_type="cpu")
    dp = make_mesh(device_type="cpu")  # (2, 1): a model axis of one
    out = {}
    with torch.no_grad():
        for name in ("tiny", "tiny4"):
            ucfg, sd = _sd_modules(work, spec, name)
            local = shard_params_tp(mesh, sd)
            out[f"{name}_shards"] = local
            net = tsd.SDUNet(ucfg, mesh=mesh)
            net.load_state_dict(local, strict=True)
            one = tsd.SDUNet(ucfg, mesh=dp)
            one.load_state_dict(shard_params_tp(dp, sd), strict=True)
            for S in spec["sizes"][name]:
                args = [torch.from_numpy(inp[f"{k}{S}"]) for k in ("lat", "t", "ctx")]
                out[f"{name}_fwd{S}"] = net(*args).numpy()
                out[f"{name}_one{S}"] = one(*args).numpy()
        ucfg, sd = _sd_modules(work, spec, "tiny")
        out["int8_errors"] = [_error(lambda: tsd.SDUNet(ucfg, int8=True, mesh=mesh))]
        vcfg = tsd.VAEConfig(**{**spec["vae"], "block_out": tuple(spec["vae"]["block_out"])})
        vae, adapter = (torch.load(work / f"{n}.pt", weights_only=True) for n in ("vae", "adapter"))
        path = work / "tp.torchprog"
        kw = dict(unet_cfg=ucfg, vae_cfg=vcfg, size=16, steps=2, batch_size=1, platforms=["cpu"], dtype="float32")
        out["export_errors"] = [
            _error(lambda: deploy.export_sharded_sd_decompressor(sd, vae, adapter, path, mesh, quant={}, **kw)),
            _error(lambda: deploy.export_sharded_sd_decompressor(sd, vae, adapter, path, mesh, **dict(
                kw, unet_cfg=tsd.SDUNetConfig(**{**spec["tiny"], "heads": 3}))))]
        deploy.export_sharded_sd_decompressor(sd, vae, adapter, path, mesh, **kw)
        call = deploy.load_sharded_sd_decompressor(path, mesh)
        out["sd_meta"], out["sd_replay"] = dict(call.meta), call.replay
        out["sd_images"] = [call(sd, vae, adapter, inp["z"], guidance_scale=g, x_T=inp["x_T"]).numpy()
                            for g in (4.0, 0.0)]
        out["sd_errors"] = [_error(lambda: deploy.load_sharded_sd_decompressor(path, dp)),
                            _error(lambda: deploy.load_sd_decompressor(path, device="cpu"))]
    return out


def spatial(work: Path, rank: int) -> dict:
    """``sample_spatial_sharded`` on a (1, 2) mesh at eta 0 (x_T injected)
    and 0.5 (drawn from a generator), its refusals, and the spatial pixel
    artifact."""
    from clip_codec_tpu_torch import deploy
    from clip_codec_tpu_torch.diffusion import NoiseSchedule
    from clip_codec_tpu_torch.parallel import make_mesh, sample_spatial_sharded
    from clip_codec_tpu_torch.utils.config import ModelConfig

    inp = dict(np.load(work / "spatial_in.npz"))
    spec = json.loads((work / "spatial_in.json").read_text())
    mesh = make_mesh(model_parallel=2, device_type="cpu")
    dp = make_mesh(device_type="cpu")
    net = _tiny_unet(work / "unet.pt", spec["cfg"])
    sched = NoiseSchedule.create(50, "linear")
    z, x_T = inp["z"], inp["x_T"]
    out = {}
    with torch.no_grad():
        out["sample"] = sample_spatial_sharded(mesh, net, sched, z, 16, steps=3, x_T=x_T)
        out["sample_eta"] = sample_spatial_sharded(mesh, net, sched, z, 16, steps=3, eta=0.5,
                                                   generator=torch.Generator().manual_seed(9))
        out["sample_errors"] = [
            _error(lambda: sample_spatial_sharded(dp, net, sched, z[:3], 16, steps=1)),
            _error(lambda: sample_spatial_sharded(mesh, net, sched, z, 15, steps=1)),
            _error(lambda: sample_spatial_sharded(mesh, net, sched, z, 12, steps=1)),
            _error(lambda: sample_spatial_sharded(mesh, lambda x, zz, t: x, sched, z, 16, steps=1))]
    mc = ModelConfig(**spec["mc"])
    params = torch.load(work / "unet.pt", weights_only=True)
    path = work / "spatial.torchprog"
    kw = dict(spatial=True, size=16, steps=3, batch_size=4, dtype="float32", platforms=["cpu"])
    out["export_errors"] = [_error(lambda: deploy.export_sharded_decompressor(params, mc, path, mesh, **dict(
        kw, size=12)))]
    deploy.export_sharded_decompressor(params, mc, path, mesh, **kw)
    call = deploy.load_sharded_decompressor(path, mesh)
    out["artifact_meta"], out["artifact_replay"] = dict(call.meta), call.replay
    out["artifact"] = [call(params, z, x_T=x_T).numpy(), call(params, z, seed=3).numpy()]
    out["artifact_errors"] = [_error(lambda: deploy.load_sharded_decompressor(path, dp))]
    return out


SPATIAL_STEPS = {"stop_grad": {}, "align_grad": {"clip_align_grad": True},
                 "remat": {"clip_align_grad": True, "remat": True}}


def spatial_train(work: Path, rank: int) -> dict:
    """Spatially sharded training on a (world / 2, 2) mesh: one step of the
    pixel trainer (recon, TV and CLIP terms on, the CLIP term a stand-in
    embed; ``t`` and the noise injected) for each of ``SPATIAL_STEPS``,
    with the summed gradient and the parameters after AdamW; ``cli.train
    --spatial_shard 2``; on two ranks also K1's split autograd in fp64 and
    ``train_diffusion``'s refusals."""
    from clip_codec_tpu_torch.cli import train as train_cli
    from clip_codec_tpu_torch.diffusion import NoiseSchedule
    from clip_codec_tpu_torch.ops import groupnorm as gn
    from clip_codec_tpu_torch.parallel import make_mesh
    from clip_codec_tpu_torch.parallel.mesh import local_rows, model_slice
    from clip_codec_tpu_torch.train import diffusion_train as ptrain
    from clip_codec_tpu_torch.train.optim import make_optimizer

    spec = json.loads((work / "spatial_train_in.json").read_text())
    inp = dict(np.load(work / "spatial_train_in.npz"))
    mesh = make_mesh(model_parallel=2, device_type="cpu")
    B, S = inp["x0"].shape[:2]
    rows, hs = local_rows(mesh, B), model_slice(mesh, S)
    proj = torch.from_numpy(inp["proj"])
    embed = lambda images: torch.tanh(images.reshape(images.shape[0], -1) @ proj)
    args = [torch.from_numpy(inp[k][rows]) for k in ("x0", "z", "w", "t", "noise")]
    args[0], args[4] = args[0][:, hs], args[4][:, hs]
    out = {"mesh": list(mesh.shape)}
    for name, kw in SPATIAL_STEPS.items():
        net = _tiny_unet(work / "unet.pt", spec["cfg"], remat=kw.get("remat", False))
        cfg = ptrain.DiffusionTrainConfig(base=spec["cfg"]["base"], ch_mult=tuple(spec["cfg"]["ch_mult"]), bf16=False,
                                          **kw)
        step = ptrain.make_train_step(net, NoiseSchedule.create(1000, "cosine"), make_optimizer(net, cfg.lr), cfg,
                                      embed, mesh=mesh, spatial=True)
        loss = step(*args, clip_on=True, wsum=float(inp["w"].sum()))
        out[name] = {"loss": float(loss), "grads": {k: p.grad.clone() for k, p in net.named_parameters()},
                     "params": {k: v.clone() for k, v in net.state_dict().items()}}
    train_cli.main(spec["train_argv"] + ["--spatial_shard", "2", "--save_dir", str(work / f"cli{mesh.size()}")])
    if mesh.size() > 2:
        return out

    x = torch.from_numpy(inp["gn_x"]).requires_grad_()  # K1's split form under autograd, this rank's rows
    scale, bias = (torch.from_numpy(inp[k]).requires_grad_() for k in ("gn_scale", "gn_bias"))
    xs = x[:, hs]
    y = gn.group_norm_silu_spatial(xs, (scale, bias), 8, mesh)
    y.backward(torch.from_numpy(inp["gn_g"])[:, hs])
    out["gn"] = {"y": y.detach(), "dx": x.grad[:, hs], "dscale": scale.grad, "dbias": bias.grad}

    dp = make_mesh(device_type="cpu")  # (2, 1)
    cfg = lambda **kw: ptrain.DiffusionTrainConfig(**{**dict(out_size=S, batch_size=2, base=8, ch_mult=(1, 2)), **kw})
    run = lambda m, **kw: ptrain.train_diffusion(work / "store", config=cfg(**kw), mesh=m, spatial=True, device="cpu")
    out["errors"] = [_error(lambda: run(None)), _error(lambda: run(dp, batch_size=3)), _error(lambda: run(dp)),
                     _error(lambda: run(mesh, out_size=15)), _error(lambda: run(mesh, out_size=12))]
    return out


def main() -> None:
    import torch.distributed as dist

    task, work = sys.argv[1], Path(sys.argv[2])
    rank = int(__import__("os").environ["RANK"])
    out = {"lib": lib, "train": train, "cli": cli, "tp": tp, "spatial": spatial,
           "spatial_train": spatial_train}[task](work, rank)
    out["world"] = dist.get_world_size()
    bad = sorted(m for m in sys.modules if m in ("jax", "clip_codec_tpu") or m.startswith(("jax.", "clip_codec_tpu.")))
    out["jax_modules"] = bad
    torch.save(out, work / f"rank{rank}_{task}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
