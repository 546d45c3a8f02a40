"""One rank of the model-axis smoke run (``chip_smoke.py`` phase 24), on the
card:

    python -m clip_codec_tpu_torch.probes.mp_rank JOB.json

started once a rank (``parallel.launch.spawn_ranks``) with the launcher's
environment; the mesh is ``(1, world)``: every rank on the model axis.
``JOB.json`` holds ``{"out": dir, "tasks": [...]}``; each task runs here in
turn, with the kernels' launch counts set to 0 just before it and read just
after, and this rank writes what it did to ``<out>/rank<r>.json``
(tensors and images to ``<out>/rank<r>_<task>*``):

* ``tp_forward``: the tensor-parallel SD UNet (``SDUNet(cfg, mesh=mesh)``,
  bf16) loaded with this rank's slices (``shard_params_tp``) of the
  diffusers file at ``unet``; one forward at the inputs in ``inputs``
  (latents, t, context) saved as fp32, its launches by shape (K4's (BH, N,
  D), each of K6's two stages' (R, C, F)), then the device ms a forward
  (CUDA events over ``reps`` forwards; ranks that share a card time each
  other's work too);
* ``tp_artifact``: ``export_sharded_sd_decompressor`` /
  ``load_sharded_sd_decompressor`` of the diffusers files; ``call.replay``,
  the header, a first call (capture or eager warm-up) and one request's
  seconds and launches, the images (rank 0); on a one-rank mesh also the
  single-device SD artifact from the same files, and whether its images are
  bit-equal to the sharded artifact's;
* ``spatial_sample``: ``sample_spatial_sharded`` of the pixel checkpoint at
  ``weights``: in fp32 from the x_T in ``x_T`` on a linear schedule of
  ``check_timesteps`` for ``check_steps`` steps (saved), then in bf16 at
  the checkpoint's schedule,
  DDIM-``steps`` from ``seed``, timed, with K1's split launches by shape
  (images saved as uint8);
* ``spatial_artifact``: ``export_sharded_decompressor(spatial=True)`` and
  its loader on the same checkpoint; the header, ``call.replay``, the
  mesh-shape refusal, a call at ``seed`` timed with its launches, and its
  images against ``spatial_sample``'s bf16 images;
* ``spatial_train`` (phase 26): the pixel trainer with the image height
  split over the ranks (``train_diffusion(spatial=True)``; on one rank the
  unsharded step). The weights at ``weights`` (fp32 parameters), each of
  the global batches ``batches`` (``x0``, ``z``, ``w``, ``t``, ``noise``)
  cut to this rank's rows and height slice: the loss and every
  parameter's gradient, summed over the mesh, in fp32 at the first batch
  and in bf16 at each (on one rank also the plain path in fp32, K1's plain
  version), K1's launches in the forward and in the backward by shape
  (rank 0 saves each gradient to ``<out>/rank0_grad_<tag>.pt``); then
  ``cli.train`` with ``argv`` and ``--spatial_shard <world>`` (one rank:
  ``--distributed``), each step's seconds, global loss, kernel launches by
  shape and collectives (``all_gather``, ``all_reduce``), and the process's
  peak device memory over the run.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _launches() -> dict:
    from ..ops import attention as attn
    from ..ops import groupnorm as gn
    from ..ops import mlp
    from ..ops import resblock_conv as rc

    return {"flash_attention": attn.flash_attention_fwd, "mlp_up": mlp.mlp_up, "mlp_down": mlp.mlp_down,
            "transformer_mlp": mlp.transformer_mlp, "group_norm_silu": gn.group_norm_silu,
            "group_norm_silu_stats": gn.group_norm_silu_stats, "group_norm_silu_apply": gn.group_norm_silu_apply,
            "affine_silu_conv3x3": rc.affine_silu_conv3x3, "affine_conv3x3": rc.affine_conv3x3}


def _reset() -> None:
    for fn in _launches().values():
        fn.launches = 0


def _counts() -> dict:
    return {k: getattr(fn, "launches", 0) for k, fn in _launches().items()}  # 0: routed to a plain version


@contextlib.contextmanager
def _by_shape(shapes: collections.Counter):
    """Tally K4, K6's two stages and K1's split entries by shape into
    ``shapes`` (keys ``"<kernel> <shape>"``; K6's (R, C, F)), through each
    one's launcher."""
    from ..ops import attention as attn
    from ..ops import groupnorm as gn
    from ..ops import mlp

    saved = attn._launch, mlp._launch_up, mlp._launch_down, gn._launch_stats, gn._launch_apply

    def flash(q, k, v):
        shapes[f"flash_attention {list(q.shape)}"] += 1
        return saved[0](q, k, v)

    def up(x, *rest):
        shapes[f"mlp_up {[x.numel() // x.shape[-1], x.shape[-1], rest[2].shape[0]]}"] += 1
        return saved[1](x, *rest)

    def down(h, wdown, *a, **k):
        shapes[f"mlp_down {[h.numel() // h.shape[-1], wdown.shape[0], h.shape[-1]]}"] += 1
        return saved[2](h, wdown, *a, **k)

    def stats(x, *a, **k):
        shapes[f"group_norm_silu_stats {list(x.shape)}"] += 1
        return saved[3](x, *a, **k)

    def apply(x, *a, **k):
        shapes[f"group_norm_silu_apply {list(x.shape)}"] += 1
        return saved[4](x, *a, **k)

    attn._launch, mlp._launch_up, mlp._launch_down, gn._launch_stats, gn._launch_apply = (
        flash, up, down, stats, apply)
    try:
        yield
    finally:
        attn._launch, mlp._launch_up, mlp._launch_down, gn._launch_stats, gn._launch_apply = saved


def _mesh():
    from ..parallel import make_mesh

    return make_mesh(model_parallel=int(os.environ.get("WORLD_SIZE", 1)))


def _sd_files(task: dict):
    from ..weights import sd_checkpoint as ckpt

    return (ckpt.load_unet(task["unet"]),
            ckpt.load_vae(task["vae"]),
            ckpt.load_adapter(task["adapter"]))


def tp_forward(task: dict, out: Path, rank: int) -> dict:
    """The tensor-parallel SD UNet's forward: launches, eps, device ms."""
    from ..models.sd import SDUNet
    from ..parallel import shard_params_tp
    from ..parallel.mesh import rank_device
    from ..weights import sd_checkpoint as ckpt

    mesh = _mesh()
    dev = rank_device(mesh)
    sd = ckpt.load_unet(task["unet"])
    with torch.device(dev):
        unet = SDUNet(ckpt.unet_config(sd, heads=8), dtype=torch.bfloat16, mesh=mesh)
    unet.load_state_dict(shard_params_tp(mesh, sd), strict=True)
    unet.eval().requires_grad_(False)
    del sd
    inp = np.load(task["inputs"])
    args = [torch.from_numpy(inp[k]).to(dev) for k in ("lat", "t", "ctx")]
    shapes = collections.Counter()
    _reset()
    with torch.no_grad(), _by_shape(shapes):
        eps = unet(*args)
    torch.cuda.synchronize()
    rec = {"launches": _counts(), "by_shape": dict(shapes), "heads": unet.down_blocks[0].attentions[0]
           .transformer_blocks[0].attn1.heads}
    torch.save(eps.float().cpu(), out / f"rank{rank}_tp_eps.pt")
    with torch.no_grad():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(task["reps"]):
            unet(*args)
        end.record()
        end.synchronize()
    rec["device_ms"] = start.elapsed_time(end) / task["reps"]
    del unet
    torch.cuda.empty_cache()
    return rec


def tp_artifact(task: dict, out: Path, rank: int) -> dict:
    """The tensor-parallel SD artifact: replay, header, a request's s."""
    from .. import deploy

    mesh = _mesh()
    unet, vae, adapter = _sd_files(task)
    z = np.load(task["z"])
    path = Path(task["path"])
    kw = dict(size=task["size"], steps=task["steps"], batch_size=z.shape[0])
    deploy.export_sharded_sd_decompressor(unet, vae, adapter, path, mesh, **kw)
    call = deploy.load_sharded_sd_decompressor(path, mesh)
    rec = {"replay": call.replay, "meta": call.meta}
    shapes = collections.Counter()
    _reset()
    torch.cuda.synchronize()
    with _by_shape(shapes):
        t0 = time.perf_counter()
        call(unet, vae, adapter, z, seed=task["seed"])  # the first call: the eager warm-up and the capture, or eager
        torch.cuda.synchronize()
        rec["first_call_s"] = time.perf_counter() - t0
        before = _counts()
        t0 = time.perf_counter()
        img = call(unet, vae, adapter, z, seed=task["seed"])
        torch.cuda.synchronize()
        rec["request_s"] = time.perf_counter() - t0
    rec["request_launches"] = {k: v - before[k] for k, v in _counts().items() if v - before[k]}
    rec["launches"], rec["by_shape"] = _counts(), dict(shapes)
    if rank == 0:
        np.save(out / "tp_artifact.npy", img.cpu().numpy())
    if mesh.size() == 1:  # the single-device artifact from the same files, in this process
        single = deploy.load_sd_decompressor(deploy.export_sd_decompressor(
            unet, vae, adapter, out / "single.torchprog", **kw), device=call.device)
        want = single(unet, vae, adapter, z, seed=task["seed"])
        rec["single_replay"] = single.replay
        rec["bit_equal_to_single"] = bool(torch.equal(img, want))
        rec["max_abs_diff_to_single"] = (img - want).abs().max().item()
        del single
    del call
    torch.cuda.empty_cache()
    return rec


def _pixel(task: dict, dev, dtype):
    from ..models import CLIPCondUNet
    from ..utils.checkpoint import load_state_dict
    from ..utils.config import ModelConfig

    mc = ModelConfig.find_for_checkpoint(task["weights"])
    with torch.device(dev):
        net = CLIPCondUNet(z_dim=mc.z_dim, base=mc.base, ch_mult=tuple(mc.ch_mult), time_dim=mc.time_dim,
                           img_ch=mc.img_ch, dtype=dtype, fused_pallas=False)
    net.load_state_dict(load_state_dict(task["weights"]), strict=True)
    return mc, net.eval().requires_grad_(False)


def spatial_sample(task: dict, out: Path, rank: int) -> dict:
    """sample_spatial_sharded: the fp32 check, then a bf16 DDIM run."""
    from ..diffusion import NoiseSchedule
    from ..parallel import sample_spatial_sharded
    from ..parallel.mesh import rank_device

    mesh = _mesh()
    dev = rank_device(mesh)
    z = np.load(task["z"])
    mc, net = _pixel(task, dev, torch.float32)
    with torch.no_grad():
        x = sample_spatial_sharded(mesh, net, NoiseSchedule.create(task["check_timesteps"], "linear"), z,
                                   task["size"], steps=task["check_steps"], x_T=np.load(task["x_T"]))
    if rank == 0:
        np.save(out / "spatial_fp32.npy", x)
    del net
    mc, net = _pixel(task, dev, torch.bfloat16)
    sched = NoiseSchedule.create(mc.timesteps, mc.schedule)
    shapes = collections.Counter()
    _reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), _by_shape(shapes):
        x = sample_spatial_sharded(mesh, net, sched, z, task["size"], steps=task["steps"], seed=task["seed"])
    rec = {"bf16_s": time.perf_counter() - t0, "launches": _counts(), "by_shape": dict(shapes)}
    u8 = ((np.clip(x, -1, 1) + 1.0) * 127.5).astype(np.uint8)
    if rank == 0:
        np.save(out / "spatial_bf16.npy", x)
        np.save(out / "spatial_bf16_u8.npy", u8)
    del net
    torch.cuda.empty_cache()
    return rec


def spatial_artifact(task: dict, out: Path, rank: int) -> dict:
    """The spatial pixel artifact: header, replay, refusal, one call."""
    from .. import deploy
    from ..parallel import make_mesh
    from ..utils.checkpoint import load_state_dict
    from ..utils.config import ModelConfig

    mesh = _mesh()
    params = load_state_dict(task["weights"])
    mc = ModelConfig.find_for_checkpoint(task["weights"])
    z = np.load(task["z"])
    path = Path(task["path"])
    deploy.export_sharded_decompressor(params, mc, path, mesh, spatial=True, size=task["size"], steps=task["steps"],
                                       batch_size=z.shape[0])
    call = deploy.load_sharded_decompressor(path, mesh)
    rec = {"replay": call.replay, "meta": call.meta}
    try:
        deploy.load_sharded_decompressor(path, make_mesh())  # the (world, 1) mesh
        rec["mesh_refusal"] = ""
    except ValueError as e:
        rec["mesh_refusal"] = str(e)
    shapes = collections.Counter()
    _reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _by_shape(shapes):
        img = call(params, z, seed=task["seed"]).cpu().numpy()
    rec.update(call_s=time.perf_counter() - t0, launches=_counts(), by_shape=dict(shapes))
    sample = np.clip(np.load(out / "spatial_bf16.npy"), -1, 1) if rank == 0 else None
    if rank == 0:
        rec["max_abs_diff_to_sample"] = float(np.abs(img - sample).max())
        np.save(out / "spatial_artifact.npy", img)
    del call
    torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def _counting(calls: collections.Counter):
    """Count ``torch.distributed``'s ``all_gather`` and ``all_reduce`` calls
    into ``calls``."""
    import torch.distributed as dist

    saved = dist.all_gather, dist.all_reduce

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    dist.all_gather, dist.all_reduce = counted("all_gather", saved[0]), counted("all_reduce", saved[1])
    try:
        yield
    finally:
        dist.all_gather, dist.all_reduce = saved


@contextlib.contextmanager
def _plain_k1(on: bool):
    """The direct ResBlock's GroupNorm+SiLU through its plain version."""
    from ..ops import groupnorm as gn

    saved = gn.group_norm_silu
    if on:
        gn.group_norm_silu = gn.group_norm_silu_plain
    try:
        yield
    finally:
        gn.group_norm_silu = saved


def spatial_train(task: dict, out: Path, rank: int) -> dict:
    """Spatially sharded training (one rank: unsharded): gradients, then the CLI."""
    from ..cli import train as train_cli
    from ..diffusion import NoiseSchedule
    from ..io.bitstream import zstd_engine
    from ..models import CLIPCondUNet
    from ..parallel.mesh import local_rows, model_slice, rank_device, sum_gradients
    from ..train import diffusion_train as module
    from ..train.optim import make_optimizer
    from ..utils.checkpoint import load_state_dict
    from .serve_times import raw_frames

    mesh = _mesh()
    spatial = mesh.size() > 1
    dev = rank_device(mesh)
    cfg = module.DiffusionTrainConfig(base=task["base"], ch_mult=tuple(task["ch_mult"]), bf16=False)
    with torch.device(dev):
        net = CLIPCondUNet(z_dim=task["z_dim"], base=cfg.base, ch_mult=cfg.ch_mult, dtype=torch.float32,
                           fused_pallas=False)
    net.load_state_dict(load_state_dict(task["weights"]), strict=True)
    step = module.make_train_step(net, NoiseSchedule.create(cfg.timesteps, cfg.schedule, device=dev),
                                  make_optimizer(net, cfg.lr), cfg, mesh=mesh if spatial else None, spatial=spatial)
    rec = {"grads": {}}

    def grad(tag, path, dtype, plain=False):
        b = torch.load(path, weights_only=True)
        B, S = b["x0"].shape[:2]
        cut = (local_rows(mesh, B), model_slice(mesh, S)) if spatial else (slice(None),)
        args = [b["x0"][cut], b["z"][cut[0]], b["w"][cut[0]], b["t"][cut[0]], b["noise"][cut]]
        net.compute_dtype = dtype
        net.zero_grad(set_to_none=True)
        shapes = collections.Counter()
        _reset()
        with _by_shape(shapes), _plain_k1(plain):
            loss = step.loss_fn(*(a.to(dev) for a in args), wsum=float(b["w"].sum()) if spatial else None)
            torch.cuda.synchronize()
            fwd = _counts()
            loss.backward()
            torch.cuda.synchronize()
        bwd = {k: v - fwd[k] for k, v in _counts().items()}
        if spatial:
            (loss,) = sum_gradients(mesh, list(net.parameters()), loss, spatial=True)
        loss = float(loss.detach())
        grads = {k: p.grad.detach().float().cpu() for k, p in net.named_parameters()}
        if rank == 0:
            torch.save({"loss": loss, "grads": grads}, out / f"rank0_grad_{tag}.pt")
        rec["grads"][tag] = {"loss": loss, "forward_launches": {k: v for k, v in fwd.items() if v},
                             "backward_launches": {k: v for k, v in bwd.items() if v}, "by_shape": dict(shapes)}

    first = task["batches"][0]
    grad("fp32", first, torch.float32)
    if not spatial:
        for i, path in enumerate(task["batches"]):
            grad(f"fp32_plain{i}", path, torch.float32, plain=True)
    for i, path in enumerate(task["batches"]):
        grad(f"bf16_{i}", path, torch.bfloat16)
    del net, step
    torch.cuda.empty_cache()

    steps = rec["steps"] = []
    real = module.make_train_step

    def recording(*args, **kw):
        run = real(*args, **kw)

        def timed(*a, **k):
            shapes, calls = collections.Counter(), collections.Counter()
            _reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _by_shape(shapes), _counting(calls):
                loss = run(*a, **k)
                steps.append({"loss": float(loss)})  # the global loss: a host sync
                torch.cuda.synchronize()
            steps[-1].update(s=time.perf_counter() - t0, launches={k: v for k, v in _counts().items() if v},
                             by_shape=dict(shapes), collectives=dict(calls))
            return loss

        return timed

    argv = task["argv"] + (["--spatial_shard", str(mesh.size())] if spatial else ["--distributed"])
    module.make_train_step = recording
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        with raw_frames(zstd_engine() is not None):
            train_cli.main(argv + ["--save_dir", str(out / "cli")])
    finally:
        module.make_train_step = real
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    return rec


TASKS = {"tp_forward": tp_forward, "tp_artifact": tp_artifact, "spatial_sample": spatial_sample,
         "spatial_artifact": spatial_artifact, "spatial_train": spatial_train}


def main(argv=None) -> int:
    job = json.loads(Path((argv or sys.argv[1:])[0]).read_text())
    out = Path(job["out"])
    rank = int(os.environ.get("RANK", 0))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {}
    for task in job["tasks"]:
        t0 = time.perf_counter()
        rec[task["name"]] = TASKS[task["name"]](task, out, rank)
        rec[task["name"]]["wall_s"] = time.perf_counter() - t0
    import torch.distributed as dist

    rec["world"] = dist.get_world_size()
    rec["backend"] = str(dist.get_backend_config())
    rec["jax_modules"] = sorted(m for m in sys.modules if m in ("jax", "clip_codec_tpu")
                                or m.startswith(("jax.", "clip_codec_tpu.")))
    (out / f"rank{rank}.json").write_text(json.dumps(rec, default=str))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
