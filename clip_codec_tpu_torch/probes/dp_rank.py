"""One rank of the data-parallel smoke run (``chip_smoke.py`` phase 23), on
the card:

    python -m clip_codec_tpu_torch.probes.dp_rank JOB.json

started once a rank (``parallel.launch.spawn_ranks``) with the launcher's
environment. ``JOB.json`` holds ``{"out": dir, "tasks": [...]}``; each task
runs here in turn and this rank writes what it did to
``<out>/rank<r>.json`` (tensors to ``<out>/rank<r>_<task>_{start,final,grad1}.pt``):

* ``train``, ``train_sd``: ``cli.train`` / ``cli.train_sd`` with the task's
  ``argv`` (``--data_parallel`` or ``--distributed`` in it); per step the
  global loss and the synchronized seconds, the parameters before the first
  step and after the last, the first step's gradient (summed over the
  ranks), and the kernels' launches (K1 by shape; K4, the K5 pair and K6);
* ``search``: ``n`` seeded unit rows at ``d`` drawn on the card (the same
  on every rank), quantized by ``codecs/quantizer.py``; the sharded fp32
  and u8 exact indexes against the single ones at ``k`` for each query
  count, launches of ``u8_ip_scores`` a search, this rank's device ms a
  search (CUDA events over its scoring and top-k) and a whole search's wall
  (the gather and the host merge too), resident bytes; then
  ``cli.search_text`` with and without ``--data_parallel`` on a store;
* ``artifact``: ``export_sharded_decompressor`` / ``load_sharded_decompressor``
  of the checkpoint at ``weights``; a first call (the capture), then at
  each seed one call's launches of K2 and K3, a replay's device ms (CUDA
  events around the graph's replay) and rank 0's gathered images as uint8;
  the task's launches in all.

Frames are real zstd frames where a zstd engine exists (``bitstream.zstd_engine()``: the native
codec on the card machine), else they carry the raw codes (``serve_times.raw_frames``).
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


def _cpu_state(module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def _launches() -> dict:
    from ..ops import attention as attn
    from ..ops import groupnorm as gn
    from ..ops import mlp
    from ..ops import resblock_conv as rc
    from ..ops import u8_scan

    return {"group_norm_silu": gn.group_norm_silu, "flash_attention": attn.flash_attention_fwd,
            "flash_attention_bwd_dq": attn.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": attn.flash_attention_bwd_dkv, "mlp_up": mlp.mlp_up,
            "mlp_down": mlp.mlp_down, "affine_silu_conv3x3": rc.affine_silu_conv3x3,
            "affine_conv3x3": rc.affine_conv3x3, "u8_ip_scores": u8_scan.u8_ip_scores}


def _reset() -> None:
    for fn in _launches().values():
        fn.launches = 0


def _counts() -> dict:
    return {k: fn.launches for k, fn in _launches().items()}


@contextlib.contextmanager
def _k1_shapes(shapes: collections.Counter):
    from ..ops import groupnorm as gn

    launch = gn._launch

    def tally(x, *args):
        shapes[str(list(x.shape))] += 1
        return launch(x, *args)

    gn._launch = tally
    try:
        yield
    finally:
        gn._launch = launch


def train(task: dict, out: Path, rank: int) -> dict:
    """A training CLI with every step recorded."""
    sd = task["name"] == "train_sd"
    if sd:
        from ..cli import train_sd as cli
        from ..train import sd_diffusion_train as module

        factory = "make_sd_train_step"
    else:
        from ..cli import train as cli
        from ..train import diffusion_train as module

        factory = "make_train_step"
    rec = {"losses": [], "step_s": []}
    held = {}
    real = getattr(module, factory)

    def recording(*args, **kw):
        step = real(*args, **kw)
        held["model"] = args[0].adapter if sd else args[0]

        def timed(*a, **k):
            if "start" not in held:
                held["start"] = _cpu_state(held["model"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(*a, **k)
            rec["losses"].append(float(loss))  # the global loss: a host sync
            torch.cuda.synchronize()
            rec["step_s"].append(time.perf_counter() - t0)
            if "grad" not in held:  # the first step's gradient, summed over the ranks
                held["grad"] = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).detach().float()
                                          .flatten() for p in held["model"].parameters()]).cpu()
            return loss

        return timed

    shapes = collections.Counter()
    setattr(module, factory, recording)
    _reset()
    try:
        with _k1_shapes(shapes):
            cli.main(task["argv"])
    finally:
        setattr(module, factory, real)
    rec["launches"] = _counts()
    rec["k1_by_shape"] = dict(shapes)
    for key, state in (("start", held["start"]), ("final", _cpu_state(held["model"])), ("grad1", held["grad"])):
        torch.save(state, out / f"rank{rank}_{task['name']}_{key}.pt")
    del held
    torch.cuda.empty_cache()
    return rec


def _same_hits(got, want, tol: float) -> dict:
    """``got`` (k places) against ``want`` (k + 1): scores within ``tol``;
    ids equal wherever neighbouring scores differ by more than ``tol``
    (near ties may swap)."""
    (gs, gi), (ws, wi) = got, want
    k = gs.shape[1]
    gap = np.abs(np.diff(ws, axis=1)) > tol
    keep = (np.concatenate([np.ones((ws.shape[0], 1), bool), gap[:, :-1]], axis=1) & gap)[:, :k]
    return {"max_score_err": float(np.abs(gs - ws[:, :k]).max()),
            "ids_equal": bool((gi[keep] == wi[:, :k][keep]).all()), "near_tie_places": int((~keep).sum())}


def search(task: dict, out: Path, rank: int) -> dict:
    """The sharded exact indexes against the single ones, then the CLI."""
    from ..cli import search_text
    from ..codecs.quantizer import fit_affine, quantize
    from ..index import build_index, build_index_u8, build_sharded_index, build_sharded_index_u8
    from ..ops import u8_scan
    from ..parallel import make_mesh
    from ..parallel.mesh import rank_device

    mesh = make_mesh()
    dev = rank_device(mesh)
    n, d, k = task["n"], task["d"], task["k"]
    gen = torch.Generator(device=dev).manual_seed(task["seed"])
    x = torch.nn.functional.normalize(torch.randn((n, d), generator=gen, device=dev), dim=-1)
    scale, zero = fit_affine(x)
    codes = quantize(x, scale, zero)
    queries = {q: torch.nn.functional.normalize(torch.randn((q, d), generator=gen, device=dev), dim=-1)
               for q in task["queries"]}
    rec = {"forms": {}}
    for form in ("fp32", "u8"):
        if form == "fp32":
            single, sharded = build_index(x, device=dev), build_sharded_index(x, mesh)
            resident = sharded.feats.numel() * 4
        else:
            single = build_index_u8(codes, scale, zero, device=dev)
            sharded = build_sharded_index_u8(codes, scale, zero, mesh)
            resident = sharded.codes.numel() + sharded.inv_norms.numel() * 4 + 2 * d * 4
        by_q = {}
        for q, qv in queries.items():
            u8_scan.u8_ip_scores.launches = 0
            got = sharded.search(qv, k)
            launches = u8_scan.u8_ip_scores.launches
            check = _same_hits(got, single.search(qv, k + 1), task["tol"])
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            for _ in range(3):
                sharded._local(qv, k)
            start.record()
            for _ in range(20):
                sharded._local(qv, k)
            end.record()
            end.synchronize()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                sharded.search(qv, k)
            wall = (time.perf_counter() - t0) / 10 * 1e3
            by_q[q] = {**check, "launches_a_search": launches, "local_device_ms": start.elapsed_time(end) / 20,
                       "search_wall_ms": wall}
        rec["forms"][form] = {"rows": int(sharded.feats.shape[0] if form == "fp32" else sharded.codes.shape[0]),
                              "base": sharded.base, "resident_bytes": int(resident), "by_q": by_q}
        del single, sharded
    del x, codes
    torch.cuda.empty_cache()
    from ..io.bitstream import zstd_engine
    from .serve_times import raw_frames

    rec["cli"] = {}
    with raw_frames(zstd_engine() is not None):
        for name, extra in (("single", []), ("sharded", ["--data_parallel"])):
            for u8 in ([], ["--u8"]):
                u8_scan.u8_ip_scores.launches = 0
                rec["cli"][f"{name}{'_u8' if u8 else ''}"] = _stdout(lambda: search_text.main(task["cli"] + extra + u8))
                if name == "sharded" and u8:
                    rec["cli_u8_launches"] = u8_scan.u8_ip_scores.launches
    return rec


def _stdout(fn) -> list:
    import io

    b = io.StringIO()
    with contextlib.redirect_stdout(b):
        fn()
    return b.getvalue().splitlines()


def artifact(task: dict, out: Path, rank: int) -> dict:
    """The data-sharded pixel artifact: export, load, capture, replays."""
    from .. import deploy
    from ..parallel import make_mesh
    from ..utils.checkpoint import load_state_dict
    from ..utils.config import ModelConfig

    mesh = make_mesh()
    params = load_state_dict(task["weights"])
    mc = ModelConfig.find_for_checkpoint(task["weights"])
    path = Path(task["path"])
    deploy.export_sharded_decompressor(params, mc, path, mesh, size=task["size"], steps=task["steps"],
                                       batch_size=task["batch"])
    call = deploy.load_sharded_decompressor(path, mesh)
    z = np.load(task["z"])
    rec = {"meta": call.meta, "rows": [call.rows.start, call.rows.stop], "by_seed": {}}
    _reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call(params, z, seed=task["seeds"][0])  # the eager warm-up and the capture
    torch.cuda.synchronize()
    rec["first_call_s"] = time.perf_counter() - t0
    for seed in task["seeds"]:
        before = _counts()
        img = call(params, z, seed=seed)
        launches = {k: _counts()[k] - before[k] for k in ("affine_silu_conv3x3", "affine_conv3x3", "group_norm_silu")}
        u8 = ((img.clamp(-1, 1) + 1.0) * 127.5).to(torch.uint8).cpu().numpy()
        if rank == 0:
            np.save(out / f"artifact_seed{seed}.npy", u8)
        rec["by_seed"][seed] = {"launches": launches, "shape": list(img.shape)}
        if call.graph is not None:  # the card's program (the CPU runs the sampler eagerly)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call.graph.graph.replay()
            end.record()
            end.synchronize()
            rec["by_seed"][seed]["replay_device_ms"] = start.elapsed_time(end)
    rec["launches"] = _counts()  # the whole task: the first call's eager warm-up, its capture's replay, the seeds'
    del call
    torch.cuda.empty_cache()
    return rec


TASKS = {"train": train, "train_sd": train, "search": search, "artifact": artifact}


def main(argv=None) -> int:
    job = json.loads(Path((argv or sys.argv[1:])[0]).read_text())
    out = Path(job["out"])
    rank = int(os.environ.get("RANK", 0))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from ..io.bitstream import zstd_engine
    from .serve_times import raw_frames

    rec = {}
    for task in job["tasks"]:
        t0 = time.perf_counter()
        if task["name"] in ("train", "train_sd"):
            with raw_frames(zstd_engine() is not None):
                rec[task["name"]] = TASKS[task["name"]](task, out, rank)
        else:
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
