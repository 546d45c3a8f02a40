"""Where K1's time goes inside its one launch: per-round phase times on a card.

    python -m clip_codec_tpu_torch.probes.gn_trace [--seed 0] [--reps 5]

Builds ``csrc/groupnorm_silu.cu`` with ``-DGN_TRACE`` (a development build
beside the production one: thread 0 of every block stamps ``%globaltimer``
at each round's phases) and runs it at ``probes.gn_times.SHAPES`` (batch 8,
bf16, 8 groups). For each round it prints, in microseconds and as the mean
over blocks (max in brackets), from the round's start in each block:

* ``stats``: until its last slab has landed and been summed (its loads
  waited for, per-slab partials published);
* ``barrier``: the grid barrier (arrival skew and the barrier itself);
* ``sample``: the group statistics from the slab partials;
* ``norm``: normalising its slabs and releasing them to the stores;

then the launch's span: from the first block's start to the last block's
end of its compute (the producer's last stores may drain after it). The
stamps are taken on the last of ``--reps`` launches. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from typing import Optional, Sequence

import torch

from clip_codec_tpu_torch.ops import _build
from clip_codec_tpu_torch.ops import groupnorm as gn
from clip_codec_tpu_torch.probes.gn_times import BATCH, GROUPS, SHAPES

PHASES = ("stats", "barrier", "sample", "norm")


def traced_lib() -> ctypes.CDLL:
    lib = gn.bind(ctypes.CDLL(str(_build.build("groupnorm_silu", ("-DGN_TRACE",)))))
    lib.groupnorm_silu_set_trace.argtypes = [ctypes.c_void_p]
    lib.groupnorm_silu_set_trace.restype = ctypes.c_int
    return lib


def trace_shape(lib: ctypes.CDLL, dev: torch.device, gen: torch.Generator, H: int, W: int, C: int,
                reps: int) -> None:
    B, G = BATCH, GROUPS
    x = (2 * torch.randn((B, H, W, C), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
    scale = 1 + 0.2 * torch.randn((C,), generator=gen, device=dev)
    bias = 0.2 * torch.randn((C,), generator=gen, device=dev)
    p = gn.plan(B, H, W, C, G, 2)
    stamps = torch.zeros((p.grid, p.rounds, 8), dtype=torch.int64, device=dev)
    rc = lib.groupnorm_silu_set_trace(stamps.data_ptr())
    if rc != 0:
        raise RuntimeError(f"groupnorm_silu_set_trace failed: CUDA error {rc}")
    with torch.no_grad():
        for _ in range(reps):
            gn.group_norm_silu(x, (scale, bias), G)
    torch.cuda.synchronize()
    lib.groupnorm_silu_set_trace(None)
    t = stamps.double().cpu() / 1e3  # microseconds
    t0 = t[:, 0, 0].min()
    print(f"[gn-trace] B={B} {H}x{W}x{C} bf16: {p.rounds} rounds, {p.slabs} slabs of {p.slab_rows} rows "
          f"({p.chunks} chunks) a sample, "
          f"{p.per_round} samples a round, grid {p.grid}, ring {p.ring}; span {float(t[:, -1, 4].max() - t0):.2f} us",
          flush=True)
    for r in range(p.rounds):
        d = t[:, r, 1:5] - t[:, r, 0:4]
        cells = ", ".join(f"{name} {float(d[:, i].mean()):.2f} [{float(d[:, i].max()):.2f}]"
                          for i, name in enumerate(PHASES))
        loads = float((t[:, r, 5] - t[:, r, 2]).mean())
        own = float((t[:, r, 7] - t[:, r, 2]).mean())
        first = t[:, r, 6] > 0
        slab0 = float((t[first, r, 6] - t[first, r, 3]).mean()) if bool(first.any()) else float("nan")
        print(f"[gn-trace]   round {r}: starts {float(t[:, r, 0].mean() - t0):.2f} us; {cells}; "
              f"(sample: partial loads {loads:.2f}, thread 0's own {own:.2f}; norm: first slab {slab0:.2f})",
              flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Per-round phase times of K1 on a card.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("no CUDA device available: the kernel runs only on a card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"-- device: {smi.stdout.strip()} --", flush=True)
    lib = traced_lib()
    saved = gn._kernel_lib
    gn._kernel_lib = lambda: lib
    try:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        for H, W, C in SHAPES:
            trace_shape(lib, dev, gen, H, W, C, args.reps)
    finally:
        gn._kernel_lib = saved
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
