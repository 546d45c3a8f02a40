"""Where flash attention's time goes: the port of ``bench_attn_probe.py``.

    python -m clip_codec_tpu_torch.probes.attn_probe [--device cuda|cpu] [--bh 64 --n 4096 --d 40] [--seed 1]

Times, at one (BH, N, D) shape (by default SD-1.5's first-level
self-attention at UNet batch 8: a CFG-batched request of four embeddings,
8 heads x 8, 64x64 latents, head dim 320 / 8 = 40):

1. eleven batched bf16 matrix products of the shapes of Q.K^T (contraction
   K = 40..256) and P.V (output width 40..256) at (BH, min(N, 1024)), and
   one with three heads packed into K = 120: plain ``torch.matmul``;
2. the production forward (K4, ``ops.attention.flash_attention_fwd``) and
   SDPA (``F.scaled_dot_product_attention``, for scale), then the P1
   variants (``ops.attention_probe.flash_variant``, on K4's own loop: the
   scale multiply, the running max, the exp or the whole softmax taken
   away at K4's tile (192, 128), and ``full`` and ``exp2`` at the other
   tiles), the P3 variants (the exact row max first, no rescale) and the
   P2 variants (polynomial or hardware exp2, the row sum on the P.V product
   or summed from fp32 p; the four forms at K4's tile, poly2 with the row
   sum on P.V at the others), each as its kernel alone
   (``fast_flash_kernel`` on a v that already has its ones column) and as
   the ``fast_flash_acc`` wrapper, which builds that column (``wrapper``);
3. each form's ``max|delta| / max|oracle|`` against an fp32 oracle computed
   one head at a time: production, exp2-fold, poly2 and poly3 with the
   row sum on the P.V product (P2 at (192, 128), divided outside the
   kernel).

Each timed line reads ``[attn-probe] <label> <ms> ms <TF/s> TF/s``: the
device time per call of 20 calls captured in a CUDA graph and replayed
(no host time between calls), then the CUDA events around 20 calls made
from Python. TF/s counts attention's 4 * BH * N^2 * D FLOP (a product's
own FLOP for the dot probes). A variant that fails to build or launch ends
the run with its error.

Run from another checkout's root (``cd <checkout> && python -m
clip_codec_tpu_torch.probes.attn_probe``), it times that checkout's
kernels: the package is imported by relative name.

``--device cpu`` runs the plain versions once each at the shape given
(``N % 128 == 0``): a check of the probe itself; its host times are no
device measurement. Inputs are bf16, drawn from a ``torch.Generator``
seeded with ``--seed``.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops import attention as attn
from ..ops import attention_probe as ap

REPS = 20  # calls per timing, in the graph and from Python
WARMUP = 3
P1_NAMES = {"full": "full", "exp2": "exp2 + scale folded into q", "noscale": "no scale mul",
            "nomax": "no max tracking (unsafe)", "noexp": "no exp (identity)", "dotonly": "dots only (no softmax)"}
# (label, tq, tk, mode): the six modes at K4's own tile (192, 128), then full and exp2 at the others.
P1_VARIANTS = [(f"{P1_NAMES[mode]} ({tq},{tk})" + (" [= production form]" if (mode, tq, tk) == ("full", 192, 128)
                                                   else ""), tq, tk, mode) for mode, tq, tk in ap.P1_TILES]
P3_VARIANTS = [(f"single-pass (exact max, no rescale) tq={tq}", tq) for tq in ap.P3_TILES]
# (label, tq, tk, deg, mxu_sum)
P2_VARIANTS = [(f"{'hw' if deg == 0 else f'poly{deg}'}-exp2 + {'mxu' if mxu else 'vpu'}-sum ({tq},{tk})",
                tq, tk, deg, mxu) for deg, mxu, tq, tk in ap.P2_TILES]
CHECKS = ("production", "exp2-fold", "poly2+mxu-sum", "poly3+mxu-sum")


def _graph_ms(fn: Callable[[], object]) -> Tuple[float, int]:
    """Device ms per call of ``fn``: REPS calls captured in a CUDA graph,
    replayed once to warm up and once under CUDA events; and the number of
    replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / REPS, 2


def _events_ms(fn: Callable[[], object]) -> float:
    """ms per call from CUDA events around REPS calls made from Python."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def time_call(label: str, fn: Callable[[], object], flops: float, dev: torch.device) -> Dict[str, float]:
    """Times ``fn`` (see the module docstring) and prints its line; returns
    the times, the calls of ``fn`` made eagerly (``eager``: on the card each
    launches its kernels) and the calls the graph's replays ran
    (``replayed``; a call recorded into the graph launches nothing)."""
    calls = {"eager": 0, "captured": 0}

    def counted():
        calls["captured" if dev.type == "cuda" and torch.cuda.is_current_stream_capturing() else "eager"] += 1
        return fn()

    if dev.type == "cuda":
        g_ms, replays = _graph_ms(counted)
        e_ms = _events_ms(counted)
        print(f"[attn-probe] {label:<46} {g_ms:8.4f} ms {flops / g_ms / 1e9:6.1f} TF/s   events {e_ms:8.4f} ms",
              flush=True)
        return {"graph_ms": g_ms, "events_ms": e_ms, "eager": calls["eager"], "replayed": calls["captured"] * replays}
    t0 = time.perf_counter()
    counted()
    h_ms = (time.perf_counter() - t0) * 1e3
    print(f"[attn-probe] {label:<46} host {h_ms:8.3f} ms (cpu, plain version: not a device time)", flush=True)
    return {"host_ms": h_ms, "eager": calls["eager"], "replayed": 0}


def _randn(gen, shape, dev) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def dot_probes(gen, bh: int, n: int, dev: torch.device) -> Dict[str, dict]:
    """The products of Q.K^T and P.V at growing contraction and output
    widths, in bf16 with fp32 accumulation, out in bf16."""
    m = min(n, 1024)
    print(f"-- batched bf16 products (BH={bh}, {m} rows) --", flush=True)
    times = {}
    for kd in (40, 80, 120, 128, 256):
        q, k = _randn(gen, (bh, m, kd), dev), _randn(gen, (bh, m, kd), dev)
        label = f"qk^T contraction K={kd:<4} ({bh},{m},K)x2"
        times[label] = time_call(label, lambda: torch.matmul(q, k.transpose(1, 2)), 2 * bh * m * m * kd, dev)
    for nd in (40, 80, 120, 128, 256):
        p, v = _randn(gen, (bh, m, m), dev), _randn(gen, (bh, m, nd), dev)
        label = f"pv   output      N={nd:<4} ({bh},{m},{m})@(...,N)"
        times[label] = time_call(label, lambda: torch.matmul(p, v), 2 * bh * m * m * nd, dev)
    b3 = max(1, bh // 3)
    q3, k3 = _randn(gen, (b3, m, 120), dev), _randn(gen, (b3, 3 * m, 120), dev)
    label = f"qk^T head-packed ({b3},{m},120)@({b3},{3 * m},120)"
    times[label] = time_call(label, lambda: torch.matmul(q3, k3.transpose(1, 2)), 2 * b3 * m * 3 * m * 120, dev)
    return times


def oracle(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """fp32 softmax(q k^T / sqrt(D)) v, one head at a time (the whole (BH,
    N, N) score tensor is 4.3 GB at the default shape)."""
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for b in range(q.shape[0]):
        s = torch.matmul(q[b].float(), k[b].float().t()) / q.shape[-1] ** 0.5
        out[b] = torch.matmul(torch.softmax(s, dim=-1), v[b].float())
    return out


def run(dev: torch.device, bh: int = 64, n: int = 4096, d: int = 40, seed: int = 1) -> dict:
    """The whole probe; returns ``{"times": {label: ...}, "errors": {label:
    max|delta|/max|oracle|}, "calls": {wrapper: {"eager": n, "replayed":
    n}}}``: each probe wrapper's calls made eagerly and run by graph replays."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # the oracle's fp32 products in full fp32
        smi = subprocess.run(["nvidia-smi", "-i", str(dev.index or 0), "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, check=True)
        print(f"-- device: {smi.stdout.strip()} --", flush=True)
    else:
        print("-- device: cpu (plain versions, host clock: no device time) --", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    times = dot_probes(gen, bh, n, dev)
    q, k, v = (_randn(gen, (bh, n, d), dev) for _ in range(3))
    fl = 4 * bh * n * n * d
    calls = {w: {"eager": 0, "replayed": 0} for w in ("flash_variant", "fast_flash_acc", "single_pass")}

    def tally(wrapper: str, t: Dict[str, float]) -> None:
        for key in ("eager", "replayed"):
            calls[wrapper][key] += t[key]

    print(f"-- flash ablations at (BH={bh}, N={n}, D={d}) --", flush=True)
    times["production"] = time_call("production flash_attention_fwd (K4)",
                                    lambda: attn.flash_attention_fwd(q, k, v), fl, dev)
    times["sdpa"] = time_call("SDPA (library, for scale)",
                              lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]), fl, dev)
    for label, tq, tk, mode in P1_VARIANTS:
        times[label] = time_call(label, lambda: ap.flash_variant(q, k, v, tq, tk, mode), fl, dev)
        tally("flash_variant", times[label])
    for label, tq in P3_VARIANTS:
        times[label] = time_call(label, lambda: ap.single_pass(q, k, v, tq), fl, dev)
        tally("single_pass", times[label])
    print("-- fast-exp2 / row-sum variants: the kernel alone, then its wrapper --", flush=True)
    for label, tq, tk, deg, mxu in P2_VARIANTS:
        vk = ap.fast_v(v, mxu)
        times[label] = time_call(label, lambda: ap.fast_flash_kernel(q, k, vk, tq, tk, deg, mxu), fl, dev)
        tally("fast_flash_acc", times[label])
        wrapped = f"{label} wrapper"
        times[wrapped] = time_call(wrapped, lambda: ap.fast_flash_acc(q, k, v, tq, tk, deg, mxu), fl, dev)
        tally("fast_flash_acc", times[wrapped])

    print("-- correctness against an fp32 oracle --", flush=True)
    want = oracle(q, k, v)
    scale = want.abs().max().item()
    errors = {}
    for label, fn in zip(CHECKS, (lambda: attn.flash_attention_fwd(q, k, v)[0],
                                  lambda: ap.flash_variant(q, k, v, 192, 128, "exp2"),
                                  lambda: ap.fast_flash(q, k, v, 192, 128, 2, True),
                                  lambda: ap.fast_flash(q, k, v, 192, 128, 3, True))):
        errors[label] = (fn().float() - want).abs().max().item() / scale
        print(f"[attn-probe] {label:<16} max|delta|/max|oracle| = {errors[label]:.3e}", flush=True)
    calls["flash_variant"]["eager"] += 1
    calls["fast_flash_acc"]["eager"] += 2
    return {"times": times, "errors": errors, "calls": calls}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Time flash attention's variants (P1-P3) on a card.")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--bh", type=int, default=64)
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--d", type=int, default=40)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device available (--device cpu runs the plain versions)")
    run(torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu"),
        args.bh, args.n, args.d, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
