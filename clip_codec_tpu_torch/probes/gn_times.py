"""Device time of K1, the pixel path's fused GroupNorm+SiLU, at its training shapes, beside the library.

    python -m clip_codec_tpu_torch.probes.gn_times [--seed 0]
    PYTHONPATH=<another checkout> python <path of this file>

Times, at the four (H, W, C) of every GroupNorm+SiLU of the full-width U-Net
(base 128, ch_mult (1, 2, 2)) at 256px, pixel training's batch 8, bf16,
8 groups (``SHAPES``; 4, 8, 8 and 8 calls per forward):

1. ``ops.groupnorm.group_norm_silu`` (K1 on the card), under no_grad;
2. ``F.group_norm`` + ``F.silu`` on the same tensor (an NCHW view of the
   NHWC data, bf16 weights), for scale: the port never calls it;

and prints the bound: the larger of x read once and y written once over
3.35 TB/s and 11 fp32 operations an element over 67 TFLOP/s (H100 SXM).

Each timed line is ``probes.attn_probe.time_call``'s: the device time per
call of 20 calls replayed from a CUDA graph, then CUDA events around 20
calls from Python (its TF/s column counts the 11 operations an element).
A ``[gn-times]`` line then gives K1's graph-replayed ms against its bound.
The 20 calls read the same x, so at the two smaller shapes (x of 16.8 and
8.4 MB) x may come from the 50 MB L2 where a training step's would not.

Only the package's public functions are called, so run by path with
PYTHONPATH at another checkout's root the script times that checkout: two
versions compared on one card in one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from clip_codec_tpu_torch.ops import groupnorm as gn
from clip_codec_tpu_torch.probes.attn_probe import time_call

BATCH, GROUPS = 8, 8
SHAPES = [(256, 256, 128), (128, 128, 128), (64, 64, 256), (32, 32, 512)]  # (H, W, C)
CALLS_PER_FORWARD = (4, 8, 8, 8)
HBM_BYTES_PER_S, FP32_FLOPS_PER_S = 3.35e12, 67e12  # H100 SXM
OPS_PER_ELEMENT = 11


def bound_ms(B: int, H: int, W: int, C: int, itemsize: int) -> float:
    n = B * H * W * C
    return max(2 * n * itemsize / HBM_BYTES_PER_S, OPS_PER_ELEMENT * n / FP32_FLOPS_PER_S) * 1e3


def time_gn(dev: torch.device, seed: int = 0) -> None:
    gen = torch.Generator(device=dev).manual_seed(seed)
    for (H, W, C), calls in zip(SHAPES, CALLS_PER_FORWARD):
        B, G = BATCH, GROUPS
        x = (2 * torch.randn((B, H, W, C), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
        scale = 1 + 0.2 * torch.randn((C,), generator=gen, device=dev)
        bias = 0.2 * torch.randn((C,), generator=gen, device=dev)
        xc, sb, bb = x.permute(0, 3, 1, 2), scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        ops = OPS_PER_ELEMENT * B * H * W * C
        tag = f"B={B} {H}x{W}x{C} G={G} bf16"
        with torch.no_grad():
            k1 = time_call(f"K1 group_norm_silu {tag}", lambda: gn.group_norm_silu(x, (scale, bias), G), ops, dev)
            lib = time_call(f"F.group_norm+F.silu {tag}", lambda: F.silu(F.group_norm(xc, G, sb, bb, gn.GN_EPS)),
                            ops, dev)
        b = bound_ms(B, H, W, C, x.element_size())
        print(f"[gn-times] {tag}: K1 {k1['graph_ms']:.4f} ms (events {k1['events_ms']:.4f}), bound {b:.4f} ms "
              f"(bytes), {100 * b / k1['graph_ms']:.1f}% of bound, {2 * x.numel() * 2 / k1['graph_ms'] / 1e9:.3f} "
              f"TB/s; library {lib['graph_ms']:.4f} ms; {calls} calls per forward", flush=True)
        del x, xc


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Time K1 at pixel training's shapes on a card.")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("no CUDA device available: the kernel runs only on a card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"-- device: {smi.stdout.strip()}; kernel from {gn.__file__} --", flush=True)
    time_gn(dev, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
