"""Device time of flash attention's kernels at the SD path's shapes, beside SDPA.

    python -m clip_codec_tpu_torch.probes.flash_times [--seed 0]
    PYTHONPATH=<another checkout> python <path of this file>

Times K4 (``ops.attention.flash_attention_fwd``) at the six (BH, N, D)
shapes of SD-1.5 serving at 512px with CFG batched (``chip_smoke.py``'s
FLASH_SHAPES) and SDPA's forward at each; then the K5 pair
(``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``) at the three
shapes of SD adapter training at batch 4 and the VAE decode's mid-block at
batch 1 that a guided inversion step backpropagates through
(FLASH_BWD_SHAPES), and SDPA's backward at each. Each line is ``probes.attn_probe.time_call``'s: the device
time per call of 20 calls replayed from a CUDA graph, then CUDA events around
20 calls from Python (at the small shapes, the host's issue time); SDPA's
backward, an autograd call, by events only. TF/s counts the function's own
products: 4 BH N^2 D FLOP forward, 6 and 8 BH N^2 D in dq and dk/dv.

The package is imported by its absolute name and only the wrappers' public
functions are called, so run by path with PYTHONPATH at another checkout's
root the script times that checkout's kernels: two versions compared on one
card in one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from clip_codec_tpu_torch.ops import attention as attn
from clip_codec_tpu_torch.probes.attn_probe import _events_ms, time_call

FLASH_SHAPES = [(16, 4096, 40), (16, 1024, 80), (1, 4096, 512),
                (64, 4096, 40), (64, 1024, 80), (4, 4096, 512)]  # (BH, N, D)
FLASH_BWD_SHAPES = [(32, 4096, 40), (32, 1024, 80), (4, 4096, 512), (1, 4096, 512)]


def run(dev: torch.device, seed: int = 0) -> None:
    smi = subprocess.run(["nvidia-smi", "-i", str(dev.index or 0), "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"-- device: {smi.stdout.strip()}; kernels from {attn.__file__} --", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    for BH, N, D in FLASH_SHAPES:
        q, k, v = (randn((BH, N, D)) for _ in range(3))
        fl = 4 * BH * N * N * D
        time_call(f"K4 ({BH}, {N}, {D})", lambda: attn.flash_attention_fwd(q, k, v), fl, dev)
        time_call(f"SDPA ({BH}, {N}, {D})", lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]),
                  fl, dev)
    for BH, N, D in FLASH_BWD_SHAPES:
        q, k, v, dout = (randn((BH, N, D)) for _ in range(4))
        out, lse = attn.flash_attention_fwd(q, k, v)
        args = (q, k, v, dout, *attn._bwd_stats(out, lse, dout))
        fl = 2 * BH * N * N * D
        time_call(f"K5 dq ({BH}, {N}, {D})", lambda: attn.flash_attention_bwd_dq(*args), 3 * fl, dev)
        time_call(f"K5 dk/dv ({BH}, {N}, {D})", lambda: attn.flash_attention_bwd_dkv(*args), 4 * fl, dev)
        qs, ks, vs = (t[None].detach().requires_grad_(True) for t in (q, k, v))
        o = F.scaled_dot_product_attention(qs, ks, vs)
        ms = _events_ms(lambda: torch.autograd.grad(o, (qs, ks, vs), dout[None], retain_graph=True))
        print(f"[attn-probe] {f'SDPA backward ({BH}, {N}, {D})':<46} events {ms:8.4f} ms", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Time K4 and the K5 pair at the SD path's shapes on a card.")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("no CUDA device available: the kernels run only on a card")
    run(torch.device("cuda", 0), args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
