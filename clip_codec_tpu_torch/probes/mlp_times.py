"""Device time of the SD path's transformer MLP (K6) at SD-1.5's shapes, beside cuBLAS.

    python -m clip_codec_tpu_torch.probes.mlp_times [--seed 0]
    PYTHONPATH=<another checkout> python <path of this file>

Times, for SD-1.5 at 512px (64x64 latents, CFG batched):

1. K6 (``ops.mlp.transformer_mlp`` with the weights packed once, as the
   model caches them) at the (R, C, F) of every MLP of a UNet forward at
   batch 2 and 8 (serving: requests of one and of four embeddings) and at
   batch 4 (adapter training), and, where the checkout has them, its two
   stages alone (``mlp_up``, ``mlp_down``);
2. cuBLAS's unfused bf16 MLP at each shape (``F.layer_norm``, ``F.linear``,
   ``F.gelu``, ``F.linear``: several calls, for scale) and, beside
   ``mlp_down``, ``F.linear`` alone (one call computing its function);
3. at each shape, how far K6's output and ``mlp_plain``'s (both bf16) are
   from the same MLP in fp32 (``mlp_plain`` on fp32 inputs):
   ||y - y_fp32|| / ||y_fp32|| for each, and their ratio (the MLP-level
   counterpart of chip_smoke's kernel-path / plain-path check);
4. one SD-1.5 UNet forward (random weights from --seed, bf16, an 8-token
   context) at batch 2 and 8: the device time of its kernels and of K6's
   (``torch.profiler``, summed over 3 forwards) and CUDA events around it.

Each kernel line is ``probes.attn_probe.time_call``'s: the device time per
call of 20 calls replayed from a CUDA graph, then CUDA events around 20
calls from Python. TF/s counts the function's 6 R C F FLOP (4 R C F for
mlp_up, 2 R C F for mlp_down).

Only ``transformer_mlp``, ``pack_weights`` and ``mlp_plain`` are needed (the
stages are timed only where ``ops.mlp`` has them), so run by path with
PYTHONPATH at another checkout's root the script times that checkout: two
versions compared on one card in one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from clip_codec_tpu_torch.ops import mlp
from clip_codec_tpu_torch.probes.attn_probe import time_call

LATENT = 64  # 512px


def unet_mlp_shapes(batch: int):
    """[((R, C, F), calls per forward)] of SD-1.5's UNet at 64x64 latents:
    five blocks at each of the three widths (two down, three up) and the
    mid-block's one at 8x8."""
    hw = LATENT * LATENT
    return [((batch * hw, 320, 1280), 5), ((batch * hw // 4, 640, 2560), 5),
            ((batch * hw // 16, 1280, 5120), 5), ((batch * hw // 64, 1280, 5120), 1)]


def mlp_inputs(gen, R, C, Fh, dev):
    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn((R, C)).to(torch.bfloat16)
    lns, lnb = 1 + randn((C,), 0.1), randn((C,), 0.1)
    wh, wg = randn((C, Fh), C ** -0.5), randn((C, Fh), C ** -0.5)
    bh, bg = randn((Fh,), 0.1), randn((Fh,), 0.1)
    return x, lns, lnb, wh, bh, wg, bg, randn((Fh, C), Fh ** -0.5)


def cublas_unfused(x, lns, lnb, wh, bh, wg, bg, wo):
    """The same MLP as cuBLAS bf16 GEMMs and PyTorch's elementwise kernels."""
    C = x.shape[-1]
    bf = torch.bfloat16
    wgeglu, bgeglu = torch.cat([wh, wg], dim=1).t().to(bf).contiguous(), torch.cat([bh, bg]).to(bf)
    who, lnw, lnbb = wo.t().to(bf).contiguous(), lns.to(bf), lnb.to(bf)

    def run():
        a, g = F.linear(F.layer_norm(x, (C,), lnw, lnbb, 1e-6), wgeglu, bgeglu).chunk(2, dim=-1)
        return F.linear(a * F.gelu(g), who)

    return run


def time_mlps(dev: torch.device, seed: int = 0) -> None:
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = []
    for batch in (2, 8, 4):
        shapes += [s for s, _ in unet_mlp_shapes(batch) if s not in shapes]
    stages = hasattr(mlp, "mlp_up") and hasattr(mlp, "mlp_down")
    for R, C, Fh in shapes:
        args = mlp_inputs(gen, R, C, Fh, dev)
        packed = mlp.pack_weights(args[3], args[5], args[7])
        flops = 6 * R * C * Fh
        tag = f"({R}, {C}, {Fh})"
        time_call(f"K6 {tag}", lambda: mlp.transformer_mlp(*args, packed=packed), flops, dev)
        if stages:
            h = mlp.mlp_up(*args[:7], packed=packed)
            time_call(f"K6 mlp_up {tag}", lambda: mlp.mlp_up(*args[:7], packed=packed), 4 * R * C * Fh, dev)
            time_call(f"K6 mlp_down {tag} splits={mlp.kernel_splits(R, C, Fh, dev)}",
                      lambda: mlp.mlp_down(h, args[7], packed), 2 * R * C * Fh, dev)
            time_call(f"F.linear alone (mlp_down's function) {tag}", lambda: F.linear(h, packed[1]),
                      2 * R * C * Fh, dev)
        time_call(f"cuBLAS unfused {tag}", cublas_unfused(*args), flops, dev)
        y32 = mlp.mlp_plain(*(a.float() for a in args)).double()
        dist = [((y.double() - y32).norm() / y32.norm()).item()
                for y in (mlp.transformer_mlp(*args, packed=packed), mlp.mlp_plain(*args))]
        print(f"[mlp-times] K6 {tag} distance from fp32: kernel {dist[0]:.4e} plain {dist[1]:.4e} "
              f"ratio {dist[0] / dist[1]:.4f}", flush=True)


def time_unet(dev: torch.device, seed: int = 0, reps: int = 3) -> None:
    """Device time of an SD-1.5 UNet forward's kernels and of K6's among
    them (profiler), and events around it, at batch 2 and 8."""
    from torch.profiler import ProfilerActivity, profile

    from clip_codec_tpu_torch.models import init_params
    from clip_codec_tpu_torch.models.sd import SD15_UNET, SDUNet

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.device(dev):
        unet = init_params(SDUNet(SD15_UNET, dtype=torch.bfloat16), gen).eval()
    for B in (2, 8):
        lat = torch.randn((B, LATENT, LATENT, 4), generator=gen, device=dev)
        t = torch.full((B,), 501, dtype=torch.int32, device=dev)
        ctx = torch.randn((B, 8, SD15_UNET.cross_dim), generator=gen, device=dev)
        with torch.no_grad():
            for _ in range(2):
                unet(lat, t, ctx)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    unet(lat, t, ctx)
                torch.cuda.synchronize()
            events = prof.key_averages()
            dev_us = sum(e.self_device_time_total for e in events)
            mlp_us = sum(e.self_device_time_total for e in events if "mlp" in e.key or "sum_splits" in e.key)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                unet(lat, t, ctx)
            end.record()
            end.synchronize()
            wall = (time.perf_counter() - t0) / reps * 1e3
        print(f"[mlp-times] SD-1.5 UNet forward B={B} {LATENT}x{LATENT}: device {dev_us / reps / 1e3:.4f} ms of "
              f"kernels, K6 {mlp_us / reps / 1e3:.4f} ms of them, events {start.elapsed_time(end) / reps:.4f} ms, "
              f"host {wall:.4f} ms", flush=True)
    del unet
    torch.cuda.empty_cache()


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Time K6 at SD-1.5's MLP shapes on a card.")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("no CUDA device available: the kernels run only on a card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"-- device: {smi.stdout.strip()}; kernels from {mlp.__file__} --", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    time_mlps(dev, args.seed)
    time_unet(dev, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
