#!/usr/bin/env python3
"""Where the time of the port's SD-1.5 latent path and of its pixel training
step goes, on one CUDA card.

    python3 prof_sd.py [--seed N] [--parts 1,2,3,4]

Parts 1-3: SD-1.5 at its published widths, random weights from --seed,
bf16, 512px (64x64 latents), CFG batched (UNet batch 2 per embedding):

1. ``mlp-splits``: the fused MLP kernel (csrc/transformer_mlp.cu) at every
   split count it can take, at the MLP shapes of UNet batches 2, 4 and 8
   (requests of 1, 2 and 4 embeddings), beside the count its rule picks:
   ms per call from CUDA events over 30 calls after 5 warm-ups.
2. ``profile``: UNet forwards (B=2 and 8, through the kernels and through
   the plain versions), VAE decodes (B=1 and 4) and whole requests of 1
   and 4 embeddings (dpmpp-10, guidance 5). For each: wall ms per call on
   the host clock without the profiler (synchronized, after warm-ups);
   then under ``torch.profiler``: device ms per call (the summed durations
   of the device's kernels, copies and sets; one stream, so the union of
   their intervals is printed beside it as a check that nothing is counted
   twice), device busy = device ms / unprofiled wall ms, top-level aten ops
   and device kernels per call, device time by kind and the largest
   kernels; peak device memory of each request.
3. ``train``: the adapter training step at batch 4 (the default loss: eps-MSE
   plus the two VAE decodes of recon_w and tv_w; AdamW), through the
   kernels and through the plain versions, and the loss's forward alone
   (autograd on) to split forward from backward; the same measurements,
   and the peak device memory of each.
4. ``train_px``: the pixel decoder's training step at batch 8 (the
   reference's U-Net, base=128, ch_mult=(1,2,2), 256px, bf16 activations,
   the default loss, AdamW), through K1 and through the plain GroupNorm+SiLU,
   and the loss's forward alone; the same measurements (K1's share is its
   line in the time by kind), the host's self time by op, and the peak
   device memory of each.

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from collections import defaultdict

import chip_smoke as cs

KINDS = (  # first match wins: copies before the generic elementwise kernels
    ("group_norm_silu(K1)", ("gn_stats_kernel", "gn_norm_kernel")),
    ("affine_conv3x3(K2/K3)", ("affine_conv3x3",)),
    ("flash_attention(K4)", ("flash_fwd_kernel",)),
    ("flash_attention_bwd(K5)", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
    ("transformer_mlp(K6)", ("mlp_kernel", "sum_splits_kernel")),
    ("conv(cuDNN)", ("fprop", "conv", "cudnn")),
    ("gemm(cuBLAS)", ("gemm", "cublas", "cutlass")),
    ("cat/copy", ("copy", "cat", "memcpy", "memset")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def mlp_splits(torch, mlp, seed, dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    for B in (2, 4, 8):
        for R, C, F in ((B * 4096, 320, 1280), (B * 1024, 640, 2560), (B * 256, 1280, 5120),
                        (B * 64, 1280, 5120)):
            x = cs._randn(torch, gen, (R, C), dev, 1.0, bf)
            lns, lnb = 1 + cs._randn(torch, gen, (C,), dev, 0.1), cs._randn(torch, gen, (C,), dev, 0.1)
            wh, wg = (cs._randn(torch, gen, (C, F), dev, C ** -0.5) for _ in range(2))
            bh, bg = (cs._randn(torch, gen, (F,), dev, 0.1) for _ in range(2))
            wo = cs._randn(torch, gen, (F, C), dev, F ** -0.5)
            packed = mlp.pack_weights(wh, wg, wo)
            chunks = F // 160
            counts = sorted({-(-chunks // per) for per in range(1, chunks + 1)})  # no empty split
            times = {s: cs.cuda_ms(torch, lambda: mlp._launch(x, lns, lnb, bh, bg, packed, splits=s),
                                   iters=30, warmup=5) for s in counts}
            best = min(times, key=times.get)
            print(f"mlp-splits: UNet batch {B} (R, C, F)=({R}, {C}, {F}) rule={mlp.kernel_splits(R, C, F, dev)} "
                  f"best={best} " + " ".join(f"s{s}={ms:.4f}" for s, ms in times.items()), flush=True)


def profile(torch, label, fn, card, iters=10, prof_iters=3, warmup=2, host_top=0) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(prof_iters):
            fn()
        torch.cuda.synchronize()
    dev_events, top_ops = [], 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev_events.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name.startswith("aten::") and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")):
            top_ops += 1
    total = sum(end - start for start, end, _ in dev_events) / 1e3 / prof_iters
    union, reach = 0, None  # union of the device intervals, in us
    for start, end, _ in sorted(dev_events):
        if reach is None or start > reach:
            union += end - start
            reach = end
        elif end > reach:
            union += end - reach
            reach = end
    by_kind, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for start, end, name in dev_events:
        by_kind[kind_of(name)] += (end - start) / 1e3 / prof_iters
        by_name[name][0] += (end - start) / 1e3 / prof_iters
        by_name[name][1] += 1
    print(f"== {label}: wall {wall:.3f} ms/call ({iters} calls, host clock, synchronized); device "
          f"{total:.3f} ms/call (interval union {union / 1e3 / prof_iters:.3f}) -> device busy "
          f"{100 * total / wall:.1f}% of the wall; top-level aten ops/call {top_ops / prof_iters:.0f}; "
          f"device kernels/call {len(dev_events) / prof_iters:.0f}; {card}", flush=True)
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"   {kind:26s} {ms:8.3f} ms  {100 * ms / total:5.1f}%")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"   {ms:8.3f} ms x {n // prof_iters:4d}  {name[:110]}")
    if host_top:  # host time by op (self CPU time under the profiler, which adds its own cost)
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:host_top]
        host = sum(e.self_cpu_time_total for e in prof.key_averages()) / 1e3 / prof_iters
        print(f"   host self time under the profiler {host:.3f} ms/call; largest:")
        for e in ops:
            print(f"   {e.self_cpu_time_total / 1e3 / prof_iters:8.3f} ms x {e.count // prof_iters:4d}  {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", type=str, default="1,2,3,4", help="which parts to run, e.g. 4")
    args = ap.parse_args()
    parts = {int(p) for p in args.parts.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("prof_sd: no CUDA device available", file=sys.stderr)
        return 1
    from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as cli
    from clip_codec_tpu_torch.ops import attention as attn
    from clip_codec_tpu_torch.ops import mlp

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    if 1 in parts:
        mlp_splits(torch, mlp, args.seed, dev)
    if parts & {2, 3}:
        sd_parts(torch, attn, mlp, cli, parts, args.seed, dev, card)
    if 4 in parts:
        train_px(torch, args.seed, dev, card)
    return 0


def sd_parts(torch, attn, mlp, cli, parts, seed, dev, card) -> None:
    from clip_codec_tpu_torch.models.sd import StableDiffusionDecoder

    unet, vae, adapter = cs.sd_models(torch, seed, dev)
    dec = StableDiffusionDecoder(unet, vae, adapter)
    if 2 in parts:
        sd_serving(torch, attn, mlp, cli, unet, vae, dec, seed, dev, card)
    if 3 in parts:
        train_step(torch, attn, mlp, dec, seed, dev, card)


def sd_serving(torch, attn, mlp, cli, unet, vae, dec, seed, dev, card) -> None:
    import numpy as np

    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    rng = np.random.default_rng(seed + 5)
    with torch.no_grad():
        for B in (2, 8):
            lat = torch.randn((B, 64, 64, 4), generator=gen, device=dev)
            t = torch.full((B,), 501, dtype=torch.int32, device=dev)
            ctx = torch.randn((B, 8, 768), generator=gen, device=dev)
            profile(torch, f"UNet forward B={B} 64x64 (kernel path)", lambda: unet(lat, t, ctx), card)
            with cs.plain_sd_kernels(attn, mlp):
                profile(torch, f"UNet forward B={B} 64x64 (plain path)", lambda: unet(lat, t, ctx), card)
        for B in (1, 4):
            z = torch.randn((B, 64, 64, 4), generator=gen, device=dev)
            profile(torch, f"VAE decode B={B} 512px (kernel path)", lambda: vae.decode(z), card)
    for n in (1, 4):
        z = rng.standard_normal((n, 512)).astype(np.float32)
        z /= np.linalg.norm(z, axis=1, keepdims=True)
        torch.cuda.reset_peak_memory_stats(dev)
        profile(torch, f"SD request of {n} embedding(s), dpmpp-{cs.SD_STEPS}, guidance {cs.SD_GUIDANCE}, "
                f"CFG batched (kernel path)",
                lambda: cli.sample_images(dec, z, cs.SD_SIZE, steps=cs.SD_STEPS, sampler="dpmpp",
                                          guidance=cs.SD_GUIDANCE, seed=seed).float().cpu(),
                card, iters=3, prof_iters=1, warmup=1)
        print(f"   peak device memory {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")


def train_step(torch, attn, mlp, dec, seed, dev, card, B=4) -> None:
    from clip_codec_tpu_torch.train.sd_diffusion_train import SDTrainConfig, make_optimizer, make_sd_train_step

    step = make_sd_train_step(dec, make_optimizer(dec.adapter, 1e-4), SDTrainConfig())
    batch = cs.train_batch(torch, seed + 9, dev, B)
    runs = [("train step (kernel path)", lambda: step(*batch), False),
            ("loss forward only, autograd on (kernel path)", lambda: step.loss_fn(*batch), False),
            ("train step (plain path)", lambda: step(*batch), True)]
    for label, fn, plain in runs:
        torch.cuda.reset_peak_memory_stats(dev)
        with cs.plain_sd_kernels(attn, mlp) if plain else contextlib.nullcontext():
            profile(torch, f"SD-1.5 adapter {label}, batch {B}, 512px", fn, card, iters=5, prof_iters=2, warmup=2)
        print(f"   peak device memory {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")


def train_px(torch, seed, dev, card, B=cs.PX_BATCH) -> None:
    from clip_codec_tpu_torch.ops import groupnorm as gn

    net = cs.px_net(torch, seed, dev)
    step = cs.px_step(torch, net, dev)
    batch = cs.px_batch(torch, seed + 13, dev, B)
    runs = [("train step (kernel path)", lambda: step(*batch), False),
            ("loss forward only, autograd on (kernel path)", lambda: step.loss_fn(*batch), False),
            ("train step (plain path)", lambda: step(*batch), True)]
    for label, fn, plain in runs:
        torch.cuda.reset_peak_memory_stats(dev)
        with cs.plain_k1(gn) if plain else contextlib.nullcontext():
            profile(torch, f"pixel U-Net {label}, batch {B}, {cs.SIZE}px", fn, card, iters=5, prof_iters=2, warmup=2,
                    host_top=10)
        print(f"   peak device memory {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")


if __name__ == "__main__":
    sys.exit(main())
