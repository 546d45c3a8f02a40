#!/usr/bin/env python3
"""Smoke run of the PyTorch port's paths on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which ends the run with a non-zero exit when it fails:

1. build the hand-written CUDA kernel (csrc/affine_conv3x3.cu) from this
   checkout with nvcc and print the build time and the compiler's report;
2. run the kernel and its plain PyTorch version on the card at every conv
   shape of the full-width U-Net at 256px (B=2, bf16), with and without the
   residual and the moments, and the linear 128->3 head; y must agree within
   rtol = atol = 2e-2 and the moments within 1e-3 of their largest magnitude;
3. one forward of the full-width U-Net (base=128, ch_mult=(1,2,2),
   z_dim=512, 256px, B=2, bf16) through the kernels and through the plain
   versions: ||eps_kernel - eps_plain|| / ||eps_plain|| < 2e-2;
4. serving: a ClipCodec is saved as a .pt store (random weights from
   --seed; no trained weights exist offline), reloaded, and answers three
   decompress requests of 1, 3 and 6 frames at 256px, DDIM-50,
   batch_size=4. Outputs must be finite, in [-1, 1] and of the right
   shape, and the kernels must have launched exactly 29 x 50 x batches
   times in those requests.

The SD-1.5 latent path (``models/sd``, ``cli/reconstruct_sd_diffusion.py``):

5. build flash attention (csrc/flash_attention.cu) and the fused
   transformer MLP (csrc/transformer_mlp.cu); all three sources are
   compiled at once, one nvcc each, when the run starts;
6. each kernel against its plain version on the card in bf16 at the shapes
   of SD-1.5 at 512px with CFG batched, for requests of one embedding (UNet
   batch 2) and of four (batch 8): flash attention at (BH, N, D) =
   (16|64, 4096, 40), (16|64, 1024, 80), (1|4, 4096, 512), normal and
   extreme logits, out within rtol = atol = 2e-2 and lse within 1e-3; the
   MLP at (R, C, F) = (8192|32768, 320, 1280), (2048|8192, 640, 2560),
   (512|2048, 1280, 5120), (128|512, 1280, 5120) within rtol = atol = 2e-2,
   with the kernel's split count, which must be 1 at some shape and more
   at another; ms of kernel, of the kernel with one split, and of plain;
   flash attention recorded at every shape: events and CUDA-graph ms of
   the kernel and of SDPA, plain ms and the bound;
7. one forward of the SD-1.5 UNet (random weights from --seed, bf16,
   64x64 latents, batch 2, a (2, 8, 768) context) and one VAE decode at
   512px, each through the kernels, through the plain versions and through
   the plain versions in fp32: kernel vs plain relative difference < 2e-2,
   the kernel path at most 1.1x as far from fp32 as the plain path, 10
   flash + 16 MLP launches per UNet forward and 1 flash launch per decode;
8. serving: the UNet, VAE and adapter are saved as diffusers-layout .pt
   files, reloaded through the SD CLI's loader, and answer three requests
   of one embedding and one of four at 512px, dpmpp-10, guidance 5, CFG
   batched. Outputs must be finite and of the right shape, and the kernels
   must have launched steps x (10, 16) per forward plus 1 flash per decode.

SD adapter training (``train/sd_diffusion_train.py``, ``cli/precompute_latents.py``):

9. the flash-attention backward (csrc/flash_attention_bwd.cu: the dq kernel
   and the dk/dv kernel) against the plain fp32 backward at the training
   shapes of SD-1.5 at 512px, batch 4: (BH, N, D) = (32, 4096, 40),
   (32, 1024, 80), (4, 4096, 512), and extreme logits at the first; dq, dk
   and dv within rtol = 2e-2 and atol = 2e-2 of each gradient's largest
   magnitude; ms of each kernel (events and CUDA-graph replay), of the
   plain versions and of SDPA's backward (for scale, not a plain version),
   recorded at every shape;
10. the adapter's gradient through SD-1.5 at full width (one 64x64 latent,
   the same injected t and noise, the default loss with its VAE decodes) on
   the kernel path, on the plain path and on the plain path in fp32, at
   --seed and --seed + 1: the kernel path at most 1.1x as far from fp32 as
   the plain path;
11. training: the port's precompute path encodes 8 seeded 512px images,
   then ``train_sd_diffusion`` runs 2 epochs at batch 4 on the kernel path.
   The loss must be finite, the adapter must change, the final adapter must
   load through the SD CLI's loader and sample a finite dpmpp-10 image, and
   every step must launch 12 flash forwards (10 in the UNet, 1 in each VAE
   decode), 10 of each backward kernel (the first UNet self-attention sees
   no input that needs a gradient) and 16 fused MLPs. Seconds per step,
   training img/s and peak device memory are printed.

Pixel-decoder training (``train/diffusion_train.py``, ``cli/train.py``):

12. K1, the fused GroupNorm+SiLU (csrc/groupnorm_silu.cu: the stats kernel
   and the norm kernel), against its plain versions at the four training
   shapes of the full-width U-Net at 256px, batch 8, bf16 ((H, W, C) =
   (256, 256, 128), (128, 128, 128), (64, 64, 256), (32, 32, 512), 8
   groups), one fp32 case and a ragged shape (3, 37, 29, 64): the stats
   partials within 1e-5 of their largest magnitude, y within rtol = atol =
   2e-2 (bf16) or 1e-4 (fp32), each kernel against its own plain version
   and the pair against ``group_norm_silu_plain``; the autograd Function's
   dx, dscale, dbias at (8, 64, 64, 256) within 2e-2 of each gradient's
   largest magnitude of plain autograd; ms of each kernel, of the pair, of
   the plain versions and of ``F.group_norm`` + ``F.silu`` (for scale), each
   as events around 20 calls from Python and as the device time of 20 calls
   replayed from a CUDA graph (at the smaller shapes the wrappers' host work
   outlasts the kernels);
13. the full-width U-Net in its training form (``fused_pallas=False``) at
   256px, batch 2: the loss and every parameter's gradient for the same
   injected t and noise on the kernel path, on the plain path and on the
   plain path in fp32, at --seed and --seed + 1: the kernel path at most
   1.1x as far from fp32 as the plain path, every gradient finite and
   nonzero, 28 launches of each K1 kernel per forward and none of K2/K3;
14. training: 16 seeded PNG images, ``train_diffusion`` for 2 epochs at
   batch 8 (``data_workers=2``) at full width, bf16, 256px: the loss finite,
   the parameters changed, 28 x 4 launches of each K1 kernel; the final
   checkpoint loads through ``ClipCodec.load`` and answers a request of 2
   frames at DDIM-50 through K2/K3 (29 x 50 launches), finite and in
   [-1, 1]; one ``remat=True`` step (56 launches of each K1 kernel); then
   seconds per step, img/s and peak device memory over 5 synchronized steps
   after 2 warm-ups.

The attention probes (``probes/attn_probe.py``, the port of bench_attn_probe.py):

15. build csrc/flash_attention_probe.cu; hold each of its 21 kernels (P1's
   six modes and tiles, P2's exp2 and row-sum forms, P3's two query tiles)
   against its plain version at (8, 4096, 40) in bf16, at normal logits and
   (all but ``nomax``) at extreme ones: softmax outputs within rtol = atol
   = 2e-2 and within 2e-2 of their largest magnitude, ``noexp`` and
   ``dotonly`` within 2e-2 of their largest magnitude, P2's row sums within
   2e-2 relative; then run the probe at (64, 4096, 40), printing its lines:
   every variant timed, four correctness lines within 2e-2 of an fp32
   oracle, one counted launch per call the probe made outside CUDA-graph
   capture (the graphs' replays reported beside); ms of each kernel, its
   plain version and SDPA at that shape.

The line before the last is the kernels' JSON record (``bound_ms``: the
largest of the bytes each kernel must move over 3.35 TB/s, its flops over
989 TFLOP/s, the H100 SXM's HBM rate and dense bf16 peak, or 67 TFLOP/s,
its fp32 rate outside the tensor cores, for K1, and, for the attention
kernels, its exponentials over the exp unit's 16 per clock per SM (or a
polynomial exp2's instructions over the FMA pipe's 128 lanes per clock per
SM) at the card's SM count and maximum SM clock, at the timed shape,
counting the work the function needs, not a kernel's recompute;
``bound_unit`` names the largest); the last line is ``{"ok": true,
"device": {...}}``. Without a CUDA device the script exits non-zero and
prints no result. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPLACES = "clip_codec_tpu/ops/pallas_resblock.py:72"
# (H, W, Cin, Cout) of every fused conv of the full-width U-Net at 256px.
RESBLOCK_SHAPES = [(256, 256, 128, 128), (128, 128, 128, 128), (64, 64, 256, 256), (32, 32, 512, 512)]
HEAD_SHAPE = (256, 256, 128, 3)
LAUNCHES_PER_FORWARD = 29  # 14 ResBlocks x 2 + the head
SIZE, STEPS = 256, 50

CSRC = "clip_codec_tpu_torch/csrc"
KERNELS = {  # name -> (library, TPU kernel it replaces)
    "affine_silu_conv3x3": ("affine_conv3x3", REPLACES),
    "affine_conv3x3": ("affine_conv3x3", REPLACES),
    "flash_attention": ("flash_attention", "clip_codec_tpu/ops/pallas_attention.py:63"),
    "transformer_mlp": ("transformer_mlp", "clip_codec_tpu/ops/pallas_mlp.py:78"),
    "flash_attention_bwd_dq": ("flash_attention_bwd", "clip_codec_tpu/ops/pallas_attention.py:181"),
    "flash_attention_bwd_dkv": ("flash_attention_bwd", "clip_codec_tpu/ops/pallas_attention.py:212"),
    "group_norm_silu_stats": ("groupnorm_silu", "clip_codec_tpu/ops/pallas_groupnorm.py:53"),
    "group_norm_silu_norm": ("groupnorm_silu", "clip_codec_tpu/ops/pallas_groupnorm.py:69"),
    "flash_probe_variant": ("flash_attention_probe", "bench_attn_probe.py:103"),
    "flash_probe_fast": ("flash_attention_probe", "bench_attn_probe.py:214"),
    "flash_probe_single_pass": ("flash_attention_probe", "bench_attn_probe.py:281"),
}
HBM_BYTES_PER_S, BF16_FLOPS_PER_S = 3.35e12, 989e12  # H100 SXM: HBM3 rate, dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# Per clock per SM: ex2 on the exp unit, fp32 lanes of the FMA pipe (CUDA
# guide, compute capability 9.0); unit_rates scales them by the card's SM
# count and maximum SM clock.
EXP2_PER_CLOCK_SM, FMA_LANES_PER_CLOCK_SM = 16, 128
# SD-1.5 at 512px (64x64 latents), CFG batched: UNet batch 2 for a request of
# one embedding (VAE batch 1), 8 for a request of four (VAE batch 4).
FLASH_SHAPES = [(16, 4096, 40), (16, 1024, 80), (1, 4096, 512),
                (64, 4096, 40), (64, 1024, 80), (4, 4096, 512)]  # (BH, N, D)
MLP_SHAPES = [(8192, 320, 1280), (2048, 640, 2560), (512, 1280, 5120), (128, 1280, 5120),
              (32768, 320, 1280), (8192, 640, 2560), (2048, 1280, 5120)]  # (R, C, F)
SD_FLASH_PER_FORWARD, SD_MLP_PER_FORWARD = 10, 16
FP32_RATIO = 1.1  # kernel path's distance from fp32, at most this x the plain path's
SD_SIZE, SD_STEPS, SD_GUIDANCE = 512, 10, 5.0
SD_REQUESTS = (1, 1, 1, 4)  # embeddings per request
# SD-1.5 training at 512px, batch 4: 8 heads at 64x64 and 32x32, the VAE's one head.
FLASH_BWD_SHAPES = [(32, 4096, 40), (32, 1024, 80), (4, 4096, 512)]  # (BH, N, D)
TRAIN_IMAGES, TRAIN_BATCH, TRAIN_EPOCHS = 8, 4, 2
# Per training step: flash forward 10 in the UNet + 1 per VAE decode (of
# lat0_hat and of lat0); each backward kernel at 9 UNet self-attentions (the
# first sees no input that needs a gradient) + the lat0_hat decode; the MLP
# at all 16 transformer blocks (its backward runs no kernel).
TRAIN_LAUNCHES = {"flash_attention": 12, "flash_attention_bwd_dq": 10, "flash_attention_bwd_dkv": 10,
                  "transformer_mlp": 16}
# Pixel training: (H, W, C) of every GroupNorm+SiLU of the full-width U-Net
# at 256px (2, 4, 4 and 4 ResBlocks, two calls each: 28 per forward), batch 8.
GN_SHAPES = [(256, 256, 128), (128, 128, 128), (64, 64, 256), (32, 32, 512)]
GN_TAIL, GN_GROUPS, GN_BATCH = (3, 37, 29, 64), 8, 8
GN_PER_FORWARD = 28
PX_IMAGES, PX_BATCH, PX_EPOCHS = 16, 8, 2
PX_MODEL = dict(base=128, ch_mult=(1, 2, 2))  # the reference's U-Net, as DiffusionTrainConfig's defaults
# The attention probes: checked against plain at PROBE_CHECK_SHAPE, run and timed at
# FLASH_SHAPES[3], SD-1.5's first-level self-attention at UNet batch 8.
PROBE_CHECK_SHAPE, PROBE_SHAPE = (8, 4096, 40), FLASH_SHAPES[3]
POLY_INSTRUCTIONS = 7  # + deg: floor, subtract, deg FMAs, max, convert, add, shift, multiply


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


@functools.cache
def unit_rates() -> dict:
    """Per second on card 0: ex2 on the exp unit and lanes of the FMA pipe,
    from its SM count and its maximum SM clock."""
    import torch

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    sm_per_s = torch.cuda.get_device_properties(0).multi_processor_count * float(smi.stdout.strip()) * 1e6
    return {"exp unit": EXP2_PER_CLOCK_SM * sm_per_s, "FMA pipe": FMA_LANES_PER_CLOCK_SM * sm_per_s,
            "max SM clock MHz": float(smi.stdout.strip())}


def bound_terms(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S, exps: float = 0.0,
                fma: float = 0.0) -> dict:
    """ms of each limit: bytes over HBM, flops over the tensor cores (or the
    fp32 rate), exponentials over the exp unit, FMA-pipe instructions."""
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": flops / flops_per_s * 1e3,
            "exp unit": exps / unit_rates()["exp unit"] * 1e3 if exps else 0.0,
            "FMA pipe": fma / unit_rates()["FMA pipe"] * 1e3 if fma else 0.0}


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S, exps: float = 0.0,
          fma: float = 0.0):
    """(bound_ms, bound_by, bound_unit): the least time the card could take,
    the largest of ``bound_terms``. ``bound_unit`` names that term;
    ``bound_by`` folds the exp unit and the FMA pipe into "operations",
    the two values the kernels record's format allows."""
    terms = bound_terms(nbytes, flops, flops_per_s, exps, fma)
    unit = max(terms, key=terms.get)
    return terms[unit], ("bytes" if unit == "bytes" else "operations"), unit


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Device time of ``fn`` per call with no host work between the calls:
    ``iters`` calls captured in a CUDA graph and replayed (where the host's
    enqueue of one call takes longer than the device's work, ``cuda_ms``
    measures the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_convs(rc):
    """Route the model's two kernel entry points to their plain versions."""
    saved = rc.affine_silu_conv3x3, rc.affine_conv3x3

    def silu(x, A, B, w9, bias, add=None, want_moments=False):
        return rc.affine_conv3x3_plain(x, A, B, w9, bias, add, want_moments, linear=False)

    def lin(x, A, B, w9, bias, add=None, want_moments=False):
        return rc.affine_conv3x3_plain(x, A, B, w9, bias, add, want_moments, linear=True)

    rc.affine_silu_conv3x3, rc.affine_conv3x3 = silu, lin
    try:
        yield
    finally:
        rc.affine_silu_conv3x3, rc.affine_conv3x3 = saved


def reset_launches(rc) -> None:
    rc.affine_silu_conv3x3.launches = 0
    rc.affine_conv3x3.launches = 0


def start_builds():
    """Compile every kernel library at once, one nvcc each; returns
    name -> future of (library path, seconds from the start)."""
    from clip_codec_tpu_torch.ops import _build

    t0 = time.perf_counter()

    def one(name):
        return _build.build(name), time.perf_counter() - t0

    names = sorted({lib for lib, _ in KERNELS.values()})
    pool = ThreadPoolExecutor(max_workers=len(names))
    futures = {name: pool.submit(one, name) for name in names}
    pool.shutdown(wait=False)
    return futures


def phase_build(builds, names=("affine_conv3x3",)):
    for name in names:
        try:
            lib, dt = builds[name].result()
        except RuntimeError as e:
            raise PhaseError(f"build of {name}.cu failed: {e}") from e
        print(f"build: {lib.name} in {dt:.2f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


def _inputs(torch, gen, B, H, W, cin, cout, dev):
    x = torch.randn((B, H, W, cin), generator=gen, device=dev).to(torch.bfloat16)
    A = 0.5 + torch.rand((B, cin), generator=gen, device=dev)
    Bv = 0.1 * torch.randn((B, cin), generator=gen, device=dev)
    w9 = (torch.randn((9, cin, cout), generator=gen, device=dev) / (9 * cin) ** 0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn((cout,), generator=gen, device=dev)
    add = torch.randn((B, H, W, cout), generator=gen, device=dev).to(torch.bfloat16)
    return x, A, Bv, w9, bias, add


def phase_kernels(torch, rc, seed, dev):
    """Kernel vs plain at the slice shapes; returns per-kernel records."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(seed)
    records = {}
    cases = [(s, False, add, mom) for s in RESBLOCK_SHAPES for add in (False, True) for mom in (False, True)]
    cases.append((HEAD_SHAPE, True, False, False))
    for (H, W, cin, cout), linear, use_add, mom in cases:
        x, A, Bv, w9, bias, add = _inputs(torch, gen, 2, H, W, cin, cout, dev)
        add = add if use_add else None
        fn = rc.affine_conv3x3 if linear else rc.affine_silu_conv3x3
        y, m = fn(x, A, Bv, w9, bias, add, mom)
        y_ref, m_ref = rc.affine_conv3x3_plain(x, A, Bv, w9, bias, add, mom, linear=linear)
        torch.cuda.synchronize()
        yf, rf = y.float(), y_ref.float()
        err = (yf - rf).abs().max().item()
        ok = bool(((yf - rf).abs() <= 2e-2 + 2e-2 * rf.abs()).all().item())
        mom_rel = 0.0
        if mom:
            for k in range(2):
                scale = m_ref[:, k].abs().max().item()
                mom_rel = max(mom_rel, (m[:, k] - m_ref[:, k]).abs().max().item() / max(scale, 1e-30))
        name = "affine_conv3x3" if linear else "affine_silu_conv3x3"
        tag = f"{name} B=2 {H}x{W} {cin}->{cout} add={int(use_add)} moments={int(mom)}"
        line = f"kernel-check: {tag} max_abs_err={err:.3e} moments_rel_err={mom_rel:.3e}"
        timed = linear or use_add != mom  # the two forms the U-Net runs
        if timed:
            k_ms = cuda_ms(torch, lambda: fn(x, A, Bv, w9, bias, add, mom))
            p_ms = cuda_ms(torch, lambda: rc.affine_conv3x3_plain(x, A, Bv, w9, bias, add, mom, linear=linear))
            act = x.permute(0, 3, 1, 2)
            wt = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
            lib_ms = cuda_ms(torch, lambda: F.conv2d(act, wt, padding=1))
            gflop = 2 * 9 * cin * cout * H * W * 2 / 1e9
            line += (f" ms={k_ms:.4f} plain_ms={p_ms:.4f} cudnn_bf16_conv_only_ms={lib_ms:.4f}"
                     f" kernel_TFLOPs={gflop / k_ms:.1f}")
        print(line)
        check(ok, f"{tag}: y outside rtol=atol=2e-2 (max abs err {err})")
        check(mom_rel <= 1e-3, f"{tag}: moments rel err {mom_rel} > 1e-3")
        rec = records.setdefault(name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        big = (H, W, cin, cout) in (RESBLOCK_SHAPES[0], HEAD_SHAPE)
        if timed and big and (linear or mom):
            px = 2 * H * W  # B = 2
            nbytes = (px * cin * 2 + 2 * 2 * cin * 4 + 9 * cin * cout * 2 + cout * 4 + px * cout * 2
                      + (px * cout * 2 if use_add else 0) + (2 * 2 * cout * 4 if mom else 0))
            b_ms, b_by, b_unit = bound(nbytes, 2 * 9 * cin * cout * px)
            # library: cuDNN's bf16 conv alone, for scale (no one call computes the fused function)
            rec.update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bound_unit=b_unit,
                       timed_at=tag)
    return records


def full_unet(torch, seed, dev):
    from clip_codec_tpu_torch.models import CLIPCondUNet, init_params

    net = CLIPCondUNet(z_dim=512, base=128, ch_mult=(1, 2, 2), time_dim=256, img_ch=3,
                       dtype=torch.bfloat16)
    init_params(net, torch.Generator().manual_seed(seed))
    return net.to(dev).eval()


def phase_forward(torch, rc, net, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((2, SIZE, SIZE, 3), generator=gen, device=dev)
    z = torch.nn.functional.normalize(torch.randn((2, 512), generator=gen, device=dev), dim=-1)
    t = torch.tensor([999, 412], dtype=torch.int32, device=dev)
    with torch.no_grad():
        reset_launches(rc)
        eps_k = net(x, z, t).float()
        n = rc.affine_silu_conv3x3.launches + rc.affine_conv3x3.launches
        with plain_convs(rc):
            eps_p = net(x, z, t).float()
        torch.cuda.synchronize()
        k_ms = cuda_ms(torch, lambda: net(x, z, t), iters=5, warmup=1)
        with plain_convs(rc):
            p_ms = cuda_ms(torch, lambda: net(x, z, t), iters=5, warmup=1)
    rel = ((eps_k - eps_p).norm() / eps_p.norm()).item()
    print(f"unet-forward: base=128 ch_mult=(1,2,2) {SIZE}px B=2 bf16 rel_err={rel:.3e} "
          f"launches={n} kernel_path_ms={k_ms:.3f} plain_path_ms={p_ms:.3f}")
    check(bool(torch.isfinite(eps_k).all().item()), "U-Net eps not finite")
    check(tuple(eps_k.shape) == (2, SIZE, SIZE, 3), f"U-Net eps shape {tuple(eps_k.shape)}")
    check(n == LAUNCHES_PER_FORWARD, f"U-Net forward launched {n} kernels, expected {LAUNCHES_PER_FORWARD}")
    check(rel < 2e-2, f"U-Net kernel vs plain path rel err {rel} >= 2e-2")


def make_store(torch, net, seed, store: Path):
    import numpy as np

    from clip_codec_tpu_torch.utils.config import ModelConfig

    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((256, 512)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    zero = feats.min(0)
    scale = (np.maximum(feats.max(0) - zero, np.float32(1e-8)) / np.float32(255)).astype(np.float32)
    store.mkdir(parents=True, exist_ok=True)
    np.savez(store / "codec_meta.npz", scale=scale, zero=zero)
    sd = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    torch.save(sd, store / "diffusion_unet_final.pt")
    ModelConfig.infer_from_state_dict(sd).save(store)
    return np.clip(np.round((feats - zero) / scale), 0, 255).astype(np.uint8)


def phase_serve(torch, rc, net, seed, dev, card):
    import numpy as np

    from clip_codec_tpu_torch.codec import ClipCodec

    store = ROOT / "build" / "chip_smoke" / "store"
    codes = make_store(torch, net, seed, store)
    codec = ClipCodec.load(store, device=dev)
    check(codec.net is not None, "ClipCodec.load found no decoder")

    try:
        from clip_codec_tpu_torch.io.bitstream import compress_frame

        compress_frame(b"\0")
        frames = True
    except ImportError:
        frames = False
        print("frames: skipped (no zstandard)")

    sizes, batch_size, steps = (1, 3, 6), 4, STEPS
    batches = sum(-(-n // batch_size) for n in sizes)
    requests = []
    s = 0
    for n in sizes:
        q = codes[s : s + n]
        s += n
        requests.append([compress_frame(row.tobytes()) for row in q] if frames else q)

    torch.cuda.synchronize()
    reset_launches(rc)
    times = []
    for n, req in zip(sizes, requests):
        t0 = time.perf_counter()
        if frames:
            out = codec.decompress(req, size=SIZE, steps=steps, batch_size=batch_size, seed=seed)
        else:
            out = codec.decompress_codes(req, size=SIZE, steps=steps, batch_size=batch_size, seed=seed)
        times.append(time.perf_counter() - t0)
        check(out.shape == (n, SIZE, SIZE, 3), f"request of {n}: output shape {out.shape}")
        check(bool(np.isfinite(out).all()), f"request of {n}: non-finite output")
        check(float(np.abs(out).max()) <= 1.0, f"request of {n}: output outside [-1, 1]")
    launches = {"affine_silu_conv3x3": rc.affine_silu_conv3x3.launches,
                "affine_conv3x3": rc.affine_conv3x3.launches}
    total = sum(launches.values())
    for n, dt in zip(sizes, times):
        print(f"serve: request of {n} frames ({-(-n // batch_size)} batch of {batch_size}, DDIM-{steps}, "
              f"{SIZE}px) {dt:.3f} s on {card}")
    print(f"serve: {sum(sizes)} images in {sum(times):.3f} s = {sum(sizes) / sum(times):.3f} img/s "
          f"(padded rows included in the work: {batches * batch_size} rows) on {card}; "
          f"launches={launches}")
    check(total == LAUNCHES_PER_FORWARD * steps * batches,
          f"kernel launches {total} != 29 x {steps} x {batches}")
    check(launches["affine_conv3x3"] == steps * batches, "head kernel launch count")
    return launches


# ------------------------------------------------------------ the SD path


def reset_sd_launches(attn, mlp) -> None:
    attn.flash_attention_fwd.launches = 0
    attn.flash_attention_bwd_dq.launches = 0
    attn.flash_attention_bwd_dkv.launches = 0
    mlp.transformer_mlp.launches = 0


def sd_launches(attn, mlp) -> dict:
    return {"flash_attention": attn.flash_attention_fwd.launches,
            "flash_attention_bwd_dq": attn.flash_attention_bwd_dq.launches,
            "flash_attention_bwd_dkv": attn.flash_attention_bwd_dkv.launches,
            "transformer_mlp": mlp.transformer_mlp.launches}


@contextlib.contextmanager
def plain_sd_kernels(attn, mlp):
    """Route the SD blocks' kernel entry points (flash forward and backward,
    the fused MLP) to their plain versions."""
    saved = attn.flash_attention_fwd, attn.flash_attention_bwd, mlp.transformer_mlp

    def mlp_plain(x, lns, lnb, wh, bh, wg, bg, wo, packed=None):
        return mlp.mlp_plain(x, lns, lnb, wh, bh, wg, bg, wo)

    attn.flash_attention_fwd, attn.flash_attention_bwd = attn.flash_attention_plain, attn.flash_attention_bwd_plain
    mlp.transformer_mlp = mlp_plain
    try:
        yield
    finally:
        attn.flash_attention_fwd, attn.flash_attention_bwd, mlp.transformer_mlp = saved


def _randn(torch, gen, shape, dev, scale=1.0, dtype=None):
    x = torch.randn(shape, generator=gen, device=dev) * scale
    return x if dtype is None else x.to(dtype)


def phase_sd_kernels(torch, attn, mlp, seed, dev):
    """Flash attention and the fused MLP against their plain versions at the
    SD-1.5 512px shapes, bf16; returns per-kernel records."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    bf = torch.bfloat16
    rec = {"flash_attention": {"max_abs_err": 0.0}, "transformer_mlp": {"max_abs_err": 0.0}}
    for BH, N, D in FLASH_SHAPES:
        for q_scale in (1.0, 30.0):
            q = _randn(torch, gen, (BH, N, D), dev, q_scale, bf)
            k, v = (_randn(torch, gen, (BH, N, D), dev, 1.0, bf) for _ in range(2))
            out, lse = attn.flash_attention_fwd(q, k, v)
            ref, lse_ref = attn.flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - lse_ref).abs().max().item()
            ok = bool(((out.float() - ref.float()).abs() <= 2e-2 + 2e-2 * ref.float().abs()).all().item())
            tag = f"flash_attention (BH, N, D)=({BH}, {N}, {D}) {'extreme' if q_scale > 1 else 'normal'} logits"
            line = f"kernel-check: {tag} max_abs_err={err:.3e} lse_abs_err={lse_err:.3e}"
            if q_scale == 1.0:
                k_ms = cuda_ms(torch, lambda: attn.flash_attention_fwd(q, k, v))
                kg_ms = graph_ms(torch, lambda: attn.flash_attention_fwd(q, k, v))
                p_ms = cuda_ms(torch, lambda: attn.flash_attention_plain(q, k, v), iters=5)
                sdpa = lambda: F.scaled_dot_product_attention(q[None], k[None], v[None])
                lib_ms, libg_ms = cuda_ms(torch, sdpa), graph_ms(torch, sdpa)
                tflops = 4 * BH * N * N * D / 1e9 / k_ms
                # exps: one exp2 per score, what softmax needs (the tiling's alphas are the kernel's own)
                b_ms, b_by, b_unit = bound(4 * BH * N * D * 2 + BH * N * 4, 4 * BH * N * N * D, exps=BH * N * N)
                line += (f" ms={k_ms:.4f} graph_ms={kg_ms:.4f} plain_ms={p_ms:.4f}"
                         f" sdpa_library_not_plain_ms={lib_ms:.4f} sdpa_graph_ms={libg_ms:.4f}"
                         f" bound_ms={b_ms:.4f} ({b_unit}) kernel_TFLOPs={tflops:.1f}")
                # every path shape; the record's own keys are the first shape's
                rec["flash_attention"].setdefault("shapes", []).append(
                    dict(shape=[BH, N, D], ms=k_ms, graph_ms=kg_ms, plain_ms=p_ms, library_ms=lib_ms,
                         library_graph_ms=libg_ms, bound_ms=b_ms, bound_by=b_by, bound_unit=b_unit))
                if (BH, N, D) == FLASH_SHAPES[0]:
                    rec["flash_attention"].update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                                                  bound_by=b_by, bound_unit=b_unit, timed_at=tag)
            print(line)
            check(ok, f"{tag}: out outside rtol=atol=2e-2 (max abs err {err})")
            check(lse_err <= 1e-3, f"{tag}: lse abs err {lse_err} > 1e-3")
            rec["flash_attention"]["max_abs_err"] = max(rec["flash_attention"]["max_abs_err"], err)
    splits_seen = set()
    for R, C, Fh in MLP_SHAPES:
        x = _randn(torch, gen, (R, C), dev, 1.0, bf)
        lns, lnb = 1 + _randn(torch, gen, (C,), dev, 0.1), _randn(torch, gen, (C,), dev, 0.1)
        wh, wg = (_randn(torch, gen, (C, Fh), dev, C ** -0.5) for _ in range(2))
        bh, bg = (_randn(torch, gen, (Fh,), dev, 0.1) for _ in range(2))
        wo = _randn(torch, gen, (Fh, C), dev, Fh ** -0.5)
        packed = mlp.pack_weights(wh, wg, wo)
        args = (x, lns, lnb, wh, bh, wg, bg, wo)
        splits = mlp.kernel_splits(R, C, Fh, dev)
        splits_seen.add(splits)
        y = mlp.transformer_mlp(*args, packed=packed)
        ref = mlp.mlp_plain(*args)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        ok = bool(((y.float() - ref.float()).abs() <= 2e-2 + 2e-2 * ref.float().abs()).all().item())
        k_ms = cuda_ms(torch, lambda: mlp.transformer_mlp(*args, packed=packed))
        # the kernel with one split, whatever it chose: the evidence for its rule
        one_ms = cuda_ms(torch, lambda: mlp._launch(x, lns, lnb, bh, bg, packed, splits=1))
        p_ms = cuda_ms(torch, lambda: mlp.mlp_plain(*args), iters=5)
        wgeglu = torch.cat([wh, wg], dim=1).t().to(bf).contiguous()
        who, lnw, lnbb = wo.t().to(bf).contiguous(), lns.to(bf), lnb.to(bf)

        def unfused():
            a, g = F.linear(F.layer_norm(x, (C,), lnw, lnbb, 1e-6), wgeglu).chunk(2, dim=-1)
            return F.linear(a * F.gelu(g), who)

        lib_ms = cuda_ms(torch, unfused)
        tflops = 6 * R * C * Fh / 1e9 / k_ms
        tag = f"transformer_mlp (R, C, F)=({R}, {C}, {Fh}) splits={splits}"
        print(f"kernel-check: {tag} max_abs_err={err:.3e} ms={k_ms:.4f} one_split_ms={one_ms:.4f} "
              f"plain_ms={p_ms:.4f} cublas_unfused_library_not_plain_ms={lib_ms:.4f} "
              f"kernel_TFLOPs={tflops:.1f}")
        check(ok, f"{tag}: y outside rtol=atol=2e-2 (max abs err {err})")
        rec["transformer_mlp"]["max_abs_err"] = max(rec["transformer_mlp"]["max_abs_err"], err)
        if (R, C, Fh) == MLP_SHAPES[0]:
            nbytes = 2 * R * C * 2 + 2 * C * 4 + 3 * C * Fh * 2 + 2 * Fh * 4
            b_ms, b_by, b_unit = bound(nbytes, 6 * R * C * Fh)
            # library: null, no one PyTorch call computes the fused MLP (cuBLAS unfused is printed for scale)
            rec["transformer_mlp"].update(ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                                          bound_unit=b_unit, timed_at=tag)
    # both epilogues (bf16 from registers; fp32 partials + the sum kernel)
    check(1 in splits_seen and max(splits_seen) > 1, f"MLP shapes ran splits {sorted(splits_seen)}: "
          "the one-split and the split form must both be checked")
    return rec


def sd_models(torch, seed, dev):
    from clip_codec_tpu_torch.models import init_params
    from clip_codec_tpu_torch.models.sd import SD15_UNET, SD15_VAE, AutoencoderKL, SDClipAdapter, SDUNet

    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    with torch.device(dev):
        unet = SDUNet(SD15_UNET, dtype=torch.bfloat16)
        vae = AutoencoderKL(SD15_VAE, dtype=torch.bfloat16)
        adapter = SDClipAdapter(512, SD15_UNET.cross_dim, 1024, 8)
    return [init_params(m, gen).eval() for m in (unet, vae, adapter)]


def phase_sd_forward(torch, attn, mlp, unet, vae, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    lat = torch.randn((2, 64, 64, 4), generator=gen, device=dev)
    t = torch.tensor([981, 401], dtype=torch.int32, device=dev)
    ctx = torch.randn((2, 8, 768), generator=gen, device=dev)
    z = torch.randn((1, 64, 64, 4), generator=gen, device=dev)
    with torch.no_grad():
        reset_sd_launches(attn, mlp)
        eps_k = unet(lat, t, ctx).float()
        n_fwd = (attn.flash_attention_fwd.launches, mlp.transformer_mlp.launches)
        reset_sd_launches(attn, mlp)
        img_k = vae.decode(z).float()
        n_dec = (attn.flash_attention_fwd.launches, mlp.transformer_mlp.launches)
        with plain_sd_kernels(attn, mlp):
            eps_p = unet(lat, t, ctx).float()
            img_p = vae.decode(z).float()
            # The same weights in fp32 on the plain versions: how far each
            # bf16 path is from it says how large bf16's own noise is here.
            unet.compute_dtype = vae.compute_dtype = torch.float32
            try:
                eps_32, img_32 = unet(lat, t, ctx), vae.decode(z)
            finally:
                unet.compute_dtype = vae.compute_dtype = torch.bfloat16
        torch.cuda.synchronize()
        k_ms = cuda_ms(torch, lambda: unet(lat, t, ctx), iters=5, warmup=1)
        d_ms = cuda_ms(torch, lambda: vae.decode(z), iters=3, warmup=1)
        with plain_sd_kernels(attn, mlp):
            p_ms = cuda_ms(torch, lambda: unet(lat, t, ctx), iters=5, warmup=1)
            dp_ms = cuda_ms(torch, lambda: vae.decode(z), iters=3, warmup=1)
    def rel_to(a, ref):
        return ((a - ref).norm() / ref.norm()).item()

    rel, rel_d = rel_to(eps_k, eps_p), rel_to(img_k, img_p)
    u32 = rel_to(eps_k, eps_32), rel_to(eps_p, eps_32)
    v32 = rel_to(img_k, img_32), rel_to(img_p, img_32)
    print(f"sd-unet-forward: SD-1.5 64x64 latents B=2 bf16 rel_err={rel:.3e} launches(flash, mlp)={n_fwd} "
          f"kernel_path_ms={k_ms:.3f} plain_path_ms={p_ms:.3f} to_fp32(kernel, plain)="
          f"({u32[0]:.3e}, {u32[1]:.3e}) ratio={u32[0] / u32[1]:.4f}")
    print(f"sd-vae-decode: SD-1.5 512px B=1 bf16 rel_err={rel_d:.3e} launches(flash, mlp)={n_dec} "
          f"kernel_path_ms={d_ms:.3f} plain_path_ms={dp_ms:.3f} to_fp32(kernel, plain)="
          f"({v32[0]:.3e}, {v32[1]:.3e}) ratio={v32[0] / v32[1]:.4f}")
    check(bool(torch.isfinite(eps_k).all().item()), "SD UNet eps not finite")
    check(tuple(eps_k.shape) == (2, 64, 64, 4), f"SD UNet eps shape {tuple(eps_k.shape)}")
    check(bool(torch.isfinite(img_k).all().item()), "VAE decode not finite")
    check(tuple(img_k.shape) == (1, SD_SIZE, SD_SIZE, 3), f"VAE decode shape {tuple(img_k.shape)}")
    check(n_fwd == (SD_FLASH_PER_FORWARD, SD_MLP_PER_FORWARD), f"UNet forward launches {n_fwd}")
    check(n_dec == (1, 0), f"VAE decode launches {n_dec}")
    check(rel < 2e-2, f"SD UNet kernel vs plain path rel err {rel} >= 2e-2")
    check(rel_d < 2e-2, f"VAE decode kernel vs plain path rel err {rel_d} >= 2e-2")
    # Both bf16 paths sit at bf16's noise floor from each other, so the
    # discriminating check is against fp32: the kernel path may be at most
    # 10% further from it than the plain path.
    check(u32[0] <= FP32_RATIO * u32[1], f"SD UNet: kernel path {u32[0]} from fp32 > {FP32_RATIO} x plain's {u32[1]}")
    check(v32[0] <= FP32_RATIO * v32[1], f"VAE decode: kernel path {v32[0]} from fp32 > {FP32_RATIO} x plain's {v32[1]}")


def sd_embeddings(seed, n):
    """(n, 512) L2-normalised embeddings as the CLI reads them: through .clp
    frames where zstandard is installed, else from the codes directly."""
    import numpy as np

    from clip_codec_tpu_torch.codecs.quantizer import dequantize_l2norm_host

    rng = np.random.default_rng(seed + 5)
    codes = rng.integers(0, 256, (n, 512), dtype=np.uint8)
    scale = np.full(512, 2.0 / 255.0, np.float32)
    zero = np.full(512, -1.0, np.float32)
    try:
        from clip_codec_tpu_torch.cli.reconstruct_diffusion import decode_embedding
        from clip_codec_tpu_torch.io.bitstream import write_bitstream

        store = ROOT / "build" / "chip_smoke" / "sd"
        np.savez(store / "codec_meta.npz", scale=scale, zero=zero)
        z = []
        for i, row in enumerate(codes):
            write_bitstream(row.tobytes(), 512, store / f"img{i}.clp")
            z.append(decode_embedding(store / f"img{i}.clp", store))
        return np.concatenate(z)
    except ImportError:
        print("sd frames: skipped (no zstandard)")
        return dequantize_l2norm_host(codes, scale, zero).astype(np.float32)


def phase_sd_serve(torch, attn, mlp, unet, vae, adapter, seed, dev, card):
    from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as cli

    store = ROOT / "build" / "chip_smoke" / "sd"
    store.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # diffusers' fp16 layout for the frozen towers, the reference fp32 adapter
    for name, mod, dt in (("unet", unet, torch.float16), ("vae", vae, torch.float16),
                          ("adapter", adapter, torch.float32)):
        torch.save({k: v.detach().to("cpu", dt) for k, v in mod.state_dict().items()}, store / f"{name}.pt")
    t1 = time.perf_counter()
    dec = cli.load_decoder(store / "unet.pt", store / "vae.pt", store / "adapter.pt", dev, heads=8)
    t2 = time.perf_counter()
    print(f"sd-serve: saved weights in {t1 - t0:.2f} s, loaded through the CLI's loader in {t2 - t1:.2f} s")
    z_all = sd_embeddings(seed, sum(SD_REQUESTS))

    torch.cuda.synchronize()
    reset_sd_launches(attn, mlp)
    times, s = [], 0
    for n in SD_REQUESTS:
        z = z_all[s:s + n]
        s += n
        t0 = time.perf_counter()
        img = cli.sample_images(dec, z, SD_SIZE, steps=SD_STEPS, sampler="dpmpp", guidance=SD_GUIDANCE,
                                seed=seed).float().cpu()
        times.append(time.perf_counter() - t0)
        check(tuple(img.shape) == (n, SD_SIZE, SD_SIZE, 3), f"SD request of {n}: output shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all().item()), f"SD request of {n}: non-finite output")
    launches = {k: sd_launches(attn, mlp)[k] for k in ("flash_attention", "transformer_mlp")}
    for n, dt in zip(SD_REQUESTS, times):
        print(f"sd-serve: request of {n} embedding(s) (CFG batched, UNet batch {2 * n}, dpmpp-{SD_STEPS}, "
              f"guidance {SD_GUIDANCE}, {SD_SIZE}px) {dt:.3f} s on {card}")
    print(f"sd-serve: {sum(SD_REQUESTS)} images in {sum(times):.3f} s = {sum(SD_REQUESTS) / sum(times):.3f} img/s "
          f"on {card}; launches={launches}")
    want = {"flash_attention": len(SD_REQUESTS) * (SD_STEPS * SD_FLASH_PER_FORWARD + 1),
            "transformer_mlp": len(SD_REQUESTS) * SD_STEPS * SD_MLP_PER_FORWARD}
    check(launches == want, f"SD kernel launches {launches} != {want}")
    return launches


# ------------------------------------------------------ SD adapter training


def _sdpa_bwd_ms(torch, q, k, v, dout):
    """SDPA's backward alone at the same shape: one library call computing
    dq, dk and dv, the work of K5's pair (for scale, not a plain version)."""
    import torch.nn.functional as F

    qs, ks, vs = (t[None].detach().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(qs, ks, vs)
    return cuda_ms(torch, lambda: torch.autograd.grad(o, (qs, ks, vs), dout[None], retain_graph=True))


def phase_flash_bwd(torch, attn, seed, dev):
    """K5's two kernels against the plain backward at the training shapes."""
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    bf = torch.bfloat16
    rec = {"flash_attention_bwd_dq": {"max_abs_err": 0.0}, "flash_attention_bwd_dkv": {"max_abs_err": 0.0}}
    cases = [(shape, 1.0) for shape in FLASH_BWD_SHAPES] + [(FLASH_BWD_SHAPES[0], 30.0)]
    for (BH, N, D), q_scale in cases:
        q = _randn(torch, gen, (BH, N, D), dev, q_scale, bf)
        k, v, dout = (_randn(torch, gen, (BH, N, D), dev, 1.0, bf) for _ in range(3))
        out, lse = attn.flash_attention_fwd(q, k, v)
        lse2, dvec = attn._bwd_stats(out, lse, dout)
        got = attn.flash_attention_bwd(q, k, v, out, lse, dout)
        want = attn.flash_attention_bwd_plain(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        tag = f"flash_attention_bwd (BH, N, D)=({BH}, {N}, {D}) {'extreme' if q_scale > 1 else 'normal'} logits"
        errs, rels = {}, {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            g, w = g.float(), w.float()
            scale = w.abs().max().item()
            errs[name] = (g - w).abs().max().item()
            rels[name] = errs[name] / scale
            ok = bool(((g - w).abs() <= 2e-2 * (w.abs() + scale)).all().item())
            check(ok, f"{tag}: {name} outside rtol = atol = 2e-2 of its scale {scale:.3e} "
                      f"(max abs err {errs[name]:.3e})")
        del got, want
        line = (f"kernel-check: {tag} max_abs_err(dq, dk, dv)=({errs['dq']:.3e}, {errs['dk']:.3e}, "
                f"{errs['dv']:.3e}) relative to each max |grad|=({rels['dq']:.3e}, {rels['dk']:.3e}, "
                f"{rels['dv']:.3e})")
        rec["flash_attention_bwd_dq"]["max_abs_err"] = max(rec["flash_attention_bwd_dq"]["max_abs_err"], errs["dq"])
        rec["flash_attention_bwd_dkv"]["max_abs_err"] = max(rec["flash_attention_bwd_dkv"]["max_abs_err"],
                                                            errs["dk"], errs["dv"])
        if q_scale == 1.0:
            args = (q, k, v, dout, lse2, dvec)
            dq_ms = cuda_ms(torch, lambda: attn.flash_attention_bwd_dq(*args))
            dkv_ms = cuda_ms(torch, lambda: attn.flash_attention_bwd_dkv(*args))
            dqg_ms = graph_ms(torch, lambda: attn.flash_attention_bwd_dq(*args))
            dkvg_ms = graph_ms(torch, lambda: attn.flash_attention_bwd_dkv(*args))
            pdq_ms = cuda_ms(torch, lambda: attn.flash_attention_bwd_dq_plain(*args), iters=3, warmup=1)
            pdkv_ms = cuda_ms(torch, lambda: attn.flash_attention_bwd_dkv_plain(*args), iters=3, warmup=1)
            lib_ms = _sdpa_bwd_ms(torch, q, k, v, dout)
            prod = 2 * BH * N * N * D  # flops of one (N, N, D) product
            io = 4 * BH * N * D * 2 + 2 * BH * N * 4  # q, k, v, dout bf16 + lse, dvec fp32, read once
            exps = BH * N * N  # p = exp2(s - lse2), recomputed in each kernel, once in the pair's own work
            bq = bound(io + BH * N * D * 2, 3 * prod, exps=exps)  # dq: S, dP, dS K
            bkv = bound(io + 2 * BH * N * D * 2, 4 * prod, exps=exps)  # dk, dv: S, dP, P^T dO, dS^T Q
            bpair = bound(io + 3 * BH * N * D * 2, 5 * prod, exps=exps)  # the backward's own work, no recompute
            line += (f" dq_ms={dq_ms:.4f} dkv_ms={dkv_ms:.4f} plain_dq_ms={pdq_ms:.4f} plain_dkv_ms={pdkv_ms:.4f}"
                     f" sdpa_bwd_library_not_plain_ms={lib_ms:.4f} dq_TFLOPs={3 * prod / 1e9 / dq_ms:.1f}"
                     f" dkv_TFLOPs={4 * prod / 1e9 / dkv_ms:.1f} useful_TFLOPs={5 * prod / 1e9 / (dq_ms + dkv_ms):.1f}"
                     f" bound_ms(dq, dkv)=({bq[0]:.4f}, {bkv[0]:.4f}) pair_bound_ms={bpair[0]:.4f}"
                     f" graph_ms(dq, dkv)=({dqg_ms:.4f}, {dkvg_ms:.4f})")
            # every path shape, on both rows; the records' own keys are the first shape's
            shape = dict(shape=[BH, N, D], dq_ms=dq_ms, dkv_ms=dkv_ms, pair_ms=dq_ms + dkv_ms, dq_graph_ms=dqg_ms,
                         dkv_graph_ms=dkvg_ms, plain_dq_ms=pdq_ms, plain_dkv_ms=pdkv_ms, library_ms=lib_ms,
                         dq_bound_ms=bq[0], dkv_bound_ms=bkv[0], pair_bound_ms=bpair[0], bound_by=bpair[1],
                         bound_unit=bpair[2])
            for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                rec[name].setdefault("shapes", []).append(shape)
            if (BH, N, D) == FLASH_BWD_SHAPES[0]:
                # each row's bound counts its own products (the split recomputes
                # S and dP in both); library_ms, pair_ms and pair_bound_ms are
                # of the whole backward, which one SDPA backward call computes
                pair = dict(library_ms=lib_ms, library_covers="dq, dk and dv", pair_ms=dq_ms + dkv_ms,
                            pair_bound_ms=bpair[0], timed_at=tag)
                rec["flash_attention_bwd_dq"].update(ms=dq_ms, plain_ms=pdq_ms, bound_ms=bq[0], bound_by=bq[1],
                                                     bound_unit=bq[2], **pair)
                rec["flash_attention_bwd_dkv"].update(ms=dkv_ms, plain_ms=pdkv_ms, bound_ms=bkv[0],
                                                      bound_by=bkv[1], bound_unit=bkv[2], **pair)
        print(line)
        del q, k, v, dout, out, lse, lse2, dvec
        torch.cuda.empty_cache()
    return rec


def train_batch(torch, seed, dev, B):
    """Seeded (z, lat0, weight, t, noise) of one SD-1.5 training batch: unit
    (B, 512) embeddings, (B, 64, 64, 4) latents and noise, t in [0, 1000)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.nn.functional.normalize(torch.randn((B, 512), generator=gen, device=dev), dim=-1)
    lat0, noise = (torch.randn((B, 64, 64, 4), generator=gen, device=dev) for _ in range(2))
    t = torch.randint(0, 1000, (B,), generator=gen, device=dev, dtype=torch.int32)
    return z, lat0, torch.ones(B, device=dev), t, noise


def _grad_vector(torch, adapter):
    return torch.cat([p.grad.detach().float().flatten() for p in adapter.parameters()])


def phase_train_grad(torch, attn, mlp, unet, vae, adapter, seed, dev):
    """The adapter's gradient on the kernel, plain and fp32 plain paths."""
    from clip_codec_tpu_torch.models.sd import StableDiffusionDecoder
    from clip_codec_tpu_torch.train.sd_diffusion_train import SDTrainConfig, make_optimizer, make_sd_train_step

    dec = StableDiffusionDecoder(unet, vae, adapter)
    step = make_sd_train_step(dec, make_optimizer(adapter, 1e-4), SDTrainConfig())
    for s in (seed, seed + 1):
        z, lat0, w, t, noise = train_batch(torch, s + 7, dev, 1)

        def grad():
            adapter.zero_grad(set_to_none=True)
            loss = step.loss_fn(z, lat0, w, t, noise)
            loss.backward()
            return loss.item(), _grad_vector(torch, adapter)

        reset_sd_launches(attn, mlp)
        loss_k, g_k = grad()
        n = sd_launches(attn, mlp)
        with plain_sd_kernels(attn, mlp):
            loss_p, g_p = grad()
            unet.compute_dtype = vae.compute_dtype = torch.float32
            try:
                loss_32, g_32 = grad()
            finally:
                unet.compute_dtype = vae.compute_dtype = torch.bfloat16
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()
        rk, rp = rel(g_k, g_32), rel(g_p, g_32)
        print(f"train-grad: seed {s} SD-1.5 64x64 latent B=1 t={int(t.item())} loss(kernel, plain, fp32)="
              f"({loss_k:.6f}, {loss_p:.6f}, {loss_32:.6f}) rel(g_kernel, g_plain)={rel(g_k, g_p):.3e} "
              f"to_fp32(kernel, plain)=({rk:.3e}, {rp:.3e}) ratio={rk / rp:.4f} launches={n}")
        check(bool(torch.isfinite(g_k).all().item()) and g_k.norm().item() > 0, "adapter gradient not finite or zero")
        check(rk <= FP32_RATIO * rp, f"adapter gradient: kernel path {rk} from fp32 > {FP32_RATIO} x plain's {rp}")
        check(n == TRAIN_LAUNCHES, f"one loss and backward launched {n}, expected {TRAIN_LAUNCHES}")
    adapter.zero_grad(set_to_none=True)


def _train_store(seed, store: Path):
    """8 seeded PNG images with .clp frames; returns their codes where
    zstandard is missing (the store is then entered at the codes), else None."""
    import json

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed + 8)
    images = rng.integers(0, 256, (TRAIN_IMAGES, 96, 128, 3), dtype=np.uint8)  # resized to 512 on load
    codes = rng.integers(0, 256, (TRAIN_IMAGES, 512), dtype=np.uint8)
    store.mkdir(parents=True, exist_ok=True)
    np.savez(store / "codec_meta.npz", scale=np.full(512, 2.0 / 255.0, np.float32), zero=np.full(512, -1.0, np.float32))
    for i, im in enumerate(images):
        Image.fromarray(im).save(store / f"img{i}.png")
    recs = [{"image": str(store / f"img{i}.png"), "bitstream": str(store / f"img{i}.clp")} for i in range(TRAIN_IMAGES)]
    (store / "manifest.json").write_text(json.dumps(recs))
    try:
        from clip_codec_tpu_torch.io.bitstream import write_bitstream

        for i, row in enumerate(codes):
            write_bitstream(row.tobytes(), 512, store / f"img{i}.clp")
    except ImportError:
        print("train frames: zstandard missing, entering at the codes")
        return codes
    return None


def phase_train(torch, attn, mlp, unet, vae, adapter, seed, dev, card):
    """Precompute latents, train 2 epochs, load the adapter and sample."""
    from clip_codec_tpu_torch.cli import reconstruct_sd_diffusion as cli
    from clip_codec_tpu_torch.cli.precompute_latents import precompute_latents
    from clip_codec_tpu_torch.io import store as store_mod
    from clip_codec_tpu_torch.models.sd import StableDiffusionDecoder
    from clip_codec_tpu_torch.train.sd_diffusion_train import (SDTrainConfig, make_optimizer, make_sd_train_step,
                                                                train_sd_diffusion)

    store = ROOT / "build" / "chip_smoke" / "train"
    codes = _train_store(seed, store)
    t0 = time.perf_counter()
    reset_sd_launches(attn, mlp)
    precompute_latents(store, vae, size=SD_SIZE, batch_size=TRAIN_BATCH,
                       generator=torch.Generator(device=dev).manual_seed(seed))
    n_pre = sd_launches(attn, mlp)["flash_attention"]
    print(f"train-precompute: {TRAIN_IMAGES} images at {SD_SIZE}px through the VAE encoder in "
          f"{time.perf_counter() - t0:.3f} s; flash launches {n_pre}")
    check(n_pre == TRAIN_IMAGES // TRAIN_BATCH, f"precompute launched flash {n_pre} times")

    before = {k: v.detach().clone() for k, v in adapter.state_dict().items()}
    dec = StableDiffusionDecoder(unet, vae, adapter)
    cfg = SDTrainConfig(epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH, seed=seed, log_every=1)
    saved_read = store_mod.Store.read_codes
    if codes is not None:
        store_mod.Store.read_codes = lambda self: codes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_sd_launches(attn, mlp)
    t0 = time.perf_counter()
    try:
        final = train_sd_diffusion(store, dec, save_dir=store / "out", config=cfg)
    finally:
        store_mod.Store.read_codes = saved_read
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sd_launches(attn, mlp)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    steps = TRAIN_EPOCHS * (TRAIN_IMAGES // TRAIN_BATCH)
    want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
    changed = max((adapter.state_dict()[k] - v).abs().max().item() for k, v in before.items())
    print(f"train: {TRAIN_EPOCHS} epochs x {TRAIN_IMAGES // TRAIN_BATCH} steps at batch {TRAIN_BATCH}, SD-1.5 "
          f"{SD_SIZE}px, bf16 UNet/VAE, fp32 adapter and AdamW: {wall:.3f} s in all (checkpoints and first-step "
          f"set-up included), peak device memory {peak:.2f} GiB on {card}; adapter max change {changed:.3e}; "
          f"launches={launches}")
    check(launches == want, f"training launches {launches} != {want}")
    check(changed > 0, "the adapter did not change")
    sd_dir = ROOT / "build" / "chip_smoke" / "sd"
    ld = cli.load_decoder(sd_dir / "unet.pt", sd_dir / "vae.pt", final, dev, heads=8)
    img = cli.sample_images(ld, torch.zeros((1, 512)).numpy() + 512 ** -0.5, SD_SIZE, steps=SD_STEPS,
                            sampler="dpmpp", guidance=SD_GUIDANCE, seed=seed).float()
    check(tuple(img.shape) == (1, SD_SIZE, SD_SIZE, 3) and bool(torch.isfinite(img).all().item()),
          "sampling with the trained adapter failed")
    del ld

    # steady-state steps on one batch, for the step time
    step = make_sd_train_step(dec, make_optimizer(adapter, cfg.lr), cfg)
    batch = train_batch(torch, seed + 9, dev, TRAIN_BATCH)
    losses = [step(*batch) for _ in range(2)]  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_timed = 5
    for _ in range(n_timed):
        losses.append(step(*batch))
    torch.cuda.synchronize()
    s_step = (time.perf_counter() - t0) / n_timed
    check(all(bool(torch.isfinite(l).item()) for l in losses), "training loss not finite")
    print(f"train-step: batch {TRAIN_BATCH}, SD-1.5 {SD_SIZE}px: {s_step:.4f} s per step = "
          f"{TRAIN_BATCH / s_step:.3f} img/s over {n_timed} synchronized steps on {card}; loss "
          f"{losses[-1].item():.6f}")
    return launches


# ------------------------------------------------------ pixel-decoder training


def reset_gn_launches(gn) -> None:
    gn.group_norm_silu_stats.launches = 0
    gn.group_norm_silu_norm.launches = 0


def gn_launches(gn, rc) -> tuple:
    """(K1 stats, K1 norm, K2 + K3) launches since the last resets."""
    return (gn.group_norm_silu_stats.launches, gn.group_norm_silu_norm.launches,
            rc.affine_silu_conv3x3.launches + rc.affine_conv3x3.launches)


@contextlib.contextmanager
def plain_k1(gn):
    """Route the ResBlocks' GroupNorm+SiLU to its plain version."""
    saved = gn.group_norm_silu
    gn.group_norm_silu = gn.group_norm_silu_plain
    try:
        yield
    finally:
        gn.group_norm_silu = saved


def _gn_inputs(torch, gen, shape, dev, dtype):
    C = shape[-1]
    x = (2 * torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
    return x, 1 + 0.2 * torch.randn((C,), generator=gen, device=dev), 0.2 * torch.randn((C,), generator=gen, device=dev)


def phase_groupnorm(torch, gn, seed, dev):
    """K1's two kernels against their plain versions at the training shapes;
    returns per-kernel records."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    G, bf = GN_GROUPS, torch.bfloat16
    rec = {"group_norm_silu_stats": {"max_abs_err": 0.0}, "group_norm_silu_norm": {"max_abs_err": 0.0}}
    cases = [((GN_BATCH, H, W, C), bf) for H, W, C in GN_SHAPES]
    cases += [((GN_BATCH, 64, 64, 256), torch.float32), (GN_TAIL, bf), (GN_TAIL, torch.float32)]
    for shape, dtype in cases:
        x, scale, bias = _gn_inputs(torch, gen, shape, dev, dtype)
        part = gn.group_norm_silu_stats(x)
        part_ref = gn.group_norm_silu_stats_plain(x, part.shape[1])
        y_norm = gn.group_norm_silu_norm(x, part, scale, bias, G)
        y_norm_ref = gn.group_norm_silu_norm_plain(x, part, scale, bias, G)
        y = gn.group_norm_silu(x, (scale, bias), G)
        y_ref = gn.group_norm_silu_plain(x, (scale, bias), G)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        tag = f"group_norm_silu {tuple(shape)} G={G} {str(dtype).split('.')[-1]} chunks={part.shape[1]}"
        part_err = max((part[:, :, k] - part_ref[:, :, k]).abs().max().item() / part_ref[:, :, k].abs().max().item()
                       for k in range(2))
        errs = {}
        for name, a, b in (("norm", y_norm, y_norm_ref), ("pair", y, y_ref)):
            a, b = a.float(), b.float()
            errs[name] = (a - b).abs().max().item()
            check(bool(((a - b).abs() <= tol + tol * b.abs()).all().item()),
                  f"{tag}: {name} outside rtol=atol={tol} (max abs err {errs[name]})")
        check(part_err <= 1e-5, f"{tag}: stats partials rel err {part_err} > 1e-5")
        line = (f"kernel-check: {tag} stats_rel_err={part_err:.3e} norm_max_abs_err={errs['norm']:.3e} "
                f"pair_vs_group_norm_silu_plain_max_abs_err={errs['pair']:.3e}")
        rec["group_norm_silu_stats"]["max_abs_err"] = max(rec["group_norm_silu_stats"]["max_abs_err"],
                                                          (part - part_ref).abs().max().item())
        rec["group_norm_silu_norm"]["max_abs_err"] = max(rec["group_norm_silu_norm"]["max_abs_err"], errs["norm"])
        if dtype == bf and shape != GN_TAIL:
            B, H, W, C = shape
            K = part.shape[1]
            with torch.no_grad():
                s_ms = cuda_ms(torch, lambda: gn.group_norm_silu_stats(x))
                n_ms = cuda_ms(torch, lambda: gn.group_norm_silu_norm(x, part, scale, bias, G))
                pair_ms = cuda_ms(torch, lambda: gn.group_norm_silu(x, (scale, bias), G))
                ps_ms = cuda_ms(torch, lambda: gn.group_norm_silu_stats_plain(x, K), iters=5)
                pn_ms = cuda_ms(torch, lambda: gn.group_norm_silu_norm_plain(x, part, scale, bias, G), iters=5)
                pp_ms = cuda_ms(torch, lambda: gn.group_norm_silu_plain(x, (scale, bias), G), iters=5)
                xc, sb, bb = x.permute(0, 3, 1, 2), scale.to(bf), bias.to(bf)  # NCHW view, channels_last
                lib_ms = cuda_ms(torch, lambda: F.silu(F.group_norm(xc, G, sb, bb, 1e-5)))
                dev_ms = [graph_ms(torch, f) for f in (
                    lambda: gn.group_norm_silu_stats(x), lambda: gn.group_norm_silu_norm(x, part, scale, bias, G),
                    lambda: gn.group_norm_silu(x, (scale, bias), G),
                    lambda: gn.group_norm_silu_plain(x, (scale, bias), G),
                    lambda: F.silu(F.group_norm(xc, G, sb, bb, 1e-5)))]
            n = B * H * W * C
            x_bytes, part_bytes = n * 2, B * K * 2 * C * 4
            bs = bound(x_bytes + part_bytes, 3 * n, FP32_FLOPS_PER_S)  # x read; partials written
            bn = bound(2 * x_bytes + part_bytes + 2 * C * 4, 8 * n, FP32_FLOPS_PER_S)  # + y written
            bp = bound(2 * x_bytes, 11 * n, FP32_FLOPS_PER_S)  # the function itself: x once, y once
            line += (f" stats_ms={s_ms:.4f} norm_ms={n_ms:.4f} pair_ms={pair_ms:.4f} plain_stats_ms={ps_ms:.4f}"
                     f" plain_norm_ms={pn_ms:.4f} plain_group_norm_silu_ms={pp_ms:.4f}"
                     f" group_norm_silu_library_not_plain_ms={lib_ms:.4f} bound_ms(stats, norm, pair)="
                     f"({bs[0]:.4f}, {bn[0]:.4f}, {bp[0]:.4f}) pair_GBps={2 * x_bytes / pair_ms / 1e6:.0f}"
                     f" graph_replayed_device_ms(stats, norm, pair, plain, library)=("
                     + ", ".join(f"{t:.4f}" for t in dev_ms) + ")")
            if (H, W, C) == GN_SHAPES[0]:
                # library: F.group_norm + F.silu computes the pair's function (for scale; the port never calls it)
                pair = dict(library_ms=lib_ms, library_covers="the pair", pair_ms=pair_ms, pair_bound_ms=bp[0],
                            timed_at=tag)
                rec["group_norm_silu_stats"].update(ms=s_ms, plain_ms=ps_ms, bound_ms=bs[0], bound_by=bs[1],
                                                    bound_unit=bs[2], **pair)
                rec["group_norm_silu_norm"].update(ms=n_ms, plain_ms=pn_ms, bound_ms=bn[0], bound_by=bn[1],
                                                   bound_unit=bn[2], **pair)
        print(line)
        del x, part, part_ref, y_norm, y_norm_ref, y, y_ref

    # the autograd Function's gradients: the backward recomputes the plain version
    shape = (GN_BATCH, 64, 64, 256)
    x, scale, bias = _gn_inputs(torch, gen, shape, dev, bf)
    g = torch.randn(shape, generator=gen, device=dev).to(bf)
    leaves = [t.detach().requires_grad_(True) for t in (x, scale, bias)]
    got = torch.autograd.grad(gn.group_norm_silu(leaves[0], tuple(leaves[1:]), G), leaves, g)
    want = torch.autograd.grad(gn.group_norm_silu_plain(leaves[0], tuple(leaves[1:]), G), leaves, g)
    rels = []
    for name, a, b in zip(("dx", "dscale", "dbias"), got, want):
        rels.append((a.float() - b.float()).abs().max().item() / b.float().abs().max().item())
        check(rels[-1] <= 2e-2, f"group_norm_silu backward {name}: rel err {rels[-1]} > 2e-2")
    print(f"kernel-check: group_norm_silu backward {shape} bf16 rel_err(dx, dscale, dbias)="
          f"({rels[0]:.3e}, {rels[1]:.3e}, {rels[2]:.3e})")
    torch.cuda.empty_cache()
    return rec


def px_net(torch, seed, dev, remat=False):
    from clip_codec_tpu_torch.models import CLIPCondUNet, init_params

    with torch.device(dev):
        net = CLIPCondUNet(z_dim=512, **PX_MODEL, time_dim=256, img_ch=3, dtype=torch.bfloat16,
                           fused_pallas=False, remat=remat)
    return init_params(net, torch.Generator(device=dev).manual_seed(seed))


def px_batch(torch, seed, dev, B):
    """Seeded (x0, z, weight, t, noise) of one 256px training batch."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.rand((B, SIZE, SIZE, 3), generator=gen, device=dev) * 2 - 1
    z = torch.nn.functional.normalize(torch.randn((B, 512), generator=gen, device=dev), dim=-1)
    t = torch.randint(0, 1000, (B,), generator=gen, device=dev, dtype=torch.int32)
    noise = torch.randn((B, SIZE, SIZE, 3), generator=gen, device=dev)
    return x0, z, torch.ones(B, device=dev), t, noise


def px_step(torch, net, dev, remat=False):
    from clip_codec_tpu_torch.diffusion import NoiseSchedule
    from clip_codec_tpu_torch.train.diffusion_train import DiffusionTrainConfig, make_train_step
    from clip_codec_tpu_torch.train.optim import make_optimizer

    cfg = DiffusionTrainConfig(**PX_MODEL, remat=remat)
    return make_train_step(net, NoiseSchedule.create(cfg.timesteps, cfg.schedule, device=dev),
                           make_optimizer(net, cfg.lr), cfg)


def phase_px_grad(torch, gn, rc, seed, dev):
    """Every parameter's gradient on the kernel, plain and fp32 plain paths."""
    net = px_net(torch, seed, dev)
    step = px_step(torch, net, dev)
    for s in (seed, seed + 1):
        batch = px_batch(torch, s + 11, dev, 2)

        def grad():
            net.zero_grad(set_to_none=True)
            loss = step.loss_fn(*batch)
            loss.backward()
            grads = [p.grad.detach().float().flatten() for p in net.parameters()]
            return loss.item(), grads

        rc.affine_silu_conv3x3.launches = rc.affine_conv3x3.launches = 0
        reset_gn_launches(gn)
        loss_k, gk = grad()
        n = gn_launches(gn, rc)
        with plain_k1(gn):
            loss_p, gp = grad()
            net.compute_dtype = torch.float32
            try:
                loss_32, g32 = grad()
            finally:
                net.compute_dtype = torch.bfloat16
        bad = [name for (name, _), g in zip(net.named_parameters(), gk)
               if not (bool(torch.isfinite(g).all().item()) and g.abs().max().item() > 0)]
        g_k, g_p, g_32 = (torch.cat(g) for g in (gk, gp, g32))
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()
        rk, rp = rel(g_k, g_32), rel(g_p, g_32)
        print(f"px-train-grad: seed {s} {PX_MODEL} {SIZE}px B=2 t={batch[3].tolist()} "
              f"loss(kernel, plain, fp32)=({loss_k:.6f}, {loss_p:.6f}, {loss_32:.6f}) rel(g_kernel, g_plain)="
              f"{rel(g_k, g_p):.3e} to_fp32(kernel, plain)=({rk:.3e}, {rp:.3e}) ratio={rk / rp:.4f} "
              f"launches(K1 stats, K1 norm, K2+K3)={n}")
        check(not bad, f"parameters with a non-finite or zero gradient: {bad[:5]}")
        check(rk <= FP32_RATIO * rp, f"U-Net gradient: kernel path {rk} from fp32 > {FP32_RATIO} x plain's {rp}")
        check(n == (GN_PER_FORWARD, GN_PER_FORWARD, 0), f"one loss and backward launched {n}")
    del net, step
    torch.cuda.empty_cache()


def _px_store(seed, store: Path):
    """16 seeded PNG images with .clp frames; returns the codes, and whether
    the frames were written (zstandard present)."""
    import json

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed + 12)
    images = rng.integers(0, 256, (PX_IMAGES, 96, 128, 3), dtype=np.uint8)  # resized to 256 on load
    codes = rng.integers(0, 256, (PX_IMAGES, 512), dtype=np.uint8)
    store.mkdir(parents=True, exist_ok=True)
    np.savez(store / "codec_meta.npz", scale=np.full(512, 2.0 / 255.0, np.float32), zero=np.full(512, -1.0, np.float32))
    for i, im in enumerate(images):
        Image.fromarray(im).save(store / f"img{i}.png")
    recs = [{"image": str(store / f"img{i}.png"), "bitstream": str(store / f"img{i}.clp")} for i in range(PX_IMAGES)]
    (store / "manifest.json").write_text(json.dumps(recs))
    try:
        from clip_codec_tpu_torch.io.bitstream import write_bitstream

        for i, row in enumerate(codes):
            write_bitstream(row.tobytes(), 512, store / f"img{i}.clp")
    except ImportError:
        print("px-train frames: zstandard missing, entering at the codes")
        return codes, False
    return codes, True


def phase_px_train(torch, gn, rc, seed, dev, card):
    """train_diffusion for 2 epochs, decompress with the result, one remat
    step, then the steady-state step time."""
    import numpy as np

    from clip_codec_tpu_torch.codec import ClipCodec
    from clip_codec_tpu_torch.io import store as store_mod
    from clip_codec_tpu_torch.train import diffusion_train as dtr

    store = ROOT / "build" / "chip_smoke" / "train_px"
    codes, frames = _px_store(seed, store)
    init = {k: v.detach().clone() for k, v in px_net(torch, seed, dev).state_dict().items()}
    cfg = dtr.DiffusionTrainConfig(out_size=SIZE, epochs=PX_EPOCHS, batch_size=PX_BATCH, **PX_MODEL,
                                   data_workers=2, seed=seed, log_every=1)
    losses = []
    saved_step, saved_read = dtr.make_train_step, store_mod.Store.read_codes

    def recording(*a, **k):
        step = saved_step(*a, **k)

        def rec(*args):
            losses.append(step(*args))
            return losses[-1]

        return rec

    dtr.make_train_step = recording
    if not frames:
        store_mod.Store.read_codes = lambda self: codes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rc.affine_silu_conv3x3.launches = rc.affine_conv3x3.launches = 0
    reset_gn_launches(gn)
    t0 = time.perf_counter()
    try:
        final = dtr.train_diffusion(store, save_dir=store / "out", config=cfg, device=dev)
    finally:
        dtr.make_train_step, store_mod.Store.read_codes = saved_step, saved_read
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = gn_launches(gn, rc)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    steps = PX_EPOCHS * -(-PX_IMAGES // PX_BATCH)
    trained = torch.load(final, map_location=dev, weights_only=True)
    changed = max((trained[k] - v).abs().max().item() for k, v in init.items())
    finite = all(bool(torch.isfinite(v).all().item()) for v in trained.values())
    print(f"px-train: {PX_EPOCHS} epochs x {steps // PX_EPOCHS} steps at batch {PX_BATCH}, {PX_MODEL} "
          f"{SIZE}px, bf16 activations, fp32 parameters and AdamW: {wall:.3f} s in all (PNG decode, checkpoints "
          f"and first-step set-up included), peak device memory {peak:.2f} GiB on {card}; losses "
          f"{[round(float(l), 6) for l in losses]}; parameters max change {changed:.3e}; "
          f"launches(K1 stats, K1 norm, K2+K3)={n}")
    check(len(losses) == steps and all(bool(torch.isfinite(l).item()) for l in losses), "training loss not finite")
    check(finite and changed > 0, "the trained parameters are not finite or did not change")
    check(n == (GN_PER_FORWARD * steps, GN_PER_FORWARD * steps, 0), f"training launches {n}")
    launches = {"group_norm_silu_stats": n[0], "group_norm_silu_norm": n[1]}

    # serve the trained decoder through ClipCodec and K2/K3
    codec = ClipCodec.load(store, weights=final, device=dev)
    rc.affine_silu_conv3x3.launches = rc.affine_conv3x3.launches = 0
    reset_gn_launches(gn)
    t0 = time.perf_counter()
    if frames:
        from clip_codec_tpu_torch.io.bitstream import compress_frame

        out = codec.decompress([compress_frame(r.tobytes()) for r in codes[:2]], size=SIZE, steps=STEPS,
                               batch_size=2, seed=seed)
    else:
        out = codec.decompress_codes(codes[:2], size=SIZE, steps=STEPS, batch_size=2, seed=seed)
    dt = time.perf_counter() - t0
    n = gn_launches(gn, rc)
    print(f"px-train-serve: the trained decoder answers a request of 2 frames (DDIM-{STEPS}, {SIZE}px) in "
          f"{dt:.3f} s on {card}; launches(K1 stats, K1 norm, K2+K3)={n}")
    check(out.shape == (2, SIZE, SIZE, 3) and bool(np.isfinite(out).all()) and float(np.abs(out).max()) <= 1.0,
          "the trained decoder's output is not finite, in [-1, 1] and (2, 256, 256, 3)")
    check(n == (0, 0, LAUNCHES_PER_FORWARD * STEPS), f"decompress launches {n}")
    del codec, trained, init

    batch = px_batch(torch, seed + 13, dev, PX_BATCH)
    net = px_net(torch, seed, dev, remat=True)
    reset_gn_launches(gn)
    loss = px_step(torch, net, dev, remat=True)(*batch)
    n = gn_launches(gn, rc)
    print(f"px-train-remat: one remat step at batch {PX_BATCH}: loss {loss.item():.6f} "
          f"launches(K1 stats, K1 norm, K2+K3)={n}")
    check(bool(torch.isfinite(loss).item()), "remat step loss not finite")
    check(n[:2] == (2 * GN_PER_FORWARD, 2 * GN_PER_FORWARD), f"remat step launches {n}")
    del net
    torch.cuda.empty_cache()

    net = px_net(torch, seed, dev)
    step = px_step(torch, net, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [step(*batch) for _ in range(2)]  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_timed = 5
    for _ in range(n_timed):
        losses.append(step(*batch))
    torch.cuda.synchronize()
    s_step = (time.perf_counter() - t0) / n_timed
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(all(bool(torch.isfinite(l).item()) for l in losses), "training loss not finite")
    print(f"px-train-step: batch {PX_BATCH}, {PX_MODEL} {SIZE}px: {s_step:.4f} s per step = "
          f"{PX_BATCH / s_step:.3f} img/s over {n_timed} synchronized steps, peak device memory {peak:.2f} GiB "
          f"on {card}; loss {losses[-1].item():.6f}")
    del net, step
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------ attention probes (P1-P3)


def probe_launches(ap) -> dict:
    return {"flash_probe_variant": ap.flash_variant.launches, "flash_probe_fast": ap.fast_flash_acc.launches,
            "flash_probe_single_pass": ap.single_pass.launches}


def reset_probe_launches(ap) -> None:
    ap.flash_variant.launches = ap.fast_flash_acc.launches = ap.single_pass.launches = 0


def _rel_to_max(got, want) -> float:
    return (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()


def _softmax_ok(got, want, tol: float = 2e-2) -> bool:
    """Within rtol = atol = ``tol`` elementwise and within ``tol`` of want's
    largest magnitude: at normal logits the output's values are ~0.02, so
    the elementwise atol alone would let a dropped key tile pass."""
    got, want = got.float(), want.float()
    return (bool(((got - want).abs() <= tol + tol * want.abs()).all().item())
            and _rel_to_max(got, want) <= tol)


def phase_probe_kernels(torch, ap, seed, dev):
    """Every probe kernel against its plain version at PROBE_CHECK_SHAPE, bf16,
    normal and (all but nomax) extreme logits; returns per-kernel records."""
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    BH, N, D = PROBE_CHECK_SHAPE
    q = _randn(torch, gen, (BH, N, D), dev, 1.0, torch.bfloat16)
    k, v = (_randn(torch, gen, (BH, N, D), dev, 1.0, torch.bfloat16) for _ in range(2))
    inputs = {"normal": q, "extreme": (q.float() * 30).to(torch.bfloat16)}
    rec = {name: {"max_abs_err": 0.0} for name in probe_launches(ap)}

    def record(name, tag, results):
        print(f"kernel-check: {tag} (BH, N, D)=({BH}, {N}, {D}) " + " ".join(
            f"{logits}: max_abs_err={err:.3e} rel_to_max={rel:.3e}" for logits, (err, rel, _) in results.items()))
        for logits, (err, _, ok) in results.items():
            check(ok, f"{tag} {logits} logits: outside its tolerance (max abs err {err:.3e})")
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    for mode, tq, tk in ap.P1_TILES:
        results = {}
        for logits, qq in inputs.items():
            if logits == "extreme" and mode == "nomax":
                continue  # overflows by design
            got, want = ap.flash_variant(qq, k, v, tq, tk, mode), ap.flash_variant_plain(qq, k, v, tk, mode)
            rel = _rel_to_max(got, want)
            ok = rel <= 2e-2 if mode in ("noexp", "dotonly") else _softmax_ok(got, want)
            results[logits] = ((got.float() - want.float()).abs().max().item(), rel, ok)
        record("flash_probe_variant", f"flash_probe_variant {mode} (tq, tk)=({tq}, {tk})", results)
    for deg, mxu, tq, tk in ap.P2_TILES:
        results = {}
        for logits, qq in inputs.items():
            acc, want = ap.fast_flash_acc(qq, k, v, tq, tk, deg, mxu), ap.fast_flash_plain(qq, k, v, tk, deg, mxu)
            out, out_ref = (a[..., :D] / a[..., D:] for a in (acc, want))
            ok = (_softmax_ok(out.to(torch.bfloat16), out_ref.to(torch.bfloat16))
                  and bool(((acc[..., D] - want[..., D]).abs() <= 2e-2 * want[..., D].abs()).all().item()))
            results[logits] = ((out - out_ref).abs().max().item(), _rel_to_max(acc, want), ok)
        record("flash_probe_fast", f"flash_probe_fast deg={deg} {'mxu' if mxu else 'vpu'}-sum (tq, tk)=({tq}, {tk})",
               results)
    for tq in ap.P3_TILES:
        results = {}
        for logits, qq in inputs.items():
            got, want = ap.single_pass(qq, k, v, tq), ap.single_pass_plain(qq, k, v)
            results[logits] = ((got.float() - want.float()).abs().max().item(), _rel_to_max(got, want),
                               _softmax_ok(got, want))
        record("flash_probe_single_pass", f"flash_probe_single_pass tq={tq}", results)
    del q, k, v, inputs
    torch.cuda.empty_cache()
    return rec


def phase_probe(torch, ap, seed, dev, rec):
    """The probe's entry point at PROBE_SHAPE (its lines printed), its launch
    counts, then each kernel's, plain version's and SDPA's ms there."""
    import torch.nn.functional as F

    from clip_codec_tpu_torch.probes import attn_probe

    BH, N, D = PROBE_SHAPE
    reset_probe_launches(ap)
    res = attn_probe.run(dev, BH, N, D, seed)
    launches = probe_launches(ap)
    wrappers = {"flash_probe_variant": "flash_variant", "flash_probe_fast": "fast_flash_acc",
                "flash_probe_single_pass": "single_pass"}
    want = {name: res["calls"][w]["eager"] for name, w in wrappers.items()}
    replayed = {name: res["calls"][w]["replayed"] for name, w in wrappers.items()}
    print(f"probe: launches={launches}, eager calls={want}, launched by CUDA-graph replays={replayed}")
    check(launches == want, f"probe launches {launches} != one per eager wrapper call {want}")
    for label, err in res["errors"].items():
        check(err <= 2e-2, f"probe correctness: {label} max|delta|/max|oracle| = {err} > 2e-2")

    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    q, k, v = (_randn(torch, gen, (BH, N, D), dev, 1.0, torch.bfloat16) for _ in range(3))
    sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]))
    io = 4 * BH * N * D * 2  # q, k, v read and out written, bf16
    prod = 2 * BH * N * N * D  # flops of one (N, N, D) product
    # Each bound counts what the function needs: Q.K^T and P.V, one exponential
    # per score. The online rescale's alphas and P3's second Q.K^T are the
    # kernels' own choices, left out (P3's own work is reported beside it).
    cases = {
        # name: (timed at, kernel, plain, bound args, library ms)
        "flash_probe_variant": ("full (tq, tk)=(64, 64)", lambda: ap.flash_variant(q, k, v, 64, 64, "full"),
                                lambda: ap.flash_variant_plain(q, k, v, 64, "full"),
                                dict(nbytes=io, flops=2 * prod, exps=BH * N * N), sdpa_ms),
        "flash_probe_single_pass": ("tq=64", lambda: ap.single_pass(q, k, v, 64),
                                    lambda: ap.single_pass_plain(q, k, v),
                                    dict(nbytes=io, flops=2 * prod, exps=BH * N * N), sdpa_ms),
        # q, k and the ones-column v (48 wide) read, the fp32 (D + 1)-wide accumulator written;
        # poly2 on the FMA pipe; no PyTorch call computes it
        "flash_probe_fast": ("poly2 + mxu-sum (tq, tk)=(64, 64), raw accumulator",
                             lambda: ap.fast_flash_acc(q, k, v, 64, 64, 2, True),
                             lambda: ap.fast_flash_plain(q, k, v, 64, 2, True),
                             dict(nbytes=BH * N * (2 * D * 2 + 48 * 2 + (D + 1) * 4), flops=2 * prod,
                                  fma=(POLY_INSTRUCTIONS + 2) * BH * N * N), None),
    }
    for name, (timed, kernel, plain, bargs, lib_ms) in cases.items():
        k_ms = cuda_ms(torch, kernel)
        p_ms = cuda_ms(torch, plain, iters=3, warmup=1)
        b_ms, b_by, b_unit = bound(**bargs)
        terms = bound_terms(**bargs)
        tag = f"{name} {timed} at (BH, N, D)=({BH}, {N}, {D})"
        print(f"probe-kernel: {tag} ms={k_ms:.4f} plain_ms={p_ms:.4f} sdpa_library_ms={sdpa_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_unit}; " + ", ".join(f"{u} {t:.4f}" for u, t in terms.items()) + ")")
        rec[name].update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bound_unit=b_unit,
                         timed_at=tag)
    rec["flash_probe_fast"]["sdpa_ms_for_scale"] = sdpa_ms
    # P3's own work: Q.K^T in both sweeps and P.V
    rec["flash_probe_single_pass"]["two_sweep_bound_ms"] = bound(io, 3 * prod, exps=BH * N * N)[0]
    for name in wrappers:
        rec[name]["graph_replay_launches"] = replayed[name]
    for name, label in (("flash_probe_variant", attn_probe.P1_VARIANTS[0][0]),
                        ("flash_probe_single_pass", attn_probe.P3_VARIANTS[0][0])):
        rec[name]["probe_graph_ms"] = res["times"][label]["graph_ms"]
    del q, k, v
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from clip_codec_tpu_torch.ops import attention as attn
    from clip_codec_tpu_torch.ops import attention_probe as ap
    from clip_codec_tpu_torch.ops import groupnorm as gn
    from clip_codec_tpu_torch.ops import mlp
    from clip_codec_tpu_torch.ops import resblock_conv as rc

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"unit rates: {unit_rates()}")

    try:
        builds = start_builds()
        phase_build(builds)
        records = phase_kernels(torch, rc, args.seed, dev)
        net = full_unet(torch, args.seed, dev)
        phase_forward(torch, rc, net, args.seed, dev)
        launches = phase_serve(torch, rc, net, args.seed, dev, card)
        del net
        torch.cuda.empty_cache()

        phase_build(builds, ("flash_attention", "transformer_mlp"))
        records.update(phase_sd_kernels(torch, attn, mlp, args.seed, dev))
        unet, vae, adapter = sd_models(torch, args.seed, dev)
        phase_sd_forward(torch, attn, mlp, unet, vae, args.seed, dev)
        launches.update(phase_sd_serve(torch, attn, mlp, unet, vae, adapter, args.seed, dev, card))

        phase_build(builds, ("flash_attention_bwd",))
        records.update(phase_flash_bwd(torch, attn, args.seed, dev))
        phase_train_grad(torch, attn, mlp, unet, vae, adapter, args.seed, dev)
        train_launches = phase_train(torch, attn, mlp, unet, vae, adapter, args.seed, dev, card)
        launches.update({k: train_launches[k] for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")})
        del unet, vae, adapter
        torch.cuda.empty_cache()

        phase_build(builds, ("groupnorm_silu",))
        records.update(phase_groupnorm(torch, gn, args.seed, dev))
        phase_px_grad(torch, gn, rc, args.seed, dev)
        launches.update(phase_px_train(torch, gn, rc, args.seed, dev, card))

        phase_build(builds, ("flash_attention_probe",))
        records.update(phase_probe_kernels(torch, ap, args.seed, dev))
        launches.update(phase_probe(torch, ap, args.seed, dev, records))
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name, (lib, replaces) in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": f"{CSRC}/{lib}.cu", "replaces": replaces,
                        "launches": launches[name], **records[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
