"""Device time of the pixel path's conv kernels (K2, K3) at the U-Net's shapes, beside cuDNN.

    python -m clip_codec_tpu_torch.probes.conv_times [--seed 0]
    PYTHONPATH=<another checkout> python <path of this file>

Times, for the full-width U-Net (base 128, ch_mult (1, 2, 2)) at 256px
served at batch 4 (``ClipCodec`` pads every batch to ``batch_size`` = 4):

1. K2 (``ops.resblock_conv.affine_silu_conv3x3``) at each ResBlock conv
   shape, in the two forms the U-Net runs: with the moments and no residual
   (a ResBlock's first conv), with the residual and no moments (its second);
   then at 256^2 x 128->128 at batch 16;
2. K3 (``affine_conv3x3``, the linear head) at 256^2 x 128->3;
3. cuDNN's bf16 conv alone at each shape, for scale (it computes less: no
   affine, activation, bias, residual or moments);
4. one U-Net forward at batch 4 and at 16: the device time of its kernels
   (``torch.profiler``, summed over 3 forwards) and CUDA events around it.

Each kernel line is ``probes.attn_probe.time_call``'s: the device time per
call of 20 calls replayed from a CUDA graph, then CUDA events around 20
calls from Python. TF/s counts the conv's 2 * 9 * Cin * Cout FLOP per pixel.

Only the wrappers' and the model's public functions are called, so run by
path with PYTHONPATH at another checkout's root the script times that
checkout: two versions compared on one card in one call. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from clip_codec_tpu_torch.models import CLIPCondUNet, init_params
from clip_codec_tpu_torch.ops import resblock_conv as rc
from clip_codec_tpu_torch.probes.attn_probe import time_call

BASE, CH_MULT, SIZE, IMG_CH = 128, (1, 2, 2), 256, 3  # the reference U-Net at 256px
SERVE_BATCH, WIDE_BATCH = 4, 16


def path_conv_shapes(base: int, ch_mult: Sequence[int], size: int, batch: int,
                     img_ch: int = 3) -> List[Tuple[Tuple[int, int, int, int, int], int]]:
    """Every fused conv of one serving forward of ``CLIPCondUNet``:
    ``[((batch, H, W, Cin, Cout), calls per forward)]``, the ResBlock convs
    (K2) by resolution from the largest, then the head (K3).

    Each ch_mult stage runs two ResBlocks (two convs each) at its input
    width, then a stride-2 conv multiplies the channels; the middle runs two
    at the lowest resolution; each decoder stage runs two at its input width
    before a transposed conv divides them. The head is one conv of the last
    width to ``img_ch``."""
    calls: dict = {}
    ch, hw = base, size
    for m in ch_mult:
        calls[(batch, hw, hw, ch, ch)] = calls.get((batch, hw, hw, ch, ch), 0) + 4
        ch, hw = ch * m, (hw + 1) // 2
    calls[(batch, hw, hw, ch, ch)] = calls.get((batch, hw, hw, ch, ch), 0) + 4
    for m in reversed(ch_mult):
        calls[(batch, hw, hw, ch, ch)] = calls.get((batch, hw, hw, ch, ch), 0) + 4
        ch, hw = ch // m, hw * 2
    return sorted(calls.items(), key=lambda kv: -kv[0][1]) + [((batch, hw, hw, ch, img_ch), 1)]


def _inputs(gen, B, H, W, cin, cout, dev):
    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn((B, H, W, cin)).to(torch.bfloat16)
    A = 0.5 + torch.rand((B, cin), generator=gen, device=dev)
    w9 = (randn((9, cin, cout)) / (9 * cin) ** 0.5).to(torch.bfloat16)
    add = randn((B, H, W, cout)).to(torch.bfloat16)
    return x, A, randn((B, cin), 0.1), w9, randn((cout,), 0.1), add


def time_convs(dev: torch.device, seed: int = 0) -> None:
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = path_conv_shapes(BASE, CH_MULT, SIZE, SERVE_BATCH, IMG_CH)
    head = shapes[-1][0]
    shapes.append(((WIDE_BATCH, SIZE, SIZE, BASE, BASE), 0))
    for shape, _ in shapes:
        B, H, W, cin, cout = shape
        x, A, Bv, w9, bias, add = _inputs(gen, B, H, W, cin, cout, dev)
        flops = 2 * 9 * cin * cout * B * H * W
        tag = f"B={B} {H}^2 {cin}->{cout}"
        if shape == head:
            time_call(f"K3 {tag}", lambda: rc.affine_conv3x3(x, A, Bv, w9, bias), flops, dev)
        else:
            time_call(f"K2 {tag} moments", lambda: rc.affine_silu_conv3x3(x, A, Bv, w9, bias, want_moments=True),
                      flops, dev)
            time_call(f"K2 {tag} add", lambda: rc.affine_silu_conv3x3(x, A, Bv, w9, bias, add), flops, dev)
        act = x.permute(0, 3, 1, 2)
        wt = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
        time_call(f"cuDNN conv alone {tag}", lambda: F.conv2d(act, wt, padding=1), flops, dev)


def time_forward(dev: torch.device, seed: int = 0, reps: int = 3) -> None:
    """Device time of the U-Net forward's kernels (profiler) and events
    around it, at the serving and the wide batch."""
    from torch.profiler import ProfilerActivity, profile

    net = CLIPCondUNet(z_dim=512, base=BASE, ch_mult=CH_MULT, time_dim=256, img_ch=IMG_CH, dtype=torch.bfloat16)
    net = init_params(net, torch.Generator().manual_seed(seed)).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for B in (SERVE_BATCH, WIDE_BATCH):
        x = torch.randn((B, SIZE, SIZE, IMG_CH), generator=gen, device=dev)
        z = F.normalize(torch.randn((B, 512), generator=gen, device=dev), dim=-1)
        t = torch.randint(0, 1000, (B,), generator=gen, device=dev, dtype=torch.int32)
        with torch.no_grad():
            for _ in range(2):
                net(x, z, t)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    net(x, z, t)
                torch.cuda.synchronize()
            dev_us = sum(e.self_device_time_total for e in prof.key_averages())
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                net(x, z, t)
            end.record()
            end.synchronize()
            wall = (time.perf_counter() - t0) / reps * 1e3
        print(f"[conv-times] U-Net forward B={B} {SIZE}px: device {dev_us / reps / 1e3:.4f} ms of kernels, "
              f"events {start.elapsed_time(end) / reps:.4f} ms, host {wall:.4f} ms", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Time K2 and K3 at the pixel path's shapes on a card.")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("no CUDA device available: the kernels run only on a card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"-- device: {smi.stdout.strip()}; kernels from {rc.__file__} --", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    time_convs(dev, args.seed)
    time_forward(dev, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
