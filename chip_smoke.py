#!/usr/bin/env python3
"""Smoke run of the PyTorch port's decompress path on one CUDA card.

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

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SRC = "clip_codec_tpu_torch/csrc/affine_conv3x3.cu"
REPLACES = "clip_codec_tpu/ops/pallas_resblock.py:72"
# (H, W, Cin, Cout) of every fused conv of the full-width U-Net at 256px.
RESBLOCK_SHAPES = [(256, 256, 128, 128), (128, 128, 128, 128), (64, 64, 256, 256), (32, 32, 512, 512)]
HEAD_SHAPE = (256, 256, 128, 3)
LAUNCHES_PER_FORWARD = 29  # 14 ResBlocks x 2 + the head
SIZE, STEPS = 256, 50


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


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


def phase_build(torch):
    from clip_codec_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build("affine_conv3x3")
    dt = time.perf_counter() - t0
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
            rec.update(ms=k_ms, plain_ms=p_ms, timed_at=tag)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from clip_codec_tpu_torch.ops import resblock_conv as rc

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    try:
        phase_build(torch)
        records = phase_kernels(torch, rc, args.seed, dev)
        net = full_unet(torch, args.seed, dev)
        phase_forward(torch, rc, net, args.seed, dev)
        launches = phase_serve(torch, rc, net, args.seed, dev, card)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name in ("affine_silu_conv3x3", "affine_conv3x3"):
        r = records[name]
        kernels.append({"name": name, "route": "cuda", "source": KERNEL_SRC, "replaces": REPLACES,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "timed_at": r["timed_at"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
