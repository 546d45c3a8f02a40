"""Device time of the int8 serving kernels at their timed shapes, beside their bounds and the library.

    python -m clip_codec_tpu_torch.probes.int8_times [--seed 0] [--sd_profile | --eager | --quantize]
    PYTHONPATH=<another checkout> python <path of this file> --eager   (or --quantize)

Times, in bf16 out, with random activations from ``--seed``:

1. at the pixel artifact's seven 3x3 convs at B = 16 and SD-1.5's timed
   shapes at 64x64 latents with CFG (``CONVS``: chip_smoke.py's phase 22a
   timed set), three forms of the same int8 layer: ``ops.int8.int8_conv2d``
   alone (``int8_conv_nhwc``, codes in), the pair the model paths run
   (``int8_quantize`` then ``int8_conv_nhwc``, one graph) and the act form
   (``int8_conv2d_act``: one ``int8_conv_act_nhwc`` launch that quantizes
   in shared memory; bf16 activations, and fp32), with
   the act form's bound (the bf16 activations read once) and the pair over
   the act form; ``torch._int_mm`` on the same int32 product where the conv
   is a GEMM (for scale: the port never calls it);
2. ``ops.int8.absmax`` at the dynamic server's four conv inputs (B = 1),
   beside ``torch.linalg.vector_norm(x, inf)``.

Each line is ``probes.attn_probe.time_call``'s: 20 calls replayed from a
CUDA graph, then CUDA events around 20 calls from Python. The bound is the
larger of the bytes (codes and weights read once, bf16 y written once) over
3.35 TB/s and the products over 1,979 dense int8 TOP/s (H100 SXM). Each
conv line names the plan ``int8_conv_plan`` gives it.

With ``--sd_profile`` it then profiles SD-1.5's UNet (random weights from
``--seed``) at one request's batch (2, CFG batched, 64x64 latents), one
forward in bf16 and one in static int8 (scales from ``calibrate_int8`` at
t = 950, 500, 50), under ``torch.profiler``: the device ms a forward (the
summed kernel durations of 3 forwards over 3) by kind of kernel, so the
int8 forward's time, and its gap to bf16, can be read by kind (the act
form apart from the codes-in conv).

With ``--quantize`` it times, instead, ``int8_quantize`` alone at the
paths' shapes (``QUANTIZE``), bf16, at the activations' absmax and at a
power-of-two scale, each checked bit-equal to ``quantize_plain``; it calls
only functions the int8 port has had since it began, so it compares two
checkouts as ``--eager`` does.

With ``--eager`` it times, instead, what the host adds where every kernel
is launched from Python (the CLIs and ``serve --int8`` without an
artifact): each line gives the events time of 20 calls from Python beside
the graph replay's, then the wall time of 5 more calls and the host
microseconds a call spent inside each of ``ops.int8``'s launch functions
(``_launch_conv``, ``_launch_quantize``, ``_launch_absmax``: the checks,
the plan, the C entry point and the launch), for the conv at SD's split 8^2 and 16^2 levels, a
GEMM and the 8-token context projection, ``absmax``, and whole forwards
at random weights from ``--seed``: the pixel U-Net of the artifact (base
128, 256px) at the CLI's B = 1 in static int8 (``calibrate_unet``'s
scales), dynamic int8 and bf16, and SD-1.5's UNet at B = 2 (CFG, 64x64
latents) in static int8 and bf16. That mode calls only functions the
int8 port has had since it began, so run by path with PYTHONPATH at
another checkout's root it times that checkout: two versions compared on
one card in one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import time
from typing import Optional, Sequence

import torch

from clip_codec_tpu_torch.ops import int8 as q8
from clip_codec_tpu_torch.probes.attn_probe import time_call

HBM_BYTES_PER_S, INT8_OPS_PER_S = 3.35e12, 1979e12  # H100 SXM
KINDS = (  # kind -> kernel-name fragments, first match wins
    ("int8_conv_nhwc", ("int8_conv_kernel",)), ("int8_quantize", ("quantize_kernel",)), ("absmax", ("absmax_kernel",)),
    ("flash_attention(K4)", ("flash_fwd_kernel",)), ("transformer_mlp(K6)", ("mlp_",)),
    ("conv(cuDNN)", ("fprop", "conv", "cudnn")), ("gemm(cuBLAS)", ("gemm", "cublas", "cutlass", "nvjet")),
    ("copy", ("copy", "cat", "memcpy", "memset")), ("reduce", ("reduce_kernel", "softmax")),
    ("elementwise", ("elementwise",)))
# (xq shape, wq shape, stride, padding)
CONVS = [((16, 256, 256, 128), (128, 3, 3, 128), 1, 1), ((16, 256, 256, 128), (128, 3, 3, 128), 2, 1),
         ((16, 128, 128, 128), (128, 3, 3, 128), 1, 1), ((16, 128, 128, 128), (256, 3, 3, 128), 2, 1),
         ((16, 64, 64, 256), (256, 3, 3, 256), 1, 1), ((16, 64, 64, 256), (512, 3, 3, 256), 2, 1),
         ((16, 32, 32, 512), (512, 3, 3, 512), 1, 1),
         ((2, 64, 64, 320), (320, 3, 3, 320), 1, 1), ((2, 32, 32, 640), (640, 3, 3, 640), 1, 1),
         ((2, 16, 16, 1280), (1280, 3, 3, 1280), 1, 1), ((2, 8, 8, 1280), (1280, 3, 3, 1280), 1, 1),
         ((8192, 1, 1, 320), (320, 1, 1, 320), 1, 0), ((8192, 1, 1, 320), (2560, 1, 1, 320), 1, 0),
         ((8192, 1, 1, 1280), (320, 1, 1, 1280), 1, 0), ((16, 1, 1, 768), (320, 1, 1, 768), 1, 0)]
ABSMAX = [(65536, 128), (16384, 128), (4096, 256), (1024, 512)]
# int8_quantize's (rows, channels) on the int8 paths, as chip_smoke.py's phase 22a times them: the pixel
# artifact's conv inputs at B = 16, then SD-1.5's at one request's batch
QUANTIZE = [(1048576, 128), (262144, 128), (65536, 256), (16384, 512),
            (8192, 320), (16, 768), (8192, 1280), (2048, 640), (512, 1280), (128, 1280)]


def conv_bound_ms(xs, ws, stride: int, pad: int, act: int = 1) -> float:
    """The least time of the conv: the activations (``act`` bytes a value:
    1 for codes, 2 for the bf16 the act form reads) and weights read once,
    bf16 y, w_scale and bias written or read once, or the products."""
    B, H, W, cin = xs
    cout, k, _, _ = ws
    m = B * ((H + 2 * pad - k) // stride + 1) * ((W + 2 * pad - k) // stride + 1)
    nbytes = act * B * H * W * cin + cout * k * k * cin + 2 * m * cout + 8 * cout
    return max(nbytes / HBM_BYTES_PER_S, 2.0 * m * cout * k * k * cin / INT8_OPS_PER_S) * 1e3


def _plan_text(plan) -> str:
    return (f"mw={plan.mw} bn={plan.bn} splits={plan.splits} swap={plan.swap} tile={plan.tile} units={plan.units} "
            f"stages={plan.stages}")


def time_int8(dev: torch.device, seed: int = 0) -> None:
    """Each conv of ``CONVS`` three ways: the codes' conv alone, the
    paths' pair (``int8_quantize`` then the codes' conv, one graph) and
    the act form on the same bf16 activations (and on fp32 ones), static
    absmax; then absmax."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for xs, ws, stride, pad in CONVS:
        cout, k, _, cin = ws
        x = torch.randn(xs, generator=gen, device=dev).to(torch.bfloat16)
        x32 = torch.randn(xs, generator=gen, device=dev)
        am = q8.absmax(x)
        xq, s = q8.quantize(x, am)
        wq = torch.randint(-127, 128, ws, generator=gen, device=dev, dtype=torch.int8)
        wsc = torch.rand((cout,), generator=gen, device=dev) * 1e-3 + 1e-4
        bias = torch.randn((cout,), generator=gen, device=dev)
        B, H, W, _ = xs
        m = B * ((H + 2 * pad - k) // stride + 1) * ((W + 2 * pad - k) // stride + 1)
        ops = 2.0 * m * cout * k * k * cin
        tag = f"x {xs} w {ws} s{stride}"
        t = time_call(f"int8_conv {tag}", lambda: q8.int8_conv2d(xq, wq, wsc, s, bias, stride, pad), ops, dev)

        def pair_call():
            codes, scale = q8.quantize(x, am)
            return q8.int8_conv2d(codes, wq, wsc, scale, bias, stride, pad)

        pair = time_call(f"quantize + int8_conv {tag}", pair_call, ops, dev)
        act = time_call(f"int8_conv_act bf16 {tag}", lambda: q8.int8_conv2d_act(x, am, wq, wsc, bias, stride, pad),
                        ops, dev)
        act32 = time_call(f"int8_conv_act fp32 {tag}",
                          lambda: q8.int8_conv2d_act(x32, am, wq, wsc, bias, stride, pad), ops, dev)
        lib = None
        if k == 1 and m > 16:
            a2, b2 = xq.reshape(m, cin), wq.reshape(cout, cin).t()
            lib = time_call(f"_int_mm {tag}", lambda: torch._int_mm(a2, b2), ops, dev)["graph_ms"]
        b, b2 = conv_bound_ms(xs, ws, stride, pad), conv_bound_ms(xs, ws, stride, pad, 2)
        plan = q8.int8_conv_plan(B, H, W, cin, cout, k, stride, pad, sms)
        plan2 = q8.int8_conv_plan(B, H, W, cin, cout, k, stride, pad, sms, 2)
        print(f"[int8-times] conv {tag}: {t['graph_ms']:.4f} ms (events {t['events_ms']:.4f}), bound {b:.4f} ms, "
              f"{100 * b / t['graph_ms']:.1f}% of bound, {ops / t['graph_ms'] / 1e9:.1f} TOP/s; _int_mm {lib}; "
              f"plan {_plan_text(plan)}", flush=True)
        print(f"[int8-times] pair vs act {tag}: quantize + conv {pair['graph_ms']:.4f} ms; act bf16 "
              f"{act['graph_ms']:.4f} ms (events {act['events_ms']:.4f}), bound {b2:.4f} ms (bf16 read once), "
              f"{100 * b2 / act['graph_ms']:.1f}% of bound, {pair['graph_ms'] / act['graph_ms']:.3f}x the pair; "
              f"act fp32 {act32['graph_ms']:.4f} ms; plan bf16 {_plan_text(plan2)}", flush=True)
        del x, x32, xq, wq
    for shape in ABSMAX:
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        t = time_call(f"absmax {shape}", lambda: q8.absmax(x), 0.0, dev)
        lib = time_call(f"vector_norm {shape}", lambda: torch.linalg.vector_norm(x, float("inf")), 0.0, dev)
        b = 2 * x.numel() / HBM_BYTES_PER_S * 1e3
        print(f"[int8-times] absmax {shape} bf16: {t['graph_ms']:.4f} ms (events {t['events_ms']:.4f}), bound "
              f"{b:.4f} ms (bytes); vector_norm {lib['graph_ms']:.4f} ms", flush=True)


def quantize_times(dev: torch.device, seed: int = 0) -> None:
    """``int8_quantize`` alone at each shape of ``QUANTIZE``, bf16, at two
    absmax: the activations' own, and the largest 127 * 2^k under it (s a
    power of two, where many x / s are exact halves): codes and scale
    checked against ``quantize_plain``, then timed beside the bytes bound."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for shape in QUANTIZE:
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        am = x.float().abs().amax()
        for kind, a in (("max|x|", am), ("pow2", 127.0 * torch.exp2(torch.floor(torch.log2(am / 127.0))))):
            got, want = q8.quantize(x, a), q8.quantize_plain(x, a)
            same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            t = time_call(f"int8_quantize {shape} {kind}", lambda: q8.quantize(x, a), 0.0, dev)
            b = 3 * x.numel() / HBM_BYTES_PER_S * 1e3
            print(f"[int8-times] quantize {shape} bf16 absmax {kind}: {t['graph_ms']:.4f} ms (events "
                  f"{t['events_ms']:.4f}), bound {b:.4f} ms (bytes), "
                  f"{'bit-equal to quantize_plain' if same else 'DIFFERS from quantize_plain'}", flush=True)
        del x


def kind_of(name: str) -> str:
    """A profiled kernel's kind; the conv's act form (its last template
    argument, the activations' element size, 2 or 4) apart from its codes-in
    form (1)."""
    low = name.lower()
    m = re.search(r"int8_conv_kernel(?:<[^>]*?(\d)\s*>|ili\d+eli\d+elb\d+eli(\d)e)", low)  # demangled, mangled
    if m:
        return "int8_conv_act" if (m.group(1) or m.group(2)) in ("2", "4") else "int8_conv_nhwc"
    return next((kind for kind, keys in KINDS if any(k in low for k in keys)), "other")


def sd_profile(dev: torch.device, seed: int, card: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from clip_codec_tpu_torch.models import init_params
    from clip_codec_tpu_torch.models.sd import SD15_UNET, SDUNet

    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    with torch.device(dev):
        unet = init_params(SDUNet(SD15_UNET, dtype=torch.bfloat16), gen).eval()
    lat = torch.randn((2, 64, 64, 4), generator=gen, device=dev)
    ctx = torch.randn((2, 8, 768), generator=gen, device=dev)
    step = lambda tt: torch.full((2,), tt, dtype=torch.int32, device=dev)
    with torch.no_grad():
        for mode in ("bf16", "int8"):
            if mode == "int8":
                unet.int8 = True
                q8.load_quant(unet, q8.calibrate_int8(unet, *[(lat, step(tt), ctx) for tt in (950, 500, 50)]))
            for _ in range(2):
                unet(lat, step(501), ctx)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    unet(lat, step(501), ctx)
                torch.cuda.synchronize()
            by_kind, launches = {}, {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    kind = kind_of(e.name)
                    by_kind[kind] = by_kind.get(kind, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / 3
                    launches[kind] = launches.get(kind, 0) + 1
            total = sum(by_kind.values())
            parts = ", ".join(f"{k} {v:.3f} ms ({launches[k] // 3})" for k, v in sorted(by_kind.items(),
                                                                                      key=lambda kv: -kv[1]))
            print(f"[int8-times] SD UNet forward B=2 64x64 {mode}: device {total:.3f} ms a forward; by kind "
                  f"(ms, kernels a forward): {parts}; {card}", flush=True)


EAGER_CONVS = [CONVS[10], CONVS[9], CONVS[11], CONVS[14]]  # SD 8^2, 16^2, a GEMM, the context
LAUNCHES = ("_launch_conv", "_launch_quantize", "_launch_absmax")


def host_in_launches(fn, reps: int = 5):
    """(wall ms a call of ``fn`` over ``reps`` eager calls, {launch function:
    (host us a call inside it, its calls a call of fn)})."""
    spent = {n: [0, 0] for n in LAUNCHES}
    saved = {n: getattr(q8, n) for n in LAUNCHES}

    def timed(name, f):
        def call(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return f(*args, **kwargs)
            finally:
                spent[name][0] += time.perf_counter_ns() - t0
                spent[name][1] += 1
        return call

    for n in LAUNCHES:
        setattr(q8, n, timed(n, saved[n]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    finally:
        for n, f in saved.items():
            setattr(q8, n, f)
    return wall, {n: (ns / max(c, 1) / 1e3, c // reps) for n, (ns, c) in spent.items()}


def eager_times(dev: torch.device, seed: int, card: str) -> None:
    from clip_codec_tpu_torch.models import CLIPCondUNet, init_params
    from clip_codec_tpu_torch.models.sd import SD15_UNET, SDUNet

    gen = torch.Generator(device=dev).manual_seed(seed)

    def line(what: str, fn) -> None:
        with torch.no_grad():
            t = time_call(what, fn, 0.0, dev)
            wall, inside = host_in_launches(fn)
        parts = ", ".join(f"{n} {us:.1f} us x {c}" for n, (us, c) in inside.items() if c)
        print(f"[int8-times] eager {what}: events {t['events_ms']:.4f} ms, graph {t['graph_ms']:.4f} ms, host "
              f"excess {t['events_ms'] - t['graph_ms']:.4f} ms a call; wall {wall:.4f} ms a call, host inside "
              f"{parts}; {card}", flush=True)

    for xs, ws, stride, pad in EAGER_CONVS:
        xq = torch.randint(-127, 128, xs, generator=gen, device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, ws, generator=gen, device=dev, dtype=torch.int8)
        wsc = torch.rand((ws[0],), generator=gen, device=dev) * 1e-3 + 1e-4
        s, bias = torch.full((), 0.02, device=dev), torch.randn((ws[0],), generator=gen, device=dev)
        line(f"int8_conv x {xs} w {ws}", lambda: q8.int8_conv2d(xq, wq, wsc, s, bias, stride, pad))
    x = torch.randn(ABSMAX[-1], generator=gen, device=dev).to(torch.bfloat16)
    line(f"absmax {ABSMAX[-1]}", lambda: q8.absmax(x))

    with torch.device(dev):
        px = init_params(CLIPCondUNet(z_dim=512, base=128, ch_mult=(1, 2, 2), time_dim=256, dtype=torch.bfloat16),
                         gen).eval()
    xs = (torch.randn((1, 256, 256, 3), generator=gen, device=dev), torch.randn((1, 512), generator=gen, device=dev),
          torch.full((1,), 500, dtype=torch.int32, device=dev))
    with torch.no_grad():
        px.int8 = True
        quant = q8.calibrate_unet(px, 256, 512)
        line("pixel U-Net B=1 int8 dynamic", lambda: px(*xs))
        q8.load_quant(px, quant)
        line("pixel U-Net B=1 int8 static", lambda: px(*xs))
        px.int8 = False
        line("pixel U-Net B=1 bf16", lambda: px(*xs))
    del px

    with torch.device(dev):
        unet = init_params(SDUNet(SD15_UNET, dtype=torch.bfloat16), gen).eval()
    lat = torch.randn((2, 64, 64, 4), generator=gen, device=dev)
    ctx = torch.randn((2, 8, 768), generator=gen, device=dev)
    step = lambda tt: torch.full((2,), tt, dtype=torch.int32, device=dev)
    with torch.no_grad():
        unet.int8 = True
        q8.load_quant(unet, q8.calibrate_int8(unet, *[(lat, step(tt), ctx) for tt in (950, 500, 50)]))
        line("SD UNet B=2 64x64 int8 static", lambda: unet(lat, step(501), ctx))
        unet.int8 = False
        line("SD UNet B=2 64x64 bf16", lambda: unet(lat, step(501), ctx))


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Time the int8 serving kernels at their timed shapes on a card.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sd_profile", action="store_true", help="also profile SD's UNet forward, bf16 and int8")
    p.add_argument("--eager", action="store_true",
                   help="instead, time kernels and forwards launched from Python against their graph replays")
    p.add_argument("--quantize", action="store_true",
                   help="instead, time int8_quantize alone at the paths' shapes, at a calibrated and a power-of-two s")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("no CUDA device available: the kernels run only on a card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"-- device: {smi.stdout.strip()}; kernels from {q8.__file__} --", flush=True)
    if args.eager:
        eager_times(dev, args.seed, smi.stdout.strip())
        return 0
    if args.quantize:
        quantize_times(dev, args.seed)
        return 0
    time_int8(dev, args.seed)
    if args.sd_profile:
        sd_profile(dev, args.seed, smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
