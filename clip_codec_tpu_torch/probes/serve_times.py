"""End-to-end HTTP serving times of the port: the counterpart of ``bench_serve.py``.

    python -m clip_codec_tpu_torch.probes.serve_times            # DDIM-50 256px, artifact batch 16
    python -m clip_codec_tpu_torch.probes.serve_times --sd       # SD-1.5 ddim-30 512px, batch 1

What a client sees from ``serve.py`` behind an exported artifact: HTTP, the
``.clp`` frame's decode on the host, the sampler replayed from its CUDA
graph, the PNG encode; ``--n_requests`` requests from ``--concurrency``
clients, gathered by the micro-batcher (``--batch_wait_ms``, 20 by
default). The decoder has random weights from seed 0 (throughput does not
depend on them): the pixel U-Net at ``--base``/``--z_dim``, or with
``--sd`` SD-1.5's UNet and VAE and a CLIP adapter, written as diffusers-
layout files for the server to load, and served at batch 1 to concurrent
single requests. Flags and defaults as ``bench_serve.py``'s.

Prints the p50/p95 request latency and the micro-batcher's fill rate, then
as the last line one JSON object ``{"metric", "value", "unit",
"vs_baseline"}``, ``vs_baseline`` against the same 2.0 img/s A100 estimate
``bench.py`` documents. The frames are real zstd frames where a zstd
engine exists (the native codec on the card machine, which has no
zstandard); on a machine with neither engine they carry the raw codes
behind their magic and length (``raw_frames``).
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import json
import os
import struct
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Sequence
from unittest import mock

import numpy as np
import torch

A100_REFERENCE_IMGS_PER_SEC = 2.0  # bench.py's documented estimate
BATCH_WAIT_MS, GUIDANCE, SEED = 20.0, 5.0, 0  # bench_serve.py's gather window; the SD CLI's guidance


@contextlib.contextmanager
def raw_frames(have_zstd: bool):
    """On a machine with no zstd engine (``bitstream.zstd_engine()`` None:
    neither zstandard nor a native codec that builds), a frame is the magic,
    the length and the raw codes: the store writer, ``ClipCodec`` and the
    server run as they are and only the zstd payload is left out."""
    from ..io import bitstream

    if have_zstd:
        yield
        return

    def compress(q_bytes: bytes) -> bytes:
        return bitstream.MAGIC + struct.pack("<I", len(q_bytes)) + bytes(q_bytes)

    def decompress(data: bytes, max_output: int = bitstream.MAX_FRAME_BYTES) -> np.ndarray:
        if data[:4] != bitstream.MAGIC:
            raise ValueError("Bad magic")
        if len(data) < 8:
            raise ValueError("Truncated frame header")
        (n,) = struct.unpack("<I", data[4:8])
        if n > max_output or len(data) != 8 + n:
            raise ValueError(f"raw frame declares {n} bytes and holds {len(data) - 8}")
        return np.frombuffer(data[8:], dtype=np.uint8)

    def compress_many(q: np.ndarray) -> list:
        return [compress(row.tobytes()) for row in np.asarray(q, dtype=np.uint8)]

    def decompress_many(frames, dim: int) -> np.ndarray:
        rows = [decompress(f) for f in frames]
        for i, r in enumerate(rows):
            if r.size != dim:
                raise ValueError(f"frame {i} is {r.size}-d but the codes are {dim}-d: it belongs to a different store")
        return np.stack(rows) if rows else np.zeros((0, dim), np.uint8)

    names = ("compress_frame", "decompress_frame", "compress_frames", "decompress_frames")
    saved = [getattr(bitstream, n) for n in names]
    for n, f in zip(names, (compress, decompress, compress_many, decompress_many)):
        setattr(bitstream, n, f)
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(bitstream, n, f)


def request(addr, path: str, body: Optional[bytes] = None, method: str = "POST",
            headers: Optional[dict] = None, timeout: float = 1200.0):
    """(status, content type, body, seconds) of one request; ``headers``
    replace the ones ``http.client`` would send."""
    t0 = time.perf_counter()
    c = http.client.HTTPConnection(*addr, timeout=timeout)
    if headers is None:
        c.request(method, path, body=body)
    else:
        c.putrequest(method, path)
        for k, v in headers.items():
            c.putheader(k, v)
        c.endheaders()
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, r.getheader("Content-Type"), data, time.perf_counter() - t0


def drive(addr, path: str, blobs: Sequence[bytes], concurrency: int):
    """Every blob POSTed once by ``concurrency`` client threads; returns
    (seconds, latencies, responses)."""
    sem = threading.Semaphore(concurrency)
    out: list = [None] * len(blobs)
    errs: list = []

    def worker(i: int) -> None:
        try:
            out[i] = request(addr, path, blobs[i])
            if out[i][0] != 200:
                errs.append(RuntimeError(f"request {i}: status {out[i][0]}: {out[i][2][:200]!r}"))
        except Exception as e:  # delivered after the join
            errs.append(e)
        finally:
            sem.release()

    t0 = time.perf_counter()
    threads = []
    for i in range(len(blobs)):
        sem.acquire()
        threads.append(threading.Thread(target=worker, args=(i,)))
        threads[-1].start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errs:
        raise errs[0]
    return dt, [o[3] for o in out], out


def percentiles(lat: Sequence[float]) -> tuple:
    """(p50, p95) as ``serve.py``'s /stats takes them."""
    s = sorted(lat)
    return s[len(s) // 2], s[int(len(s) * 0.95)]


def sd_weight_files(out: Path, seed: int, device) -> dict:
    """Random SD-1.5 UNet and VAE (fp16, diffusers layout) and an fp32 CLIP
    adapter (512 -> 8 tokens of 768) from ``seed``, as files."""
    from ..models import init_params
    from ..models.sd import SD15_UNET, SD15_VAE, AutoencoderKL, SDClipAdapter, SDUNet

    gen = torch.Generator(device=device).manual_seed(seed)
    paths = {}
    for name, make, dt in (("unet", lambda: SDUNet(SD15_UNET), torch.float16),
                           ("vae", lambda: AutoencoderKL(SD15_VAE), torch.float16),
                           ("adapter", lambda: SDClipAdapter(512, SD15_UNET.cross_dim, 1024, 8), torch.float32)):
        with torch.device(device):
            mod = init_params(make(), gen)
        paths[name] = out / f"{name}.pt"
        torch.save({k: v.detach().to("cpu", dt) for k, v in mod.state_dict().items()}, paths[name])
        del mod
    return paths


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=None, help="default 256 (512 with --sd)")
    ap.add_argument("--steps", type=int, default=None, help="default 50 (30 with --sd)")
    ap.add_argument("--sampler", type=str, default="ddim", choices=("ddim", "ddim_std", "dpmpp"))
    ap.add_argument("--batch", type=int, default=16, help="artifact batch (micro-batching); 1 with --sd")
    ap.add_argument("--n_requests", type=int, default=64)
    ap.add_argument("--concurrency", type=int, default=32)
    ap.add_argument("--z_dim", type=int, default=512)
    ap.add_argument("--base", type=int, default=128)
    ap.add_argument("--artifact", type=str, default=None,
                    help="reuse an exported program (must match size/steps/batch/z_dim)")
    ap.add_argument("--format", type=str, default="png", choices=("png", "jpeg"))
    ap.add_argument("--output", type=str, default="uint8", choices=("float32", "uint8"),
                    help="artifact output dtype (uint8 = 4x smaller device-to-host copy)")
    ap.add_argument("--sd", action="store_true", help="the SD-1.5 artifact at batch 1 instead")
    ap.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use --device cpu)")
    size = args.size or (512 if args.sd else 256)
    steps = args.steps or (30 if args.sd else 50)
    batch = 1 if args.sd else args.batch
    z_dim = 512 if args.sd else args.z_dim

    from ..codecs.quantizer import fit_affine, quantize
    from ..deploy import export_decompressor, export_sd_decompressor
    from ..io import bitstream
    from ..io.store import write_store
    from ..models import CLIPCondUNet, init_params
    from ..serve import serve
    from ..utils.config import ModelConfig
    from ..weights import sd_checkpoint as ckpt

    have_zstd = bitstream.zstd_engine() is not None
    print(f"frames: {bitstream.zstd_engine() or 'raw codes (no zstd engine)'}")
    with tempfile.TemporaryDirectory(prefix="serve_times_") as tmp, raw_frames(have_zstd):
        tmp = Path(tmp)
        rng = np.random.default_rng(SEED)
        feats = rng.standard_normal((args.n_requests, z_dim)).astype(np.float32)
        feats /= np.linalg.norm(feats, axis=1, keepdims=True)
        scale, zero = fit_affine(feats)
        q = quantize(feats, scale, zero).numpy()
        store = tmp / "store"
        write_store(store, feats, [f"img{i}.png" for i in range(args.n_requests)], scale, zero, q)
        blobs = [bitstream.compress_frame(q[i].tobytes()) for i in range(args.n_requests)]
        t0 = time.perf_counter()
        if args.sd:
            files = sd_weight_files(tmp, SEED, args.device)
            usd = ckpt.load_unet(files["unet"])
            vsd = ckpt.load_vae(files["vae"])
            art = Path(args.artifact) if args.artifact else export_sd_decompressor(
                usd, vsd, ckpt.load_adapter(files["adapter"]), tmp / "sd.torchprog",
                unet_cfg=ckpt.unet_config(usd), vae_cfg=ckpt.vae_config(vsd), size=size, steps=steps,
                sampler=args.sampler, platforms=[args.device])
            del usd, vsd
            env = {ckpt.UNET_ENV: str(files["unet"]), ckpt.VAE_ENV: str(files["vae"])}
            with mock.patch.dict(os.environ, env):
                srv = serve(str(store), port=0, sd_artifact=str(art), adapter=str(files["adapter"]),
                            device=args.device)
            path = f"/decompress_sd?format={args.format}&guidance={GUIDANCE}"
            what = f"SD-1.5 {args.sampler}-{steps} {size}px, batch 1, guidance {GUIDANCE}"
        else:
            mc = ModelConfig(z_dim=z_dim, base=args.base, ch_mult=(1, 2, 2))
            net = init_params(CLIPCondUNet(z_dim=z_dim, base=args.base, ch_mult=(1, 2, 2)),
                              torch.Generator().manual_seed(SEED))
            weights = store / "diffusion_unet_final.pt"
            torch.save(net.state_dict(), weights)
            mc.save(store)
            art = Path(args.artifact) if args.artifact else export_decompressor(
                net.state_dict(), mc, tmp / "dec.torchprog", size=size, steps=steps, sampler=args.sampler,
                batch_size=batch, output=args.output, platforms=[args.device])
            del net
            srv = serve(str(store), weights=str(weights), port=0, artifact=str(art),
                        batch_wait_ms=BATCH_WAIT_MS, device=args.device)
            path = f"/decompress?format={args.format}"
            what = f"{args.sampler.upper()}-{steps} {size}px, micro-batch {batch}"
        print(f"[serve_times] start-up (weights, export, load, capture) {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        addr = srv.server_address
        try:
            status, _, data, _ = request(addr, path, blobs[0])  # one request before the clock
            if status != 200:
                raise SystemExit(f"warm-up request: status {status}: {data[:200]!r}")
            dt, lat, _ = drive(addr, path, blobs, args.concurrency)
            stats = json.loads(request(addr, "/stats", method="GET")[2])
        finally:
            srv.shutdown()
            srv.server_close()
    p50, p95 = percentiles(lat)
    v = args.n_requests / dt
    print(f"[serve_times] {args.n_requests} requests from {args.concurrency} clients in {dt:.3f} s; "
          f"latency p50 {p50:.4f} s p95 {p95:.4f} s")
    if "micro_batch" in stats:
        mb = stats["micro_batch"]
        print(f"[serve_times] micro-batch {mb['batch_size']}: {mb['calls']} calls, fill rate {mb['fill_rate']}")
    print(json.dumps({
        "metric": f"e2e HTTP serving img/s ({what}, {args.concurrency} clients, {args.format})",
        "value": round(v, 3), "unit": "images/sec",
        "vs_baseline": round(v / A100_REFERENCE_IMGS_PER_SEC, 2),
    }))


if __name__ == "__main__":
    main()
