"""HTTP serving over :class:`clip_codec_tpu_torch.codec.ClipCodec`: the port of
``clip_codec_tpu/serve.py``, with its endpoints, status codes and JSON.

Endpoints:

* ``GET  /healthz``  -> ``{"status": "ok", "dim": D}``
* ``POST /compress`` -> body: one image file; response: one ``.clp`` frame.
  Needs CLIP weights (503 with the variable's name otherwise).
* ``POST /decompress?size=256&steps=50&sampler=ddim|ddim_std|dpmpp&seed=N&format=png|jpeg``
  -> body: one ``.clp`` frame; response: the reconstructed image. Needs a
  decoder checkpoint.
* ``POST /embed``    -> body: one ``.clp`` frame; ``{"embedding": [...]}``.
* ``POST /decompress_sd?guidance=5.0&seed=N&format=...`` -> body: one
  ``.clp`` frame; the SD latent path, served from ``--sd_artifact`` and
  ``--adapter`` (the SD weights from their variables).
* ``GET  /search?q=<text>&k=10`` -> text -> image retrieval over the store:
  ``{"results": [{"path": ..., "score": ...}]}``; CLIP weights needed.
* ``POST /search_image?k=10`` -> body: a ``.clp`` frame (no weights needed)
  or image bytes (the CLIP image tower); the same JSON.
* ``GET  /stats``   -> request counts, decompress latency p50/p95, and the
  micro-batcher's fill rate.

Run: ``python -m clip_codec_tpu_torch.serve --store_dir store [--port 8700]
[--device cuda|cpu]``. Device work goes through ONE lock shared by every
endpoint and the micro-batch worker.

``--artifact decoder.torchprog`` serves ``/decompress`` from an exported
program (``cli.export_decoder``): its size/steps/sampler/eta are checked
against the artifact's header (412 on a mismatch). On the card the program
is the whole sampler captured as one CUDA graph; the capture happens at
startup, before the socket takes traffic, so no request thread runs during
a capture and every later request replays under the device lock. A
batch > 1 artifact turns on micro-batching: concurrent requests gathered
within ``--batch_wait_ms`` share one replay (padded with the last row), and
``seed`` is refused (one replay, one seed).

``--int8`` turns on int8 serving (``ops/int8.py``): with no artifact,
``/decompress`` runs the U-Net with dynamic int8 scales through
``ClipCodec``. An int8 artifact (``cli.export_decoder --int8``) is static
int8 whatever the flag says, and needs its calibration sidecar
``<artifact>.quant.pt``: a server whose sidecar is missing stops at start-up
with a message that names it, and every call passes the dict to the program.
"""

from __future__ import annotations

import argparse
import io
import itertools
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np
from PIL import Image

from .cli._common import add_int8_flag, apply_int8_flag
from .codec import ClipCodec

_MAX_BODY_BYTES = 64 << 20


class _BodyTooLarge(ValueError):
    def __init__(self, n: int):
        super().__init__(f"request body {n} bytes exceeds the {_MAX_BODY_BYTES}-byte limit")


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer with an accept backlog of 128: the default of 5
    resets connections under the bursts micro-batching invites."""

    request_queue_size = 128
    daemon_threads = True


class _MicroBatcher:
    """Coalesce concurrent /decompress requests into ONE program call.

    A program for batch B costs the same whether 1 or B rows are real, so a
    worker thread gathers up to B requests inside a small window and pads
    the rest with the last row; HTTP threads wait on per-request events."""

    def __init__(self, run_batch, batch_size: int, max_wait_ms: float = 5.0):
        self._run = run_batch  # (z (B, D) float32, seed int) -> (B, H, W, C) numpy
        self.batch_size = batch_size
        self._wait = max_wait_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._seeds = itertools.count()
        self.calls = 0          # program invocations
        self.rows_served = 0    # real (non-padding) rows across them
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @property
    def fill_rate(self) -> float:
        """Mean fraction of each program call's batch that was real work."""
        return self.rows_served / (self.calls * self.batch_size) if self.calls else 0.0

    def submit(self, z_row: np.ndarray, timeout: float = 600.0) -> np.ndarray:
        done = threading.Event()
        slot: dict = {}
        self._q.put((z_row, done, slot))
        if not done.wait(timeout):
            raise RuntimeError("batched decompress timed out")
        if "err" in slot:
            raise slot["err"]
        return slot["img"]

    def _loop(self) -> None:
        while True:
            batch = [self._q.get()]
            deadline = time.monotonic() + self._wait
            while len(batch) < self.batch_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            zs = np.stack([b[0] for b in batch]).astype(np.float32)
            if len(batch) < self.batch_size:  # pad with the last row
                zs = np.concatenate([zs, np.repeat(zs[-1:], self.batch_size - len(batch), axis=0)])
            try:
                imgs = self._run(zs, next(self._seeds))
                self.calls += 1
                self.rows_served += len(batch)
                for i, (_, done, slot) in enumerate(batch):
                    slot["img"] = imgs[i]
                    done.set()
            except Exception as e:  # deliver the failure to every waiter
                for _, done, slot in batch:
                    slot["err"] = e
                    done.set()


class _Searcher:
    """Retrieval over the store: the index is built on first use (no
    weights needed) and the CLIP tower made on first text or image query, so
    a server without weights starts and answers 503 there."""

    def __init__(self, store_dir, codec: ClipCodec, lock: threading.Lock, ivf: bool = False,
                 nlist: Optional[int] = None, nprobe: int = 8, u8: bool = False):
        self._store_dir = Path(store_dir)
        self._codec = codec
        self._lock = lock
        self._init_lock = threading.Lock()
        self._index = None
        self._paths = None
        self._ivf = (ivf, nlist, nprobe)
        self._u8 = u8

    def _ensure_index(self):
        from .cli.search_text import load_codes, load_features
        from .index import build_index, build_index_u8, build_ivf_index, build_ivf_index_u8

        dev = self._codec.device
        with self._init_lock:
            if self._index is None:
                use_ivf, nlist, nprobe = self._ivf
                if self._u8:
                    codes, scale, zero, self._paths = load_codes(self._store_dir)
                    self._index = (build_ivf_index_u8(codes, scale, zero, nlist=nlist, nprobe=nprobe, device=dev)
                                   if use_ivf else build_index_u8(codes, scale, zero, device=dev))
                elif use_ivf:
                    feats, self._paths = load_features(self._store_dir)
                    self._index = build_ivf_index(feats, nlist=nlist, nprobe=nprobe, device=dev)
                else:
                    feats, self._paths = load_features(self._store_dir)
                    self._index = build_index(feats, device=dev)

    def _ensure_encoder(self):
        """Caller holds the device lock: /compress builds the same
        ``codec.encoder`` under it, and two first requests must not load
        the tower twice."""
        if self._codec.encoder is None:
            from . import encoders

            self._codec.encoder = encoders.ClipEncoder(device=self._codec.device)  # RuntimeError -> 503

    def search(self, text: str, k: int):
        from .index import search_index

        self._ensure_index()
        with self._lock:
            self._ensure_encoder()
            qvec = self._codec.encoder.encode_text(text)[0]
            return search_index(qvec, self._index, self._paths, k=k)

    def search_image(self, body: bytes, k: int):
        """Image -> image retrieval: a ``.clp`` frame (CLPF magic) is
        dequantized on the host with no weights; image bytes go through
        the CLIP image tower, weight-gated like /compress."""
        from .encoders.clip import preprocess_pil_u8
        from .index import search_index
        from .io.bitstream import MAGIC

        self._ensure_index()
        if body[:4] == MAGIC:
            qvec = self._codec.decode_embeddings_host([body])[0]
            with self._lock:
                return search_index(qvec, self._index, self._paths, k=k)
        img = Image.open(io.BytesIO(body))  # PIL error -> 400 via the handler
        with self._lock:
            self._ensure_encoder()
            x = preprocess_pil_u8(img, self._codec.encoder.cfg.image_size)
            qvec = self._codec.encoder.encode_image_array(x[None])[0]
            return search_index(qvec, self._index, self._paths, k=k)


def make_handler(codec: ClipCodec, artifact=None, batcher: Optional[_MicroBatcher] = None, sd=None,
                 lock: Optional[threading.Lock] = None, searcher: Optional[_Searcher] = None):
    """``artifact``: optional ``(call, params)`` of a pixel program, which
    replaces the eager /decompress path; ``batcher``: the micro-batching
    worker of a batch > 1 artifact; ``sd``: optional ``(call, unet_params,
    vae_params, adapter_params)`` behind /decompress_sd; ``lock``: the
    device lock, the one the micro-batcher shares."""
    lock = lock if lock is not None else threading.Lock()
    stats_lock = threading.Lock()
    counts: dict = {}
    latencies: list = []  # rolling /decompress* wall times, capped

    def record(endpoint: str, dt: Optional[float] = None) -> None:
        with stats_lock:
            counts[endpoint] = counts.get(endpoint, 0) + 1
            if dt is not None:
                latencies.append(dt)
                if len(latencies) > 512:
                    del latencies[: len(latencies) - 512]

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _body(self) -> bytes:
            """The request body, bounded: past 64 MiB it raises (413) before
            anything is buffered."""
            n = int(self.headers.get("Content-Length", 0))
            if n > _MAX_BODY_BYTES:
                raise _BodyTooLarge(n)
            self._unread = 0
            return self.rfile.read(n)

        def _drain(self) -> None:
            """Read a body that an early answer (400, 404, 412, 503) left
            unread: closing the socket over unread bytes resets the
            connection, and the client may lose the answer it was sent."""
            if 0 < self._unread <= _MAX_BODY_BYTES:
                self.rfile.read(self._unread)

        def _check_format(self, q) -> bool:
            """``?format=`` checked before any compute."""
            fmt = q.get("format", ["png"])[0].lower()
            if fmt not in ("png", "jpeg", "jpg"):
                self._json(400, {"error": f"unknown format {fmt!r}; png or jpeg"})
                return False
            return True

        def _check_statics(self, q, meta) -> bool:
            """412 when the query conflicts with the artifact's statics."""
            mismatches = {
                k: (q[k][0], meta[k]) for k, cast in
                (("size", int), ("steps", int), ("sampler", str), ("eta", float))
                if k in q and cast(q[k][0]) != meta[k]
            }
            if mismatches:
                self._json(412, {
                    "error": "artifact statics mismatch; re-export with cli.export_decoder",
                    "requested": {k: v[0] for k, v in mismatches.items()},
                    "artifact": {k: meta[k] for k in mismatches},
                })
                return False
            return True

        def _send_image(self, img: np.ndarray, q) -> None:
            fmt = q.get("format", ["png"])[0].lower()
            if img.dtype == np.uint8:  # output="uint8" artifact
                arr = img
            else:
                arr = ((np.clip(img, -1, 1) + 1.0) * 127.5).astype(np.uint8)
            buf = io.BytesIO()
            if fmt == "png":
                Image.fromarray(arr).save(buf, format="PNG")
                self._send(200, buf.getvalue(), "image/png")
            else:
                Image.fromarray(arr).save(buf, format="JPEG", quality=92)
                self._send(200, buf.getvalue(), "image/jpeg")

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"status": "ok", "dim": codec.dim})
            elif path == "/stats":
                with stats_lock:
                    lat = sorted(latencies)
                    out = {
                        "requests": dict(counts),
                        "decompress_latency_s": {
                            "n": len(lat),
                            "p50": lat[len(lat) // 2] if lat else None,
                            "p95": lat[int(len(lat) * 0.95)] if lat else None,
                        },
                    }
                if batcher is not None:
                    out["micro_batch"] = {"batch_size": batcher.batch_size, "calls": batcher.calls,
                                          "fill_rate": round(batcher.fill_rate, 4)}
                self._json(200, out)
            elif path == "/search":
                q = parse_qs(urlparse(self.path).query)
                if "q" not in q or not q["q"][0]:
                    self._json(400, {"error": "missing ?q=<text query>"})
                    return
                if searcher is None:
                    self._json(503, {"error": "no store attached for search"})
                    return
                try:
                    k = int(q.get("k", ["10"])[0])
                    hits = searcher.search(q["q"][0], k=k)
                    record("search")
                    self._json(200, {"results": [{"path": p, "score": s} for p, s in hits]})
                except RuntimeError as e:  # weight-gated text tower
                    self._json(503, {"error": str(e)})
                except Exception as e:
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})
            else:
                self._json(404, {"error": "unknown endpoint"})

        def do_POST(self):
            self._unread = int(self.headers.get("Content-Length", 0))
            try:
                self._post()
            finally:
                self._drain()

        def _post(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            try:
                if url.path == "/compress":
                    img = Image.open(io.BytesIO(self._body()))
                    with lock:
                        blob = codec.compress([img], batch_size=1)[0]
                    record("compress")
                    self._send(200, blob, "application/octet-stream")
                elif url.path == "/embed":
                    with lock:
                        z = codec.decode_embeddings([self._body()])[0]
                    record("embed")
                    self._json(200, {"embedding": [float(v) for v in z]})
                elif url.path == "/search_image":
                    if searcher is None:
                        self._json(503, {"error": "no store attached for search"})
                        return
                    k = int(q.get("k", ["10"])[0])
                    hits = searcher.search_image(self._body(), k=k)
                    record("search_image")
                    self._json(200, {"results": [{"path": p, "score": s} for p, s in hits]})
                elif url.path == "/decompress":
                    t0 = time.monotonic()
                    if not self._check_format(q):
                        return
                    if artifact is not None:
                        call, params, quant = artifact
                        if not self._check_statics(q, call.meta):
                            return
                        # the frame is decoded on the host: a device round trip here
                        # would stagger arrivals past the gather window
                        if batcher is not None:
                            if "seed" in q:
                                self._json(400, {
                                    "error": "seed is per-program: batched serving (artifact "
                                             "batch_size > 1) coalesces requests; export with "
                                             "--batch_size 1 for seeded serving"})
                                return
                            img = batcher.submit(codec.decode_embeddings_host([self._body()])[0])
                        else:
                            z = codec.decode_embeddings_host([self._body()])
                            seed = int(q.get("seed", ["0"])[0])
                            with lock:
                                img = call(params, z, seed=seed, quant=quant)[0].cpu().numpy()
                    else:
                        size = int(q.get("size", ["256"])[0])
                        steps = int(q.get("steps", ["50"])[0])
                        sampler = q.get("sampler", ["ddim"])[0]
                        seed = int(q["seed"][0]) if "seed" in q else None
                        with lock:
                            img = codec.decompress([self._body()], size=size, steps=steps, batch_size=1,
                                                   sampler=sampler, seed=seed)[0]
                    record("decompress", time.monotonic() - t0)
                    self._send_image(img, q)
                elif url.path == "/decompress_sd":
                    t0 = time.monotonic()
                    if sd is None:
                        self._json(503, {"error": "no SD artifact loaded; start with --sd_artifact + --adapter"})
                        return
                    sd_call, up, vp, ap_, sd_quant = sd
                    if not self._check_format(q) or not self._check_statics(q, sd_call.meta):
                        return
                    z = codec.decode_embeddings_host([self._body()])
                    seed = int(q.get("seed", ["0"])[0])
                    guidance = float(q.get("guidance", ["5.0"])[0])
                    with lock:
                        img = sd_call(up, vp, ap_, z, seed=seed, guidance_scale=guidance,
                                      quant=sd_quant)[0].cpu().numpy()
                    record("decompress_sd", time.monotonic() - t0)
                    self._send_image(img, q)
                else:
                    self._json(404, {"error": "unknown endpoint"})
            except _BodyTooLarge as e:
                self._json(413, {"error": str(e)})
            except RuntimeError as e:  # weight-gated paths
                self._json(503, {"error": str(e)})
            except Exception as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(store_dir: str, weights: Optional[str] = None, host: str = "127.0.0.1", port: int = 8700,
          artifact: Optional[str] = None, batch_wait_ms: float = 5.0, sd_artifact: Optional[str] = None,
          adapter: Optional[str] = None, search_ivf: bool = False, search_nlist: Optional[int] = None,
          search_nprobe: int = 8, search_u8: bool = False, device: str = "cuda") -> _Server:
    """The server, bound and listening, artifacts loaded and captured; call
    ``serve_forever()`` on it."""
    codec = ClipCodec.load(store_dir, weights=weights, device=device)
    art = None
    batcher = None
    device_lock = threading.Lock()  # one program in flight at a time
    if adapter is not None and sd_artifact is None:
        raise ValueError("--adapter only makes sense with --sd_artifact")
    sd = _load_sd_serving(sd_artifact, adapter, codec) if sd_artifact else None
    if artifact is not None:
        if weights is None:
            raise ValueError("--artifact serving still needs --weights (params are call-time arguments, "
                             "not baked into artifacts)")
        from .deploy import load_decompressor
        from .utils.checkpoint import load_unet_checkpoint

        call = load_decompressor(artifact, device=device)
        quant = _validate_artifact(call, codec, artifact)
        params = load_unet_checkpoint(weights)
        art = (call, params, quant)

        def run(zs, seed):
            with device_lock:
                return call(params, zs, seed=seed, quant=quant).cpu().numpy()

        # the first call builds the network and captures the sampler: pay it
        # before the socket takes traffic
        run(np.zeros((call.meta["batch_size"], codec.dim), np.float32), 0)
        if call.meta["batch_size"] > 1:
            batcher = _MicroBatcher(run, batch_size=call.meta["batch_size"], max_wait_ms=batch_wait_ms)
    server = _Server(
        (host, port),
        make_handler(codec, artifact=art, batcher=batcher, sd=sd, lock=device_lock,
                     searcher=_Searcher(store_dir, codec, device_lock, ivf=search_ivf, nlist=search_nlist,
                                        nprobe=search_nprobe, u8=search_u8)))
    mode = f", artifact={artifact}" if artifact else ""
    if batcher is not None:
        mode += f", micro-batch={batcher.batch_size}"
    if sd is not None:
        mode += f", sd_artifact={sd_artifact}"
    print(f"[serve] codec (dim={codec.dim}{mode}) on http://{host}:{server.server_address[1]}")
    return server


def _validate_artifact(call, codec: ClipCodec, artifact_path: str):
    """Startup checks shared by the pixel and SD artifacts: the embedding
    dim, the device kind and, for an int8 artifact, its calibration sidecar.
    Returns the sidecar's quant dict on the codec's device, or None."""
    if call.meta["z_dim"] != codec.dim:
        raise ValueError(f"{artifact_path}: exported for z_dim={call.meta['z_dim']} but the store carries "
                         f"dim={codec.dim} embeddings; re-export against this store's checkpoint")
    if codec.device.type not in call.platforms:
        raise ValueError(f"{artifact_path}: exported for platforms {list(call.platforms)} but this server "
                         f"runs {codec.device.type!r}; re-export with --platforms {codec.device.type}")
    if not call.meta.get("int8"):
        return None
    from .deploy import QUANT_SUFFIX
    from .ops.int8 import read_quant

    sidecar = f"{artifact_path}{QUANT_SUFFIX}"
    try:
        return read_quant(sidecar, codec.device)
    except FileNotFoundError:
        raise ValueError(f"int8 artifact: calibration sidecar {sidecar} not found "
                         f"(cli.export_decoder --int8 writes it)") from None


def _load_sd_serving(sd_artifact: str, adapter: Optional[str], codec: ClipCodec):
    """Load, check and capture the SD artifact behind /decompress_sd: the
    frozen UNet and VAE from ``$CLIP_CODEC_SD_UNET_WEIGHTS`` and
    ``$CLIP_CODEC_SD_VAE_WEIGHTS``, the adapter from ``adapter``, all three
    call-time arguments."""
    from .deploy import load_sd_decompressor
    from .weights import sd_checkpoint as ckpt

    if adapter is None:
        raise ValueError("--sd_artifact needs --adapter <trained adapter checkpoint>")
    unet_path, vae_path = ckpt.require_sd_weight_paths()
    call = load_sd_decompressor(sd_artifact, device=codec.device)
    if call.meta["batch_size"] != 1:
        raise ValueError(f"SD serving artifacts must be exported with --batch_size 1 (got "
                         f"{call.meta['batch_size']}): guidance_scale is per program call, so requests "
                         f"cannot be coalesced")
    quant = _validate_artifact(call, codec, sd_artifact)
    up = ckpt.load_unet(unet_path)
    vp = ckpt.load_vae(vae_path)
    ap_ = ckpt.load_adapter(adapter)
    # build and capture before the socket takes traffic
    call(up, vp, ap_, np.zeros((1, codec.dim), np.float32), seed=0, guidance_scale=5.0, quant=quant)
    return (call, up, vp, ap_, quant)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Serve a ClipCodec store over HTTP.")
    ap.add_argument("--store_dir", type=str, required=True)
    ap.add_argument("--weights", type=str, default=None)
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--artifact", type=str, default=None,
                    help="exported decoder.torchprog (cli.export_decoder); serves /decompress from its "
                         "captured sampler")
    ap.add_argument("--batch_wait_ms", type=float, default=5.0,
                    help="micro-batching gather window for batch>1 artifacts")
    ap.add_argument("--sd_artifact", type=str, default=None,
                    help="exported SD program (cli.export_decoder --sd); serves /decompress_sd "
                         "(SD weights via env vars)")
    ap.add_argument("--adapter", type=str, default=None, help="trained SD adapter checkpoint (with --sd_artifact)")
    ap.add_argument("--search_ivf", action="store_true",
                    help="serve /search from the clustered IVF index instead of exact search")
    ap.add_argument("--search_nlist", type=int, default=None, help="IVF cluster count (default ~sqrt(N))")
    ap.add_argument("--search_nprobe", type=int, default=8, help="IVF cells probed per query")
    ap.add_argument("--search_u8", action="store_true",
                    help="serve /search and /search_image from a uint8-resident index; composes with "
                         "--search_ivf")
    add_int8_flag(ap)
    ap.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    apply_int8_flag(args)
    serve(args.store_dir, args.weights, args.host, args.port, artifact=args.artifact,
          batch_wait_ms=args.batch_wait_ms, sd_artifact=args.sd_artifact, adapter=args.adapter,
          search_ivf=args.search_ivf, search_nlist=args.search_nlist, search_nprobe=args.search_nprobe,
          search_u8=args.search_u8, device=args.device).serve_forever()


if __name__ == "__main__":
    main()
