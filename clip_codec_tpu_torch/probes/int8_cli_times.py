"""Wall seconds of the int8 entry points that launch every kernel from Python, beside the bf16 CLI.

    python -m clip_codec_tpu_torch.probes.int8_cli_times --build_dir build/chip_smoke [--reps 2]
    PYTHONPATH=<another checkout> python <path of this file> --build_dir <...>

Reads what ``chip_smoke.py`` leaves in its build directory (the pixel
U-Net's weights, the SD-1.5 weights and adapter, the compressed store) and
times, in one process, ``--reps`` rounds of chip_smoke's phase 22c after
one untimed round (kernel builds, first loads): ``cli.reconstruct_diffusion``
(DDIM-50, 256px, one image, weights load included) in bf16 and with
``--int8`` (calibration included), ``serve --int8`` with no artifact (the
dynamic int8 U-Net) answering one /decompress, and
``cli.reconstruct_sd_diffusion --int8 --inv_weight 0`` (DDIM-30, 512px,
weights load and calibration included). Only entry points the int8 port has
had since it began are called, so run by path with PYTHONPATH at another
checkout's root it times that checkout: two versions compared on one card in
one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence
from unittest import mock

import torch

from clip_codec_tpu_torch import serve
from clip_codec_tpu_torch.cli import reconstruct_diffusion, reconstruct_sd_diffusion
from clip_codec_tpu_torch.io.bitstream import zstd_engine
from clip_codec_tpu_torch.ops import int8 as q8
from clip_codec_tpu_torch.probes.serve_times import raw_frames, request
from clip_codec_tpu_torch.weights import sd_checkpoint as ckpt

SIZE, STEPS = 256, 50  # the pixel CLI's and serve's defaults, as phase 22c runs them


def one_round(build: Path, out: Path, seed: int) -> Dict[str, float]:
    """Phase 22c's four runs, seconds each."""
    px_weights, sd_dir, store = build / "store" / "diffusion_unet_final.pt", build / "sd", build / "compress" / "store"
    manifest = json.loads((store / "manifest.json").read_text())
    f0 = Path(manifest[0]["bitstream"])
    times = {}
    for name, flags in (("reconstruct_diffusion bf16", []), ("reconstruct_diffusion --int8", ["--int8"])):
        t0 = time.perf_counter()
        try:
            reconstruct_diffusion.main(["--store_dir", str(store), "--bitstream", str(f0), "--weights",
                                        str(px_weights), "--out", str(out / "recon.png"), "--seed", str(seed)] + flags)
        finally:
            q8.set_int8_conv(False)
        times[name] = time.perf_counter() - t0
    q8.set_int8_conv(True)
    try:
        srv = serve.serve(str(store), weights=str(px_weights), port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            status, _, _, wall = request(srv.server_address, f"/decompress?size={SIZE}&steps={STEPS}&seed={seed}",
                                         f0.read_bytes())
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join()
    finally:
        q8.set_int8_conv(False)
    if status != 200:
        raise RuntimeError(f"serve --int8 /decompress answered {status}")
    times["serve --int8 dynamic /decompress"] = wall
    t0 = time.perf_counter()
    try:
        reconstruct_sd_diffusion.main(["--store_dir", str(store), "--bitstream", str(f0), "--adapter",
                                       str(sd_dir / "adapter.pt"), "--int8", "--inv_weight", "0", "--out",
                                       str(out / "sd.png")])
    finally:
        q8.set_int8_conv(False)
    times["reconstruct_sd_diffusion --int8"] = time.perf_counter() - t0
    return times


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Time the int8 CLIs and serve --int8 (dynamic) on a card.")
    p.add_argument("--build_dir", required=True, help="chip_smoke.py's build directory (build/chip_smoke)")
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("no CUDA device available: the int8 kernels run only on a card")
    build = Path(args.build_dir).resolve()
    sd_dir = build / "sd"
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(f"-- device: {card}; kernels from {q8.__file__} --", flush=True)
    env = {ckpt.UNET_ENV: str(sd_dir / "unet.pt"), ckpt.VAE_ENV: str(sd_dir / "vae.pt")}
    rounds: List[Dict[str, float]] = []
    with tempfile.TemporaryDirectory(dir=build) as tmp, mock.patch.dict(os.environ, env), \
            raw_frames(zstd_engine() is not None):
        for r in range(args.reps + 1):
            rounds.append(one_round(build, Path(tmp), args.seed))
            print(f"[int8-cli-times] round {r}{' (warm-up, untimed)' if r == 0 else ''}: "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in rounds[-1].items()), flush=True)
    for k in rounds[0]:
        print(f"[int8-cli-times] {k}: {[round(t[k], 3) for t in rounds[1:]]} s; {card}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
