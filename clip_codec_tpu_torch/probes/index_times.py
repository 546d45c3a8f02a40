"""Device time of the four retrieval searches on a card: the port's
counterpart of ``bench_index.py``.

    python -m clip_codec_tpu_torch.probes.index_times [--seed 0] [--sizes 100000,1000000]
    PYTHONPATH=<another checkout> python <path of this file>

For each N: N unit rows at D = 512 drawn on the card from a seeded
generator, fitted and quantized by ``codecs/quantizer.py``; the exact fp32
index over the dequantized, renormalized matrix (``build_index``), the exact
uint8 index over the codes (``build_index_u8``), and the IVF index in both
modes at the search CLI's defaults (nlist = round(sqrt(N)), nprobe 8). Then,
for Q = 1 and 64 seeded unit queries and k = 10, each search's device time
per call (``_search``: device tensors in and out, 20 calls replayed from a
CUDA graph), its scoring step alone (the fp32 product, or the uint8 kernel
``u8_ip_scores`` / ``u8_ip_probe``), its ranking alone (``_rank`` of the
exact indexes' (Q, N) scores, ``lax.top_k``'s order), and CUDA events
around 20 calls from Python. Prints each index's resident bytes and the IVF
builds' seconds. The package is imported by its absolute name, so run by
path with PYTHONPATH at another checkout's root it times that checkout.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from clip_codec_tpu_torch.codecs.quantizer import dequantize_l2norm, fit_affine, quantize
from clip_codec_tpu_torch.index import build_index, build_index_u8, build_ivf_index, build_ivf_index_u8
from clip_codec_tpu_torch.index.search import _rank
from clip_codec_tpu_torch.ops import u8_scan
from clip_codec_tpu_torch.probes.attn_probe import _events_ms, _graph_ms

D, K, NPROBE = 512, 10, 8
QUERIES = (1, 64)


def unit_rows(n: int, d: int, gen: torch.Generator, dev: torch.device) -> torch.Tensor:
    """(n, d) fp32 rows of unit norm, drawn on ``dev`` a chunk at a time."""
    x = torch.empty((n, d), dtype=torch.float32, device=dev)
    for lo in range(0, n, u8_scan.CHUNK_ROWS):
        r = torch.randn((min(u8_scan.CHUNK_ROWS, n - lo), d), generator=gen, device=dev)
        x[lo:lo + r.shape[0]] = r / torch.linalg.vector_norm(r, dim=1, keepdim=True)
    return x


def make_store(n: int, gen: torch.Generator, dev: torch.device) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """A store's (codes (n, D) uint8 on ``dev``, scale, zero) from n unit rows."""
    x = unit_rows(n, D, gen, dev)
    scale, zero = fit_affine(x)
    codes = torch.empty((n, D), dtype=torch.uint8, device=dev)
    for lo in range(0, n, u8_scan.CHUNK_ROWS):
        codes[lo:lo + u8_scan.CHUNK_ROWS] = quantize(x[lo:lo + u8_scan.CHUNK_ROWS], scale, zero)
    return codes, scale, zero


def dequantized(codes: torch.Tensor, scale: np.ndarray, zero: np.ndarray) -> torch.Tensor:
    """The codes dequantized and renormalized in fp32 (what the fp32 indexes hold)."""
    s, z = (torch.from_numpy(np.asarray(a, np.float32)).to(codes.device) for a in (scale, zero))
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    for lo in range(0, codes.shape[0], u8_scan.CHUNK_ROWS):
        out[lo:lo + u8_scan.CHUNK_ROWS] = dequantize_l2norm(codes[lo:lo + u8_scan.CHUNK_ROWS], s, z)
    return out


def resident_bytes(index) -> int:
    """Device bytes of every tensor the index holds."""
    return sum(v.numel() * v.element_size() for v in (getattr(index, f.name) for f in dataclasses.fields(index))
               if isinstance(v, torch.Tensor))


def search_call(index, q: torch.Tensor, k: int = K) -> Callable[[], object]:
    """One search as the index runs it, device tensors in and out."""
    if hasattr(index, "nlist"):
        return lambda: index._search(q, k, min(index.nprobe, index.nlist))
    return lambda: index._search(q, k)


def score_call(index, q: torch.Tensor) -> Callable[[], object]:
    """A search's scoring step alone: the fp32 product or the uint8 kernel."""
    if hasattr(index, "nlist"):
        with u8_scan.full_fp32():
            probe = _rank(q @ index.centroids.T, min(index.nprobe, index.nlist))[1]
        if index.scale is not None:
            qs, qz = u8_scan.fold_query(q, index.scale, index.zero)
            p32 = probe.to(torch.int32)
            return lambda: u8_scan.u8_ip_probe(index.lists, index.list_inv, p32, qs, qz)

        def product():
            with u8_scan.full_fp32():
                return torch.einsum("qd,qpcd->qpc", q, index.lists[probe])
        return product
    if hasattr(index, "codes"):
        qs, qz = u8_scan.fold_query(q, index.scale, index.zero)
        return lambda: u8_scan.u8_ip_scores(index.codes, qs, qz, index.inv_norms)

    def matmul():
        with u8_scan.full_fp32():
            return q @ index.feats.T
    return matmul


def build_all(codes: torch.Tensor, scale: np.ndarray, zero: np.ndarray, dev: torch.device) -> Dict[str, object]:
    """The four indexes over one store, IVF at the CLI's defaults; prints the builds' seconds."""
    out = {"exact": build_index(dequantized(codes, scale, zero), device=dev),
           "exact-u8": build_index_u8(codes, scale, zero, device=dev)}
    for name, build in (("ivf", lambda: build_ivf_index(dequantized(codes, scale, zero), nprobe=NPROBE, device=dev)),
                        ("ivf-u8", lambda: build_ivf_index_u8(codes, scale, zero, nprobe=NPROBE, device=dev))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = build()
        torch.cuda.synchronize()
        idx = out[name]
        print(f"[index-times] N={codes.shape[0]} {name} build {time.perf_counter() - t0:.3f} s (nlist {idx.nlist}, "
              f"cap {idx.lists.shape[1]}, pad {idx.nlist * idx.lists.shape[1] / codes.shape[0]:.3f}x)", flush=True)
    return out


def run(dev: torch.device, seed: int = 0, sizes: Sequence[int] = (100_000, 1_000_000)) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "-i", str(dev.index or 0), "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"-- device: {smi.stdout.strip()}; kernels from {u8_scan.__file__} --", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for n in sizes:
        codes, scale, zero = make_store(n, gen, dev)
        indexes = build_all(codes, scale, zero, dev)
        for name, idx in indexes.items():
            print(f"[index-times] N={n} {name} resident {resident_bytes(idx)} bytes", flush=True)
        for nq in QUERIES:
            q = unit_rows(nq, D, gen, dev)
            for name, idx in indexes.items():
                search, score = search_call(idx, q), score_call(idx, q)
                s_ms, score_ms, e_ms = _graph_ms(search)[0], _graph_ms(score)[0], _events_ms(search)
                rank = ""
                if not hasattr(idx, "nlist"):
                    sims = score()
                    rank = f"  ranking {_graph_ms(lambda: _rank(sims, K))[0]:8.4f} ms (graph)"
                print(f"[index-times] N={n} Q={nq} {name:<8} search {s_ms:8.4f} ms (graph)  scoring "
                      f"{score_ms:8.4f} ms (graph){rank}  search events {e_ms:8.4f} ms", flush=True)
        del indexes, codes
        torch.cuda.empty_cache()


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Time the four retrieval searches on a card.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sizes", type=str, default="100000,1000000", help="store sizes N, comma-separated")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("no CUDA device available: the kernels run only on a card")
    run(torch.device("cuda", 0), args.seed, [int(s) for s in args.sizes.split(",")])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
