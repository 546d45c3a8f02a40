"""Device time of the four retrieval searches on a card: the port's
counterpart of ``bench_index.py``.

    python -m clip_codec_tpu_torch.probes.index_times [--seed 0] [--sizes 100000,1000000]
    python -m clip_codec_tpu_torch.probes.index_times --kernels [--seed 0]
    PYTHONPATH=<another checkout> python <path of this file> [--kernels]

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
builds' seconds.

``--kernels`` times the two uint8 kernels alone at ``chip_smoke.py`` phase
19's shapes instead: ``u8_ip_scores`` over 1M rows at Q = 1 and 64, over
1000 rows at D = 100 (no TMA) for Q = 3 and over 138 rows (the search CLI's
store in phase 19) at Q = 1; ``u8_ip_probe`` on the IVF index over the first
100,000 rows at the CLI's defaults (nlist 316) at Q = 1 and 64 probing 8
lists and all 316, and on a 138-row index probing all of its 12 lists. Each
time is the median (and least) of ROUNDS replays of a CUDA graph of REPS
calls, since the small shapes take about 10 us, where one replay varies by
a tenth. Beside each: the fp32 product of the dequantized rows that the fp32
indexes run (``torch.matmul``, or the IVF's einsum), and the least times the
card could take: the bytes (codes and inv read once, scores written once)
over 3.35 TB/s, the kernel's products (three bf16 parts, 3 x 2 Q rows D
flops) over 989 TFLOP/s, and the single fp32 product (2 Q rows D) over 67
TFLOP/s outside the tensor cores. Beside each probe: how its pairs fall on
the lists and the kernel's blocks (``probe_skew``), and, where the kernel
groups more than 128 pairs, its time on the same probe over one-row lists
(what its grouping costs, at most) against ``grouping_prepass`` alone.

The package is imported by its absolute name, so run by path with
PYTHONPATH at another checkout's root it times that checkout (in both
modes). Needs a CUDA device.
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
# --kernels: phase 19's shapes; timing rounds
KERNEL_N, KERNEL_IVF_N, KERNEL_SMALL, KERNEL_CLI_N = 1_000_000, 100_000, (3, 1000, 100), 138
REPS, ROUNDS = 20, 7
HBM_BYTES_PER_S, BF16_FLOPS_PER_S, FP32_FLOPS_PER_S = 3.35e12, 989e12, 67e12  # H100 SXM peaks


def scan_bounds(nbytes: float, macs: float) -> Dict[str, float]:
    """ms of each least time of a scan that moves ``nbytes`` and makes
    ``macs`` query x code products: bytes over HBM, the three-part bf16
    products over the tensor cores, one fp32 product over the FMA pipe."""
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "split bf16": 3 * 2 * macs / BF16_FLOPS_PER_S * 1e3,
            "fp32 FMA": 2 * macs / FP32_FLOPS_PER_S * 1e3}


def scores_bytes(nq: int, n: int, d: int) -> float:
    """Bytes ``u8_ip_scores`` must move: codes and inv read once, scores
    written once, qs and qz read once."""
    return n * d + 4 * n + 4 * nq * n + 4 * nq * (d + 1)


def probe_bytes(lists_used: int, cap: int, nq: int, nprobe: int, d: int) -> float:
    """Bytes ``u8_ip_probe`` must move: each probed list (codes and list_inv)
    read once however many queries probe it, the probe ids, the scores."""
    return lists_used * cap * (d + 4) + 4 * nq * nprobe * (1 + cap) + 4 * nq * (d + 1)


def probe_skew(probe: torch.Tensor, nlist: int, cap: int, sms: int) -> Dict[str, int]:
    """How a probe's (query, slot) pairs fall on the lists, and, where
    ``u8_ip_probe`` buckets them (more than 128 pairs), on its blocks: its
    work items are the lists' row tiles (``tile_rows`` of
    ``csrc/u8_ip_scan.cu``: 512 rows at Q > 4), dealt to min(items, sms)
    blocks round robin whether probed or not. ``dealt_probed_tiles`` is the
    most probed tiles a block would get if only probed tiles were dealt."""
    counts = np.bincount(probe.reshape(-1).cpu().numpy(), minlength=nlist)
    out = {"pairs": int(counts.sum()), "lists": int((counts > 0).sum()), "max_pairs_a_list": int(counts.max())}
    if probe.numel() > 128:
        q = probe.shape[0]
        trows = 512 if q > 4 else 256 if min(nlist, probe.numel()) * -(-cap // 256) >= sms else 128
        tiles = -(-cap // trows)
        per_tile = np.repeat(counts, tiles)  # item = list * tiles + tile
        blocks = np.arange(per_tile.size) % min(per_tile.size, sms)
        out["block_max_probed_tiles"] = int(np.bincount(blocks, weights=per_tile > 0).max())
        out["block_max_pairs"] = int(np.bincount(blocks, weights=per_tile).max())
        out["dealt_probed_tiles"] = -(-int((per_tile > 0).sum()) // min(per_tile.size, sms))
    return out


def grouping_prepass(probe: torch.Tensor, nlist: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A device-side grouping of the probe's pairs by list, with no host
    sync, that ``u8_ip_probe`` does not run (it groups in the kernel), timed
    by ``--kernels`` as the cost of that alternative: the flat pair indices
    ``q * nprobe + slot`` sorted by list (stable), and where each list's
    pairs start in them (``nlist + 1`` entries)."""
    flat = probe.reshape(-1)
    order = torch.argsort(flat, stable=True).to(torch.int32)
    starts = torch.zeros(nlist + 1, dtype=torch.int32, device=probe.device)
    starts[1:].scatter_add_(0, flat.long(), torch.ones_like(flat))
    return order, torch.cumsum(starts, 0, dtype=torch.int32)


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


def replay_ms(fn: Callable[[], object]) -> Tuple[float, float]:
    """(median, least) device ms per call of ``fn`` over ROUNDS replays of a
    CUDA graph of REPS calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    times = []
    for _ in range(ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    del graph
    return float(np.median(times)), min(times)


def time_kernel(label: str, call: Callable[[], object], fp32: Callable[[], object], nbytes: float,
                macs: float) -> None:
    """Prints one kernel line: the kernel's and the fp32 product's ms, the bounds."""
    (k_med, k_min), (f_med, _) = replay_ms(call), replay_ms(fp32)
    b = scan_bounds(nbytes, macs)
    by = max(("bytes", "split bf16"), key=b.get)
    print(f"[index-kernels] {label}: kernel {k_med:.4f} ms (median of {ROUNDS} replays of {REPS}; least "
          f"{k_min:.4f}), fp32 product {f_med:.4f} ms; bound {b[by]:.4f} ms ({by}; bytes {b['bytes']:.4f}, split "
          f"bf16 products {b['split bf16']:.4f}, fp32 FMA {b['fp32 FMA']:.4f})", flush=True)


def run_kernels(dev: torch.device, seed: int = 0) -> None:
    """The two uint8 kernels alone at phase 19's shapes (module docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "-i", str(dev.index or 0), "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"-- device: {smi.stdout.strip()}; kernels from {u8_scan.__file__} --", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(seed)
    codes, scale, zero = make_store(KERNEL_N, gen, dev)
    flat, feats = build_index_u8(codes, scale, zero, device=dev), dequantized(codes, scale, zero)
    queries = {nq: unit_rows(nq, D, gen, dev) for nq in QUERIES}

    def fp32_product(q, rows):
        def product():
            with u8_scan.full_fp32():
                return q @ rows.T
        return product

    for nq, q in queries.items():
        qs, qz = u8_scan.fold_query(q, flat.scale, flat.zero)
        time_kernel(f"u8_ip_scores ({nq}, {KERNEL_N}, {D})", lambda: u8_scan.u8_ip_scores(flat.codes, qs, qz, flat.inv_norms),
                    fp32_product(q, feats), scores_bytes(nq, KERNEL_N, D), nq * KERNEL_N * D)
    sq, sn, sd = KERNEL_SMALL
    small = torch.randint(0, 256, (sn, sd), generator=gen, device=dev, dtype=torch.uint8)
    s_scale = (0.5 + torch.rand(sd, generator=gen, device=dev)) / 255
    s_zero = torch.full((sd,), -0.4, device=dev)
    s_idx, s_q = build_index_u8(small, s_scale, s_zero, device=dev), unit_rows(sq, sd, gen, dev)
    s_qs, s_qz = u8_scan.fold_query(s_q, s_scale, s_zero)
    s_feats = (small.float() * s_scale + s_zero) * s_idx.inv_norms[:, None]
    time_kernel(f"u8_ip_scores {KERNEL_SMALL}", lambda: u8_scan.u8_ip_scores(small, s_qs, s_qz, s_idx.inv_norms),
                fp32_product(s_q, s_feats), scores_bytes(*KERNEL_SMALL), sq * sn * sd)

    def probe_case(ivf, q, nprobe, fp32_rows):
        with u8_scan.full_fp32():
            probe = _rank(q @ ivf.centroids.T, nprobe)[1].to(torch.int32).contiguous()
        qs, qz = u8_scan.fold_query(q, ivf.scale, ivf.zero)
        cap = ivf.lists.shape[1]
        lists32 = (ivf.lists.float() * ivf.scale + ivf.zero) * ivf.list_inv[..., None]

        def fp32():  # the fp32 IVF's einsum over the probed lists, or the flat product when every list is probed
            with u8_scan.full_fp32():
                if nprobe < ivf.nlist:
                    return torch.einsum("qd,qpcd->qpc", q, lists32[probe.long()])
                return q @ fp32_rows.T
        label = f"u8_ip_probe ({q.shape[0]}, {nprobe} x {cap}, {D})"
        time_kernel(label, lambda: u8_scan.u8_ip_probe(ivf.lists, ivf.list_inv, probe, qs, qz), fp32,
                    probe_bytes(int(torch.unique(probe).numel()), cap, q.shape[0], nprobe, D),
                    q.shape[0] * nprobe * cap * D)
        print(f"[index-kernels] {label}: skew {probe_skew(probe, ivf.nlist, cap, sms)}", flush=True)
        if probe.numel() > 128:  # the kernel's own grouping against a pre-pass that would do it instead
            tiny = torch.zeros((ivf.nlist, 1, 16), dtype=torch.uint8, device=dev)
            t_inv, t_qs = torch.ones((ivf.nlist, 1), device=dev), torch.ones((q.shape[0], 16), device=dev)
            grouping, _ = replay_ms(lambda: u8_scan.u8_ip_probe(tiny, t_inv, probe, t_qs, qz))
            prepass, _ = replay_ms(lambda: grouping_prepass(probe, ivf.nlist))
            print(f"[index-kernels] {label}: the kernel on the same probe over lists of one row at D = 16 (its "
                  f"grouping, a launch and a least product) {grouping:.4f} ms; a device-side grouping pre-pass "
                  f"(argsort, scatter_add, cumsum) alone {prepass:.4f} ms", flush=True)

    ivf = build_ivf_index_u8(codes[:KERNEL_IVF_N], scale, zero, nprobe=NPROBE, device=dev)
    for nq, q in queries.items():
        for nprobe in (ivf.nprobe, ivf.nlist):
            probe_case(ivf, q, nprobe, feats[:KERNEL_IVF_N])
    # the search CLI's store in phase 19: 138 rows, every one of its lists probed
    cli_codes, q = codes[:KERNEL_CLI_N].contiguous(), queries[1]
    cli = build_index_u8(cli_codes, scale, zero, device=dev)
    qs, qz = u8_scan.fold_query(q, cli.scale, cli.zero)
    time_kernel(f"u8_ip_scores (1, {KERNEL_CLI_N}, {D})", lambda: u8_scan.u8_ip_scores(cli.codes, qs, qz, cli.inv_norms),
                fp32_product(q, feats[:KERNEL_CLI_N]), scores_bytes(1, KERNEL_CLI_N, D), KERNEL_CLI_N * D)
    cli_ivf = build_ivf_index_u8(cli_codes, scale, zero, device=dev)
    probe_case(cli_ivf, q, cli_ivf.nlist, feats[:KERNEL_CLI_N])


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Time the four retrieval searches on a card.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sizes", type=str, default="100000,1000000", help="store sizes N, comma-separated")
    p.add_argument("--kernels", action="store_true",
                   help="time u8_ip_scores and u8_ip_probe alone at chip_smoke.py phase 19's shapes")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("no CUDA device available: the kernels run only on a card")
    if args.kernels:
        run_kernels(torch.device("cuda", 0), args.seed)
    else:
        run(torch.device("cuda", 0), args.seed, [int(s) for s in args.sizes.split(",")])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
