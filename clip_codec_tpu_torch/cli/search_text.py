"""Text/image -> image retrieval over a compressed store.

    python -m clip_codec_tpu_torch.cli.search_text --store_dir STORE --query "a dog" \\
        --weights ViT-B-32.pt [--k 10] [--u8] [--ivf [--nlist N] [--nprobe 8]]

The port of ``clip_codec_tpu/cli/search_text.py``: its flags and its output,
one ``score\\tpath`` line per hit. Exactly one query: ``--query`` (the CLIP
text tower; ``--bpe`` names the merges file), ``--query_image`` (the image
tower, as ``ClipEncoder.encode_image_array`` of ``preprocess_pil_u8``) or
``--query_clp`` (a ``.clp`` frame dequantized against the store's codec
meta: no weights needed). Features come from ``decoded.npy`` when present,
else from the store's frames (``Store.decode_all``). ``--u8`` searches the
store's raw uint8 codes (``U8FlatIPIndex``, or with ``--ivf`` the uint8
``IVFIndex``) through the hand-written score kernels; ``--ivf`` the
clustered index (``--nlist``, default ~sqrt(N); ``--nprobe``).
``--use_gpu`` is accepted and ignored; ``--device`` is ``cuda`` (the
default) or ``cpu``. ``--data_parallel`` splits the exact index's rows
(fp32, or with ``--u8`` the codes) over the launcher's ranks
(``ShardedFlatIPIndex``, ``ShardedU8FlatIPIndex``): every rank embeds the
query and searches its block, and rank 0 prints the merged hits, the
single index's. As in JAX, ``--ivf`` with ``--data_parallel`` is refused.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ._common import add_parallel_flags, make_mesh_from_flags


def load_features(store_dir: Path):
    """(N, D) fp32 features and the image paths: ``decoded.npy`` when present,
    else every frame dequantized and renormalized."""
    with open(store_dir / "manifest.json", "r", encoding="utf-8") as f:
        paths = [rec["image"] for rec in json.load(f)]
    decoded_path = store_dir / "decoded.npy"
    if decoded_path.exists():
        return np.load(decoded_path), paths
    from ..io.store import Store

    return Store.open(store_dir).decode_all(renormalize=True), paths


def load_codes(store_dir: Path):
    """Raw uint8 codes + codec meta + image paths, the input of the
    uint8-resident indexes (``--u8``). The frames are the source of truth
    here, so any ``decoded.npy`` cache is ignored."""
    from ..io.store import Store

    st = Store.open(store_dir)
    return st.read_codes(), st.scale, st.zero, [r["image"] for r in st.manifest]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Search images with a text or image query against an exact IP index.")
    ap.add_argument("--store_dir", type=str, required=True)
    qgroup = ap.add_mutually_exclusive_group(required=True)
    qgroup.add_argument("--query", type=str, default=None, help="text query (CLIP text tower)")
    qgroup.add_argument("--query_image", type=str, default=None,
                        help="image file to use as the query (CLIP image tower)")
    qgroup.add_argument("--query_clp", type=str, default=None,
                        help="existing .clp frame to use as the query, dequantized against the store's "
                             "codec meta: no weights needed")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--use_gpu", action="store_true", help="accepted for parity; placement is --device")
    add_parallel_flags(ap, distributed=False)
    ap.add_argument("--ivf", action="store_true",
                    help="use the clustered IVF index (FAISS IndexIVFFlat analogue) instead of exact search: "
                         "probes only --nprobe of --nlist k-means cells per query")
    ap.add_argument("--nlist", type=int, default=None, help="IVF cluster count (default ~sqrt(N))")
    ap.add_argument("--nprobe", type=int, default=8,
                    help="IVF cells probed per query (higher = better recall; nprobe >= nlist is exact)")
    ap.add_argument("--u8", action="store_true",
                    help="keep the store's uint8 codes resident on the device and search them directly "
                         "(dequantize folded into the score kernel): a quarter of the fp32 matrix's bytes, "
                         "same hits; composes with --ivf")
    ap.add_argument("--weights", type=str, default=None)
    ap.add_argument("--bpe", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    if args.ivf and args.data_parallel:
        # JAX's CLI builds no sharded IVF (shard_ivf_index is the library's); refusing beats dropping a flag
        raise SystemExit("--ivf and --data_parallel do not combine; pick the "
                         "clustered single-chip index or the sharded exact one")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use --device cpu)")

    from ..index import (build_index, build_index_u8, build_ivf_index, build_ivf_index_u8, build_sharded_index,
                         build_sharded_index_u8, search_index)
    from ..parallel.mesh import barrier, is_main, rank_device

    mesh = make_mesh_from_flags(args)
    store_dir = Path(args.store_dir)
    dev = rank_device(mesh) if mesh is not None else args.device
    if args.u8:
        codes, scale, zero, paths = load_codes(store_dir)
        if args.ivf:
            idx = build_ivf_index_u8(codes, scale, zero, nlist=args.nlist, nprobe=args.nprobe, device=dev)
        elif mesh is not None:
            idx = build_sharded_index_u8(codes, scale, zero, mesh)
        else:
            idx = build_index_u8(codes, scale, zero, device=dev)
    elif mesh is not None:
        feats, paths = load_features(store_dir)
        idx = build_sharded_index(feats, mesh)
    elif args.ivf:
        feats, paths = load_features(store_dir)
        idx = build_ivf_index(feats, nlist=args.nlist, nprobe=args.nprobe, device=dev)
    else:
        feats, paths = load_features(store_dir)
        idx = build_index(feats, use_gpu=args.use_gpu, device=dev)

    if args.query_clp is not None:
        from ..codecs.quantizer import dequantize_l2norm_host
        from ..io import bitstream

        meta = np.load(store_dir / "codec_meta.npz")
        q = bitstream.decompress_frame(Path(args.query_clp).read_bytes())
        if q.shape[0] != meta["scale"].shape[0]:
            raise SystemExit(
                f"{args.query_clp}: frame is {q.shape[0]}-d but the store's "
                f"codec is {meta['scale'].shape[0]}-d — the .clp header "
                f"carries no dim (reference quirk), so it must match the "
                f"store it is searched against")
        qvec = dequantize_l2norm_host(q[None, :], meta["scale"], meta["zero"])[0]
    elif args.query_image is not None:
        from PIL import Image

        from ..encoders import ClipEncoder
        from ..encoders.clip import preprocess_pil_u8

        encoder = ClipEncoder(weights_path=args.weights, bpe_path=args.bpe, device=dev)
        try:
            x = preprocess_pil_u8(Image.open(args.query_image), encoder.cfg.image_size)
        except Exception as e:  # any unreadable image: the JAX CLI's exit
            raise SystemExit(f"could not read query image {args.query_image!r}: {e}")
        # one image: the B=1 encode_image_array path
        qvec = encoder.encode_image_array(x[None])[0]
    else:
        from ..encoders import ClipEncoder

        encoder = ClipEncoder(weights_path=args.weights, bpe_path=args.bpe, device=dev)
        qvec = encoder.encode_text(args.query)[0]
    hits = search_index(qvec, idx, paths, k=args.k)  # a collective under a mesh: every rank searches
    if is_main(mesh):
        for p, s in hits:
            print(f"{s:.4f}\t{p}")
    barrier(mesh)


if __name__ == "__main__":
    main()
