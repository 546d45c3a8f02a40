"""Encode a directory of images to CLIP embeddings -> a quantized ``.clp`` store.

    python -m clip_codec_tpu_torch.cli.encode_images --img_dir D --out_dir S [--append] [--device cuda]

Flags as the JAX CLI (``clip_codec_tpu/cli/encode_images.py``): the CLIP
checkpoint comes from ``--weights`` or ``CLIP_CODEC_CLIP_WEIGHTS``; only
``--model ViT-B-32`` is built in; ``--device`` is ``cuda`` (the default;
without a card it exits with an error) or ``cpu``. The tower runs in bf16
in batches of ``--batch_size`` (the last one padded); the codebook is fit
on all the embeddings, or, with ``--append``, the store's own is used and
the manifest grows. ``--data_parallel`` splits each batch over the
launcher's ranks (``cli/train.py``); rank 0 writes the store, whose bytes
are a one-rank run's.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ._common import add_parallel_flags


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Encode images to CLIP and save per-vector bitstreams.")
    ap.add_argument("--img_dir", type=str, required=True)
    ap.add_argument("--out_dir", type=str, required=True)
    ap.add_argument("--model", type=str, default="ViT-B-32")
    ap.add_argument("--pretrained", type=str, default="openai")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--device", type=str, default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--weights", type=str, default=None,
                    help="CLIP checkpoint path (else $CLIP_CODEC_CLIP_WEIGHTS)")
    add_parallel_flags(ap, distributed=False)
    ap.add_argument("--append", action="store_true",
                    help="add images to an EXISTING store: new vectors are quantized against the store's "
                         "codec_meta (old frames stay byte-identical; out-of-range values clamp) and the "
                         "manifest grows")
    args = ap.parse_args(argv)

    import torch

    from .. import encoders
    from ..codecs.quantizer import fit_affine, quantize
    from ..io.store import Store, append_store, write_store
    from ..parallel.mesh import barrier, is_main
    from ._common import make_mesh_from_flags, rglob_images

    if args.model != "ViT-B-32":
        raise SystemExit(f"Only ViT-B-32 is built in (got {args.model}); extend encoders/clip.py CLIPConfig.")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (use --device cpu)")
    if args.append:  # fail before the encode pass: the store must exist
        try:
            st = Store.open(args.out_dir)
        except FileNotFoundError as e:
            raise SystemExit(f"--append needs an existing store: {e}")

    mesh = make_mesh_from_flags(args)
    encoder = encoders.ClipEncoder(weights_path=args.weights, device=args.device, mesh=mesh)
    if args.append and st.dim != encoder.cfg.embed_dim:  # still before the encode pass
        raise SystemExit(f"--append target {args.out_dir} is {st.dim}-d but this encoder emits "
                         f"{encoder.cfg.embed_dim}-d embeddings")
    feats, kept = encoder.encode_images(rglob_images(args.img_dir), batch_size=args.batch_size)
    if feats.size == 0:
        raise SystemExit("No images encoded.")
    if is_main(mesh):  # every rank holds the gathered embeddings; rank 0 writes
        z = torch.from_numpy(feats).to(encoder.device)
        if args.append:
            recs = append_store(args.out_dir, z, kept)
            print(f"Done. Appended {len(recs)} vectors to {args.out_dir}")
        else:
            scale, zero = fit_affine(z)  # eps=1e-8, as the reference quantizer
            q = quantize(z, scale, zero).cpu().numpy()
            manifest = write_store(args.out_dir, feats, kept, scale, zero, q)
            print(f"Done. Stored {len(manifest)} vectors in {args.out_dir}")
    barrier(mesh)


if __name__ == "__main__":
    main()
