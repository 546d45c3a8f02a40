"""Shared CLI plumbing: the ``--int8`` flag, the data-parallel flags and image discovery."""

from __future__ import annotations

from pathlib import Path
from typing import List


def add_int8_flag(ap) -> None:
    """The shared --int8 serving-mode flag (reconstruct/eval/serve)."""
    ap.add_argument(
        "--int8", action="store_true",
        help="int8 serving mode (sampled trajectories change like a different seed — not for parity runs)",
    )


def apply_int8_flag(args) -> None:
    """``--int8`` turns on the process default of ``ops.int8`` (models built
    with ``int8=None`` then run their int8 layers)."""
    if getattr(args, "int8", False):
        from ..ops.int8 import set_int8_conv

        set_int8_conv(True)


IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".webp", ".bmp"}


def rglob_images(img_dir: str) -> List[str]:
    """Every image file under ``img_dir``, recursively."""
    return [str(p) for p in Path(img_dir).rglob("*") if p.suffix.lower() in IMAGE_EXTS]


def add_parallel_flags(ap, distributed: bool = True) -> None:
    """``--data_parallel`` (and, for the trainers, ``--distributed``)."""
    ap.add_argument("--data_parallel", action="store_true",
                    help="split each batch over the launcher's ranks, one per card (torchrun --nproc_per_node N); "
                         "without a launcher, one rank")
    if distributed:
        ap.add_argument("--distributed", action="store_true",
                        help="join the launcher's process group (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, "
                             "LOCAL_RANK) first; implies --data_parallel")


def make_mesh_from_flags(args, model_parallel: int = 1):
    """The ``(data, model)`` mesh on ``args.device`` that the flags ask for,
    or None: ``(world / model_parallel, model_parallel)`` over the
    launcher's ranks for ``--spatial_shard`` (``model_parallel`` > 1),
    ``(world, 1)`` for ``--data_parallel``. ``--distributed`` or
    ``--spatial_shard`` without the launcher's environment stops."""
    from ..parallel.distributed import LAUNCHER_ENV, initialize_distributed, launcher_env

    needs = ("--distributed" if getattr(args, "distributed", False) else
             f"--spatial_shard {model_parallel}" if model_parallel > 1 else None)
    if needs is not None:
        if launcher_env() is None:
            raise SystemExit(f"{needs} needs the launcher's environment ({', '.join(LAUNCHER_ENV)}, "
                             f"LOCAL_RANK): start the run under torchrun")
        initialize_distributed(device_type=args.device)
        args.data_parallel = True
    if not args.data_parallel:
        return None
    from ..parallel.mesh import make_mesh

    return make_mesh(model_parallel=model_parallel, device_type=args.device)
