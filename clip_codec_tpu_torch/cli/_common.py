"""Shared CLI plumbing: the ``--int8`` flag and image discovery."""

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
