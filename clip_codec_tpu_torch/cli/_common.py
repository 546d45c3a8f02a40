"""Shared CLI plumbing: image discovery."""

from __future__ import annotations

from pathlib import Path
from typing import List

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".webp", ".bmp"}


def rglob_images(img_dir: str) -> List[str]:
    """Every image file under ``img_dir``, recursively."""
    return [str(p) for p in Path(img_dir).rglob("*") if p.suffix.lower() in IMAGE_EXTS]
