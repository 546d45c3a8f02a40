"""Numerical-health checks, the port of ``clip_codec_tpu/utils/debug.py``.

``nan_checked(fn)`` checks the outputs of each call (every tensor and
numpy array in the returned tree) and raises ``FloatingPointError`` naming
the first leaf that holds a NaN or an Inf. JAX's ``checkify`` also checks
every intermediate and out-of-bounds indexing inside the function; this
checks outputs only (a known difference). ``assert_finite_tree`` checks a
tree (a state dict, a parameter tree) the same way.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) pairs in JAX's ``keystr`` notation: ``['k']``, ``[0]``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _finite(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not (leaf.is_floating_point() or leaf.is_complex()) or bool(torch.isfinite(leaf).all())
    if isinstance(leaf, (np.ndarray, np.generic, float)):
        a = np.asarray(leaf)
        return not np.issubdtype(a.dtype, np.inexact) or bool(np.all(np.isfinite(a)))
    return True


def assert_finite_tree(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` at the first leaf of ``tree`` with a
    NaN or an Inf (checking a tensor on the card waits for it)."""
    for path, leaf in _leaves(tree):
        if not _finite(leaf):
            raise FloatingPointError(f"non-finite values in {name}{path}")


def nan_checked(fn: Callable) -> Callable:
    """``fn`` whose every call's outputs are checked by :func:`assert_finite_tree`::

        step = nan_checked(train_step)
        loss = step(x, z, w, t, noise)   # FloatingPointError on a NaN or Inf
    """

    name = getattr(fn, "__name__", type(fn).__name__)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite_tree(out, f"{name} output")
        return out

    return functools.update_wrapper(wrapper, fn, updated=())
