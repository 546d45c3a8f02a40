"""Retrieval on one card — the port of ``clip_codec_tpu/index``: the exact
fp32 and uint8-resident indexes and the IVF index in both modes. The
sharded forms (``Sharded*``, ``shard_ivf_index``) wait for ``parallel/``."""

from .ivf import IVFIndex, build_ivf_index, build_ivf_index_u8, kmeans
from .search import FlatIPIndex, U8FlatIPIndex, build_index, build_index_u8, search_index

__all__ = [
    "FlatIPIndex", "build_index", "search_index",
    "U8FlatIPIndex", "build_index_u8",
    "IVFIndex", "build_ivf_index", "build_ivf_index_u8", "kmeans",
]
