"""Retrieval — the port of ``clip_codec_tpu/index``: the exact fp32 and
uint8-resident indexes and the IVF index in both modes, on one card or
split over a mesh's ``data`` axis (``Sharded*``, ``shard_ivf_index``)."""

from .ivf import IVFIndex, ShardedIVFIndex, build_ivf_index, build_ivf_index_u8, kmeans, shard_ivf_index
from .search import (FlatIPIndex, ShardedFlatIPIndex, ShardedU8FlatIPIndex, U8FlatIPIndex, build_index,
                     build_index_u8, build_sharded_index, build_sharded_index_u8, search_index)

__all__ = [
    "FlatIPIndex", "build_index", "search_index",
    "U8FlatIPIndex", "build_index_u8",
    "ShardedFlatIPIndex", "build_sharded_index",
    "ShardedU8FlatIPIndex", "build_sharded_index_u8",
    "IVFIndex", "build_ivf_index", "build_ivf_index_u8", "kmeans",
    "ShardedIVFIndex", "shard_ivf_index",
]
