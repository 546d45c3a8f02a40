"""Data parallelism over a device mesh: the port of ``clip_codec_tpu/parallel``
(its data axis). One process per rank, started by a launcher (``torchrun``),
joined by ``initialize_distributed``; ``make_mesh`` builds the ``(data,
model)`` mesh the trainers, encoders, indexes and the sharded pixel artifact
take. The model axis (``tp.py``: ``sd_unet_tp_specs``, ``shard_params_tp``,
``validate_tp``) and spatial sharding are not ported yet (ROADMAP.md)."""

from .distributed import initialize_distributed, replicate_global, shard_host_batch_global
from .mesh import DATA_AXIS, MODEL_AXIS, make_mesh, replicate, shard_batch
from .sample import sample_sharded, sample_spatial_sharded

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "replicate",
    "shard_batch",
    "sample_sharded",
    "sample_spatial_sharded",
    "initialize_distributed",
    "replicate_global",
    "shard_host_batch_global",
]
