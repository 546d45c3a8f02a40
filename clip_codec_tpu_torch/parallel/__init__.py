"""Data and model parallelism over a device mesh: the port of
``clip_codec_tpu/parallel``. One process per rank, started by a launcher
(``torchrun``), joined by ``initialize_distributed``; ``make_mesh`` builds
the ``(data, model)`` mesh. The data axis splits batches (the trainers,
encoders, indexes, ``sample_sharded`` and the data-sharded pixel artifact);
the model axis splits the SD-1.5 UNet Megatron-style (``tp.py``:
``sd_unet_tp_specs``, ``shard_params_tp``, ``validate_tp``; the
tensor-parallel SD artifacts in ``deploy.py``) or the pixel U-Net's image
height (``sample_spatial_sharded``, the spatial pixel artifact and
``train_diffusion(spatial=True)``; every model-axis gather carries a
gradient). JAX's
``batch_sharded`` and ``replicated`` (``NamedSharding`` helpers) have no
meaning here: a rank holds its rows (``shard_batch``) or a replica
(``replicate``)."""

from .distributed import initialize_distributed, replicate_global, shard_host_batch_global
from .mesh import DATA_AXIS, MODEL_AXIS, make_mesh, replicate, shard_batch
from .sample import sample_sharded, sample_spatial_sharded
from .tp import sd_unet_tp_specs, shard_params_tp, validate_tp

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
    "sd_unet_tp_specs",
    "shard_params_tp",
    "validate_tp",
]
