"""The device mesh and its data-axis collectives: the port of
``clip_codec_tpu/parallel/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of shape
``(world // model_parallel, model_parallel)`` with dims ``("data",
"model")``, one rank per device. Where JAX shards a global array over the
``data`` axis, a rank here holds its own rows (``local_rows``); where JAX
hands back a global array, the rows are gathered so that every rank holds
the whole (``all_gather_rows``). Parameters are replicated by a broadcast
from rank 0 (``replicate``), and a data-parallel step sums its gradients
over the axis (``sum_gradients``): the one collective of a training step.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, device_type: str = "cuda"):
    """A ``(data, model)`` mesh over every rank of the process group.

    Joins the launcher's group first (``initialize_distributed``); with no
    launcher it makes a world of one on the caller's device, JAX's
    single-chip mesh, and stops where more cards are visible, since one
    process never drives several cards. ``n_devices``, when given, must be
    the world's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .distributed import init_single_process, initialize_distributed

    if not dist.is_initialized():
        initialize_distributed(device_type=device_type)
    if not dist.is_initialized():
        if device_type == "cuda" and torch.cuda.device_count() > 1:
            raise SystemExit(f"{torch.cuda.device_count()} CUDA devices are visible but no launcher started this "
                             f"process: one process drives one card, so start the run under torchrun "
                             f"--nproc_per_node {torch.cuda.device_count()}")
        init_single_process(device_type)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"n_devices={n}: a mesh spans every rank of the process group ({world})")
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return init_device_mesh(device_type, (n // model_parallel, model_parallel), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str = DATA_AXIS) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str = DATA_AXIS) -> int:
    """This rank's coordinate on ``axis`` (JAX's ``lax.axis_index``)."""
    return int(mesh.get_local_rank(axis))


def is_main(mesh) -> bool:
    """True on the rank that writes files and prints results (rank 0; every
    process when there is no mesh)."""
    return mesh is None or mesh.get_rank() == 0


def barrier(mesh) -> None:
    """Every rank waits for the others (after a write of rank 0's)."""
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()


def rank_device(mesh) -> torch.device:
    """The device this rank drives."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_rows(mesh, batch: int) -> slice:
    """This rank's rows of a global batch of ``batch`` rows."""
    n = axis_size(mesh)
    if batch % n:
        raise ValueError(f"batch {batch} not divisible by data axis {n}; pad the batch")
    per = batch // n
    lo = axis_index(mesh) * per
    return slice(lo, lo + per)


def shard_batch(mesh, *arrays):
    """This rank's rows of each global host batch, on the rank's device."""
    dev = rank_device(mesh)
    out = []
    for a in arrays:
        t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
        out.append(t[local_rows(mesh, t.shape[0])].to(dev))
    return tuple(out) if len(out) > 1 else out[0]


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return list(tree.values())
    if torch.is_tensor(tree):
        return [tree]
    return list(tree)


def replicate(mesh, tree):
    """Overwrite, in place, every tensor of ``tree`` (a module's parameters
    and buffers, a dict or a sequence of tensors) with rank 0's, and return
    ``tree``."""
    import torch.distributed as dist

    with torch.no_grad():
        for t in _tensors(tree):
            dist.broadcast(t.data, src=0)
    return tree


def all_gather_rows(mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order over the
    data axis (the global array of rows that ``local_rows`` split)."""
    import torch.distributed as dist

    n = axis_size(mesh)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.get_group(DATA_AXIS))
    return torch.cat(parts, dim=dim)


def sum_gradients(mesh, params: Sequence[torch.nn.Parameter], *scalars: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Sum every parameter's gradient, and ``scalars``, over the data axis
    in one all-reduce of one fp32 buffer; the sums replace the gradients and
    the scalars' sums are returned. A parameter without a gradient counts as
    zeros. Every rank receives the same sums, bit for bit."""
    import torch.distributed as dist

    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [s.detach().reshape(1).float() for s in scalars])
    dist.all_reduce(flat, group=mesh.get_group(DATA_AXIS))
    off = 0
    for p, g in zip(params, grads):
        p.grad = flat[off:off + g.numel()].view_as(g).to(g.dtype)
        off += g.numel()
    return tuple(flat[off + i] for i in range(len(scalars)))
