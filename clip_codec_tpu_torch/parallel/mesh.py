"""The device mesh and its collectives: the port of
``clip_codec_tpu/parallel/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of shape
``(world // model_parallel, model_parallel)`` with dims ``("data",
"model")``, one rank per device. Where JAX shards a global array over the
``data`` axis, a rank here holds its own rows (``local_rows``); where JAX
hands back a global array, the rows are gathered so that every rank holds
the whole (``all_gather_rows``). Parameters are replicated by a broadcast
from rank 0 (``replicate``), and a data-parallel step sums its gradients
over the axis (``sum_gradients``): the one collective of a training step.

The ``model`` axis has the collectives GSPMD inserts in JAX:
``all_reduce_model``, the sum after a row-parallel product of the
tensor-parallel SD UNet (``parallel/tp.py``); ``merge_moments_model``, the
GroupNorm statistics of a spatially sharded U-Net; and ``halo_rows``, the
neighbours' edge rows that a conv of an image whose height is split over
the axis reads. They are built on ``all_reduce`` and ``all_gather``, which gloo takes on CUDA
tensors (``send``/``recv`` it may refuse there). Whether a CUDA graph may
capture them is the backend's (``capturable``): NCCL's collectives can be
captured, gloo's cannot.

The gathers carry a gradient (``all_gather``, an autograd Function whose
backward sums the gathered gradient over the axis in fp32 and keeps this
rank's slot), so ``all_gather_rows``, ``merge_moments_model`` and
``halo_rows`` train: a halo row's gradient goes back to the rank that owns
the row, the merged moments' to every rank's sums. A backward collective
runs on every rank of the axis or on none, so each of these makes its
result depend on the whole gather on every rank (the first rank's zero top
halo is a gathered slot times zero, not a fresh tensor): the ranks
then reach the same backward collectives in the same order, and a spatially
sharded step's gradient, summed over both axes by ``sum_gradients``, is the
unsharded step's.
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


class _AllGather(torch.autograd.Function):
    """Forward: every rank's ``t`` stacked in rank order over the group.
    Backward: the gathered gradient summed over the group in fp32 (fp64
    stays fp64), this rank's slot, rounded once to t's dtype."""

    @staticmethod
    def forward(ctx, t, group, n, k):
        import torch.distributed as dist

        ctx.group, ctx.k = group, k
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        s = g.to(torch.promote_types(g.dtype, torch.float32), copy=True).contiguous()
        dist.all_reduce(s, group=ctx.group)
        return s[ctx.k].to(g.dtype), None, None, None


def all_gather(mesh, t: torch.Tensor, axis: str = MODEL_AXIS) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` in rank order over ``axis`` of n
    ranks, on every rank; differentiable (each rank's slot receives the sum
    over the axis of every rank's gradient for it)."""
    return _AllGather.apply(t, mesh.get_group(axis), axis_size(mesh, axis), axis_index(mesh, axis))


def all_gather_rows(mesh, t: torch.Tensor, dim: int = 0, axis: str = DATA_AXIS) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order over
    ``axis`` (the global array of rows that ``local_rows`` split; over the
    model axis, the image rows that ``model_slice`` split); differentiable
    (``all_gather``)."""
    if axis_size(mesh, axis) == 1:
        return t
    return torch.cat(all_gather(mesh, t, axis).unbind(0), dim=dim)


def model_slice(mesh, size: int) -> slice:
    """This rank's part of ``size`` split evenly over the model axis in rank
    order (rows of an image, columns of a weight)."""
    n = axis_size(mesh, MODEL_AXIS)
    if size % n:
        raise ValueError(f"{size} not divisible by model axis {n}")
    per = size // n
    lo = axis_index(mesh, MODEL_AXIS) * per
    return slice(lo, lo + per)


def all_reduce_model(mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of every model-axis rank's ``t``, on every rank, in t's
    dtype. The partials are summed in fp32 and the sum rounded once to t's
    dtype: closest to the one-rank product, which accumulates its whole
    contraction in fp32 and rounds once (a bf16 partial has already been
    rounded once by the product that made it, so a bf16 sum sits within
    about 1.5 ulp of the one-rank value, against 0.5). Every rank receives
    the same bits. A model axis of one returns ``t`` itself."""
    import torch.distributed as dist

    if mesh is None or axis_size(mesh, MODEL_AXIS) == 1:
        return t
    s = t.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(s, group=mesh.get_group(MODEL_AXIS))
    return s.to(t.dtype)


def merge_moments_model(mesh, shift: torch.Tensor, s: torch.Tensor, q: torch.Tensor,
                        n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean and the centred sum of squares over the model axis of data
    that each rank holds ``n`` elements of, from this rank's fp32 sums
    ``s`` of ``x - shift`` and ``q`` of its squares (``shift`` this rank's
    own, near its data: the sums then do not cancel where the mean is large
    against the spread): Chan's merge of every rank's (mean, centred sum),
    summed in rank order from one ``all_gather``, so every rank holds the
    same bits. A model axis of one merges nothing. Differentiable in
    ``shift``, ``s`` and ``q``."""
    mean = shift + s / n
    m2 = q - s * (s / n)
    if mesh is None or axis_size(mesh, MODEL_AXIS) == 1:
        return mean, m2
    parts = all_gather(mesh, torch.stack([mean, m2]))
    means, m2s = parts[:, 0], parts[:, 1]
    mean = means.mean(dim=0)
    return mean, m2s.sum(dim=0) + n * (means - mean).square().sum(dim=0)


def halo_rows(mesh, x: torch.Tensor, n_top: int, n_bottom: int) -> torch.Tensor:
    """``x`` (B, h, W, C), this rank's rows of an NHWC tensor whose height
    is split over the model axis in rank order, between its neighbours'
    edge rows: the last ``n_top`` rows of the rank above (zeros on the
    first rank: the image's top) and the first ``n_bottom`` of the rank
    below (zeros on the last) -> (B, n_top + h + n_bottom, W, C). One
    ``all_gather`` over the axis of every rank's edge rows; differentiable
    (each halo row's gradient reaches the rank that owns the row). An edge
    rank's zero rows are a slot of the gather times zero, so every rank's
    result depends on the gather and every rank joins its backward (a
    product, not a tensor made on the host: a CUDA graph may capture it)."""
    B, h, W, C = x.shape
    if n_top > h or n_bottom > h:
        raise ValueError(f"a halo of {n_top} + {n_bottom} rows around a shard of {h}")
    n, k = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    if n == 1:
        return torch.cat([x.new_zeros((B, n_top, W, C)), x, x.new_zeros((B, n_bottom, W, C))], dim=1)
    parts = all_gather(mesh, torch.cat([x[:, :n_bottom], x[:, h - n_top:]], dim=1))
    top = parts[k - 1][:, n_bottom:] if k > 0 else parts[0][:, n_bottom:] * 0.0
    bottom = parts[k + 1][:, :n_bottom] if k < n - 1 else parts[k][:, :n_bottom] * 0.0
    return torch.cat([top, x, bottom], dim=1)


def capturable(mesh) -> bool:
    """True where a CUDA graph may capture a sampler's model-axis
    collectives on the card: the axis has one rank (no collective runs), or
    NCCL serves CUDA tensors (one card a rank). Under gloo (ranks sharing a
    card) a sampler with a model axis runs eagerly."""
    import torch.distributed as dist

    if mesh is None or axis_size(mesh, MODEL_AXIS) == 1:
        return True
    return "cuda:nccl" in str(dist.get_backend_config(mesh.get_group(MODEL_AXIS)))


def sum_gradients(mesh, params: Sequence[torch.nn.Parameter], *scalars: torch.Tensor,
                  spatial: bool = False) -> Tuple[torch.Tensor, ...]:
    """Sum every parameter's gradient, and ``scalars``, over the data axis
    (with ``spatial``, where each rank's loss covers its rows of the images,
    over the whole ``(data, model)`` mesh; without, the model axis's ranks
    are replicas) in one all-reduce of one fp32 buffer; the sums replace the
    gradients and the scalars' sums are returned. A parameter without a
    gradient counts as zeros. Every rank receives the same sums, bit for
    bit."""
    import torch.distributed as dist

    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [s.detach().reshape(1).float() for s in scalars])
    whole = spatial and axis_size(mesh, MODEL_AXIS) > 1  # the mesh spans every rank of the process group
    dist.all_reduce(flat, group=None if whole else mesh.get_group(DATA_AXIS))
    off = 0
    for p, g in zip(params, grads):
        p.grad = flat[off:off + g.numel()].view_as(g).to(g.dtype)
        off += g.numel()
    return tuple(flat[off + i] for i in range(len(scalars)))
