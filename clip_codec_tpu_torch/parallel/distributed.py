"""Process groups: the port of ``clip_codec_tpu/parallel/distributed.py``.

JAX runs one process per host and joins them with ``jax.distributed``. Here
every rank is a process of its own that drives one device, started by a
launcher (``torchrun``) that hands it ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``. Every rank runs the same
program on the same arguments; ``initialize_distributed`` joins them into one
``torch.distributed`` process group.

The rank's device is ``cuda:{LOCAL_RANK}`` (or the CPU when the caller asks
for it). The collective backend is chosen once, from the layout, and
printed: every rank publishes its card's UUID through the group's store, and
NCCL serves CUDA tensors when every rank has a card of its own; when two
ranks share a card (two launcher nodes on one machine each see it as
``cuda:0``), NCCL refuses them ("Duplicate GPU detected"), so gloo serves
CUDA tensors as it serves CPU ones. Gloo takes CUDA tensors for every
collective the port runs (all_reduce, broadcast, all_gather, barrier):
nothing is moved to the host by hand. The backend never changes after a
failure: a collective that fails, or waits past the group's timeout, ends
the run.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT = datetime.timedelta(seconds=120)  # a dead rank ends the run instead of hanging it


def launcher_env() -> Optional[dict]:
    """The launcher's variables when all of ``LAUNCHER_ENV`` are set, None
    when none is; a partial set raises."""
    got = {k: os.environ[k] for k in LAUNCHER_ENV if k in os.environ}
    if not got:
        return None
    if len(got) < len(LAUNCHER_ENV):
        missing = [k for k in LAUNCHER_ENV if k not in got]
        raise RuntimeError(f"incomplete launcher environment: {missing} unset (start the run under torchrun, "
                           f"which sets {', '.join(LAUNCHER_ENV)} and LOCAL_RANK)")
    return got


def _local_device(device_type: str, local_rank: int) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass device_type='cpu')")
    n = torch.cuda.device_count()
    if local_rank >= n:
        raise SystemExit(f"local rank {local_rank} but only {n} CUDA device(s) here: start one rank per card "
                         f"(torchrun --nproc_per_node {n})")
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def _choose_backend(store, rank: int, world: int, dev: torch.device) -> tuple:
    """(backend, reason) from every rank's device UUID, read through ``store``."""
    if dev.type == "cpu":
        return "cpu:gloo", "CPU ranks"
    store.set(f"clip_codec/device/{rank}", str(torch.cuda.get_device_properties(dev).uuid))
    uuids = [store.get(f"clip_codec/device/{r}").decode() for r in range(world)]
    if len(set(uuids)) == world:
        return "cpu:gloo,cuda:nccl", "one card per rank"
    return "cpu:gloo,cuda:gloo", f"{world} ranks share {len(set(uuids))} card(s)"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    device_type: str = "cuda",
) -> bool:
    """Join (or no-op) the process group. Returns True when more than one
    process runs after the call.

    Safe to call always: with no arguments and no launcher environment it
    does nothing, and a second call only reports. Arguments take precedence
    over the environment: ``coordinator_address`` ("host:port") over
    ``MASTER_ADDR``/``MASTER_PORT``, ``num_processes`` over ``WORLD_SIZE``,
    ``process_id`` over ``RANK``, ``local_device_ids[0]`` over
    ``LOCAL_RANK`` (default 0). A launcher's world of one is joined too (a
    group of one, on the backend its layout picks)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = launcher_env() or {}
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 0))
    if coordinator_address is None and not world:
        return False
    if coordinator_address is None or not world:
        raise ValueError("initialize_distributed needs both a coordinator address and a process count")
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    local = int(local_device_ids[0] if local_device_ids else os.environ.get("LOCAL_RANK", 0))
    dev = _local_device(device_type, local)
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=TIMEOUT)
    backend, why = _choose_backend(store, rank, world, dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=TIMEOUT)
    if rank == 0:
        print(f"[parallel] {world} rank(s), backend {backend} ({why})", flush=True)
    return world > 1


def init_single_process(device_type: str) -> None:
    """A process group of one with no launcher: JAX's single-chip mesh."""
    import torch.distributed as dist

    _local_device(device_type, 0)
    backend = "cpu:gloo" if device_type == "cpu" else "cpu:gloo,cuda:nccl"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, timeout=TIMEOUT)


def shard_host_batch_global(mesh, *arrays):
    """This rank's host slice of a global batch, on the rank's device (the
    rank already holds only its rows)."""
    from .mesh import rank_device

    dev = rank_device(mesh)
    out = tuple(torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(dev) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate_global(mesh, tree):
    """Rank 0's values on every rank: see ``mesh.replicate``."""
    from .mesh import replicate

    return replicate(mesh, tree)
