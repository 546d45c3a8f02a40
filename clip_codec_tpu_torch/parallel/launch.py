"""Start the ranks of a command on this machine, each as a launcher node of its
own: rank r gets what ``torchrun --nnodes N --node_rank r --nproc_per_node
1`` hands its one process (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK=0``,
``LOCAL_WORLD_SIZE=1``, ``MASTER_ADDR``, ``MASTER_PORT``). So every rank
drives device 0: on a machine with one card the ranks share it (over gloo,
``distributed.py``), and on the CPU they are gloo ranks. The tests and
``chip_smoke.py`` run multi-rank paths this way; a user starts one rank per
card with ``torchrun --nproc_per_node N``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Mapping, Optional, Sequence, Tuple


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(args: Sequence[str], world: int, timeout: float, env: Optional[Mapping[str, str]] = None,
                cwd: Optional[str] = None) -> List[Tuple[int, str]]:
    """Run ``python <args>`` as ``world`` ranks and return each rank's (exit
    code, standard output and error). When a rank fails, the others (left
    waiting in a collective) are stopped 5 s later; past ``timeout`` seconds
    every rank still running is stopped and reports the code -9."""
    base = dict(os.environ if env is None else env)
    base.update(WORLD_SIZE=str(world), LOCAL_RANK="0", LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(free_port()))
    logs = [tempfile.TemporaryFile() for _ in range(world)]
    procs = [subprocess.Popen([sys.executable, *args], env={**base, "RANK": str(r), "GROUP_RANK": str(r)},
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=cwd) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if time.monotonic() > deadline:
                break
            if failed:
                deadline = min(deadline, time.monotonic() + 5.0)
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for p, f in zip(procs, logs):
        f.seek(0)
        out.append((p.returncode, f.read().decode(errors="replace")))
        f.close()
    return out

