"""Tracing and step timing, the port of ``clip_codec_tpu/utils/profiling.py``:
``torch.profiler`` in place of ``jax.profiler``.

    with trace("build/trace"):            # writes build/trace/trace.json
        with annotate("decode"):
            net(x, z, t)

``trace`` records the CPU and, where a card is present, its kernels
(CUPTI), and writes a Chrome trace (chrome://tracing, ui.perfetto.dev).
``annotate`` names a region in it (``record_function``) and, on a card,
as an NVTX range too. ``StepTimer`` times steps on the host clock,
leaving out the first ``skip_first`` (compilation, first-call builds).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional, Union

import torch

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Union[str, Path]) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where available) and write
    ``<log_dir>/trace.json``; yields the profiler (``key_averages()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(out / TRACE_NAME))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in profiler timelines (and an NVTX range on a card)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock step timing with the first ``skip_first`` steps left out
    of the mean. With a cuda ``device`` the card is synchronized when a
    step starts and ends, so its queued work falls inside the step."""

    def __init__(self, skip_first: int = 1, device: Optional[torch.device] = None) -> None:
        self.skip_first = skip_first
        self.device = torch.device(device) if device is not None else None
        self._seen = 0
        self._total = 0.0
        self._last: Optional[float] = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self) -> "StepTimer":
        self._sync()
        self._last = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._sync()
        dt = time.perf_counter() - (self._last or 0.0)
        self._seen += 1
        if self._seen > self.skip_first:
            self._total += dt
        return False

    @property
    def mean_s(self) -> float:
        return self._total / max(self._seen - self.skip_first, 1)
