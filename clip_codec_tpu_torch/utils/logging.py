"""Training log lines and records — the port of
``clip_codec_tpu/utils/logging.py`` ``TrainLogger``: its stdout shape, its
JSON-lines records (``jsonl_path``: ``{"kind": "step", "step", "loss", "t"}``
every ``log_every`` steps, ``{"kind": "epoch", "epoch", "loss",
"imgs_per_sec"}`` every epoch) and its TensorBoard scalars
(``tensorboard_dir``: ``train/loss`` every step, ``train/epoch_loss``
every epoch). Where ``torch.utils.tensorboard`` cannot be imported, the
TensorBoard sink is off and stderr says so once."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Optional, Union

PathLike = Union[str, Path]


class TrainLogger:
    """``enabled=False`` prints and writes nothing (a data-parallel rank other than 0)."""

    def __init__(self, log_every: int = 0, enabled: bool = True, jsonl_path: Optional[PathLike] = None,
                 tensorboard_dir: Optional[PathLike] = None) -> None:
        self.log_every = log_every
        self.enabled = enabled
        self.jsonl_path = Path(jsonl_path) if jsonl_path and enabled else None
        self._t0 = time.time()
        self._tb = None
        if tensorboard_dir and enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"[train] TensorBoard sink off: torch.utils.tensorboard cannot be imported ({e})",
                      file=sys.stderr)
            else:
                self._tb = SummaryWriter(str(tensorboard_dir))

    def _emit(self, record: dict) -> None:
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def step(self, step: int, loss) -> None:
        if self._tb is not None:
            self._tb.add_scalar("train/loss", float(loss), step)
        if self.enabled and self.log_every and step % self.log_every == 0:
            v = float(loss)
            print(f"[train] step {step} loss={v:.4f}")
            self._emit({"kind": "step", "step": step, "loss": v, "t": time.time() - self._t0})

    def epoch(self, ep: int, total: int, loss: float, imgs_per_sec: float) -> None:
        if self.enabled:
            print(f"[train] epoch {ep}/{total} loss={loss:.4f} ({imgs_per_sec:.1f} imgs/s)")
        if self._tb is not None:
            self._tb.add_scalar("train/epoch_loss", loss, ep)
        self._emit({"kind": "epoch", "epoch": ep, "loss": loss, "imgs_per_sec": imgs_per_sec})

    def close(self) -> None:
        """Flush and close the TensorBoard writer, if any."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None
