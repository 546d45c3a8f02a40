"""Training log lines — the port of ``clip_codec_tpu/utils/logging.py``
``TrainLogger``, with its stdout shape. (Its JSON-lines and TensorBoard sinks
are not ported: no trainer of either package turns them on.)"""

from __future__ import annotations


class TrainLogger:
    """``enabled=False`` prints nothing (a data-parallel rank other than 0)."""

    def __init__(self, log_every: int = 0, enabled: bool = True) -> None:
        self.log_every = log_every
        self.enabled = enabled

    def step(self, step: int, loss) -> None:
        if self.enabled and self.log_every and step % self.log_every == 0:
            print(f"[train] step {step} loss={float(loss):.4f}")

    def epoch(self, ep: int, total: int, loss: float, imgs_per_sec: float) -> None:
        if self.enabled:
            print(f"[train] epoch {ep}/{total} loss={loss:.4f} ({imgs_per_sec:.1f} imgs/s)")
