"""Structured training metrics.

A copy of :mod:`tfkaldi_tpu.utils.metrics` (``MetricsLogger``).

The reference's only observability is ``print`` statements and optional
TensorBoard histogram/scalar summaries (trainer.py:207-211, nnet.py:125-129).
Here metrics are first-class: every step appends a JSON line to
``<savedir>/metrics.jsonl`` (cheap, greppable, machine-readable), and the
logger keeps running aggregates (frames/sec, loss EMA) for progress lines.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, TextIO


class MetricsLogger:
    """Append-only JSONL metrics sink + running aggregates."""

    def __init__(self, path: str | None = None, ema_decay: float = 0.98):
        self._file: TextIO | None = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._file = open(path, "a", buffering=1)
        self.ema_decay = ema_decay
        self.loss_ema: float | None = None
        self.total_frames = 0
        self.total_time = 0.0
        self._t0 = time.time()

    def __call__(self, **metrics: Any) -> None:
        """Record one step's metrics (used as the controller's hook)."""
        loss = metrics.get("loss")
        if loss is not None:
            self.loss_ema = (
                loss
                if self.loss_ema is None
                else self.ema_decay * self.loss_ema + (1 - self.ema_decay) * loss
            )
            metrics["loss_ema"] = round(self.loss_ema, 6)
        frames = metrics.get("num_frames")
        step_time = metrics.get("step_time")
        if frames and step_time:
            self.total_frames += frames
            self.total_time += step_time
            metrics["frames_per_sec"] = round(frames / step_time, 1)
        metrics["wall_time"] = round(time.time() - self._t0, 3)
        if self._file:
            self._file.write(json.dumps(metrics) + "\n")

    @property
    def avg_frames_per_sec(self) -> float:
        return self.total_frames / self.total_time if self.total_time else 0.0

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
