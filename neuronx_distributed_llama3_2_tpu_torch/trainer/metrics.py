"""Throughput and metrics reporting.

Counterpart of ``neuronx_distributed_llama3_2_tpu/trainer/metrics.py``:
``Throughput`` (moving-window sequences per second) and the append-only
JSON-lines ``TrainingMetrics`` file. The FLOP formula lives in
:mod:`..flops` and is re-exported here.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Optional

from neuronx_distributed_llama3_2_tpu_torch.flops import (  # noqa: F401
    mfu,
    train_flops_per_token,
)


class Throughput:
    """seqs/s = window · (batch · world · grad_accum) / window time, over a
    moving window of iteration boundaries."""

    def __init__(
        self,
        batch_size: int,
        world_size: int = 1,
        grad_accum: int = 1,
        moving_avg_window: int = 10,
    ):
        self.seqs_per_iteration = batch_size * world_size * grad_accum
        self.window = moving_avg_window
        self.times: deque = deque(maxlen=moving_avg_window + 1)

    def tick(self) -> Optional[float]:
        """Record an iteration boundary; return seqs/s over the window (None
        until the window has two points). A caller timing device work
        synchronizes before it ticks."""
        self.times.append(time.perf_counter())
        if len(self.times) < 2:
            return None
        span = self.times[-1] - self.times[0]
        iters = len(self.times) - 1
        return self.seqs_per_iteration * iters / span

    def reset(self) -> None:
        """Drop the window, after wall time that is not training (eval,
        checkpoint)."""
        self.times.clear()


class TrainingMetrics:
    """Append-only JSON-lines metrics file."""

    def __init__(self, path: str):
        self.path = path

    def log(self, step: int, **metrics):
        rec = {"step": step, "ts": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
