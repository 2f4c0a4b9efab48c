"""Training configuration.

Counterpart of ``neuronx_distributed_llama3_2_tpu/trainer/config.py``:
the same fields with the same defaults, so a configuration reads the same
in both packages. The port trains on one device: :meth:`TrainingConfig.initialize`
refuses every parallel size above 1 and ``sequence_parallel`` (the
multi-GPU slice ports them). ``zero_one_enabled`` shards optimizer state
over data parallelism, which one device does not have; it is accepted and
has no effect, as in the JAX package at dp = 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from neuronx_distributed_llama3_2_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """AdamW hyperparameters, clipping, mixed precision and the LR
    schedule."""

    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    zero_one_enabled: bool = True
    grad_clipping: bool = True
    max_grad_norm: float = 1.0
    use_master_weights: bool = True
    use_fp32_grad_acc: bool = True
    # storage dtype of master / mu / nu ("float32" | "bfloat16"); the update
    # math is fp32 either way
    state_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"  # "cosine" | "linear" | "constant"

    @property
    def state_torch_dtype(self) -> torch.dtype:
        dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        if self.state_dtype not in dtypes:
            raise ValueError(f"state_dtype must be one of {list(dtypes)}, got {self.state_dtype!r}")
        return dtypes[self.state_dtype]

    def lr_at(self, step: int) -> float:
        """Learning rate after ``step`` optimizer steps: linear warmup, then
        cosine / linear decay to ``min_lr_ratio`` of the peak, or constant."""
        warm = min(step / max(self.warmup_steps, 1), 1.0)
        frac = (step - self.warmup_steps) / max(self.total_steps - self.warmup_steps, 1)
        frac = min(max(frac, 0.0), 1.0)
        if self.schedule == "cosine":
            decay = 0.5 * (1 + math.cos(math.pi * frac))
        elif self.schedule == "linear":
            decay = 1.0 - frac
        elif self.schedule == "constant":
            decay = 1.0
        else:
            raise ValueError(f"unknown schedule {self.schedule!r}")
        floor = self.min_lr_ratio
        return self.learning_rate * warm * (floor + (1 - floor) * decay)


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    expert_parallel_size: int = 1
    context_parallel_size: int = 1
    sequence_parallel: bool = False
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    # the global batch of a step is split into this many sequential
    # microbatches whose gradients accumulate
    num_microbatches: int = 1
    pipeline_schedule: Optional[str] = None
    num_model_chunks: Optional[int] = None
    seed: int = 42

    def require_single_device(self) -> None:
        """Raise NotImplementedError naming the first knob the single-device
        port cannot honour."""
        for knob in ("tensor_parallel_size", "pipeline_parallel_size",
                     "expert_parallel_size", "context_parallel_size"):
            if getattr(self, knob) != 1:
                raise NotImplementedError(
                    f"{knob}={getattr(self, knob)} waits for the multi-GPU "
                    "slice of the port: it trains on one device"
                )
        for knob in ("sequence_parallel", "pipeline_schedule", "num_model_chunks"):
            if getattr(self, knob):
                raise NotImplementedError(
                    f"{knob}={getattr(self, knob)!r} waits for the multi-GPU "
                    "slice of the port: it trains on one device"
                )

    def initialize(self, device: DeviceLike = "cuda") -> torch.device:
        """Check that the configuration runs on one device and return that
        device (the card unless the caller names another)."""
        self.require_single_device()
        if self.num_microbatches < 1:
            raise ValueError(f"num_microbatches must be >= 1, got {self.num_microbatches}")
        return resolve_device(device)
