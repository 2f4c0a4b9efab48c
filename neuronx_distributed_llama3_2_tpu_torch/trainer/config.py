"""Training configuration.

Counterpart of ``neuronx_distributed_llama3_2_tpu/trainer/config.py``:
the same fields with the same defaults, so a configuration reads the same
in both packages. :meth:`TrainingConfig.initialize` builds the mesh of
tensor parallelism (with or without Megatron sequence parallelism) and
data parallelism over the processes of the group (one process per rank,
started by ``torchrun`` or by the caller), as the JAX one builds its
``Mesh``; ``zero_one_enabled`` splits the optimizer state over the dp
ranks (ZeRO-1, a no-op at dp = 1 as in the JAX package). Context
parallelism (``context_parallel_size``) splits each sequence over the cp
ranks and runs attention as a ring (:mod:`..kernels.ring_attention`).
Pipeline parallelism (``pipeline_parallel_size``) splits the layers into
stages (:mod:`..pipeline`), and expert parallelism (``expert_parallel_size``)
splits an MoE model's experts over the ep ranks of the (dp, ep) plane
(:mod:`..moe`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.multihost import world_size
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

    def require_ported(self) -> None:
        """Raise NotImplementedError naming the first knob the port does not
        run yet and the ROADMAP.md item that ports it (none is left)."""
        parallel_state.ParallelConfig(
            tensor_parallel_size=self.tensor_parallel_size,
            pipeline_parallel_size=self.pipeline_parallel_size,
            expert_parallel_size=self.expert_parallel_size,
            context_parallel_size=self.context_parallel_size,
            sequence_parallel=self.sequence_parallel,
        ).require_ported()

    def initialize(self, device: DeviceLike = "cuda") -> torch.device:
        """Check the configuration and return the device (the card unless
        the caller names another). Tensor, sequence, context, pipeline or
        expert parallelism, or a process group of several ranks, builds the
        mesh (:func:`..parallel.state.initialize_model_parallel`; dp is what
        the world size leaves, and a world that tp * pp * cp does not
        divide, or whose dp ep does not divide, raises) unless one is live,
        which must then agree."""
        self.require_ported()
        if self.num_microbatches < 1:
            raise ValueError(f"num_microbatches must be >= 1, got {self.num_microbatches}")
        dev = resolve_device(device)
        want = (self.tensor_parallel_size, self.pipeline_parallel_size,
                self.context_parallel_size, self.expert_parallel_size, self.sequence_parallel)
        if parallel_state.model_parallel_is_initialized():
            st = parallel_state.get_parallel_state()
            have = (st.tensor_parallel_size, st.pipeline_parallel_size,
                    st.context_parallel_size, st.expert_parallel_size, st.sequence_parallel)
            if have != want:
                raise ValueError(
                    f"the live mesh has (tp, pp, cp, ep, sequence_parallel) = {have}; this "
                    f"config asks for {want}"
                )
        elif (self.tensor_parallel_size > 1 or self.context_parallel_size > 1
              or self.pipeline_parallel_size > 1 or self.expert_parallel_size > 1
              or self.sequence_parallel or world_size() > 1):
            parallel_state.initialize_model_parallel(
                tensor_model_parallel_size=self.tensor_parallel_size,
                pipeline_model_parallel_size=self.pipeline_parallel_size,
                expert_model_parallel_size=self.expert_parallel_size,
                context_parallel_size=self.context_parallel_size,
                sequence_parallel=self.sequence_parallel, device=dev,
            )
        return dev


def validate_pipeline_config(model, config: TrainingConfig) -> None:
    """Raise when the config's pipeline knobs disagree with the model being
    trained (JAX ``_validate_pipeline_config``): the schedule lives on the
    :class:`..pipeline.PipelinedCausalLM`, so a config asking for one
    schedule must not train the model under another. An unpipelined model
    takes neither knob."""
    model_schedule = getattr(model, "schedule", None)
    model_chunks = getattr(model, "num_model_chunks", None)
    if model_schedule is None:
        if config.pipeline_schedule is not None or config.num_model_chunks is not None:
            raise ValueError(
                f"TrainingConfig(pipeline_schedule={config.pipeline_schedule!r}, "
                f"num_model_chunks={config.num_model_chunks}) but the model is not "
                "pipelined: wrap it in PipelinedCausalLM(schedule=..., num_model_chunks=...) "
                "or leave the config knobs at None"
            )
        return
    if config.pipeline_schedule is not None and model_schedule != config.pipeline_schedule:
        raise ValueError(f"model schedule {model_schedule!r} != TrainingConfig."
                         f"pipeline_schedule {config.pipeline_schedule!r}")
    if config.num_model_chunks is not None and model_chunks != config.num_model_chunks:
        raise ValueError(f"model num_model_chunks {model_chunks} != TrainingConfig."
                         f"num_model_chunks {config.num_model_chunks}")
