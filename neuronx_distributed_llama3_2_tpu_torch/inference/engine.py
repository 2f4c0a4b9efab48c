"""Inference engine: the generation config, the bucket ladder, and the
model/weights holder the paged serving engine runs on.

Counterpart of ``neuronx_distributed_llama3_2_tpu/inference/engine.py``.
Only what :class:`..serving.engine.PagedServingEngine` reads is ported:
``GenerationConfig``, ``default_buckets`` / ``pick_bucket`` and the
``InferenceEngine`` fields config, model, params, max_batch, max_seq_len,
buckets and ``_kv_bucket``. The dense per-slot cache, its programs,
``generate`` (and the ``on_device_steps`` / ``precompile`` fields of
``GenerationConfig`` that drive it) and the ``ContinuousBatchingEngine``
come with the dense-engine slice; no dense cache is allocated here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from neuronx_distributed_llama3_2_tpu_torch.inference.model import LlamaDecode
from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import (
    SamplingConfig,
)
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
)
from neuronx_distributed_llama3_2_tpu_torch.serving import catalog


def default_buckets(max_seq_len: int, min_bucket: int = 128) -> List[int]:
    """Powers-of-2 bucket ladder up to max_seq_len (canonical
    implementation in ``serving/catalog.py``)."""
    return catalog.default_buckets(max_seq_len, min_bucket)


def pick_bucket(buckets: Sequence[int], length: int) -> int:
    """Smallest bucket >= length (canonical implementation in
    ``serving/catalog.py``)."""
    return catalog.pick_bucket(buckets, length)


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 128
    eos_token_id: Optional[int] = None
    sampling: SamplingConfig = SamplingConfig()
    seed: int = 0


class InferenceEngine:
    """Owns the model and its weights plus the bucket ladder.

    ``params`` is the :class:`LlamaForCausalLM` module holding the weights
    (on the card unless it was built elsewhere); ``model`` is the weightless
    :class:`LlamaDecode` that runs them over a paged cache."""

    def __init__(
        self,
        config: LlamaConfig,
        params: LlamaForCausalLM,
        *,
        max_batch: int = 4,
        max_seq_len: int = 2048,
        buckets: Optional[Sequence[int]] = None,
    ) -> None:
        self.config = config
        self.model = LlamaDecode(config)
        self.params = params
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.buckets = list(buckets) if buckets else default_buckets(max_seq_len)
        if self.buckets[-1] > max_seq_len:
            raise ValueError("largest bucket exceeds max_seq_len")

    @property
    def device(self):
        return self.params.device

    def _kv_bucket(self, needed: int) -> int:
        """Token-gen cache bucket covering ``needed`` rows; positions past a
        short custom ladder fall back to the full cache."""
        if needed > self.buckets[-1]:
            return self.max_seq_len
        return pick_bucket(self.buckets, needed)
