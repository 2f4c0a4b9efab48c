"""Inference: the KV-cache decode model (dense slots and the paged pool),
the dense engine's bucketed programs, continuous batching, sampling,
draft-model and Medusa speculation, the accuracy gate and the latency
benchmarks.

Counterpart of ``neuronx_distributed_llama3_2_tpu/inference/__init__.py``,
with the same exports: the GPT-NeoX decode model beside Llama's and
Mixtral's, and the Mllama decoder (:mod:`.mllama_decode`).
"""

from neuronx_distributed_llama3_2_tpu_torch.inference.benchmark import (
    GenerationBenchmark,
    LatencyCollector,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
    ContinuousBatchingEngine,
    GenerateResult,
    GenerationConfig,
    InferenceEngine,
    default_buckets,
    pick_bucket,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.model import (
    GPTNeoXDecode,
    KVCache,
    LlamaDecode,
    MixtralDecode,
    PagedKVCache,
    decode_model_for,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.mllama_decode import (
    MllamaCache,
    MllamaDecoder,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import (
    SamplingConfig,
    sample,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.runner import (
    benchmark_generation,
    check_accuracy_logits,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.speculative import (
    SpeculativeDecoder,
    SpeculativeResult,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.medusa import (
    MedusaBuffers,
    MedusaDecoder,
    MedusaHeads,
    MedusaResult,
    generate_medusa_buffers,
)

__all__ = [
    "ContinuousBatchingEngine",
    "GenerateResult",
    "GenerationBenchmark",
    "GenerationConfig",
    "InferenceEngine",
    "KVCache",
    "LatencyCollector",
    "LlamaDecode",
    "MixtralDecode",
    "MllamaCache",
    "MllamaDecoder",
    "GPTNeoXDecode",
    "MedusaBuffers",
    "MedusaDecoder",
    "MedusaHeads",
    "MedusaResult",
    "PagedKVCache",
    "decode_model_for",
    "SamplingConfig",
    "SpeculativeDecoder",
    "SpeculativeResult",
    "benchmark_generation",
    "check_accuracy_logits",
    "default_buckets",
    "generate_medusa_buffers",
    "pick_bucket",
    "sample",
]
