"""DBRX model family (MoE), in PyTorch.

Counterpart of ``neuronx_distributed_llama3_2_tpu/models/dbrx.py``
(``DbrxConfig`` :31, ``DBRX_CONFIGS`` :47, ``DbrxForCausalLM`` :65): GQA
attention with ``clip_qkv`` clamping, bias-free LayerNorm, and a 16-expert
top-4 MoE feed-forward with normalized affinities, all of it config on the
Mixtral model (``norm_type="layernorm"``, ``clip_qkv``), so training,
pipeline, expert parallelism and decode (:class:`..inference.model.
MixtralDecode`) run unchanged. The HF converters (JAX :73, :146) come
with the checkpoint converter (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from neuronx_distributed_llama3_2_tpu_torch.models.mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
)


@dataclasses.dataclass(frozen=True)
class DbrxConfig(MixtralConfig):
    """MixtralConfig with DBRX's defaults (HF ``databricks/dbrx-base``)."""

    norm_type: str = "layernorm"
    norm_bias: bool = False
    clip_qkv: float = 8.0
    num_experts: int = 16
    top_k: int = 4
    router_aux_loss_coef: float = 0.05
    # every published DBRX checkpoint is untied
    tie_word_embeddings: bool = False


DBRX_CONFIGS: Dict[str, DbrxConfig] = {
    # databricks/dbrx-base config.json values
    "dbrx": DbrxConfig(
        vocab_size=100352, hidden_size=6144, intermediate_size=10752,
        num_layers=40, num_heads=48, num_kv_heads=8, head_dim=128,
        max_seq_len=32768, rope_theta=500000.0, tie_word_embeddings=False,
        num_experts=16, top_k=4, capacity_factor=8.0,
    ),
    "tiny-dbrx": DbrxConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=8, num_kv_heads=4, head_dim=8,
        max_seq_len=128, rope_theta=10000.0, dtype=torch.float32,
        remat="none", num_experts=4, top_k=2,
    ),
}


class DbrxForCausalLM(MixtralForCausalLM):
    """DBRX: the Mixtral causal LM under a :class:`DbrxConfig`."""
