"""Mixture of experts: routers, the expert MLPs and their dispatch, the
MoE block with expert parallelism, and the load-balancing loss.

Counterpart of ``neuronx_distributed_llama3_2_tpu/moe/``.
"""

from neuronx_distributed_llama3_2_tpu_torch.moe.experts import ExpertMLPs
from neuronx_distributed_llama3_2_tpu_torch.moe.loss import load_balancing_loss
from neuronx_distributed_llama3_2_tpu_torch.moe.model import MoE, MoEConfig
from neuronx_distributed_llama3_2_tpu_torch.moe.routing import (
    Router,
    sinkhorn,
    sinkhorn_routing,
    top_k_routing,
)

__all__ = [
    "ExpertMLPs",
    "MoE",
    "MoEConfig",
    "Router",
    "load_balancing_loss",
    "sinkhorn",
    "sinkhorn_routing",
    "top_k_routing",
]
