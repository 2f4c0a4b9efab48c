"""Mixtral-style MoE causal LM, in PyTorch.

Counterpart of ``neuronx_distributed_llama3_2_tpu/models/mixtral.py``
(``MixtralConfig`` :49, ``MIXTRAL_CONFIGS`` :72, ``MixtralDecoderLayer``
:91, ``MixtralForCausalLM`` :129). The model is the port's Llama model
(:class:`..models.llama.LlamaForCausalLM`: its embedding, norms, GQA
attention with K1-K3, RoPE, sequence, context and pipeline parallelism and
the chunked loss) with the dense MLP of each layer swapped for the
:class:`..moe.MoE` block. The parameters keep JAX's layout and names:
``layers.<i>.moe.router.kernel`` (H, E) fp32, ``layers.<i>.moe.experts.
gate_up`` (E, H, 2, I) and ``down`` (E, I, H), so that
:func:`..models.llama.params_from_jax` / ``params_to_jax`` carry them.

:meth:`MixtralForCausalLM.loss` is the cross-entropy plus
``router_aux_loss_coef`` times the mean over the layers of each layer's
load-balancing loss (JAX ``loss`` :246). The JAX package computes that
loss over the global batch; here the tokens of one step lie on several
ranks under data, context or expert parallelism, so each layer's
assignment and probability sums are all-reduced over the ranks that hold
different tokens (the (dp, ep) plane and cp) before the loss is formed
(:func:`aux_term`). The trainer weighs each rank's loss and gradients by
the rank's token count and sums them; :func:`aux_term` gives each rank the
share that makes that sum the global aux loss and its gradient.

The HF converters (JAX :254, :336) come with the checkpoint converter
(``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from neuronx_distributed_llama3_2_tpu_torch.kernels.ring_attention import cp_layout_from_inv
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaAttention,
    make_norm,
)
from neuronx_distributed_llama3_2_tpu_torch.moe.loss import balance_loss_of_sums, balance_sums
from neuronx_distributed_llama3_2_tpu_torch.moe.model import MoE, MoEConfig
from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import (
    all_reduce,
    reduce_from_tensor_model_parallel_region,
)


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    """LlamaConfig + the MoE knobs (HF ``MixtralConfig`` fields)."""

    num_experts: int = 8
    top_k: int = 2
    capacity_factor: Optional[float] = None
    routing: str = "topk"
    normalize_top_k: bool = True
    router_aux_loss_coef: float = 0.02

    def moe_config(self) -> MoEConfig:
        return MoEConfig(
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_experts=self.num_experts,
            top_k=self.top_k,
            capacity_factor=self.capacity_factor,
            routing=self.routing,
            normalize_top_k=self.normalize_top_k,
            dtype=self.dtype,
        )


MIXTRAL_CONFIGS: Dict[str, MixtralConfig] = {
    # HF mistralai/Mixtral-8x7B config.json values; capacity_factor sized for
    # no dropping at balance (E/k = 4) with headroom, needed for ep > 1
    "mixtral-8x7b": MixtralConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        max_seq_len=32768, rope_theta=1e6, tie_word_embeddings=False,
        num_experts=8, top_k=2, capacity_factor=4.0,
    ),
    "tiny-moe": MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=8, num_kv_heads=4, head_dim=8,
        max_seq_len=128, rope_theta=10000.0, dtype=torch.float32,
        remat="none", num_experts=4, top_k=2,
    ),
}


class MixtralDecoderLayer(LlamaDecoderLayer):
    """Attention block, then the MoE block. ``forward`` returns (x, the
    layer's expert assignment counts (E,), its router probability sums
    (E,)): the sums of its load-balancing loss."""

    def __init__(self, config: MixtralConfig, device=None, sequence_parallel: bool = False):
        torch.nn.Module.__init__(self)
        sp = sequence_parallel
        self.attn_norm = make_norm(config, device, sp)
        self.attn = LlamaAttention(config, device, sp)
        self.mlp_norm = make_norm(config, device, sp)
        self.moe = MoE(config.moe_config(), device, sp)

    def reset_parameters(self, generator) -> None:
        self.attn_norm.reset_parameters()
        self.attn.reset_parameters(generator)
        self.mlp_norm.reset_parameters()
        self.moe.reset_parameters(generator)

    def _moe(self, x):
        y, logits, idx = self.moe(self.mlp_norm(x))
        assigned, prob_sum = balance_sums(logits, idx, self.moe.config.num_experts)
        return x + y, assigned, prob_sum

    def forward(self, x, sin, cos, positions):
        return self._moe(x + self.attn(self.attn_norm(x), sin, cos, positions))

    def _rest(self, x, attn):
        return self._moe(x + self.attn.o(attn))


def token_groups():
    """The groups over which the ranks hold different tokens of one model
    replica: the (dp, ep) plane and cp (those of size above 1)."""
    if not parallel_state.model_parallel_is_initialized():
        return []
    out = []
    if parallel_state.get_data_parallel_size() > 1:
        out.append(parallel_state.get_data_parallel_group())
    if parallel_state.get_context_parallel_size() > 1:
        out.append(parallel_state.get_context_parallel_group())
    return out


def aux_term(aux: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """What a rank adds to its loss sum for the (global) aux loss ``aux``,
    so that the trainer's sum over ranks of (loss sum / ``count``) ×
    ``count``, over the global count, holds ``aux`` once and its gradient
    whole: ``aux`` itself on one rank; with data ranks, the global count
    times ``aux`` / (dp·ep) in value and ``aux``'s rank-local gradient
    (the sums were all-reduced with an identity backward)."""
    if parallel_state.data_parallel_size_or(1) == 1:
        return aux * count
    n = all_reduce(count.detach(), parallel_state.get_data_parallel_group())
    r = parallel_state.get_data_parallel_size()
    return n * (aux.detach() / r + (aux - aux.detach()))


class MixtralForCausalLM(LlamaForCausalLM):
    """The Llama causal LM with MoE layers (module docstring). After a
    forward that records autograd, ``aux`` holds the mean over the layers
    run of their load-balancing losses (the layers of this stage's chunk
    under a pipeline)."""

    layer_class = MixtralDecoderLayer

    def _layer_aux(self, assigned, prob_sum, num_tokens: int) -> torch.Tensor:
        """One layer's load-balancing loss over the tokens of every rank
        (the sums all-reduced over :func:`token_groups`)."""
        c = self.config
        for group in token_groups():
            assigned = all_reduce(assigned, group)
            prob_sum = reduce_from_tensor_model_parallel_region(prob_sum, group=group)
            num_tokens *= torch.distributed.get_world_size(group)
        return balance_loss_of_sums(assigned, prob_sum, num_tokens, c.top_k, c.num_experts)

    def _run_layers(self, x: torch.Tensor, layers, positions, sin, cos, plan) -> torch.Tensor:
        remat = self.config.remat if torch.is_grad_enabled() else "none"
        auxes = []
        b, s = x.shape[:2]
        tokens = b * s * (self.tp if self.sequence_parallel else 1)
        with cp_layout_from_inv(plan.inv if plan is not None else None):
            for layer in layers:
                x, assigned, prob_sum = self._layer(layer, remat, x, sin, cos, positions)
                auxes.append(self._layer_aux(assigned, prob_sum, tokens))
        self.aux = torch.stack(auxes).mean() if auxes else None
        return x

    def moe_layers(self):
        """The MoE blocks this model holds, in layer order."""
        return [layer.moe for layer in self.layers]

    def loss(self, input_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """CE + ``router_aux_loss_coef`` · the mean per-layer aux loss (JAX
        ``loss``), under data ranks in the share of :func:`aux_term`."""
        plan = self._cp_plan(input_ids.shape[1], input_ids.device)
        hidden = self._backbone(input_ids, plan)
        loss_sum, count = self._head_sums(hidden, labels, plan)
        n = torch.clamp(count, min=1.0)
        coef = self.config.router_aux_loss_coef
        if not token_groups():
            return loss_sum / n + coef * self.aux
        return (loss_sum + coef * aux_term(self.aux, count)) / n
