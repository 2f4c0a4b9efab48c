"""MoE load-balancing loss (the Switch Transformer's auxiliary loss).

Counterpart of ``neuronx_distributed_llama3_2_tpu/moe/loss.py``
(``load_balancing_loss`` :16): ``E · Σ_e f_e · P_e``, with ``f_e`` the
fraction of the (token, k) assignments routed to expert ``e`` and ``P_e``
the mean router probability of ``e``, in fp32.

:func:`balance_sums` splits it into its sums over the tokens, so that a
model whose tokens lie on several ranks (data, context or expert
parallelism) sums them over the ranks first and gets the loss of the whole
batch, as the JAX package computes it on the global arrays
(:func:`balance_loss_of_sums`).
"""

from __future__ import annotations

from typing import Tuple

import torch


def balance_sums(router_logits: torch.Tensor, expert_idx: torch.Tensor,
                 num_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(assignments per expert (E,), router probabilities summed per expert
    (E,)), fp32 sums over the T tokens of ``router_logits`` (T, E) and
    ``expert_idx`` (T, k)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    onehot = (expert_idx[..., None] == torch.arange(num_experts, device=expert_idx.device))
    return onehot.float().sum(dim=(0, 1)), probs.sum(dim=0)


def balance_loss_of_sums(assigned: torch.Tensor, prob_sum: torch.Tensor, num_tokens,
                         top_k: int, num_experts: int) -> torch.Tensor:
    """The aux loss from :func:`balance_sums` over ``num_tokens`` tokens."""
    f = assigned / num_tokens / top_k
    p = prob_sum / num_tokens
    return num_experts * torch.sum(f * p)


def load_balancing_loss(router_logits: torch.Tensor, expert_idx: torch.Tensor,
                        num_experts: int) -> torch.Tensor:
    """router_logits (T, E), expert_idx (T, k) -> the scalar fp32 aux loss
    (1.0 at perfect balance)."""
    assigned, prob_sum = balance_sums(router_logits, expert_idx, num_experts)
    t, k = expert_idx.shape
    return balance_loss_of_sums(assigned, prob_sum, t, k, num_experts)
