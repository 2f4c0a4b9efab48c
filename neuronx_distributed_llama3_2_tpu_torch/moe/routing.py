"""MoE routers: a linear router and the top-k / Sinkhorn assignment.

Counterpart of ``neuronx_distributed_llama3_2_tpu/moe/routing.py``
(``Router`` :27, ``top_k_routing`` :53, ``sinkhorn`` :68,
``sinkhorn_routing`` :80). All router math is fp32: the logits, the
softmax, the Sinkhorn iterations and the gates, whatever the model's
compute dtype. The router's weight is replicated over tp (its gradient is
whole on every tp rank: the router reads the whole token, never a shard).

``torch.topk`` orders ties differently from ``lax.top_k`` (which keeps the
lower index first); on inputs without ties the two agree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


class Router(nn.Module):
    """Linear router producing fp32 logits: ``kernel`` (H, E), fp32."""

    def __init__(self, hidden_size: int, num_experts: int, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.kernel = nn.Parameter(
            torch.empty((hidden_size, num_experts), dtype=torch.float32, device=device)
        )

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """N(0, 1 / sqrt(H)), as the JAX init draws it."""
        with torch.no_grad():
            self.kernel.normal_(0.0, self.hidden_size ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (T, H) -> logits (T, E), fp32."""
        return x.float() @ self.kernel.float()


def top_k_routing(logits: torch.Tensor, top_k: int,
                  normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax, then the top ``top_k`` experts of each token: (gates (T, k)
    fp32, expert_idx (T, k) int64). ``normalize`` renormalizes the chosen
    affinities to sum to 1 (the Mixtral convention)."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    if normalize:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates.float(), idx


def sinkhorn(cost: torch.Tensor, n_iters: int = 3) -> torch.Tensor:
    """Fixed-iteration Sinkhorn normalization in log space (rows, then
    columns, ``n_iters`` times; a fixed count keeps the shapes static)."""
    log_p = cost
    for _ in range(n_iters):
        log_p = log_p - torch.logsumexp(log_p, dim=1, keepdim=True)
        log_p = log_p - torch.logsumexp(log_p, dim=0, keepdim=True)
    return torch.exp(log_p)


def sinkhorn_routing(logits: torch.Tensor, top_k: int, n_iters: int = 3,
                     normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sinkhorn-balanced assignment: the experts come from the balanced
    matrix, the gates from the raw logits (so the router gets the task
    loss's gradient). At ``top_k == 1`` the gate is ``sigmoid(logit)`` (a
    renormalized softmax gate would be the constant 1)."""
    logits = logits.float()
    _, idx = torch.topk(sinkhorn(logits, n_iters), top_k, dim=-1)
    if top_k == 1:
        gates = torch.sigmoid(torch.gather(logits, -1, idx))
    else:
        gates = torch.gather(torch.softmax(logits, dim=-1), -1, idx)
        if normalize:
            gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates.float(), idx
