"""The MoE block: router -> dispatch -> (the ep all-to-all) -> experts ->
combine.

Counterpart of ``neuronx_distributed_llama3_2_tpu/moe/model.py``
(``MoEConfig`` :51, ``MoE`` :73). ``MoE.forward(x (B, S, H))`` returns
``(y (B, S, H), router_logits (T, E), expert_idx (T, k))``, T = B·S.

- **ep == 1**: the tokens are routed and run through
  :class:`..moe.experts.ExpertMLPs` by its dispatch rule.
- **ep > 1** (:meth:`MoE._ep_forward`, JAX ``_ep_forward`` :144): each rank
  routes and dispatches its own tokens into (E, C, H) buffers, C from its
  own token count (rank-local capacity, as in JAX);
  :func:`..parallel.mappings.enter_expert_parallel_region` all-to-alls them
  to (E/ep, ep·C, H) on the ranks that own the experts, the experts run,
  :func:`..parallel.mappings.exit_expert_parallel_region` brings the
  outputs back, and they are combined. ep > 1 needs a capacity factor:
  without one a buffer would have to hold T·k slots an expert (JAX's
  refusal, :178-190).

Under tp the router reads the whole token on every tp rank (its input
keeps its gradient to this rank, or its part of the sequence under SP) and
the experts' input enters the tp region as a column-parallel product's
does (an all-reduce, or under SP a reduce-scatter, of its gradient); the
experts' outputs are summed over tp before the gates weigh them, and
under SP the block's output is this rank's part of the sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch import nn

from neuronx_distributed_llama3_2_tpu_torch.moe.experts import ExpertMLPs
from neuronx_distributed_llama3_2_tpu_torch.moe.routing import (
    Router,
    sinkhorn_routing,
    top_k_routing,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    enter_expert_parallel_region,
    exit_expert_parallel_region,
    gather_from_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    hidden_size: int
    intermediate_size: int
    num_experts: int
    top_k: int = 2
    # None: no token is dropped (the selective / all-experts dispatch)
    capacity_factor: Optional[float] = None
    routing: str = "topk"  # "topk" | "sinkhorn"
    normalize_top_k: bool = True
    sinkhorn_iterations: int = 3
    glu: bool = True
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.routing not in ("topk", "sinkhorn"):
            raise ValueError(f"routing must be topk|sinkhorn, got {self.routing!r}")
        if not 1 <= self.top_k <= self.num_experts:
            raise ValueError("need 1 <= top_k <= num_experts")


class MoE(nn.Module):
    """The MoE block (module docstring): ``router`` and ``experts``."""

    def __init__(self, config: MoEConfig, device=None, sequence_parallel: bool = False):
        super().__init__()
        c = config
        self.config = c
        self.sequence_parallel = sequence_parallel
        self.router = Router(c.hidden_size, c.num_experts, device)
        self.experts = ExpertMLPs(c.num_experts, c.hidden_size, c.intermediate_size,
                                  c.capacity_factor, c.glu, c.dtype, device)

    def reset_parameters(self, generator) -> None:
        self.router.reset_parameters(generator)
        self.experts.reset_parameters(generator)

    def route(self, x_flat: torch.Tensor):
        """(logits (T, E) fp32, gates (T, k) fp32, expert_idx (T, k))."""
        c = self.config
        logits = self.router(x_flat)
        if c.routing == "sinkhorn":
            gates, idx = sinkhorn_routing(logits, c.top_k, c.sinkhorn_iterations,
                                          c.normalize_top_k)
        else:
            gates, idx = top_k_routing(logits, c.top_k, c.normalize_top_k)
        return logits, gates, idx

    def _inputs(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the router's input, the experts' input), the whole sequence
        each (module docstring)."""
        if self.sequence_parallel:
            return (gather_from_sequence_parallel_region(x, dim=1, to_model_parallel=False),
                    gather_from_sequence_parallel_region(x, dim=1))
        return x, copy_to_tensor_model_parallel_region(x)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x_r, x_e = self._inputs(x)
        b, s, h = x_r.shape
        x_r, x_e = x_r.reshape(b * s, h), x_e.reshape(b * s, h)
        logits, gates, idx = self.route(x_r)
        if self.experts.ep > 1:
            y = self._ep_forward(x_e, gates, idx)
        else:
            y = self.experts(x_e, gates, idx)
        y = y.reshape(b, s, h)
        if self.sequence_parallel:
            y = scatter_to_sequence_parallel_region(y, dim=1)
        return y, logits, idx

    def _ep_forward(self, x: torch.Tensor, gates: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
        """The rank's tokens through the experts of every ep rank (module
        docstring)."""
        c, ex = self.config, self.experts
        if c.capacity_factor is None:
            raise ValueError(
                "expert parallelism (ep > 1) requires a capacity_factor; "
                "capacity_factor=None (all-experts dispatch) would buffer "
                "T·top_k slots per expert. Set e.g. capacity_factor="
                f"{float(c.num_experts) / c.top_k:g} for a no-drop-at-balance budget."
            )
        t = x.shape[0]
        buf, slot, keep = ex.dispatch(x, gates, idx, ex.capacity(t, c.top_k))
        ex.note_drops(keep)
        group = parallel_state.get_expert_model_parallel_group()
        y = ex._mlp(enter_expert_parallel_region(buf, group))
        return ex.combine(exit_expert_parallel_region(y, group), slot, keep, gates, t)
