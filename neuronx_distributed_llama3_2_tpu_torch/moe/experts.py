"""Expert MLPs: the fused expert weights and the static-shape dispatch paths.

Counterpart of ``neuronx_distributed_llama3_2_tpu/moe/experts.py``
(``ExpertMLPs``), with its parameter layout: ``gate_up`` (E, H, 2, I) and
``down`` (E, I, H) in the model's dtype, a SwiGLU per expert. A module
built under a live mesh holds its shards (JAX ``specs()``): the experts
over ep (``E / ep`` of them, those of its ep rank) and the intermediate
width over tp.

Three forward paths, as in JAX (``__call__`` :202 picks one):

- :meth:`ExpertMLPs.forward_all_experts` (:89): every token through every
  expert, combined by a one-hot contraction of the gates;
- :meth:`ExpertMLPs.forward_capacity_factor` (:167): C = ceil(T·k·cf / E)
  slots an expert; each (token, choice) takes the next free slot of its
  expert in token-major order (a cumulative count), the ones past C are
  dropped; :meth:`ExpertMLPs.dispatch` ``index_add``\\ s the tokens into an
  (E·C + 1, H) buffer whose last row takes every dropped one, the experts
  run as one batched product, and :meth:`ExpertMLPs.combine` gathers each
  assignment's output back, scaled by its gate. Each kept slot receives
  exactly one row, so the buffer does not depend on the order of the adds;
- :meth:`ExpertMLPs.forward_selective` (:178): each token's chosen experts'
  weights gathered (T·k expert copies), for small blocks.

Without a capacity factor the block takes the selective path when T·k <= E
and all experts otherwise. Under tp each rank's experts give partial sums
over its slice of the intermediate width, summed over tp before the gates
weigh them (:meth:`ExpertMLPs._mlp`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.layers import KERNEL_INIT_STD, divide
from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import (
    reduce_from_tensor_model_parallel_region,
)


class ExpertMLPs(nn.Module):
    """Fused gate_up / down projections of E experts (module docstring)."""

    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int,
                 capacity_factor: Optional[float] = None, glu: bool = True,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.num_experts = num_experts
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.capacity_factor = capacity_factor
        self.glu = glu
        self.dtype = dtype
        self.tp = parallel_state.tensor_parallel_size_or(1)
        self.tp_rank = parallel_state.tensor_parallel_rank_or(0)
        self.ep = parallel_state.expert_parallel_size_or(1)
        self.ep_rank = parallel_state.expert_parallel_rank_or(0)
        e, i = divide(num_experts, self.ep), divide(intermediate_size, self.tp)
        n_up = 2 if glu else 1
        self.gate_up = nn.Parameter(torch.empty((e, hidden_size, n_up, i), dtype=dtype,
                                                device=device))
        self.down = nn.Parameter(torch.empty((e, i, hidden_size), dtype=dtype, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """N(0, 0.02) drawn in fp32 over the whole (E, ...) tensors; the
        rank keeps its experts and its intermediate slice."""
        e, h, n_up, i = self.gate_up.shape
        with torch.no_grad():
            for p, full, i_dim in ((self.gate_up, (self.num_experts, h, n_up, i * self.tp), 3),
                                   (self.down, (self.num_experts, i * self.tp, h), 1)):
                tmp = torch.empty(full, dtype=torch.float32, device=p.device)
                tmp.normal_(0.0, KERNEL_INIT_STD, generator=generator)
                tmp = tmp.narrow(0, self.ep_rank * e, e).narrow(i_dim, self.tp_rank * i, i)
                p.copy_(tmp)

    # -- the expert math, shared by every path ---------------------------

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        """x (E', C, H) through each of the rank's E' experts -> (E', C, H):
        one batched product per projection, summed over tp."""
        gate_up = self.gate_up  # read once: a quantized layer dequantizes on each read
        e, h, n_up, i = gate_up.shape
        h1 = torch.bmm(x, gate_up.reshape(e, h, n_up * i)).unflatten(-1, (n_up, i))
        act = (nn.functional.silu(h1[..., 0, :]) * h1[..., 1, :] if self.glu
               else nn.functional.silu(h1[..., 0, :]))
        return reduce_from_tensor_model_parallel_region(torch.bmm(act, self.down))

    # -- dispatch paths ----------------------------------------------------

    def forward_all_experts(self, x: torch.Tensor, gates: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
        """Every token through every expert; x (T, H), gates / idx (T, k)."""
        t, h = x.shape
        y_all = self._mlp(x.expand(self.num_experts, t, h))  # (E, T, H)
        onehot = (idx[:, :, None] == torch.arange(self.num_experts, device=idx.device)).float()
        combine = torch.einsum("tke,tk->te", onehot, gates)
        return torch.einsum("te,eth->th", combine.to(x.dtype), y_all)

    def capacity(self, num_tokens: int, top_k: int) -> int:
        """C = ceil(T·k·cf / E), at least 1."""
        if self.capacity_factor is None:
            raise ValueError("capacity() needs a capacity_factor")
        return max(1, math.ceil(num_tokens * top_k * self.capacity_factor / self.num_experts))

    def dispatch(self, x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
                 capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The tokens into (E, C, H) expert buffers: (buffers, slot (T·k,)
        the flat slot of each assignment with E·C for a dropped one, keep
        (T·k,) fp32). Slots go token-major: earlier tokens win capacity."""
        t, k = idx.shape
        e, c = self.num_experts, capacity
        e_flat = idx.reshape(-1)
        onehot = (e_flat[:, None] == torch.arange(e, device=idx.device)).to(torch.int32)
        pos = torch.gather(torch.cumsum(onehot, dim=0) - 1, 1, e_flat[:, None])[:, 0]
        kept = pos < c
        keep = kept.float()
        slot = torch.where(kept, e_flat * c + pos, torch.full_like(e_flat, e * c))
        x_rep = x.repeat_interleave(k, dim=0) * keep[:, None].to(x.dtype)
        buf = torch.zeros((e * c + 1, x.shape[1]), dtype=x.dtype, device=x.device)
        buf = buf.index_add(0, slot, x_rep)
        return buf[: e * c].reshape(e, c, -1), slot, keep

    def combine(self, y: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
                gates: torch.Tensor, num_tokens: int) -> torch.Tensor:
        """The expert outputs y (E, C, H) gathered back to the tokens and
        scaled by their gates; a dropped assignment contributes 0."""
        e, c, h = y.shape
        y_pad = torch.cat([y.reshape(e * c, h), y.new_zeros((1, h))])
        w = (keep * gates.reshape(-1))[:, None].to(y.dtype)
        return (y_pad.index_select(0, slot) * w).reshape(num_tokens, -1, h).sum(dim=1)

    def forward_capacity_factor(self, x: torch.Tensor, gates: torch.Tensor,
                                idx: torch.Tensor) -> torch.Tensor:
        """The static-shape dispatch with token dropping; x (T, H)."""
        t = x.shape[0]
        buf, slot, keep = self.dispatch(x, gates, idx, self.capacity(t, idx.shape[1]))
        self.note_drops(keep)
        return self.combine(self._mlp(buf), slot, keep, gates, t)

    def forward_selective(self, x: torch.Tensor, gates: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
        """Each token's chosen experts' weights gathered, (T, k, H, 2, I)
        and (T, k, I, H); x (T, H), gates / idx (T, k)."""
        w_gu = self.gate_up[idx]
        w_dn = self.down[idx]
        h1 = torch.einsum("th,tkhui->tkui", x, w_gu)
        act = (nn.functional.silu(h1[:, :, 0]) * h1[:, :, 1] if self.glu
               else nn.functional.silu(h1[:, :, 0]))
        y = reduce_from_tensor_model_parallel_region(torch.einsum("tki,tkih->tkh", act, w_dn))
        return (y * gates[:, :, None].to(y.dtype)).sum(dim=1)

    def note_drops(self, keep: torch.Tensor) -> None:
        """Keep the last dispatch's dropped assignments (a device scalar)
        and its assignment count, for the caller to log."""
        self.dropped = (keep.numel() - keep.sum()).detach()
        self.assignments = keep.numel()

    def path(self, num_tokens: int, top_k: int) -> str:
        """The path :meth:`forward` takes for T tokens: ``"capacity"`` with
        a capacity factor, else ``"selective"`` when T·k <= E, else
        ``"all_experts"``."""
        if self.capacity_factor is not None:
            return "capacity"
        return "selective" if num_tokens * top_k <= self.num_experts else "all_experts"

    def forward(self, x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if self.ep > 1:
            raise ValueError("ExpertMLPs holds E / ep experts at ep > 1: run it through MoE")
        path = self.path(x.shape[0], idx.shape[1])
        if path == "capacity":
            return self.forward_capacity_factor(x, gates, idx)
        if path == "selective":
            return self.forward_selective(x, gates, idx)
        return self.forward_all_experts(x, gates, idx)
