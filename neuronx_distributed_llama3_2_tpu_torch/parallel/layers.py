"""Linear, embedding and fused GQA QKV layers, single device.

Counterpart of ``neuronx_distributed_llama3_2_tpu/parallel/layers.py``. The
parameter names and layouts are the JAX package's, so a weight crosses
between the two packages without reshuffling:

- ``ColumnParallelLinear`` / ``RowParallelLinear``: ``kernel`` (in, out),
  optional ``bias`` (out,); ``y = x @ kernel``.
- ``ParallelEmbedding``: ``embedding`` (V, H).
- ``GQAQKVColumnParallelLinear``: ``q_kernel`` (H, N*D) and ``k_kernel`` /
  ``v_kernel`` (H, NKV*D).

Tensor parallelism (sharded kernels, the Megatron collectives) waits for
the multi-GPU slice; until then these layers hold whole tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

#: std of the JAX package's ``default_kernel_init`` (normal, 0.02)
KERNEL_INIT_STD = 0.02


def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def normal_init_(
    p: torch.Tensor, generator: Optional[torch.Generator], std: float
) -> None:
    """Fill ``p`` with N(0, std) drawn in fp32 (the JAX init draws fp32 and
    casts), from ``generator`` so a seed fixes the weights."""
    with torch.no_grad():
        tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        tmp.normal_(0.0, std, generator=generator)
        p.copy_(tmp)


class ColumnParallelLinear(nn.Module):
    """Y = X·A + b with A stored (in, out)."""

    def __init__(self, in_features: int, out_features: int, *,
                 use_bias: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.kernel = _empty((in_features, out_features), dtype, device)
        self.bias = (
            _empty((out_features,), dtype, device) if use_bias else None
        )

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        normal_init_(self.kernel, generator, KERNEL_INIT_STD)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        if self.bias is not None:
            y = y + self.bias
        return y


class RowParallelLinear(ColumnParallelLinear):
    """Same math as :class:`ColumnParallelLinear` on one device; under
    tensor parallelism the kernel shards along ``in`` instead of ``out``."""


class ParallelEmbedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.embedding = _empty((num_embeddings, embedding_dim), dtype, device)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        normal_init_(self.embedding, generator, KERNEL_INIT_STD)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(ids, self.embedding)


class GQAQKVColumnParallelLinear(nn.Module):
    """Fused grouped-query Q/K/V projection: three kernels, one input."""

    def __init__(self, hidden_size: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, *, use_bias: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        q_out = num_heads * head_dim
        kv_out = num_kv_heads * head_dim
        self.q_kernel = _empty((hidden_size, q_out), dtype, device)
        self.k_kernel = _empty((hidden_size, kv_out), dtype, device)
        self.v_kernel = _empty((hidden_size, kv_out), dtype, device)
        if use_bias:
            self.q_bias = _empty((q_out,), dtype, device)
            self.k_bias = _empty((kv_out,), dtype, device)
            self.v_bias = _empty((kv_out,), dtype, device)
        else:
            self.q_bias = self.k_bias = self.v_bias = None

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        for p in (self.q_kernel, self.k_kernel, self.v_kernel):
            normal_init_(p, generator, KERNEL_INIT_STD)
        with torch.no_grad():
            for b in (self.q_bias, self.k_bias, self.v_bias):
                if b is not None:
                    b.zero_()

    def forward(self, x: torch.Tensor):
        q = x @ self.q_kernel
        k = x @ self.k_kernel
        v = x @ self.v_kernel
        if self.q_bias is not None:
            q = q + self.q_bias
            k = k + self.k_bias
            v = v + self.v_bias
        return q, k, v
