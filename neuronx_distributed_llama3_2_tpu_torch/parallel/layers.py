"""Tensor-parallel linear, embedding and fused GQA QKV layers.

Counterpart of ``neuronx_distributed_llama3_2_tpu/parallel/layers.py``
(:102-352). The parameter names and layouts are the JAX package's, and each
rank holds exactly the shard the JAX ``specs()`` gives it, read from the
live parallel state when the layer is built (tp = 1 without one: whole
tensors, as on one device):

- ``ColumnParallelLinear``: ``kernel`` (in, out/tp), ``bias`` (out/tp,);
  ``gather_output`` all-gathers y over tp as in JAX;
- ``RowParallelLinear``: ``kernel`` (in/tp, out), ``bias`` (out,); the
  partial products are all-reduced, or reduce-scattered along the sequence
  under sequence parallelism;
- ``ParallelEmbedding``: ``embedding`` (V/tp, H) by default, a masked local
  lookup then an all-reduce (a reduce-scatter along the sequence under SP);
  (V, H/tp) with ``shard_dim="embed"``;
- ``GQAQKVColumnParallelLinear``: ``q_kernel`` (H, N*D/tp); ``k_kernel`` /
  ``v_kernel`` (H, NKV*D/tp) when tp divides NKV or, past NKV, the flat
  kv width (JAX ``_kv_flat_sharded``: the rank all-gathers k and v and
  keeps its copy of a head, ``kv_repeat_factor``), else whole and
  replicated (each rank keeps the kv heads of its q heads, and the
  kernels' gradients are summed over tp).

Every rank draws each whole tensor from the seeded generator and keeps its
slice, so the weights are the tp = 1 weights whatever tp is (the reference's
``create_local_weight``, layers.py:58).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)

#: std of the JAX package's ``default_kernel_init`` (normal, 0.02)
KERNEL_INIT_STD = 0.02


def divide(numerator: int, denominator: int) -> int:
    """reference utils.py:78-87."""
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")
    return numerator // denominator


def kv_mode(num_heads: int, num_kv_heads: int, head_dim: int, tp: int) -> str:
    """How the k / v kernels sit over tp (JAX ``_kv_sharded`` /
    ``_kv_flat_sharded``): ``"sharded"`` when tp divides the kv heads,
    ``"flat"`` past them when tp divides the flat kv width and the q heads,
    else ``"replicated"``."""
    if num_kv_heads % tp == 0:
        return "sharded"
    if (tp % num_kv_heads == 0 and (num_kv_heads * head_dim) % tp == 0
            and num_heads % tp == 0):
        return "flat"
    return "replicated"


def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _tp():
    return (parallel_state.tensor_parallel_size_or(1),
            parallel_state.tensor_parallel_rank_or(0))


def normal_init_(
    p: torch.Tensor, generator: Optional[torch.Generator], std: float,
    full_shape=None, dim: int = 0, rank: int = 0,
) -> None:
    """Fill ``p`` with N(0, std) drawn in fp32 (the JAX init draws fp32 and
    casts), from ``generator`` so a seed fixes the weights. With
    ``full_shape`` the whole tensor is drawn and ``p`` takes part ``rank`` of
    it along ``dim``."""
    with torch.no_grad():
        shape = tuple(p.shape) if full_shape is None else tuple(full_shape)
        tmp = torch.empty(shape, dtype=torch.float32, device=p.device)
        tmp.normal_(0.0, std, generator=generator)
        if full_shape is not None:
            tmp = tmp.narrow(dim, rank * p.shape[dim], p.shape[dim])
        p.copy_(tmp)


def _enter(x: torch.Tensor, sequence_parallel: bool) -> torch.Tensor:
    """The input of a column-parallel product: all-gathered along the
    sequence under SP (reduce-scatter backward), else copied into the
    region (all-reduce backward)."""
    if sequence_parallel:
        return gather_from_sequence_parallel_region(x, dim=1)
    return copy_to_tensor_model_parallel_region(x)


class ColumnParallelLinear(nn.Module):
    """Y = X·A + b with A (in, out) split along ``out`` (reference
    layers.py:460)."""

    def __init__(self, in_features: int, out_features: int, *,
                 use_bias: bool = False, gather_output: bool = False,
                 sequence_parallel: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.tp, self.tp_rank = _tp()
        self.gather_output = gather_output
        self.sequence_parallel = sequence_parallel
        self.full_shape = (in_features, out_features)
        local = divide(out_features, self.tp)
        self.kernel = _empty((in_features, local), dtype, device)
        self.bias = _empty((local,), dtype, device) if use_bias else None

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        normal_init_(self.kernel, generator, KERNEL_INIT_STD, self.full_shape, 1, self.tp_rank)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _enter(x, self.sequence_parallel) @ self.kernel
        if self.bias is not None:
            y = y + self.bias
        if self.gather_output:
            y = gather_from_tensor_model_parallel_region(y, -1)
        return y


class RowParallelLinear(nn.Module):
    """Y = X·A + b with A (in, out) split along ``in`` (reference
    layers.py:637). X's last dim arrives split over tp; the partial products
    are all-reduced, or reduce-scattered along the sequence (dim 1) under
    ``sequence_parallel`` (reference layers.py:793-797)."""

    def __init__(self, in_features: int, out_features: int, *,
                 use_bias: bool = False, sequence_parallel: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.tp, self.tp_rank = _tp()
        self.sequence_parallel = sequence_parallel
        self.full_shape = (in_features, out_features)
        self.kernel = _empty((divide(in_features, self.tp), out_features), dtype, device)
        self.bias = _empty((out_features,), dtype, device) if use_bias else None

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        normal_init_(self.kernel, generator, KERNEL_INIT_STD, self.full_shape, 0, self.tp_rank)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        if self.sequence_parallel:
            y = reduce_scatter_to_sequence_parallel_region(y, dim=1)
        else:
            y = reduce_from_tensor_model_parallel_region(y)
        if self.bias is not None:
            # read on a sequence shard under SP: its gradient is summed over tp
            bias = copy_to_tensor_model_parallel_region(self.bias) if self.sequence_parallel else self.bias
            y = y + bias
        return y


class ParallelEmbedding(nn.Module):
    """Embedding table split along the vocab (reference ``ParallelEmbedding``
    layers.py:101, :215-238), or along the embedding with
    ``shard_dim="embed"``."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 dtype=torch.float32, device=None, shard_dim: str = "vocab"):
        super().__init__()
        if shard_dim not in ("vocab", "embed"):
            raise ValueError(f"shard_dim must be 'vocab' or 'embed', got {shard_dim!r}")
        self.tp, self.tp_rank = _tp()
        self.shard_dim = shard_dim
        self.full_shape = (num_embeddings, embedding_dim)
        if shard_dim == "vocab":
            shape = (divide(num_embeddings, self.tp), embedding_dim)
        else:
            shape = (num_embeddings, divide(embedding_dim, self.tp))
        self.embedding = _empty(shape, dtype, device)

    @property
    def vocab_start(self) -> int:
        return self.tp_rank * self.embedding.shape[0] if self.shard_dim == "vocab" else 0

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        dim = 0 if self.shard_dim == "vocab" else 1
        normal_init_(self.embedding, generator, KERNEL_INIT_STD, self.full_shape, dim, self.tp_rank)

    def forward(self, ids: torch.Tensor, sequence_parallel: bool = False) -> torch.Tensor:
        """(B, S) ids -> (B, S, H), replicated over tp; split along the
        sequence (dim 1) with ``sequence_parallel``."""
        if self.tp == 1:
            return nn.functional.embedding(ids, self.embedding)
        if self.shard_dim == "embed":
            y = gather_from_tensor_model_parallel_region(
                nn.functional.embedding(ids, self.embedding), -1
            )
            return scatter_to_tensor_model_parallel_region(y, 1) if sequence_parallel else y
        vl = self.embedding.shape[0]
        local = ids - self.vocab_start
        outside = (local < 0) | (local >= vl)
        y = nn.functional.embedding(local.clamp(0, vl - 1), self.embedding)
        y = y.masked_fill(outside[..., None], 0.0)
        if sequence_parallel:
            return reduce_scatter_to_sequence_parallel_region(y, dim=1)
        return reduce_from_tensor_model_parallel_region(y)


class GQAQKVColumnParallelLinear(nn.Module):
    """Fused grouped-query Q/K/V projection (reference
    ``GQAQKVColumnParallelLinear`` qkv_linear.py:454); the kv layout follows
    JAX's ``_kv_sharded`` / ``_kv_flat_sharded`` / ``kv_repeat_factor``
    (module docstring). :meth:`forward` returns this rank's q (b, s,
    N/tp * D) and k, v (b, s, :attr:`kv_local_heads` * D)."""

    def __init__(self, hidden_size: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, *, use_bias: bool = False, sequence_parallel: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.tp, self.tp_rank = _tp()
        tp = self.tp
        if num_heads % tp:
            raise ValueError(
                f"tp={tp} does not divide the {num_heads} q heads: pad them with "
                "parallel.pad.pad_llama_params_for_tp or pick another tp"
            )
        self.num_heads, self.num_kv_heads, self.head_dim = num_heads, num_kv_heads, head_dim
        self.sequence_parallel = sequence_parallel
        self.q_local_heads = num_heads // tp
        q_out, kv_out = num_heads * head_dim, num_kv_heads * head_dim
        if self.kv_sharded:
            self.kv_local_heads = num_kv_heads // tp
        elif self.kv_flat_sharded:
            self.kv_local_heads = 1  # NKV * kv_repeat_factor() / tp
        else:
            self.kv_local_heads = self.q_local_heads  # the kv head of each q head
        kv_cols = kv_out // tp if self.kv_split else kv_out
        self.full_shapes = {"q": (hidden_size, q_out), "k": (hidden_size, kv_out),
                            "v": (hidden_size, kv_out)}
        self.q_kernel = _empty((hidden_size, q_out // tp), dtype, device)
        self.k_kernel = _empty((hidden_size, kv_cols), dtype, device)
        self.v_kernel = _empty((hidden_size, kv_cols), dtype, device)
        if use_bias:
            self.q_bias = _empty((q_out // tp,), dtype, device)
            self.k_bias = _empty((kv_cols,), dtype, device)
            self.v_bias = _empty((kv_cols,), dtype, device)
        else:
            self.q_bias = self.k_bias = self.v_bias = None

    @property
    def kv_sharded(self) -> bool:
        return kv_mode(self.num_heads, self.num_kv_heads, self.head_dim, self.tp) == "sharded"

    @property
    def kv_flat_sharded(self) -> bool:
        """tp past the kv heads, with the flat kv width split over tp."""
        return kv_mode(self.num_heads, self.num_kv_heads, self.head_dim, self.tp) == "flat"

    @property
    def kv_split(self) -> bool:
        """Whether the k / v kernels are split over tp (else replicated)."""
        return self.kv_sharded or self.kv_flat_sharded

    def kv_repeat_factor(self) -> int:
        return self.tp // self.num_kv_heads if self.kv_flat_sharded else 1

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        for name in ("q", "k", "v"):
            p = getattr(self, f"{name}_kernel")
            split = name == "q" or self.kv_split
            normal_init_(p, generator, KERNEL_INIT_STD, self.full_shapes[name], 1,
                         self.tp_rank if split else 0)
        with torch.no_grad():
            for b in (self.q_bias, self.k_bias, self.v_bias):
                if b is not None:
                    b.zero_()

    def project(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """One of the three products on the region's input ``x`` (already
        entered), bias added, this rank's heads flattened."""
        w = getattr(self, f"{name}_kernel")
        b = getattr(self, f"{name}_bias")
        if name != "q" and not self.kv_split:
            # replicated kernel: each rank's gradient covers its own heads
            w = copy_to_tensor_model_parallel_region(w)
            b = copy_to_tensor_model_parallel_region(b) if b is not None else None
        y = x @ w
        if b is not None:
            y = y + b
        return y if name == "q" else self._kv_heads(y)

    def _kv_heads(self, y: torch.Tensor) -> torch.Tensor:
        """k or v (b, s, cols) -> this rank's kv heads, flattened."""
        if self.kv_sharded:
            return y
        d, nkv = self.head_dim, self.num_kv_heads
        lead = y.shape[:-1]
        if self.kv_flat_sharded:
            # the whole flat width, then this rank's copy of one head
            full = gather_from_sequence_parallel_region(y, dim=-1)
            heads = full.reshape(*lead, nkv, d).repeat_interleave(self.kv_repeat_factor(), dim=-2)
            return heads[..., self.tp_rank, :]
        g = self.num_heads // nkv
        first = self.tp_rank * self.q_local_heads
        idx = torch.arange(first, first + self.q_local_heads, device=y.device) // g
        return y.reshape(*lead, nkv, d).index_select(-2, idx).reshape(*lead, -1)

    def forward(self, x: torch.Tensor):
        x = _enter(x, self.sequence_parallel)
        return self.project(x, "q"), self.project(x, "k"), self.project(x, "v")
