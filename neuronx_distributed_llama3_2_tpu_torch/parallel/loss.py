"""Cross-entropy for the LM head, over vocab-sharded logits.

Counterpart of ``neuronx_distributed_llama3_2_tpu/parallel/loss.py``
(:36-185). Under tensor parallelism each rank holds its V/tp slice of the
logits, and :func:`parallel_cross_entropy` keeps the reference's three
collectives (``loss_functions.py:18-67``): a local max and an all-reduce
max, the target logit from the rank that owns it (an all-reduce of the
masked pick), a local sum of exponentials and an all-reduce sum; the full
softmax over the vocab never exists on one rank. Its backward is torch
autograd through :mod:`.mappings`' regions (the all-reduces are the
identity backward, the max shift carries no gradient). At tp = 1 it is
:func:`cross_entropy`.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import (
    all_reduce_max,
    reduce_from_tensor_model_parallel_region,
)

IGNORE_INDEX = -100  # positions with this label contribute zero loss


def valid_token_mask(labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Which label positions contribute loss: ids in [0, vocab) count,
    everything else (IGNORE_INDEX, out-of-vocab) does not. Every CE
    numerator and denominator and the trainer's microbatch weights use this
    one rule."""
    return (labels >= 0) & (labels < vocab_size)


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Per-token cross-entropy (...), fp32, of logits (..., V). Labels
    outside [0, V), IGNORE_INDEX included, contribute zero loss."""
    logits = logits.float()
    valid = valid_token_mask(labels, logits.shape[-1])
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    pred = torch.gather(logits, -1, safe[..., None])[..., 0]
    loss = logz - pred
    if label_smoothing > 0.0:
        mean_logit = logits.mean(dim=-1)
        loss = (1.0 - label_smoothing) * loss + label_smoothing * (logz - mean_logit)
    return torch.where(valid, loss, torch.zeros_like(loss))


def _vocab_parallel_xent_body(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float
) -> torch.Tensor:
    """JAX ``_vocab_parallel_xent_body``: logits (..., V/tp) fp32 of this
    rank's vocab slice, labels (...) global ids."""
    tp = parallel_state.get_tensor_model_parallel_size()
    vl = logits.shape[-1]
    vocab_total = vl * tp
    valid = valid_token_mask(labels, vocab_total)
    labels = torch.where(valid, labels, torch.zeros_like(labels)).long()
    # 1) stable max over the whole vocab (reference :18)
    lmax = all_reduce_max(logits.detach().amax(dim=-1))
    logits = logits - lmax[..., None]
    # 2) the target logit, from the rank whose slice holds it (reference :55)
    local = labels - parallel_state.get_tensor_model_parallel_rank() * vl
    in_range = (local >= 0) & (local < vl)
    pred = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    pred = reduce_from_tensor_model_parallel_region(torch.where(in_range, pred, torch.zeros_like(pred)))
    # 3) the log partition function (reference :67)
    logz = torch.log(reduce_from_tensor_model_parallel_region(logits.exp().sum(dim=-1)))
    loss = logz - pred
    if label_smoothing > 0.0:
        mean_logit = reduce_from_tensor_model_parallel_region(logits.sum(dim=-1)) / vocab_total
        loss = (1.0 - label_smoothing) * loss + label_smoothing * (logz - mean_logit)
    return torch.where(valid, loss, torch.zeros_like(loss))


def parallel_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Per-token cross-entropy (...), fp32. Under tensor parallelism
    ``logits`` is this rank's (..., V/tp) vocab slice (reference
    ``parallel_cross_entropy``, loss_functions.py:133); at tp = 1 the whole
    vocab, and this is :func:`cross_entropy`."""
    if parallel_state.tensor_parallel_size_or(1) == 1:
        return cross_entropy(logits, labels, label_smoothing)
    return _vocab_parallel_xent_body(logits.float(), labels, label_smoothing)


def vocab_size_of(logits: torch.Tensor) -> int:
    """The whole vocab of a (tp-sliced) logits tensor."""
    return logits.shape[-1] * parallel_state.tensor_parallel_size_or(1)


def fused_linear_cross_entropy(
    hidden: torch.Tensor,
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    labels: torch.Tensor,
    chunk_size: int = 512,
    label_smoothing: float = 0.0,
    vocab_parallel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of per-token CE and the valid-token count (fp32 scalars),
    running the LM head ``logits_fn(h_chunk) -> (B, c, V or V/tp)`` over
    sequence chunks of ``chunk_size``. While autograd records, each chunk
    runs under ``torch.utils.checkpoint``, so one chunk's logits are alive
    at a time and the backward recomputes them (for Llama-3.2 1B at batch 12
    and chunk 256, one chunk's fp32 logits are 1.6 GB; all 8 would be 12.6
    GB). ``hidden`` (B, T, H), ``labels`` (B, T). With ``vocab_parallel``
    False the logits are the whole vocab on every rank (a row-parallel
    head's), and each chunk takes the plain CE."""

    def chunk(hc: torch.Tensor, lc: torch.Tensor):
        logits = logits_fn(hc)
        if vocab_parallel:
            per_tok = parallel_cross_entropy(logits, lc, label_smoothing)
            vocab = vocab_size_of(logits)
        else:
            per_tok, vocab = cross_entropy(logits, lc, label_smoothing), logits.shape[-1]
        valid = valid_token_mask(lc, vocab).float()
        return (per_tok * valid).sum(), valid.sum()

    dev = hidden.device
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    count = torch.zeros((), dtype=torch.float32, device=dev)
    for s0 in range(0, hidden.shape[1], chunk_size):
        hc, lc = hidden[:, s0:s0 + chunk_size], labels[:, s0:s0 + chunk_size]
        if torch.is_grad_enabled():
            s, n = checkpoint(chunk, hc, lc, use_reentrant=False)
        else:
            s, n = chunk(hc, lc)
        loss_sum = loss_sum + s
        count = count + n
    return loss_sum, count
