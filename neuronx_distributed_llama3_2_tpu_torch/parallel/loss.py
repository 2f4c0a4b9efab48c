"""Cross-entropy for the LM head, single device.

Counterpart of ``neuronx_distributed_llama3_2_tpu/parallel/loss.py``. The
vocab-parallel body (the three collectives over tp-sharded logits) waits
for the multi-GPU slice: at tp = 1 :func:`parallel_cross_entropy` is
:func:`cross_entropy`, as it is in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.utils.checkpoint import checkpoint

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


def parallel_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Per-token cross-entropy over the vocab; at tensor-parallel size 1
    (the only size ported) exactly :func:`cross_entropy`."""
    return cross_entropy(logits, labels, label_smoothing)


def fused_linear_cross_entropy(
    hidden: torch.Tensor,
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    labels: torch.Tensor,
    chunk_size: int = 512,
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of per-token CE and the valid-token count (fp32 scalars),
    running the LM head ``logits_fn(h_chunk) -> (B, c, V)`` over sequence
    chunks of ``chunk_size``. While autograd records, each chunk runs under
    ``torch.utils.checkpoint``, so one chunk's logits are alive at a time
    and the backward recomputes them (for Llama-3.2 1B at batch 12 and
    chunk 256, one chunk's fp32 logits are 1.6 GB; all 8 would be 12.6 GB).
    ``hidden`` (B, T, H), ``labels`` (B, T)."""

    def chunk(hc: torch.Tensor, lc: torch.Tensor):
        logits = logits_fn(hc)
        per_tok = parallel_cross_entropy(logits, lc, label_smoothing)
        valid = valid_token_mask(lc, logits.shape[-1]).float()
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
