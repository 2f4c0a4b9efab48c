"""Token sampling on the host-loop path.

Counterpart of ``neuronx_distributed_llama3_2_tpu/inference/sampling.py``
(``SamplingConfig``, ``GREEDY_TEMPERATURE``, ``sample``). The PRNG is an
explicit ``torch.Generator`` on the logits' device instead of a JAX key, so
a sampled stream is valid but does not match the JAX package's draws; the
greedy path (argmax, first maximum on ties, as ``jnp.argmax`` picks) matches
exactly. The per-lane fused sampler (``lane_keys`` / ``sample_lanes``) comes
with the on-device-sampling sub-slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Static sampling parameters."""

    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0       # 0 = disabled
    top_p: float = 1.0   # 1.0 = disabled

    def __post_init__(self):
        if self.temperature <= 0.0:
            raise ValueError("temperature must be > 0; use greedy=True for argmax")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


#: the per-lane greedy sentinel: SamplingConfig forbids temperature <= 0,
#: so a non-positive temperature can only be engine-written and means
#: "exact argmax for this lane"
GREEDY_TEMPERATURE = 0.0


def sample(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    config: SamplingConfig,
) -> torch.Tensor:
    """Sample token ids from (..., V) logits. Returns (...,) int32.
    ``generator`` lives on the logits' device; greedy sampling draws
    nothing from it."""
    if config.greedy:
        # torch.argmax returns the first maximal index, like jnp.argmax
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / config.temperature
    if config.top_k > 0:
        k = min(config.top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if config.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the minimal prefix whose mass reaches top_p: a token is kept
        # if the cumulative mass *before* it is < top_p. The cutoff is the
        # SMALLEST kept value (the boundary token) — everything at or above
        # it survives, ties with the boundary included
        keep = (cum - probs) < config.top_p
        cutoff = torch.where(
            keep, sorted_logits, torch.full_like(sorted_logits, float("inf"))
        ).min(dim=-1).values
        logits = logits.masked_fill(logits < cutoff[..., None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    drawn = torch.multinomial(flat, 1, generator=generator)
    return drawn.reshape(probs.shape[:-1]).to(torch.int32)
