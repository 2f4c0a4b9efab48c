"""Token sampling: the host-loop path and the fused per-lane path.

Counterpart of ``neuronx_distributed_llama3_2_tpu/inference/sampling.py``
(``SamplingConfig``, ``GREEDY_TEMPERATURE``, ``sample``, ``lane_keys``,
``sample_lanes``).

- :func:`sample` — the host-loop path: a static :class:`SamplingConfig`
  and an explicit ``torch.Generator`` on the logits' device instead of a
  JAX key, so a host-sampled stream is valid but does not match the JAX
  package's draws; the greedy path (argmax, first maximum on ties, as
  ``jnp.argmax`` picks) matches exactly.
- :func:`sample_lanes` — the fused serving path
  (``PagedConfig.on_device_sampling``): per-lane ``(temperature, top_k,
  top_p)`` tensors and per-lane key *data* live on the device beside the
  tokens and positions, the token landing at sequence index ``i`` is drawn
  with ``fold_in(lane_key, i)``, and ``temperature <= 0`` is the greedy
  sentinel (exact argmax). The key is data, not a generator: the draws are
  JAX's counter-based threefry2x32 reproduced bit for bit in torch integer
  ops (:func:`threefry2x32`), and JAX's gumbel-argmax ``categorical`` over
  the same bits, so a fused sampled stream is the JAX engine's token for
  token. Every op is a plain tensor op, so the whole draw runs inside a
  captured CUDA graph.

The 32-bit words of threefry are carried in int64 tensors, each value in
``[0, 2**32)`` and masked back after every add and shift: int32 shifts
are arithmetic and most CUDA ops lack uint32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
#: "exact argmax for this lane" in :func:`sample_lanes`
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


# -- threefry2x32, as jax.random's default PRNG computes it ---------------------

_MASK32 = 0xFFFFFFFF
# the key schedule's parity constant and the two rotation sets, alternating
# every four rounds (Salmon et al., "Parallel random numbers: as easy as 1,
# 2, 3", SC 2011; JAX's _threefry2x32_lowering)
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(v: torch.Tensor, r: int) -> torch.Tensor:
    return (v << r).bitwise_and_(_MASK32).bitwise_or_(v >> (32 - r))


def threefry2x32(
    key: Tuple[torch.Tensor, torch.Tensor],
    count: Tuple[torch.Tensor, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``count``
    under the key words ``key``: int64 tensors holding 32-bit values, which
    broadcast against each other. Returns the two output words, int64 in
    ``[0, 2**32)``: JAX's ``threefry2x32_p`` bit for bit."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (count[0] + ks[0]) & _MASK32
    x1 = (count[1] + ks[1]) & _MASK32
    # x0 and x1 are fresh tensors of the broadcast shape: updated in place
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK32)
            x1 = _rotl32(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK32)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_MASK32)
    return x0, x1


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` on raw key data: ``key (..., 2)`` 32-bit words
    (int64 tensor), ``data (...)`` non-negative integers below 2**32.
    Returns the new key data (..., 2), int64: the hash of the counter
    ``(0, data)``."""
    key = key.long()
    y0, y1 = threefry2x32(
        (key[..., 0], key[..., 1]), (torch.zeros_like(key[..., 0]), data.long())
    )
    return torch.stack([y0, y1], dim=-1)


def lane_keys(rng_data: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Per-sample key data from resident key data (JAX ``lane_keys``):
    ``rng_data (N, 2)`` raw 32-bit threefry words (any integer dtype holding
    them, e.g. int64), ``index (N,)`` each sample's absolute sequence index.
    The token landing at sequence index ``i`` of a lane is ALWAYS drawn with
    ``fold_in(lane_key, i)`` — decode, prefill, chunked prefill and
    speculative verify all key by landing index, so a preempt-resume replay
    emits the identical suffix. Returns (N, 2) int64 key data."""
    return fold_in(rng_data, index)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each of ``keys (N, 2)``
    (the partitionable threefry, JAX's default): the word of element ``j``
    is ``hi ^ lo`` of the hash of the counter ``(0, j)``. Returns (N, n)
    int64 in ``[0, 2**32)``."""
    j = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    y0, y1 = threefry2x32((keys[:, :1].long(), keys[:, 1:].long()), (torch.zeros_like(j), j))
    return y0 ^ y1


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") for each of
    ``keys (N, 2)``: ``-log(-log(u))`` of the uniform ``u`` in ``[tiny, 1)``
    that JAX builds from the bits (23 mantissa bits under exponent 0, minus
    1, scaled into ``[tiny, 1)``). Returns (N, n) float32."""
    bits = random_bits(keys, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    one = torch.ones((), dtype=torch.float32, device=keys.device)
    u = torch.clamp_min(f * (one - tiny) + tiny, tiny)
    return -torch.log(-torch.log(u))


def filtered_logits(
    logits: torch.Tensor,       # (N, V) float32
    temperature: torch.Tensor,  # (N,)
    top_k: torch.Tensor,        # (N,)
    top_p: torch.Tensor,        # (N,)
) -> torch.Tensor:
    """The logits each sampled row draws from (JAX ``sample_lanes``' filter):
    divided by the temperature (1 where it is the greedy sentinel), then
    everything below the top-k threshold or the top-p cutoff set to -inf.
    One descending sort serves both filters; the top-k threshold is a
    value, so ties with the k-th value survive; top-p keeps the minimal
    prefix whose mass reaches ``top_p``, the boundary token and its ties
    included. fp32 throughout. Returns (N, V) float32."""
    v = logits.shape[-1]
    temp = temperature.float()
    safe_temp = torch.where(temp > 0, temp, torch.ones_like(temp))
    x = logits / safe_temp[:, None]
    sorted_x = torch.sort(x, dim=-1, descending=True).values
    top_k = top_k.long()
    k_eff = torch.where(top_k > 0, top_k.clamp(1, v), torch.full_like(top_k, v))
    kth = torch.gather(sorted_x, 1, (k_eff - 1)[:, None])           # (N, 1)
    neg_inf = torch.full_like(sorted_x, float("-inf"))
    sorted_masked = torch.where(sorted_x < kth, neg_inf, sorted_x)
    # jax.nn.softmax's arithmetic: exp(x - max) / sum
    e = torch.exp(sorted_masked - sorted_masked.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p.float()[:, None]
    cutoff = torch.where(keep, sorted_masked, torch.full_like(sorted_x, float("inf")))
    cutoff = cutoff.amin(dim=-1, keepdim=True)
    return torch.where((x < kth) | (x < cutoff), torch.full_like(x, float("-inf")), x)


def perturbed_logits(
    logits: torch.Tensor,       # (N, V)
    rng_data: torch.Tensor,     # (N, 2) per-sample base key data
    index: torch.Tensor,        # (N,) landing index
    temperature: torch.Tensor,  # (N,)
    top_k: torch.Tensor,        # (N,)
    top_p: torch.Tensor,        # (N,)
) -> torch.Tensor:
    """The values a sampled row takes the argmax of: the gumbel noise of
    ``fold_in(rng_data, index)`` plus :func:`filtered_logits` (JAX's
    ``categorical``: ``argmax(gumbel + logits)``). Returns (N, V) float32."""
    lf = logits.float()
    keys = lane_keys(rng_data, index)
    return gumbel(keys, lf.shape[-1]) + filtered_logits(lf, temperature, top_k, top_p)


def sample_lanes(
    logits: torch.Tensor,       # (B, V) or (B, T, V)
    rng_data: torch.Tensor,     # (B, 2) per-lane key data
    index: torch.Tensor,        # (B,) or (B, T) absolute sequence index
    temperature: torch.Tensor,  # (B,) f32; <= 0 = greedy sentinel (argmax)
    top_k: torch.Tensor,        # (B,) int; 0 = disabled, > V clamps to V
    top_p: torch.Tensor,        # (B,) f32; 1.0 = disabled
) -> torch.Tensor:
    """Per-lane fused sampling over (B, V) decode or (B, T, V) verify
    logits. Returns int32 tokens of shape ``logits.shape[:-1]``.

    JAX ``sample_lanes`` draw for draw: the filter of
    :func:`filtered_logits`, the key ``fold_in(lane_key, index)`` and the
    gumbel-argmax of :func:`perturbed_logits`. Lanes at the greedy sentinel
    (``temperature <= 0``) return the exact first-maximum argmax of the raw
    logits; they still compute the draw, as JAX's ``jnp.where`` does, so
    nothing branches on the host and one captured graph serves mixed
    greedy / sampled traffic."""
    shape = logits.shape[:-1]
    v = logits.shape[-1]
    lf = logits.float().reshape(-1, v)
    if logits.dim() == 3:
        # each lane's parameters for each of its t rows (an expand: no
        # output size to read back, so nothing syncs under a capture)
        b, t = logits.shape[:2]
        rng_data, temperature, top_k, top_p = (
            a[:, None].expand(b, t, *a.shape[1:]).reshape(b * t, *a.shape[1:])
            for a in (rng_data, temperature, top_k, top_p)
        )
    idx = torch.broadcast_to(index, shape).reshape(-1)
    pert = perturbed_logits(lf, rng_data, idx, temperature, top_k, top_p)
    sampled = torch.argmax(pert, dim=-1)
    greedy = torch.argmax(lf, dim=-1)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32).reshape(shape)
