"""Gradient norm and clipping over sharded gradients.

Counterpart of ``neuronx_distributed_llama3_2_tpu/parallel/grads.py``
(:30-47). The JAX package's gradients are global arrays, so its norm is a
plain sum; the port's rank holds shards, and the norm is the reference's
``get_grad_norm`` (grads.py:33) with its duplicate bookkeeping: each leaf's
squares are summed on the ranks that hold a distinct part of it and
skipped on the ranks that hold a copy (``owned``: a tp-replicated leaf
counts on tp rank 0 alone, a leaf whole on every dp rank on dp rank 0
alone, a ZeRO-1 shard on its own rank, a pipeline's layer on its stage and
the tied embedding on the first stage alone), then one all-reduce sums the
parts over every rank, every pp rank's among them. Nothing syncs with the
host: the norm stays a device scalar.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import all_reduce

Grads = Dict[str, torch.Tensor]


def global_norm(grads: Grads, owned: Optional[Mapping[str, bool]] = None,
                group=None) -> torch.Tensor:
    """L2 norm (fp32 scalar) over the gradients, each squared in fp32.
    ``owned[name]`` False skips a leaf this rank holds a copy of; ``group``
    (a process group, or None for one process) sums the ranks' parts."""
    leaves = [g for k, g in grads.items() if owned is None or owned[k]]
    dev = next(iter(grads.values())).device if grads else None
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for g in leaves:
        total = total + g.float().square().sum()
    if group is not None:
        total = all_reduce(total, group)
    return torch.sqrt(total)


def clip_coefficient(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a global norm ``norm`` to at most
    ``max_norm``: min(1, max_norm / (norm + 1e-6))."""
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def clip_grad_norm(grads: Grads, max_norm: float, owned: Optional[Mapping[str, bool]] = None,
                   group=None) -> Tuple[Grads, torch.Tensor]:
    """Scale the gradients so their global norm is at most ``max_norm``.
    Returns (clipped, pre-clip norm); each gradient keeps its dtype."""
    norm = global_norm(grads, owned, group)
    scale = clip_coefficient(norm, max_norm)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, norm


def world_group():
    """The group that sums a norm's parts: every process when a group of
    several is up, else None."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None
