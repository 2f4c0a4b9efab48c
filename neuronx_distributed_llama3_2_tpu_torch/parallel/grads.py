"""Gradient norm and clipping, single device.

Counterpart of ``neuronx_distributed_llama3_2_tpu/parallel/grads.py``:
the global L2 norm over a dict of gradients and clipping by it. Neither
syncs with the host: the norm stays a device scalar.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Grads = Dict[str, torch.Tensor]


def global_norm(grads: Grads) -> torch.Tensor:
    """L2 norm (fp32 scalar) over every gradient, each squared in fp32."""
    leaves = list(grads.values())
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    total = sum(g.float().square().sum() for g in leaves)
    return torch.sqrt(total)


def clip_coefficient(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a global norm ``norm`` to at most
    ``max_norm``: min(1, max_norm / (norm + 1e-6))."""
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def clip_grad_norm(grads: Grads, max_norm: float) -> Tuple[Grads, torch.Tensor]:
    """Scale the gradients so their global norm is at most ``max_norm``.
    Returns (clipped, pre-clip norm); each gradient keeps its dtype."""
    norm = global_norm(grads)
    scale = clip_coefficient(norm, max_norm)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, norm
