"""Model-parallel random streams.

Counterpart of ``neuronx_distributed_llama3_2_tpu/parallel/random.py``
(:31-41) and the reference's ``model_parallel_xla_manual_seed``
(``random.py:100``): two ``torch.Generator`` streams per rank,

- :func:`data_parallel_generator`: the shared stream, the same on every tp
  rank (dropout on replicated activations);
- :func:`tensor_parallel_generator`: seeded ``seed + 2718 + tp_rank``, so
  each tp rank draws its own stream (dropout on sharded activations).

Weights are not drawn from either: every rank draws each whole tensor from
the seeded generator and keeps its slice (``parallel/layers.py``), so the
weights are the tp = 1 weights whatever tp is.
"""

from __future__ import annotations

import torch

from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.utils.device import DeviceLike, resolve_device

_MODEL_PARALLEL_FOLD = 2718  # the reference's seed offset (random.py:100)


def tensor_parallel_generator(seed: int, device: DeviceLike = "cuda") -> torch.Generator:
    """This tp rank's own stream."""
    rank = parallel_state.tensor_parallel_rank_or(0)
    return torch.Generator(device=resolve_device(device)).manual_seed(
        seed + _MODEL_PARALLEL_FOLD + rank
    )


def data_parallel_generator(seed: int, device: DeviceLike = "cuda") -> torch.Generator:
    """The stream every tp rank shares."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)
