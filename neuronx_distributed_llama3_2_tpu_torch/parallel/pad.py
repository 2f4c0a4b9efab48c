"""Head-count padding for tensor parallelism that does not divide the heads.

Counterpart of ``neuronx_distributed_llama3_2_tpu/parallel/pad.py`` (the
reference's ``parallel_layers/pad.py`` and the GQA ``replicate_kv`` /
``maybe_pad_interleaved`` transforms): Q/O get zero heads and the KV heads
are replicated so that tp divides both counts. The padding is exact in the
forward: a padded Q head has a zero query projection and zero output rows.
:func:`get_number_of_extra_heads` and :func:`gqa_padding_plan` are the JAX
package's own (they need no JAX); :func:`pad_llama_params_for_tp` works on
the port's full (unsharded) state dict.

The JAX package's training caveat holds here too: the replicated KV copies
are separate parameters, so training the padded model optimizes a slightly
larger parametrization than the reference (which sums the copies'
gradients). Prefer tp <= num_kv_heads for training.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger

logger = get_logger()


def get_number_of_extra_heads(num_heads: int, tp: int) -> int:
    """Heads to add so tp | num_heads (reference pad.py:10)."""
    return (-num_heads) % tp


def gqa_padding_plan(num_heads: int, num_kv_heads: int, tp: int) -> Tuple[int, int, list]:
    """(new_num_heads, new_num_kv_heads, q_slot_of_old_head).

    KV heads are replicated ``m = tp / gcd(kv, tp)`` times; each original KV
    head's group of ``g`` Q heads is split across its m copies and padded
    to ``ceil(g/m)`` slots per copy. ``q_slot_of_old_head[i]`` is the new
    position of original Q head i."""
    m = tp // math.gcd(num_kv_heads, tp)
    new_kv = num_kv_heads * m
    g = num_heads // num_kv_heads
    gq = -(-g // m)  # ceil: Q slots per KV copy
    new_n = new_kv * gq
    slots = []
    for j in range(num_kv_heads):  # original kv head
        for qi in range(g):  # its qi-th query head
            copy, pos = divmod(qi, gq)
            slots.append((j * m + copy) * gq + pos)
    return new_n, new_kv, slots


def pad_llama_params_for_tp(state_dict: Dict[str, torch.Tensor], config, tp: int):
    """Pad a full Llama state dict (the port's parameter names, per-layer
    tensors) and its config so that tp divides both head counts. Returns
    (new_config, new_state_dict); tensors that need no padding are shared."""
    n, kv, d = config.num_heads, config.num_kv_heads, config.head_dim
    if n % tp == 0 and kv % tp == 0:
        return config, state_dict
    new_n, new_kv, slots = gqa_padding_plan(n, kv, tp)
    m = new_kv // kv
    logger.warning(
        "padding GQA heads for tp=%d: q %d->%d (zero heads), kv %d->%d "
        "(replicated %dx); exact in the forward, see parallel/pad.py",
        tp, n, new_n, kv, new_kv, m,
    )
    idx = torch.tensor(slots)

    def pad_q(kernel):  # (H, n*d) -> (H, new_n*d), slot-permuted
        h = kernel.shape[0]
        out = kernel.new_zeros((h, new_n, d))
        out[:, idx.to(kernel.device)] = kernel.reshape(h, n, d)
        return out.reshape(h, new_n * d)

    def rep_kv(kernel):  # (H, kv*d) -> (H, new_kv*d), copies adjacent
        h = kernel.shape[0]
        return kernel.reshape(h, kv, d).repeat_interleave(m, dim=1).reshape(h, new_kv * d)

    def pad_o(kernel):  # (n*d, H) -> (new_n*d, H), zero rows for the pads
        h = kernel.shape[1]
        out = kernel.new_zeros((new_n, d, h))
        out[idx.to(kernel.device)] = kernel.reshape(n, d, h)
        return out.reshape(new_n * d, h)

    fix = {"attn.qkv.q_kernel": pad_q, "attn.qkv.k_kernel": rep_kv,
           "attn.qkv.v_kernel": rep_kv, "attn.o.kernel": pad_o}
    out = {}
    for name, t in state_dict.items():
        rest = name.split(".", 2)[2] if name.startswith("layers.") else None
        out[name] = fix[rest](t) if rest in fix else t
    return dataclasses.replace(config, num_heads=new_n, num_kv_heads=new_kv), out
