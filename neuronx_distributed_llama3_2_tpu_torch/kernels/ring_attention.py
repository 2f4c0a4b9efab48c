"""Ring attention: context parallelism for long sequences.

Counterpart of ``neuronx_distributed_llama3_2_tpu/kernels/ring_attention.py``.
The sequence is split over the ``cp`` axis of the mesh, one process per cp
rank; each rank holds one q / k / v chunk, the k / v chunks rotate round
the ring (:func:`..parallel.mappings.ring_shift`), and each rank folds
every visiting chunk into its own queries' online-softmax state. Peak
memory is O(S/cp) a rank.

With contiguous chunks, ring step r on rank i sees the chunk of rank
``(i - r) mod cp``: a chunk wholly in the future is masked, the resident
chunk is causal, a past chunk attends fully.

- :func:`ring_attention` is the plain ring, on
  :func:`..flash_attention.blockwise_attention_stats`, differentiated by
  autograd (the rotation's backward rotates the gradient back): the
  numerics oracle, and ``impl="jnp"`` of :func:`ring_attention_sharded`.
- :mod:`.ring_attention_pallas` is the kernel ring on K1-K3, contiguous or
  zigzag (balanced causal work): the model's ring on every device (the
  kernels' plain versions on the CPU).
- :func:`resolve_cp_layout` picks the layout; the model permutes its tokens
  once when it is zigzag and declares the layout with :func:`cp_layout`
  around its layers, and attention reads it (:func:`active_cp_layout`).
- :func:`ring_attention_sharded` is the global-view entry: whole (B, S, N,
  D) tensors on every rank in, the whole output on every rank out.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch

from neuronx_distributed_llama3_2_tpu_torch.kernels.flash_attention import (
    DEFAULT_BLOCK_KV,
    blockwise_attention_stats,
)
from neuronx_distributed_llama3_2_tpu_torch.kernels.ring_attention_pallas import (
    ring_attention_pallas,
    zigzag_permutation,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import (
    gather_from_sequence_parallel_region,
    ring_shift_region,
    scatter_to_sequence_parallel_region,
)


def _merge_stats(carry, stats):
    """Combine two (acc, m, l) online-softmax states (JAX ``merge``); a
    fully masked chunk keeps m = -1e30 and its weight underflows to 0."""
    acc, m, l = carry
    a2, m2, l2 = stats
    m_new = torch.maximum(m, m2)
    alpha = torch.exp(m - m_new)
    alpha2 = torch.exp(m2 - m_new)
    return acc * alpha[..., None] + a2 * alpha2[..., None], m_new, l * alpha + l2 * alpha2


def ring_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
    causal: bool = True, kv_len: Optional[int] = None,
    block_kv: int = DEFAULT_BLOCK_KV,
) -> torch.Tensor:
    """Exact attention over the sequence split contiguously across
    ``group`` (the cp group). q (B, S/cp, N, D), k / v (B, S/cp, Nkv, D)
    are this rank's chunks; returns its output chunk (B, S/cp, N, D)."""
    cp = torch.distributed.get_world_size(group)
    idx = torch.distributed.get_rank(group)
    b, s_loc, n, d = q.shape

    def stats_for(kc, vc, r):
        # the local q against the chunk of rank (idx - r) % cp, at their
        # global offsets (JAX ``_chunk_attn_stats``)
        src = (idx - r) % cp
        return blockwise_attention_stats(q, kc, vc, causal=causal, q_off=idx * s_loc,
                                         kv_off=src * s_loc, kv_len=kv_len, block_kv=block_kv)

    acc, m, l = stats_for(k, v, 0)
    kc, vc = k, v
    for r in range(1, cp):
        # rotate first: the resident chunk was consumed above, and no dead
        # hop is paid after the last visiting chunk
        kc, vc = ring_shift_region(kc, group), ring_shift_region(vc, group)
        acc, m, l = _merge_stats((acc, m, l), stats_for(kc, vc, r))
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, s_loc, n, d).to(q.dtype)


def resolve_cp_layout(seq: int, cp: int, causal: bool = True, force: str = "auto",
                      device=None) -> str:
    """The cp sequence layout, ``"zigzag"`` or ``"contiguous"``. ``force``
    (the config's ``cp_ring_layout``) wins unless it is ``"auto"``, which
    chooses zigzag on a CUDA ``device`` for causal attention when ``seq %
    (2 * cp) == 0`` (the counterpart of JAX's rule on a TPU), and
    contiguous on the CPU (as JAX's rule does there)."""
    if force != "auto":
        if force not in ("contiguous", "zigzag"):
            raise ValueError(f"cp layout must be auto|contiguous|zigzag, got {force!r}")
        return force
    on_card = device is not None and torch.device(device).type == "cuda"
    if causal and seq % (2 * cp) == 0 and on_card:
        return "zigzag"
    return "contiguous"


# The layout the site that permuted the tokens declared around its layers;
# attention reads it. The model's checkpointed segments re-enter it when the
# backward recomputes them (models/llama.py ``_checkpoint``).
_CP_LAYOUT_STACK: list = []


@contextlib.contextmanager
def cp_layout(layout: str):
    """Declare the cp sequence layout for the attention calls inside."""
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"layout must be contiguous|zigzag, got {layout!r}")
    _CP_LAYOUT_STACK.append(layout)
    try:
        yield
    finally:
        _CP_LAYOUT_STACK.pop()


def active_cp_layout() -> str:
    return _CP_LAYOUT_STACK[-1] if _CP_LAYOUT_STACK else "contiguous"


def cp_layout_from_inv(zz_inv):
    """:func:`cp_layout` from the inverse permutation the permuting site
    holds (None: contiguous)."""
    return cp_layout("zigzag" if zz_inv is not None else "contiguous")


def ring_attention_sharded(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis_name: str,
    causal: bool = True, block_kv: int = DEFAULT_BLOCK_KV, impl: str = "auto",
    pre_permuted: bool = False,
) -> torch.Tensor:
    """Global-view entry: q (B, S, N, D) and k / v (B, S, Nkv, D) whole on
    every rank of the ``axis_name`` group of ``mesh`` (a
    ``DeviceMesh``); each rank runs the ring on its chunk and the chunks'
    outputs are all-gathered, so every rank returns the whole (B, S, N, D).
    Differentiable: each rank's input gradients are whole.

    ``impl``: ``"jnp"`` (the plain ring, :func:`ring_attention`),
    ``"pallas"`` (the kernel ring), ``"zigzag"`` (the kernel ring over the
    zigzag layout) or ``"auto"`` (zigzag where :func:`resolve_cp_layout`
    picks it, else the kernel ring); JAX's names. ``pre_permuted``: the
    inputs are already in the zigzag layout; without it the zigzag impl
    permutes them and un-permutes the output."""
    group = mesh.get_group(axis_name)
    cp = torch.distributed.get_world_size(group)
    seq = q.shape[1]
    if impl == "auto":
        impl = "pallas"
        if resolve_cp_layout(seq, cp, causal, device=q.device) == "zigzag":
            impl = "zigzag"
    if impl == "zigzag" and seq % (2 * cp):
        raise ValueError(f"zigzag ring needs seq % (2*cp) == 0, got seq={seq} cp={cp}")
    if impl == "jnp":
        fn = functools.partial(ring_attention, group=group, causal=causal, kv_len=None,
                               block_kv=block_kv)
    elif impl in ("pallas", "zigzag"):
        fn = functools.partial(ring_attention_pallas, group=group, causal=causal,
                               zigzag=impl == "zigzag", block_kv=block_kv)
    else:
        raise ValueError(f"impl must be auto|jnp|pallas|zigzag, got {impl!r}")
    inv = None
    if impl == "zigzag" and not pre_permuted:
        perm, inv = zigzag_permutation(seq, cp, device=q.device)
        q, k, v = (x.index_select(1, perm) for x in (q, k, v))
    # the rank's chunk (backward: the chunks' gradients all-gathered), the
    # ring, then every rank's output (backward: the rank's part)
    q, k, v = (scatter_to_sequence_parallel_region(x, 1, group) for x in (q, k, v))
    out = gather_from_sequence_parallel_region(fn(q, k, v), 1, group, to_model_parallel=False)
    if inv is not None:
        out = out.index_select(1, inv)
    return out
