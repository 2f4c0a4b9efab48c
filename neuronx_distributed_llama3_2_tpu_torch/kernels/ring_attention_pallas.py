"""The kernel ring: exact attention over a cp-sharded sequence on K1-K3.

Counterpart of ``neuronx_distributed_llama3_2_tpu/kernels/ring_attention_pallas.py``.
There is no kernel of its own here: each ring step runs the port's
:func:`..flash_attention.flash_fwd` / :func:`..flash_attention.flash_bwd`,
which launch K1 (``csrc/flash_fwd.cu``) and K2 / K3 (``csrc/flash_bwd.cu``)
on CUDA tensors and run their plain versions on CPU tensors, so the
launch counters ``fwd_launches``, ``bwd_dq_launches`` and
``bwd_dkv_launches`` count every ring launch.

- **Forward** (contiguous layout, :class:`_RingFlash`): the resident chunk
  is the only causal call; a visiting chunk is either in the past (a full
  call) or in the future (skipped, no launch). Chunk outputs merge in fp32
  by their log-sum-exp (:func:`_merge`).
- **Backward**: the ring-flash decomposition. With the global (o, lse) of
  the forward, dq of the local queries and dk / dv of each visiting chunk
  are one :func:`flash_bwd` call per (q, visiting chunk) pair. The fp32
  dk / dv accumulators travel round the ring with their chunks and take one
  last hop home.
- **Zigzag** (:class:`_ZigzagFlash`): rank i holds the half-chunks
  ``(i, 2cp-1-i)`` of a 2cp-way split (:func:`zigzag_permutation`), so each
  visit is two half-chunk calls on every rank and the causal work is even
  over the ring.

The rotation is :func:`..parallel.mappings.ring_shift` (K and V stacked
into one tensor a step, dK and dV into another), over the process group
the caller passes: the cp group of the mesh.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from neuronx_distributed_llama3_2_tpu_torch.kernels.flash_attention import (
    DEFAULT_BLOCK_KV,
    DEFAULT_BLOCK_Q,
    flash_bwd,
    flash_fwd,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import ring_shift

NEG_INF = float("-inf")


def _merge(o1, lse1, o2, lse2):
    """lse-weighted combine of two normalized attention outputs: o fp32
    (B, N, S, D), lse fp32 (B, N, S). A skipped or fully masked
    contribution carries lse = -inf and a zero weight."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(m == NEG_INF, 0.0, m)
    a1 = torch.where(lse1 == NEG_INF, 0.0, torch.exp(lse1 - m_safe))
    a2 = torch.where(lse2 == NEG_INF, 0.0, torch.exp(lse2 - m_safe))
    l = a1 + a2
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (o1 * a1[..., None] + o2 * a2[..., None]) / l_safe[..., None]
    lse = torch.where(l == 0.0, NEG_INF, m_safe + torch.log(l_safe))
    return o, lse


def _fwd_chunk(q, kc, vc, causal, sm_scale, block_q, block_kv):
    """One chunk's K1 call: its output in fp32 (rounded to q's dtype by the
    kernel first, as JAX's ``_fwd_chunk``) and its lse."""
    o, lse = flash_fwd(q, kc, vc, None, causal, sm_scale, block_q, block_kv)
    return o.float(), lse


def _skip_like(q):
    """The contribution of a chunk that is skipped: o = 0, lse = -inf."""
    b, n, s, _ = q.shape
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full((b, n, s), NEG_INF, dtype=torch.float32, device=q.device))


def _ring(group) -> Tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


# ---------------------------------------------------------------------------
# contiguous ring
# ---------------------------------------------------------------------------

class _RingFlash(torch.autograd.Function):
    """JAX ``_ring_pallas_bnsd`` (its ``_ring_fwd`` and ``_ring_bwd_rule``)
    on (B, N, S/cp, D) local chunks."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, block_q, block_kv):
        cp, idx = _ring(group)
        sm_scale = q.shape[-1] ** -0.5
        # the resident chunk: the only causal call of the ring
        o, lse = _fwd_chunk(q, k, v, causal, sm_scale, block_q, block_kv)
        kv = torch.stack((k, v))
        for r in range(1, cp):
            kv = ring_shift(kv, group)
            # the visiting chunk (idx - r) % cp is in the future iff idx < r:
            # it contributes nothing, and no kernel is launched for it
            if causal and idx < r:
                o_r, lse_r = _skip_like(q)
            else:
                o_r, lse_r = _fwd_chunk(q, kv[0], kv[1], False, sm_scale, block_q, block_kv)
            o, lse = _merge(o, lse, o_r, lse_r)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group = group
        ctx.args = (causal, sm_scale, block_q, block_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group = ctx.group
        causal, sm_scale, block_q, block_kv = ctx.args
        cp, idx = _ring(group)
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, None, causal, sm_scale, block_q, block_kv)
        dq = dq.float()
        dkv = torch.stack((dk, dv)).float()
        kv = torch.stack((k, v))
        for r in range(1, cp):
            # the dk / dv accumulators travel with their chunk
            kv = ring_shift(kv, group)
            dkv = ring_shift(dkv, group)
            if causal and idx < r:
                continue
            dq_r, dk_r, dv_r = flash_bwd(q, kv[0], kv[1], o, lse, do, None, False, sm_scale,
                                         block_q, block_kv)
            dq += dq_r.float()
            dkv[0] += dk_r.float()
            dkv[1] += dv_r.float()
        # cp - 1 rotations in the loop leave each chunk one hop from home
        dkv = ring_shift(dkv, group)
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None, None, None, None


# ---------------------------------------------------------------------------
# zigzag ring
# ---------------------------------------------------------------------------

def zigzag_permutation(seq_len: int, cp: int, device=None):
    """(perm, inv), int64 index tensors: ``x.index_select(1, perm)`` puts a
    contiguous (B, S, ...) tensor in the zigzag layout, whose contiguous
    split over cp gives rank i the half-chunks ``(i, 2cp-1-i)`` of a
    2cp-way split; ``index_select(1, inv)`` undoes it."""
    if seq_len % (2 * cp):
        raise ValueError(f"seq_len {seq_len} not divisible by 2*cp={2 * cp}")
    h = seq_len // (2 * cp)
    order = []
    for i in range(cp):
        order.extend(range(i * h, (i + 1) * h))
        j = 2 * cp - 1 - i
        order.extend(range(j * h, (j + 1) * h))
    perm = np.asarray(order, np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq_len)
    return torch.as_tensor(perm, device=device), torch.as_tensor(inv, device=device)


def _halves(x):
    """The early and late half-chunks of a (B, N, S, ...) local chunk, each
    contiguous (K1-K3 read contiguous operands)."""
    h = x.shape[2] // 2
    return x[:, :, :h].contiguous(), x[:, :, h:].contiguous()


class _ZigzagFlash(torch.autograd.Function):
    """JAX ``_zigzag_pallas_bnsd`` (its ``_zigzag_fwd`` and
    ``_zigzag_bwd_rule``): the causal ring over the zigzag layout. Early
    halves attend only earlier early halves (ids < cp); late halves attend
    every early half and the later late halves, so each visit is exactly
    two half-chunk calls."""

    @staticmethod
    def forward(ctx, q, k, v, group, block_q, block_kv):
        cp, idx = _ring(group)
        sm_scale = q.shape[-1] ** -0.5
        qe, ql = _halves(q)
        ke, kl = _halves(k)
        ve, vl = _halves(v)
        # resident: early causal; late causal over its own keys and full over
        # the resident early keys (id idx < late id 2cp-1-idx)
        o_e, lse_e = _fwd_chunk(qe, ke, ve, True, sm_scale, block_q, block_kv)
        o_l, lse_l = _fwd_chunk(ql, kl, vl, True, sm_scale, block_q, block_kv)
        o_l, lse_l = _merge(o_l, lse_l, *_fwd_chunk(ql, ke, ve, False, sm_scale, block_q, block_kv))
        kv = torch.stack((k, v))
        for r in range(1, cp):
            kv = ring_shift(kv, group)
            ke_v, kl_v = _halves(kv[0])
            ve_v, vl_v = _halves(kv[1])
            # pair 1, every visit: local late x visiting early (src < 2cp-1-idx)
            o_l, lse_l = _merge(o_l, lse_l, *_fwd_chunk(ql, ke_v, ve_v, False, sm_scale,
                                                         block_q, block_kv))
            # pair 2: src < idx -> local early x visiting early; src > idx ->
            # local late x visiting late
            if (idx - r) % cp < idx:
                o_e, lse_e = _merge(o_e, lse_e, *_fwd_chunk(qe, ke_v, ve_v, False, sm_scale,
                                                             block_q, block_kv))
            else:
                o_l, lse_l = _merge(o_l, lse_l, *_fwd_chunk(ql, kl_v, vl_v, False, sm_scale,
                                                             block_q, block_kv))
        o = torch.cat([o_e, o_l], dim=2).to(q.dtype)
        lse = torch.cat([lse_e, lse_l], dim=2)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group = group
        ctx.args = (sm_scale, block_q, block_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group = ctx.group
        sm_scale, block_q, block_kv = ctx.args
        cp, idx = _ring(group)
        h = q.shape[2] // 2
        qe, ql = _halves(q)
        ke, kl = _halves(k)
        ve, vl = _halves(v)
        oe, ol = _halves(o)
        doe, dol = _halves(do)
        lse_e, lse_l = lse[:, :, :h].contiguous(), lse[:, :, h:].contiguous()

        def pair(qh, kc, vc, oh, lseh, doh, causal):
            dq, dk, dv = flash_bwd(qh, kc, vc, oh, lseh, doh, None, causal, sm_scale,
                                   block_q, block_kv)
            return dq.float(), dk.float(), dv.float()

        # the resident pairs (the forward's three resident calls)
        dqe, dke, dve = pair(qe, ke, ve, oe, lse_e, doe, True)
        dql, dkl, dvl = pair(ql, kl, vl, ol, lse_l, dol, True)
        dql2, dke2, dve2 = pair(ql, ke, ve, ol, lse_l, dol, False)
        dql += dql2
        dkv = torch.stack((torch.cat([dke + dke2, dkl], dim=2),
                           torch.cat([dve + dve2, dvl], dim=2)))
        kv = torch.stack((k, v))
        for r in range(1, cp):
            kv = ring_shift(kv, group)
            dkv = ring_shift(dkv, group)
            ke_v, kl_v = _halves(kv[0])
            ve_v, vl_v = _halves(kv[1])
            # pair 1: local late x visiting early (every visit)
            dq_a, dk_a, dv_a = pair(ql, ke_v, ve_v, ol, lse_l, dol, False)
            dql += dq_a
            dkv[0, :, :, :h] += dk_a
            dkv[1, :, :, :h] += dv_a
            # pair 2: early x early (src < idx) or late x late (src > idx)
            if (idx - r) % cp < idx:
                dq_b, dk_b, dv_b = pair(qe, ke_v, ve_v, oe, lse_e, doe, False)
                dqe += dq_b
                dkv[0, :, :, :h] += dk_b
                dkv[1, :, :, :h] += dv_b
            else:
                dq_b, dk_b, dv_b = pair(ql, kl_v, vl_v, ol, lse_l, dol, False)
                dql += dq_b
                dkv[0, :, :, h:] += dk_b
                dkv[1, :, :, h:] += dv_b
        dkv = ring_shift(dkv, group)
        dq = torch.cat([dqe, dql], dim=2)
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None, None, None


# ---------------------------------------------------------------------------
# the (B, S, N, D) entry point, on one rank's chunk
# ---------------------------------------------------------------------------

def ring_attention_pallas(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
    causal: bool = True, zigzag: bool = False,
    block_q: int = DEFAULT_BLOCK_Q, block_kv: int = DEFAULT_BLOCK_KV,
) -> torch.Tensor:
    """Exact ring attention on K1-K3 over the sequence split across
    ``group`` (the cp group), named after its JAX counterpart. q (B, S/cp,
    N, D), k / v (B, S/cp, Nkv, D) are this rank's chunks; returns its
    output chunk (B, S/cp, N, D). ``zigzag`` expects the zigzag layout
    (:func:`zigzag_permutation`) and causal attention. ``block_q`` /
    ``block_kv`` chunk the plain versions only (the CPU path)."""
    if zigzag and not causal:
        raise ValueError("zigzag balancing only applies to causal attention")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if zigzag:
        if q.shape[1] % 2:
            raise ValueError(f"the zigzag ring needs an even local chunk, got {q.shape[1]}")
        o = _ZigzagFlash.apply(qt, kt, vt, group, block_q, block_kv)
    else:
        o = _RingFlash.apply(qt, kt, vt, group, causal, block_q, block_kv)
    return o.transpose(1, 2)
