"""The Megatron collective regions, as autograd functions over the tp group.

Counterpart of ``neuronx_distributed_llama3_2_tpu/parallel/mappings.py``
(:38-98). JAX differentiates through its collectives; torch does not, so
each region is a ``torch.autograd.Function`` whose backward is its
forward's dual, as in the NxD reference's ``parallel_layers/mappings.py``:

===========================================  ==============  ===============
region                                       forward         backward
===========================================  ==============  ===============
copy_to_tensor_model_parallel_region         identity        all-reduce
reduce_from_tensor_model_parallel_region     all-reduce      identity
gather_from_tensor_model_parallel_region     all-gather      split
scatter_to_tensor_model_parallel_region      split           all-gather
scatter_to_sequence_parallel_region          split           all-gather
gather_from_sequence_parallel_region         all-gather      reduce-scatter
                                                             (split when the
                                                             consumer's
                                                             gradient is
                                                             already whole)
reduce_scatter_to_sequence_parallel_region   reduce-scatter  all-gather
===========================================  ==============  ===============

:func:`enter_expert_parallel_region` and :func:`exit_expert_parallel_region`
carry an MoE layer's expert buffers between the ep ranks (JAX
``all_to_all_expert_parallel`` / ``enter_`` / ``exit_expert_parallel_region``,
:116-156): a tiled all-to-all that sends rank j the buffers of its experts
and gathers every rank's tokens for this rank's own, and its inverse; the
backward of each is the other.

:func:`ring_shift` is the context-parallel ring's rotation (JAX
``lax.ppermute`` with ``perm = [(i, (i + 1) % cp)]``): rank i sends its
tensor to rank i + 1 and gets rank i - 1's, and its backward rotates the
gradient the other way.

:func:`send_forward`, :func:`recv_forward`, :func:`send_backward` and
:func:`recv_backward` carry a pipeline's stage boundary between two pp
ranks (the reference's ``pipeline/comm.py``; JAX's ``jnp.roll`` of the
stream): a send does not block, and its request is kept until
:func:`finish_sends` at the end of the step; a receive waits. Messages
between a pair of ranks are matched by their order, never by a tag (NCCL
has none), which the schedules' task lists keep
(``tests/test_torch_pipeline.py``).

Without parallel state every region is the identity and issues nothing.
Under a mesh each region issues its collective even over a group of one
rank (NCCL at world size 1 then runs, and a CUDA graph captures, the
collectives of the tp code path). Each raw collective adds one to
:data:`COLLECTIVE_COUNTS` under its name when it is issued
(``all_reduce``, ``all_gather``, ``reduce_scatter``, ``all_to_all``, ``ring_shift``,
``send_forward``, ``recv_forward``, ``send_backward``, ``recv_backward``),
so a caller can count the collectives a step (or a captured CUDA graph)
holds.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.distributed as dist

from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state

#: collectives issued, by kind (module docstring)
COLLECTIVE_COUNTS: collections.Counter = collections.Counter()


#: the tp group of a process without parallel state: one rank
_ALONE = object()


def _tp_group(group):
    if group is not None:
        return group
    if not parallel_state.model_parallel_is_initialized():
        return _ALONE
    return parallel_state.get_tensor_model_parallel_group()


def _world(group) -> int:
    return 1 if group is _ALONE else dist.get_world_size(group)


# ---------------------------------------------------------------------------
# raw collectives (reference mappings.py:42-163)
# ---------------------------------------------------------------------------

def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or ``op``) of ``x`` over ``group``, in a new tensor."""
    if group is _ALONE:
        return x
    out = x.contiguous().clone()
    COLLECTIVE_COUNTS["all_reduce"] += 1
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, in rank order."""
    if group is _ALONE:
        return x
    n = _world(group)
    dim = dim % x.dim()
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=x.dtype, device=x.device)
    COLLECTIVE_COUNTS["all_gather"] += 1
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of the ranks' ``x``, split along ``dim``; this rank's part."""
    if group is _ALONE:
        return x
    n = _world(group)
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} not divisible by {n} ranks")
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=x.dtype, device=x.device)
    COLLECTIVE_COUNTS["reduce_scatter"] += 1
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal part of ``x`` along ``dim`` (no communication)."""
    n = _world(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} not divisible by {n} ranks")
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


def ring_transport(group) -> str:
    """How :func:`ring_shift` moves a tensor over ``group``'s backend:
    ``"send_recv"`` (``batch_isend_irecv`` pairs) under NCCL;
    ``"all_gather"`` otherwise, since gloo's point-to-point refuses CUDA
    tensors (``writev ... Bad address`` on an H100, torch 2.11:
    ``chip_trials/gloo_p2p_trial.py``) while its all-gather carries them.
    At two ranks the all-gather moves the bytes a send would. The CPU
    takes the transport the card's gloo ranks take."""
    return "send_recv" if dist.get_backend(group) == "nccl" else "all_gather"


def ring_shift(x: torch.Tensor, group, hops: int = 1) -> torch.Tensor:
    """What rank ``i - hops`` (mod the group's size) of ``group`` holds as
    ``x``, on rank ``i`` (every rank sends its ``x`` to rank ``i + hops``).
    Not differentiable: see :func:`ring_shift_region`."""
    n = _world(group)
    hops %= n
    if hops == 0:
        return x
    i = dist.get_rank(group)
    COLLECTIVE_COUNTS["ring_shift"] += 1
    if ring_transport(group) == "all_gather":
        src = x.contiguous().unsqueeze(0)
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, src, group=group)
        return out[(i - hops) % n]
    src = x.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, dist.get_global_rank(group, (i + hops) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (i - hops) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


# ---------------------------------------------------------------------------
# the expert-parallel all-to-all (reference mappings.py:311-486)
# ---------------------------------------------------------------------------

def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """Tiled all-to-all over ``group`` (JAX ``lax.all_to_all(...,
    tiled=True)``): ``x`` cut into n equal blocks along ``split_dim``,
    block j sent to rank j; the n blocks received, in rank order,
    concatenated along ``concat_dim``. One ``all_to_all_single`` on the
    tensor where it lies: NCCL's, or gloo's, which carries CUDA tensors as
    well as CPU ones (bit for bit on an H100, torch 2.11:
    ``chip_trials/gloo_a2a_trial.py``)."""
    n = _world(group)
    if n == 1:
        return x
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of shape {tuple(x.shape)} not divisible by {n} ranks")
    COLLECTIVE_COUNTS["all_to_all"] += 1
    # blocks leading: (n, ..., shape[split] / n, ...)
    src = x.unflatten(split_dim, (n, -1)).movedim(split_dim, 0).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    # block j, from rank j, concatenated in rank order along concat_dim
    return out.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


# ---------------------------------------------------------------------------
# the pipeline's stage boundary (reference pipeline/comm.py)
# ---------------------------------------------------------------------------

def pp_transport(group) -> str:
    """How a stage boundary's tensor moves over ``group``'s backend:
    ``"send_recv"`` (``isend`` / ``irecv`` of the tensor itself) under
    NCCL; ``"host_send_recv"`` otherwise: gloo's point-to-point refuses
    CUDA tensors (``chip_trials/gloo_p2p_trial.py``) and carries CPU ones,
    so the tensor is copied to a host buffer first and the receiver copies
    it back to its device. The CPU takes the card's gloo path."""
    return "send_recv" if dist.get_backend(group) == "nccl" else "host_send_recv"


#: the sends of the step in flight: (request, buffer), kept alive until
#: :func:`finish_sends`
_PENDING_SENDS: list = []


def _send(x: torch.Tensor, dst: int, group, kind: str) -> None:
    COLLECTIVE_COUNTS[kind] += 1
    buf = x.detach().contiguous()
    if pp_transport(group) == "host_send_recv":
        buf = buf.to("cpu", copy=True)
    _PENDING_SENDS.append((dist.isend(buf, dst, group=group), buf))


def _recv(shape, dtype, device, src: int, group, kind: str) -> torch.Tensor:
    COLLECTIVE_COUNTS[kind] += 1
    host = pp_transport(group) == "host_send_recv"
    buf = torch.empty(tuple(shape), dtype=dtype, device="cpu" if host else device)
    dist.irecv(buf, src, group=group).wait()
    return buf.to(device) if host else buf


def send_forward(x: torch.Tensor, dst: int, group) -> None:
    """Send a stage's output to the next stage's global rank ``dst``."""
    _send(x, dst, group, "send_forward")


def recv_forward(shape, dtype, device, src: int, group) -> torch.Tensor:
    """The previous stage's output (from global rank ``src``), on
    ``device``; waits for it."""
    return _recv(shape, dtype, device, src, group, "recv_forward")


def send_backward(g: torch.Tensor, dst: int, group) -> None:
    """Send the gradient of a stage's input to the previous stage."""
    _send(g, dst, group, "send_backward")


def recv_backward(shape, dtype, device, src: int, group) -> torch.Tensor:
    """The gradient of this stage's output from the next stage; waits."""
    return _recv(shape, dtype, device, src, group, "recv_backward")


def finish_sends() -> None:
    """Wait for every send in flight (the end of a step)."""
    while _PENDING_SENDS:
        req, _ = _PENDING_SENDS.pop(0)
        req.wait()


# ---------------------------------------------------------------------------
# autograd regions
# ---------------------------------------------------------------------------

class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_shift(x, group)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, ctx.group, -1), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return all_to_all(g, concat_dim, split_dim, ctx.group), None, None, None


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    """all-gather forward; split (``dual="split"``) or reduce-scatter
    backward."""

    @staticmethod
    def forward(ctx, x, dim, group, dual):
        ctx.dim, ctx.group, ctx.dual = dim, group, dual
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.dual == "split":
            return split(g, ctx.dim, ctx.group), None, None, None
        return reduce_scatter(g, ctx.dim, ctx.group), None, None, None


class _ScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return split(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _ReduceScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


def _trivial(group) -> bool:
    return group is _ALONE


# TP regions (reference mappings.py:165-235)

def copy_to_tensor_model_parallel_region(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity forward, all-reduce backward (reference :165)."""
    group = _tp_group(group)
    return x if _trivial(group) else _CopyToRegion.apply(x, group)


def reduce_from_tensor_model_parallel_region(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce partial sums over tp; identity backward (reference :183)."""
    group = _tp_group(group)
    return x if _trivial(group) else _ReduceFromRegion.apply(x, group)


def gather_from_tensor_model_parallel_region(
    x: torch.Tensor, dim: int = -1, group=None
) -> torch.Tensor:
    """All-gather shards along ``dim``; backward keeps this rank's part
    (reference :219)."""
    group = _tp_group(group)
    return x if _trivial(group) else _GatherFromRegion.apply(x, dim, group, "split")


def scatter_to_tensor_model_parallel_region(
    x: torch.Tensor, dim: int = -1, group=None
) -> torch.Tensor:
    """Keep this rank's part of ``dim``; all-gather backward (reference :201)."""
    group = _tp_group(group)
    return x if _trivial(group) else _ScatterToRegion.apply(x, dim, group)


# sequence-parallel regions (reference mappings.py:237-308): the sequence
# dim is sharded over the tp group

def scatter_to_sequence_parallel_region(
    x: torch.Tensor, dim: int = 1, group=None
) -> torch.Tensor:
    """Enter the SP region (reference :237)."""
    group = _tp_group(group)
    return x if _trivial(group) else _ScatterToRegion.apply(x, dim, group)


def gather_from_sequence_parallel_region(
    x: torch.Tensor, dim: int = 1, group=None, to_model_parallel: bool = True,
) -> torch.Tensor:
    """Leave the SP region (reference :255): all-gather forward,
    reduce-scatter backward, since a model-parallel consumer's gradient is a
    partial sum on each rank. ``to_model_parallel=False`` when the consumer
    gives every rank the whole gradient: the backward then splits."""
    group = _tp_group(group)
    if _trivial(group):
        return x
    return _GatherFromRegion.apply(
        x, dim, group, "reduce_scatter" if to_model_parallel else "split"
    )


def reduce_scatter_to_sequence_parallel_region(
    x: torch.Tensor, dim: int = 1, group=None
) -> torch.Tensor:
    """Reduce partial sums and scatter along the sequence; all-gather
    backward (reference :292)."""
    group = _tp_group(group)
    return x if _trivial(group) else _ReduceScatterToRegion.apply(x, dim, group)


def all_reduce_max(x: torch.Tensor, group: Optional[object] = None) -> torch.Tensor:
    """Elementwise max over the tp group, without a gradient (the stable
    shift of the vocab-parallel softmax)."""
    return all_reduce(x.detach(), _tp_group(group), op=dist.ReduceOp.MAX)


def ring_shift_region(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`ring_shift` by one rank with its dual backward (the gradient
    rotated one rank back), for the plain ring that autograd
    differentiates."""
    return x if _world(group) == 1 else _RingShift.apply(x, group)


# expert-parallel regions (reference mappings.py:412-486)

def enter_expert_parallel_region(x: torch.Tensor, group) -> torch.Tensor:
    """(E, C, H) -> (E/ep, ep·C, H): each ep rank receives every rank's
    tokens for its own experts (reference :412); the backward is the exit."""
    n = _world(group)
    if x.shape[0] % n:
        raise ValueError(f"num experts {x.shape[0]} not divisible by ep {n}")
    return x if n == 1 else _AllToAll.apply(x, 0, 1, group)


def exit_expert_parallel_region(x: torch.Tensor, group) -> torch.Tensor:
    """Inverse of :func:`enter_expert_parallel_region` (reference :452):
    (E/ep, ep·C, H) -> (E, C, H), each rank's outputs back to the rank
    whose tokens they are."""
    return x if _world(group) == 1 else _AllToAll.apply(x, 1, 0, group)
