"""Which part of each JAX leaf a rank holds.

The JAX package describes a parameter's distribution by the
``PartitionSpec`` its ``specs()`` gives the leaf; the port holds exactly
those shards, one process per rank, so that a weight, a gradient and an
optimizer state cross between the packages rank by rank. A
:class:`LeafSpec` is that spec with the leaf's global shape: per dim the
mesh axis it is split over (``"tp"``; ``"ep"`` for an MoE layer's experts;
``"dp"`` for ZeRO-1's data-parallel split of a dense leaf, which is JAX's
``("dp", "ep")``: the rank's index on the (dp, ep) plane; ``"edp"`` for
ZeRO-1's split of an expert leaf, JAX's ``("dp",)``) or None. Stacked leaves
(the JAX package's ``layers`` subtree, a leading L dim) stand for the
port's per-layer tensors ``layers.<i>.<name>``. No leaf is split over cp:
parameters and ZeRO-1's state are replicated over it (JAX
``trainer/optimizer.py:85-94`` shards the state over ``("dp", "ep")``
alone), so the cp ranks of one (dp, tp) coordinate hold the same parts.

Under pipeline parallelism the layers of a stacked leaf are split over
``"pp"`` along the layer dim, in ``pp * chunks`` equal blocks of which
block ``u`` sits on pp rank ``u % pp`` (one contiguous block a stage, or
the interleaved schedule's ``chunks`` blocks: JAX ``to_pipeline``'s
``(V, pp, L/(pp·V), ...)`` layout read back in the canonical ``(L, ...)``
one). A leaf outside the layers lives on the stages that use it
(``stages``: the embedding on the first, and on the last when the head is
tied to it; the final norm and an untied head on the last), the first of
them writing it and counting it in the gradient norm.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state

Spec = Tuple[Optional[str], ...]
Region = Tuple[Tuple[int, int], ...]
#: mesh axis -> (this rank's coordinate, axis size)
Coords = Mapping[str, Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    shape: Tuple[int, ...]  # the JAX leaf's global shape (L first when stacked)
    spec: Spec              # mesh axis per dim, or None
    stacked: bool = False   # a (L, ...) stack of the port's per-layer tensors
    chunks: int = 1         # layer blocks a pp rank holds ("pp" on the layer dim)
    stages: Tuple[int, ...] = ()  # the pp ranks holding an unstacked leaf (all: ())

    def __post_init__(self):
        if len(self.spec) != len(self.shape):
            raise ValueError(f"spec {self.spec} does not match shape {self.shape}")

    def mentions(self, axis: str) -> bool:
        return axis in self.spec

    @property
    def expert(self) -> bool:
        """An MoE layer's expert leaf (split over ep)."""
        return self.mentions(parallel_state.EP_AXIS)

    @property
    def data_axis(self) -> str:
        """The axis over which the leaf is data-parallel: "edp" for an
        expert leaf, "dp" (the (dp, ep) plane) for the others."""
        return parallel_state.EDP_AXIS if self.expert else parallel_state.DP_AXIS

    def with_dp_shard(self, dp: int, edp: Optional[int] = None) -> "LeafSpec":
        """ZeRO-1's spec of an optimizer-state leaf (JAX ``_zero1_leaf_spec``):
        the leaf's data axis (``dp`` ranks, ``edp`` for an expert leaf)
        added on the first free dim that its size divides; the leaf stays
        replicated where none does."""
        n_dp = (dp if edp is None else edp) if self.expert else dp
        if n_dp == 1:
            return self
        for i, (p, n) in enumerate(zip(self.spec, self.shape)):
            if p is None and n % n_dp == 0:
                spec = self.spec[:i] + (self.data_axis,) + self.spec[i + 1:]
                return dataclasses.replace(self, spec=spec)
        return self


def mesh_coords() -> Dict[str, Tuple[int, int]]:
    """This process's (rank, size) on tp, dp (the (dp, ep) plane), cp, pp,
    ep and edp (the mesh's dp alone); (0, 1) each without parallel state."""
    return {
        parallel_state.EP_AXIS: (parallel_state.expert_parallel_rank_or(0),
                                 parallel_state.expert_parallel_size_or(1)),
        parallel_state.EDP_AXIS: (parallel_state.expert_data_parallel_rank_or(0),
                                  parallel_state.expert_data_parallel_size_or(1)),
        parallel_state.PP_AXIS: (parallel_state.pipeline_parallel_rank_or(0),
                                 parallel_state.pipeline_parallel_size_or(1)),
        parallel_state.TP_AXIS: (parallel_state.tensor_parallel_rank_or(0),
                                 parallel_state.tensor_parallel_size_or(1)),
        parallel_state.DP_AXIS: (parallel_state.data_parallel_rank_or(0),
                                 parallel_state.data_parallel_size_or(1)),
        parallel_state.CP_AXIS: (parallel_state.context_parallel_rank_or(0),
                                 parallel_state.context_parallel_size_or(1)),
    }


def _pp_blocks(leaf: LeafSpec, pp_rank: int, pp: int) -> list:
    """The (start, stop) blocks of the layer dim that pp rank ``pp_rank``
    holds, in order."""
    n = leaf.shape[0]
    blocks = pp * leaf.chunks
    if n % blocks:
        raise ValueError(f"{n} layers do not split into {pp} stages x {leaf.chunks} chunks")
    w = n // blocks
    return [(u * w, (u + 1) * w) for u in range(pp_rank, blocks, pp)]


def dim_range(leaf: LeafSpec, coords: Coords, dim: int) -> Tuple[int, int]:
    """The (start, stop) of the rank's part along one dim (not the layer dim
    of a leaf split over pp in several chunks: :func:`regions`)."""
    axis, n = leaf.spec[dim], leaf.shape[dim]
    if axis is None:
        return (0, n)
    r, s = coords.get(axis, (0, 1))
    if axis == parallel_state.PP_AXIS:
        blocks = _pp_blocks(leaf, r, s)
        if len(blocks) != 1:
            raise ValueError("a leaf split over pp in several chunks has several regions")
        return blocks[0]
    if n % s:
        raise ValueError(f"dim of size {n} does not split over {s} ranks of {axis}")
    w = n // s
    return (r * w, (r + 1) * w)


def region(leaf: LeafSpec, coords: Coords, layer: Optional[int] = None) -> Region:
    """The global index ((start, stop) per dim) of the rank's part; with
    ``layer``, of that layer's slice of a stacked leaf."""
    if layer is None:
        return tuple(dim_range(leaf, coords, i) for i in range(len(leaf.shape)))
    return ((layer, layer + 1),) + tuple(dim_range(leaf, coords, i)
                                         for i in range(1, len(leaf.shape)))


def regions(leaf: LeafSpec, coords: Coords) -> list:
    """Every region of ``leaf`` the rank holds: one, or one per layer block
    of a leaf split over pp (none on a stage without the leaf)."""
    pp_r = coords.get(parallel_state.PP_AXIS, (0, 1))[0]
    if leaf.stages and pp_r not in leaf.stages:
        return []
    if not leaf.mentions(parallel_state.PP_AXIS):
        return [region(leaf, coords)]
    rest = [dim_range(leaf, coords, i) for i in range(1, len(leaf.shape))]
    r, s = coords.get(parallel_state.PP_AXIS, (0, 1))
    return [(block, *rest) for block in _pp_blocks(leaf, r, s)]


def holds(leaf: LeafSpec, coords: Coords, layer: Optional[int] = None) -> bool:
    """Whether the rank holds any part of ``leaf`` (of layer ``layer`` of a
    stacked one)."""
    regs = regions(leaf, coords)
    if layer is None or not leaf.stacked:
        return bool(regs)
    return any(lo <= layer < hi for (lo, hi), *_ in regs)


def all_regions(leaf: LeafSpec, sizes: Mapping[str, int]) -> list:
    """Every distinct region of ``leaf`` over the mesh, in the mesh's rank
    order (pp outer, dp, tp inner; the layer blocks of a leaf split over pp
    in layer order): the chunk list of a multi-process checkpoint."""
    seen: Dict[Region, None] = {}
    tp, pp = sizes.get(parallel_state.TP_AXIS, 1), sizes.get(parallel_state.PP_AXIS, 1)
    ep = sizes.get(parallel_state.EP_AXIS, 1)
    edp = sizes.get(parallel_state.EDP_AXIS, sizes.get(parallel_state.DP_AXIS, 1) // ep)
    for p in range(pp):
        for d in range(edp):
            for e in range(ep):
                for t in range(tp):
                    coords = {parallel_state.TP_AXIS: (t, tp),
                              parallel_state.DP_AXIS: (d * ep + e, edp * ep),
                              parallel_state.EP_AXIS: (e, ep),
                              parallel_state.EDP_AXIS: (d, edp),
                              parallel_state.PP_AXIS: (p, pp)}
                    for reg in regions(dataclasses.replace(leaf, stages=()), coords):
                        seen.setdefault(reg)
    return sorted(seen) if leaf.mentions(parallel_state.PP_AXIS) else list(seen)


def pp_owner(leaf: LeafSpec, coords: Coords) -> bool:
    """Whether this pp rank is the one that writes ``leaf`` and counts it in
    the gradient norm: every stage its own layers, the first stage holding
    any other leaf."""
    pp_r = coords.get(parallel_state.PP_AXIS, (0, 1))[0]
    if leaf.mentions(parallel_state.PP_AXIS):
        return True
    return pp_r == (leaf.stages[0] if leaf.stages else 0)


def is_writer(leaf: LeafSpec, coords: Coords) -> bool:
    """Whether this rank is the lowest rank holding its region of ``leaf``
    (the one that writes it): rank 0 of every axis the leaf is replicated
    over (of its data axis, ``LeafSpec.data_axis``), cp rank 0 for every
    leaf, and the pp rank :func:`pp_owner` names."""
    return pp_owner(leaf, coords) and all(
        coords.get(axis, (0, 1))[0] == 0
        for axis in (parallel_state.TP_AXIS, leaf.data_axis, parallel_state.CP_AXIS)
        if not leaf.mentions(axis)
    )


def axis_group(axis: str):
    """The process group of a spec's axis on the live mesh: the (dp, ep)
    plane's for "dp", the mesh's dp for "edp", the mesh's own otherwise."""
    if axis == parallel_state.DP_AXIS:
        return parallel_state.get_data_parallel_group()
    if axis == parallel_state.EDP_AXIS:
        return parallel_state.get_expert_data_parallel_group()
    return parallel_state.get_parallel_state().group(axis)


def port_slice(leaf: LeafSpec, coords: Coords, layer: Optional[int]):
    """(held, index) of one port tensor: whether this rank holds it, and
    the slices that cut it out of the full per-layer (``layer`` set) or
    unstacked array."""
    if not holds(leaf, coords, layer):
        return False, ()
    reg = region(leaf, coords, layer if leaf.stacked else None)
    if leaf.stacked:
        return True, tuple(slice(a, b) for a, b in reg[1:])
    return True, tuple(slice(a, b) for a, b in reg)
