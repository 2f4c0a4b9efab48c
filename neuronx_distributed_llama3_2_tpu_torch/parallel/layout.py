"""Which part of each JAX leaf a rank holds.

The JAX package describes a parameter's distribution by the
``PartitionSpec`` its ``specs()`` gives the leaf; the port holds exactly
those shards, one process per rank, so that a weight, a gradient and an
optimizer state cross between the packages rank by rank. A
:class:`LeafSpec` is that spec with the leaf's global shape: per dim the
mesh axis it is split over (``"tp"``, ``"dp"`` for ZeRO-1's data-parallel
split, which is JAX's ``("dp", "ep")`` at ep = 1) or None. Stacked leaves
(the JAX package's ``layers`` subtree, a leading L dim) stand for the
port's per-layer tensors ``layers.<i>.<name>``. No leaf is split over cp:
parameters and ZeRO-1's state are replicated over it (JAX
``trainer/optimizer.py:85-94`` shards the state over ``("dp", "ep")``
alone), so the cp ranks of one (dp, tp) coordinate hold the same parts.
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

    def __post_init__(self):
        if len(self.spec) != len(self.shape):
            raise ValueError(f"spec {self.spec} does not match shape {self.shape}")

    def mentions(self, axis: str) -> bool:
        return axis in self.spec

    def with_dp_shard(self, dp: int) -> "LeafSpec":
        """ZeRO-1's spec of an optimizer-state leaf (JAX ``_zero1_leaf_spec``):
        dp added on the first free dim that dp divides; the leaf stays
        replicated over dp where none does."""
        if dp == 1:
            return self
        for i, (p, n) in enumerate(zip(self.spec, self.shape)):
            if p is None and n % dp == 0:
                spec = self.spec[:i] + (parallel_state.DP_AXIS,) + self.spec[i + 1:]
                return dataclasses.replace(self, spec=spec)
        return self


def mesh_coords() -> Dict[str, Tuple[int, int]]:
    """This process's (rank, size) on tp, dp and cp; (0, 1) each without
    parallel state."""
    return {
        parallel_state.TP_AXIS: (parallel_state.tensor_parallel_rank_or(0),
                                 parallel_state.tensor_parallel_size_or(1)),
        parallel_state.DP_AXIS: (parallel_state.data_parallel_rank_or(0),
                                 parallel_state.data_parallel_size_or(1)),
        parallel_state.CP_AXIS: (parallel_state.context_parallel_rank_or(0),
                                 parallel_state.context_parallel_size_or(1)),
    }


def region(leaf: LeafSpec, coords: Coords) -> Region:
    """The global index ((start, stop) per dim) of the rank's part."""
    out = []
    for axis, n in zip(leaf.spec, leaf.shape):
        if axis is None:
            out.append((0, n))
            continue
        r, s = coords.get(axis, (0, 1))
        if n % s:
            raise ValueError(f"dim of size {n} does not split over {s} ranks of {axis}")
        w = n // s
        out.append((r * w, (r + 1) * w))
    return tuple(out)


def all_regions(leaf: LeafSpec, sizes: Mapping[str, int]) -> list:
    """Every distinct region of ``leaf`` over the mesh, in the mesh's rank
    order (dp outer, tp inner): the chunk list of a multi-process
    checkpoint."""
    seen: Dict[Region, None] = {}
    tp, dp = sizes.get(parallel_state.TP_AXIS, 1), sizes.get(parallel_state.DP_AXIS, 1)
    for d in range(dp):
        for t in range(tp):
            seen.setdefault(region(leaf, {parallel_state.TP_AXIS: (t, tp),
                                          parallel_state.DP_AXIS: (d, dp)}))
    return list(seen)


def is_writer(leaf: LeafSpec, coords: Coords) -> bool:
    """Whether this rank is the lowest rank holding its region of ``leaf``
    (the one that writes it): rank 0 of every axis the leaf is replicated
    over, cp rank 0 for every leaf."""
    return all(
        coords.get(axis, (0, 1))[0] == 0
        for axis in (parallel_state.TP_AXIS, parallel_state.DP_AXIS, parallel_state.CP_AXIS)
        if not leaf.mentions(axis)
    )


def port_slice(leaf: LeafSpec, coords: Coords, layer: Optional[int]):
    """(held, index) of one port tensor: whether this rank holds it, and
    the slices that cut it out of the full per-layer (``layer`` set) or
    unstacked array."""
    reg = region(leaf, coords)
    if leaf.stacked:
        lo, hi = reg[0]
        return lo <= layer < hi, tuple(slice(a, b) for a, b in reg[1:])
    return True, tuple(slice(a, b) for a, b in reg)

