"""Parallel state: the device mesh and its process groups.

Counterpart of ``neuronx_distributed_llama3_2_tpu/parallel/state.py``. The
JAX package builds one ``jax.sharding.Mesh`` for a single controller; the
port runs one process per rank over ``torch.distributed`` (the NxD
reference's design, ``parallel_state.py:60`` ``initialize_model_parallel``)
and lays the ranks out on a :class:`torch.distributed.device_mesh.DeviceMesh`
with the JAX package's axes and order::

    (pp, dp, cp, ep, tp)   with tp innermost (stride 1)

so rank ``r`` sits at ``tp = r % tp``, ``ep = (r // tp) % ep``, ``cp = (r
// (tp * ep)) % cp``, ``dp = (r // (tp * ep * cp)) % dp`` and ``pp = r //
(dp * cp * ep * tp)``, where JAX's ``build_mesh`` puts device ``r``. Every
process group comes from the mesh (``mesh.get_group("tp")``); no module
builds its own, except the group of the first and the last pipeline stage
of each coordinate at pp > 2 (the tied embedding's gradient,
:func:`get_embedding_group`) and, at ep > 1 and dp > 1, the data-parallel
group of the dense parameters over (dp, ep) (:func:`get_data_parallel_group`).

Expert parallelism splits the data-parallel dimension as the JAX package
and the reference do (dp = dp_exp * ep, reference ``parallel_state.py:86-95``):
the ranks of one (dp, ep) plane hold different rows of the batch; a dense
parameter is replicated over all of them (its gradient summed over the
(dp, ep) group, the data-parallel rank ``dp_rank * ep + ep_rank``), and an
MoE layer's experts are split over ep and replicated over dp alone (the
expert data-parallel group, the mesh's "dp"). The cp ranks of
one (dp, tp) coordinate hold consecutive chunks of the sequence (context
parallelism, :mod:`..kernels.ring_attention`); parameters and optimizer
state are replicated over cp. The pp ranks of one (dp, cp, tp) coordinate
are the stages of one pipeline (:mod:`..pipeline`): each holds its own
layers, and they pass activations and gradients point to point
(:func:`..parallel.mappings.send_forward` and its siblings).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import torch.distributed as dist

from neuronx_distributed_llama3_2_tpu_torch.utils.device import DeviceLike, resolve_device
from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger

logger = get_logger()

PP_AXIS = "pp"
DP_AXIS = "dp"
CP_AXIS = "cp"
EP_AXIS = "ep"
TP_AXIS = "tp"
MESH_AXES = (PP_AXIS, DP_AXIS, CP_AXIS, EP_AXIS, TP_AXIS)
#: not a mesh axis: the split of an expert leaf's ZeRO-1 state over the
#: mesh's dp alone (JAX's ``("dp",)`` for expert leaves), where a dense
#: leaf's "dp" stands for the (dp, ep) plane (JAX's ``("dp", "ep")``)
EDP_AXIS = "edp"

#: the ROADMAP.md queue A item that ports each refused axis (none is left)
_WAITS_FOR: dict = {}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Degrees of parallelism, with the JAX package's fields and checks."""

    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    expert_parallel_size: int = 1
    context_parallel_size: int = 1
    sequence_parallel: bool = False

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name.endswith("_size"):
                v = getattr(self, f.name)
                if not isinstance(v, int) or v < 1:
                    raise ValueError(f"{f.name} must be a positive int, got {v!r}")
        if self.sequence_parallel and self.context_parallel_size > 1:
            raise ValueError(
                "sequence_parallel (Megatron SP over tp) and "
                "context_parallel_size > 1 both shard the sequence dim; "
                "enable one of them"
            )

    def require_ported(self) -> None:
        """Raise NotImplementedError naming the first axis above 1 that the
        port does not run yet, and the ROADMAP item that ports it."""
        for knob, item in _WAITS_FOR.items():
            if getattr(self, knob) != 1:
                raise NotImplementedError(
                    f"{knob}={getattr(self, knob)} waits for ROADMAP.md {item}"
                )


@dataclasses.dataclass
class ParallelState:
    """The mesh, its config and this process's coordinates on it."""

    mesh: "torch.distributed.device_mesh.DeviceMesh"
    config: ParallelConfig
    #: the first and the last pp rank of this rank's pipeline (the pp group
    #: itself at pp = 2; None at pp = 1)
    embedding_group: Any = None
    #: the dense parameters' data-parallel group over (dp, ep)
    data_parallel_group: Any = None

    def _size(self, axis: str) -> int:
        return self.mesh.size(MESH_AXES.index(axis))

    @property
    def tensor_parallel_size(self) -> int:
        return self._size(TP_AXIS)

    @property
    def pipeline_parallel_size(self) -> int:
        return self._size(PP_AXIS)

    @property
    def expert_parallel_size(self) -> int:
        return self._size(EP_AXIS)

    @property
    def context_parallel_size(self) -> int:
        return self._size(CP_AXIS)

    @property
    def data_parallel_size(self) -> int:
        # the reference's DP size is dp_exp * ep (parallel_state.py:86-95)
        return self._size(DP_AXIS) * self._size(EP_AXIS)

    @property
    def sequence_parallel(self) -> bool:
        return self.config.sequence_parallel

    @property
    def world_size(self) -> int:
        return self.mesh.size()

    def rank(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.mesh.get_group(axis)


_PARALLEL_STATE: Optional[ParallelState] = None


def initialize_model_parallel(
    tensor_model_parallel_size: int = 1,
    pipeline_model_parallel_size: int = 1,
    expert_model_parallel_size: int = 1,
    context_parallel_size: int = 1,
    sequence_parallel: bool = False,
    device: DeviceLike = "cuda",
) -> ParallelState:
    """Lay the ranks of the process group out on the (pp, dp, cp, ep, tp)
    mesh (reference ``parallel_state.py:60``). dp is what the world size
    leaves: ``world // (tp * pp * cp * ep)``. The process group is started
    first when it is not up (:func:`..parallel.multihost.initialize_distributed`,
    NCCL on the card, gloo when the caller asks for the CPU)."""
    global _PARALLEL_STATE
    if _PARALLEL_STATE is not None:
        raise RuntimeError(
            "parallel state already initialized; call destroy_model_parallel() first"
        )
    config = ParallelConfig(
        tensor_parallel_size=tensor_model_parallel_size,
        pipeline_parallel_size=pipeline_model_parallel_size,
        expert_parallel_size=expert_model_parallel_size,
        context_parallel_size=context_parallel_size,
        sequence_parallel=sequence_parallel,
    )
    config.require_ported()
    from neuronx_distributed_llama3_2_tpu_torch.parallel.multihost import (
        initialize_distributed,
    )

    dev = resolve_device(device)
    # the sizes are checked against the world before any group is started
    n = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", 1))
    tp, pp, ep, cp = (tensor_model_parallel_size, pipeline_model_parallel_size,
                      expert_model_parallel_size, context_parallel_size)
    if n % (tp * pp * cp) != 0:
        raise ValueError(f"world size {n} not divisible by tp*pp*cp = {tp}*{pp}*{cp}")
    dp_total = n // (tp * pp * cp)
    if dp_total % ep != 0:
        raise ValueError(
            f"data parallel size {dp_total} not divisible by expert_parallel_size {ep}"
        )
    initialize_distributed(device=dev)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(
        dev.type, (pp, dp_total // ep, cp, ep, tp), mesh_dim_names=MESH_AXES
    )
    _PARALLEL_STATE = ParallelState(mesh=mesh, config=config,
                                    embedding_group=_embedding_group(mesh, pp),
                                    data_parallel_group=_dp_ep_group(mesh))
    logger.info("initialized parallel state: mesh=%s", dict(zip(MESH_AXES, mesh.shape)))
    return _PARALLEL_STATE


def _embedding_group(mesh, pp: int):
    """This rank's group of the first and the last stage of its pipeline
    (Megatron's embedding group): none at pp = 1, the pp group at pp = 2,
    else one new group per (dp, cp, ep, tp) coordinate, which every rank
    creates in the same order."""
    if pp <= 2:
        return mesh.get_group(PP_AXIS) if pp == 2 else None
    ranks = mesh.mesh.reshape(pp, -1)
    mine = None
    for col in range(ranks.shape[1]):
        pair = [int(ranks[0, col]), int(ranks[-1, col])]
        group = dist.new_group(pair)
        if dist.get_rank() in pair:
            mine = group
    return mine


def _dp_ep_group(mesh):
    """This rank's group over the (dp, ep) plane of its (pp, cp, tp)
    coordinate: the mesh's own dp or ep group when one of the two has size
    1, else one new group per coordinate, which every rank creates in the
    same order."""
    dp, ep = mesh.size(MESH_AXES.index(DP_AXIS)), mesh.size(MESH_AXES.index(EP_AXIS))
    if ep == 1 or dp == 1:
        return mesh.get_group(DP_AXIS if ep == 1 else EP_AXIS)
    ranks = mesh.mesh.permute(0, 2, 4, 1, 3).reshape(-1, dp * ep)  # (pp·cp·tp, dp·ep)
    mine = None
    for row in ranks.tolist():
        group = dist.new_group(row)
        if dist.get_rank() in row:
            mine = group
    return mine


def model_parallel_is_initialized() -> bool:
    return _PARALLEL_STATE is not None


def get_parallel_state() -> ParallelState:
    if _PARALLEL_STATE is None:
        raise RuntimeError("parallel state not initialized; call initialize_model_parallel()")
    return _PARALLEL_STATE


def destroy_model_parallel() -> None:
    """Forget the mesh (reference ``parallel_state.py:625``). The process
    group stays up, as ``jax.distributed`` does in the JAX package."""
    global _PARALLEL_STATE
    _PARALLEL_STATE = None


# ---------------------------------------------------------------------------
# getters (reference parallel_state.py:447-622)
# ---------------------------------------------------------------------------

def get_tensor_model_parallel_size() -> int:
    return get_parallel_state().tensor_parallel_size


def get_tensor_model_parallel_rank() -> int:
    return get_parallel_state().rank(TP_AXIS)


def get_tensor_model_parallel_group():
    return get_parallel_state().group(TP_AXIS)


def get_data_parallel_size() -> int:
    """dp * ep: the ranks of one model replica's data-parallel plane."""
    return get_parallel_state().data_parallel_size


def get_data_parallel_rank() -> int:
    """``dp_rank * ep + ep_rank``: the rank's block of the batch (JAX
    shards the batch over ("dp", "ep"))."""
    st = get_parallel_state()
    return st.rank(DP_AXIS) * st.expert_parallel_size + st.rank(EP_AXIS)


def get_data_parallel_group():
    """The dense parameters' data-parallel group, over (dp, ep)."""
    return get_parallel_state().data_parallel_group


def get_expert_model_parallel_size() -> int:
    return get_parallel_state().expert_parallel_size


def get_expert_model_parallel_rank() -> int:
    return get_parallel_state().rank(EP_AXIS)


def get_expert_model_parallel_group():
    return get_parallel_state().group(EP_AXIS)


def get_expert_data_parallel_size() -> int:
    """The mesh's dp alone: the ranks holding the same experts."""
    return get_parallel_state()._size(DP_AXIS)


def get_expert_data_parallel_rank() -> int:
    return get_parallel_state().rank(DP_AXIS)


def get_expert_data_parallel_group():
    return get_parallel_state().group(DP_AXIS)


def get_context_parallel_size() -> int:
    return get_parallel_state().context_parallel_size


def get_context_parallel_rank() -> int:
    return get_parallel_state().rank(CP_AXIS)


def get_context_parallel_group():
    return get_parallel_state().group(CP_AXIS)


def get_pipeline_model_parallel_size() -> int:
    return get_parallel_state().pipeline_parallel_size


def get_pipeline_model_parallel_rank() -> int:
    return get_parallel_state().rank(PP_AXIS)


def get_pipeline_model_parallel_group():
    return get_parallel_state().group(PP_AXIS)


def is_pipeline_first_stage() -> bool:
    return pipeline_parallel_rank_or(0) == 0


def is_pipeline_last_stage() -> bool:
    return pipeline_parallel_rank_or(0) == pipeline_parallel_size_or(1) - 1


def get_pipeline_model_parallel_prev_rank() -> int:
    """The global rank of the previous stage (the last stage's for the
    first, as the interleaved schedule's chunks wrap round)."""
    pp, r = get_pipeline_model_parallel_size(), get_pipeline_model_parallel_rank()
    return dist.get_global_rank(get_pipeline_model_parallel_group(), (r - 1) % pp)


def get_pipeline_model_parallel_next_rank() -> int:
    """The global rank of the next stage (the first's for the last)."""
    pp, r = get_pipeline_model_parallel_size(), get_pipeline_model_parallel_rank()
    return dist.get_global_rank(get_pipeline_model_parallel_group(), (r + 1) % pp)


def get_embedding_group():
    """The group of the first and the last stage, which both hold the tied
    embedding and sum its gradient (:func:`_embedding_group`)."""
    return get_parallel_state().embedding_group


def pipeline_parallel_size_or(default: int = 1) -> int:
    return get_pipeline_model_parallel_size() if model_parallel_is_initialized() else default


def pipeline_parallel_rank_or(default: int = 0) -> int:
    return get_pipeline_model_parallel_rank() if model_parallel_is_initialized() else default


def tensor_parallel_size_or(default: int = 1) -> int:
    """tp size if parallel state is live, else ``default`` (the JAX
    package's rule for layers built without a mesh)."""
    return get_tensor_model_parallel_size() if model_parallel_is_initialized() else default


def tensor_parallel_rank_or(default: int = 0) -> int:
    return get_tensor_model_parallel_rank() if model_parallel_is_initialized() else default


def data_parallel_rank_or(default: int = 0) -> int:
    return get_data_parallel_rank() if model_parallel_is_initialized() else default


def data_parallel_size_or(default: int = 1) -> int:
    return get_data_parallel_size() if model_parallel_is_initialized() else default


def expert_parallel_size_or(default: int = 1) -> int:
    return get_expert_model_parallel_size() if model_parallel_is_initialized() else default


def expert_parallel_rank_or(default: int = 0) -> int:
    return get_expert_model_parallel_rank() if model_parallel_is_initialized() else default


def expert_data_parallel_size_or(default: int = 1) -> int:
    return get_expert_data_parallel_size() if model_parallel_is_initialized() else default


def expert_data_parallel_rank_or(default: int = 0) -> int:
    return get_expert_data_parallel_rank() if model_parallel_is_initialized() else default


def context_parallel_size_or(default: int = 1) -> int:
    return get_context_parallel_size() if model_parallel_is_initialized() else default


def context_parallel_rank_or(default: int = 0) -> int:
    return get_context_parallel_rank() if model_parallel_is_initialized() else default


def mesh_is_tp_only() -> bool:
    """True when the mesh's only axis above 1 is tp: then replicated serving
    state (block tables, positions) is replicated exactly and a head-split
    region covers the whole mesh. False without parallel state."""
    if _PARALLEL_STATE is None:
        return False
    return _PARALLEL_STATE.tensor_parallel_size == _PARALLEL_STATE.world_size


def kv_head_shard_size(num_kv_heads: int) -> int:
    """kv heads a rank holds: ``NKV / tp`` when tp divides, all ``NKV`` on
    the replication fallback (the per-rank pool's head count)."""
    tp = tensor_parallel_size_or(1)
    return num_kv_heads // tp if num_kv_heads % tp == 0 else num_kv_heads


def get_data_parallel_axes(expert: bool = False) -> Tuple[str, ...]:
    """Axes over which a parameter's gradients are data-parallel-reduced:
    ("dp", "ep") for dense parameters, ("dp",) for expert ones."""
    return (DP_AXIS,) if expert else (DP_AXIS, EP_AXIS)


def sequence_parallel_enabled() -> bool:
    return _PARALLEL_STATE is not None and _PARALLEL_STATE.config.sequence_parallel

