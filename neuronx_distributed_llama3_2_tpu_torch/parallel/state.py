"""Parallel state: the device mesh and its process groups.

Counterpart of ``neuronx_distributed_llama3_2_tpu/parallel/state.py``. The
JAX package builds one ``jax.sharding.Mesh`` for a single controller; the
port runs one process per rank over ``torch.distributed`` (the NxD
reference's design, ``parallel_state.py:60`` ``initialize_model_parallel``)
and lays the ranks out on a :class:`torch.distributed.device_mesh.DeviceMesh`
with the JAX package's axes and order::

    (pp, dp, cp, ep, tp)   with tp innermost (stride 1)

so rank ``r`` sits at ``tp = r % tp``, ``cp = (r // tp) % cp``, ``dp = r //
(tp * cp)`` (pp = ep = 1), where JAX's ``build_mesh`` puts device ``r``.
Every process group comes from the mesh (``mesh.get_group("tp")``); no
module builds its own. The cp ranks of one (dp, tp) coordinate hold
consecutive chunks of the sequence (context parallelism,
:mod:`..kernels.ring_attention`); parameters and optimizer state are
replicated over cp.

Sizes above 1 of ``pp`` and ``ep`` are refused, each naming the ROADMAP
item that ports it, so they never fall through to a one-rank path.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

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

#: the ROADMAP.md queue A item that ports each refused axis
_WAITS_FOR = {
    "pipeline_parallel_size": "slice 5 item 3 (the pipeline)",
    "expert_parallel_size": "slice 5 item 4 (MoE)",
}


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
    _PARALLEL_STATE = ParallelState(mesh=mesh, config=config)
    logger.info("initialized parallel state: mesh=%s", dict(zip(MESH_AXES, mesh.shape)))
    return _PARALLEL_STATE


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
    return get_parallel_state().data_parallel_size


def get_data_parallel_rank() -> int:
    return get_parallel_state().rank(DP_AXIS)


def get_data_parallel_group():
    return get_parallel_state().group(DP_AXIS)


def get_context_parallel_size() -> int:
    return get_parallel_state().context_parallel_size


def get_context_parallel_rank() -> int:
    return get_parallel_state().rank(CP_AXIS)


def get_context_parallel_group():
    return get_parallel_state().group(CP_AXIS)


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

