"""Process bootstrap and coordination.

Counterpart of ``neuronx_distributed_llama3_2_tpu/parallel/multihost.py``.
Where the JAX package starts ``jax.distributed``, the port starts a
``torch.distributed`` process group:

- :func:`initialize_distributed`: ``init_process_group`` from ``torchrun``'s
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``)
  or from explicit arguments; one process with none of them gets a group of
  one over an in-memory store. NCCL on the card, gloo when the caller asks
  for the CPU or names gloo. Idempotent. A failed NCCL init raises: it never
  becomes gloo.
- :func:`is_coordinator`, :func:`sync_global_devices` (a barrier) and
  :func:`broadcast_from_host0` (a small object from rank 0 to every rank).
- :func:`spawn_gloo_ranks`: several ranks of one function on this host,
  started by ``torch.multiprocessing`` and joined over gloo (what the
  scripts run on the CPU instead of ``torchrun``).
"""

from __future__ import annotations

import gc
import os
import pickle
import tempfile
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from neuronx_distributed_llama3_2_tpu_torch.utils.device import DeviceLike, resolve_device
from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger

logger = get_logger()


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> None:
    """Start the process group, unless it is up already.

    ``device`` picks the backend (NCCL for the card, gloo for the CPU) unless
    ``backend`` names one. On the card each process takes device
    ``LOCAL_RANK % device_count``. Without ``init_method`` the group comes
    from the environment ``torchrun`` sets; without that either, it is a
    group of one."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if world_size not in (None, 1):
            raise ValueError(
                f"world_size={world_size} needs an init_method or torchrun's environment"
            )
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        if world_size is None and "WORLD_SIZE" in os.environ:
            world_size = int(os.environ["WORLD_SIZE"])
        if rank is None and "RANK" in os.environ:
            rank = int(os.environ["RANK"])
        kw = {}
        if world_size is not None:
            kw["world_size"] = world_size
        if rank is not None:
            kw["rank"] = rank
        dist.init_process_group(backend, init_method=init_method or "env://", **kw)
    logger.info("process group up: rank %d of %d over %s",
                dist.get_rank(), dist.get_world_size(), dist.get_backend())


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the process that writes the files and the logs (rank 0)."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def sync_global_devices(name: str) -> None:
    """A barrier over every process (the reference's checkpoint
    rendezvous). ``name`` labels the point for a reader of the code."""
    del name
    if world_size() > 1:
        dist.barrier()


def broadcast_from_host0(obj: Any, group=None) -> Any:
    """``obj`` as rank 0 (of ``group``, every process by default) has it,
    on every process of the group (a small picklable object: the
    reference's python-object side channel)."""
    if world_size() == 1 or (group is not None and dist.get_world_size(group) == 1):
        return obj
    box = [obj]
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def spawn_gloo_ranks(fn: Callable, nproc: int, *args, device: DeviceLike = "cpu",
                     tmp_dir: Optional[str] = None) -> List[Any]:
    """``fn(rank, nproc, *args)`` in ``nproc`` spawned processes, each in a
    gloo process group of ``nproc`` ranks joined through a file under a
    fresh temporary directory (under ``tmp_dir`` if given), on ``device``
    (the CPU, or the card each rank shares); their return values, by rank.
    ``fn`` must be importable by name (a module-level function), and what
    it returns picklable. A rank that raises fails the call."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="pg", dir=tmp_dir) as d:
        mp.spawn(_spawned_rank, args=(fn, nproc, d, str(device), args), nprocs=nproc,
                 join=True)
        out = []
        for r in range(nproc):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _spawned_rank(rank: int, fn: Callable, nproc: int, d: str, device: str, args) -> None:
    initialize_distributed(f"file://{d}/pg", nproc, rank, backend="gloo", device=device)
    try:
        result = fn(rank, nproc, *args)
        with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state

        # release the mesh's groups while the interpreter is whole: a gloo
        # group still referenced at exit is torn down after the threads it
        # joins, and the process aborts ("terminate called without an
        # active exception")
        parallel_state.destroy_model_parallel()
        gc.collect()
        dist.destroy_process_group()


def require_capturable_collectives(what: str) -> None:
    """Raise unless the process group's collectives can be captured in a
    CUDA graph (NCCL can; gloo cannot, and a graph would leave them out)."""
    if world_size() > 1 and dist.get_backend() != "nccl":
        raise RuntimeError(
            f"{what} captures CUDA graphs, which hold the tensor-parallel "
            f"collectives only over NCCL; this process group runs over "
            f"{dist.get_backend()}"
        )
