"""Tokenized-dataset loading with deterministic, resumable batches.

Counterpart of ``neuronx_distributed_llama3_2_tpu/data/dataset.py``: the
mmap'd ``.npy`` token stream (:class:`TokenDataset`), the per-epoch seeded
shuffle with resume at any step and the ``sample_range`` holdout
(:class:`DistributedDataLoader`), batch for batch the JAX package's. The
loader yields numpy batches; :func:`batch_to_device` puts one on the card.

Over several processes each data-parallel rank reads only its rows of
each global batch: dp rank r the r-th of dp contiguous blocks, the JAX
package's ``process_index`` split with the dp rank in the place of the
process (the tp, cp and pp ranks of one dp rank read the same rows: the
first stage of a pipeline its tokens, the last its labels). The position
(:class:`LoaderState`) is the same on every rank, so each resumes its own
rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.multihost import world_size
from neuronx_distributed_llama3_2_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)


class TokenDataset:
    """A flat token stream stored as one ``.npy`` array (any int dtype),
    cut into fixed-length samples. Memory-mapped: arbitrarily large files
    cost no host RAM."""

    def __init__(self, path: str, seq_len: int):
        self.tokens = np.load(path, mmap_mode="r")
        if self.tokens.ndim != 1:
            raise ValueError(
                f"token file must be a 1-D stream, got shape {self.tokens.shape}"
            )
        self.seq_len = seq_len

    def __len__(self) -> int:
        return len(self.tokens) // self.seq_len

    def __getitem__(self, i: int) -> np.ndarray:
        s = self.seq_len
        return np.asarray(self.tokens[i * s : (i + 1) * s], dtype=np.int32)


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write a token stream (the synthetic-dataset helper used by tests and
    the pretrain example's --synthetic mode)."""
    np.save(path, np.asarray(tokens))


@dataclasses.dataclass
class LoaderState:
    """Resumable position (reference: DistributedSampler.set_epoch + batch
    skip on resume)."""

    step: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {"step": self.step}

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "LoaderState":
        return LoaderState(step=int(obj.get("step", 0)))


class DistributedDataLoader:
    """Yields (global_batch_size, seq_len) int32 batches forever.

    Determinism: sample order within epoch e is ``rng(seed + e)``'s
    permutation; a loader resumed at step k yields exactly the batches the
    original would have yielded from step k.
    """

    def __init__(
        self,
        dataset: TokenDataset,
        global_batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        state: Optional[LoaderState] = None,
        sample_range: Optional[Tuple[int, int]] = None,
    ):
        """``sample_range=(lo, hi)`` restricts the loader to dataset samples
        [lo, hi) — the train/eval holdout split (the reference holds out a
        separate hdf5 shard; here two loaders over disjoint ranges of one
        token stream give the same guarantee)."""
        lo, hi = sample_range if sample_range is not None else (0, len(dataset))
        if not (0 <= lo < hi <= len(dataset)):
            raise ValueError(
                f"sample_range {sample_range} invalid for dataset of "
                f"{len(dataset)} samples"
            )
        if hi - lo < global_batch_size:
            raise ValueError(
                f"sample range has {hi - lo} samples < global batch "
                f"{global_batch_size}"
            )
        self.dataset = dataset
        self.gbs = global_batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.state = state or LoaderState()
        self.range_lo, self.range_hi = lo, hi
        self.steps_per_epoch = (hi - lo) // global_batch_size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        # cached per epoch: the permutation is O(dataset) and must not run
        # on the synchronous host path of every step
        cached = getattr(self, "_order_cache", None)
        if cached is not None and cached[0] == epoch:
            return cached[1]
        n = self.steps_per_epoch * self.gbs
        if not self.shuffle:
            order = np.arange(self.range_lo, self.range_lo + n)
        else:
            order = self.range_lo + np.random.default_rng(
                self.seed + epoch
            ).permutation(self.range_hi - self.range_lo)[:n]
        self._order_cache = (epoch, order)
        return order

    def _step_indices(self, step: int, rows: Optional[slice]) -> np.ndarray:
        epoch, within = divmod(step, self.steps_per_epoch)
        order = self._epoch_order(epoch)
        idx = order[within * self.gbs : (within + 1) * self.gbs]
        return idx if rows is None else idx[rows]

    def batch_at(self, step: int, rows: Optional[slice] = None) -> np.ndarray:
        """Global batch for ``step``; pass ``rows`` to materialize only a
        row range."""
        idx = self._step_indices(step, rows)
        # native path: one C++ gather call instead of a python row loop
        if hasattr(self.dataset, "gather"):
            return self.dataset.gather(np.asarray(idx, np.int64))
        return np.stack([self.dataset[int(i)] for i in idx])

    def rows(self) -> Optional[slice]:
        """This process's rows of each global batch: its dp rank's block
        (None, the whole batch, on one process); the tp, cp and pp ranks of
        one dp rank read the same rows."""
        if world_size() == 1:
            return None
        if not parallel_state.model_parallel_is_initialized():
            raise RuntimeError(
                "a data loader over several processes reads the rows of its dp "
                "rank: call initialize_model_parallel (or TrainingConfig."
                "initialize) first"
            )
        dp = parallel_state.get_data_parallel_size()
        if self.gbs % dp != 0:
            raise ValueError(f"global batch {self.gbs} not divisible by {dp} dp ranks")
        per = self.gbs // dp
        r = parallel_state.get_data_parallel_rank()
        return slice(r * per, (r + 1) * per)

    def __iter__(self) -> Iterator[np.ndarray]:
        """Yields this process's rows of each global batch in turn (the
        whole batch on one process), from ``state.step`` on. Feed through
        :func:`batch_to_device`."""
        rows = self.rows()
        prefetching = hasattr(self.dataset, "prefetch")
        if prefetching:
            # native double-buffering: the C++ worker gathers step k+1 while
            # the accelerator runs step k
            self.dataset.prefetch(
                np.asarray(self._step_indices(self.state.step, rows), np.int64)
            )
        while True:
            if prefetching:
                batch = self.dataset.wait()
                self.state.step += 1
                self.dataset.prefetch(
                    np.asarray(self._step_indices(self.state.step, rows), np.int64)
                )
            else:
                batch = self.batch_at(self.state.step, rows=rows)
                self.state.step += 1
            yield batch


def batch_to_device(batch: np.ndarray, device: DeviceLike = "cuda") -> torch.Tensor:
    """A host batch as int64 token ids on ``device`` (the card unless the
    caller names another): on the card, one copy into page-locked memory
    and one non-blocking upload."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return torch.from_numpy(np.asarray(batch, dtype=np.int64)).to(dev)
    host = torch.empty(np.shape(batch), dtype=torch.int64, pin_memory=True)
    host.numpy()[...] = batch
    return host.to(dev, non_blocking=True)
