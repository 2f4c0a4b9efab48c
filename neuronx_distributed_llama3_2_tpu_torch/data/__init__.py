"""Data pipeline: the token stream, the resumable loader, the native
gather (:mod:`.native_loader`)."""

from neuronx_distributed_llama3_2_tpu_torch.data.dataset import (
    DistributedDataLoader,
    LoaderState,
    TokenDataset,
    batch_to_device,
    write_token_file,
)

__all__ = [
    "DistributedDataLoader",
    "LoaderState",
    "TokenDataset",
    "batch_to_device",
    "write_token_file",
]
