"""Checkpointing in the JAX package's on-disk format: the tag protocol and
its backends (:mod:`.storage`), save / load / copy (:mod:`.checkpoint`)."""

from neuronx_distributed_llama3_2_tpu_torch.checkpoint.storage import (  # noqa: F401
    BaseCheckpointStorage,
    FilesysCheckpointStorage,
    create_checkpoint_storage,
)
from neuronx_distributed_llama3_2_tpu_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointIOState,
    copy_checkpoint,
    finalize_async_saves,
    load_checkpoint,
    save_checkpoint,
)
