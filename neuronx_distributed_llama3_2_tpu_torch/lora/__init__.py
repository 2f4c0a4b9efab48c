"""LoRA adapters (the JAX package's ``lora/``; reference ``modules/lora/``)."""

from neuronx_distributed_llama3_2_tpu_torch.lora.model import (
    DEFAULT_TARGETS,
    LoraConfig,
    LoraModel,
    adapters_from_jax,
    adapters_to_jax,
    merge_lora,
    register_grouped_stack,
)

__all__ = ["DEFAULT_TARGETS", "LoraConfig", "LoraModel", "adapters_from_jax",
           "adapters_to_jax", "merge_lora", "register_grouped_stack"]
