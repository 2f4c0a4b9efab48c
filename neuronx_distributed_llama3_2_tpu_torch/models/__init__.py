"""Model families: Llama-3 / Llama-3.2, Mixtral, DBRX, GPT-NeoX / CodeGen,
BERT and Llama-3.2 Vision (Mllama), and the registry over them (JAX
``models/__init__.py:51-103``)."""

from neuronx_distributed_llama3_2_tpu_torch.models.bert import (  # noqa: F401
    BERT_CONFIGS,
    BertConfig,
    BertForPreTraining,
)
from neuronx_distributed_llama3_2_tpu_torch.models.dbrx import (  # noqa: F401
    DBRX_CONFIGS,
    DbrxConfig,
    DbrxForCausalLM,
)
from neuronx_distributed_llama3_2_tpu_torch.models.gptneox import (  # noqa: F401
    GPTNEOX_CONFIGS,
    GPTNeoXConfig,
    GPTNeoXForCausalLM,
)
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (  # noqa: F401
    LLAMA_CONFIGS,
    LlamaConfig,
    LlamaForCausalLM,
)
from neuronx_distributed_llama3_2_tpu_torch.models.mixtral import (  # noqa: F401
    MIXTRAL_CONFIGS,
    MixtralConfig,
    MixtralForCausalLM,
)
from neuronx_distributed_llama3_2_tpu_torch.models.mllama import (  # noqa: F401
    MLLAMA_CONFIGS,
    MllamaConfig,
    MllamaForConditionalGeneration,
)


def model_registry():
    """name -> {"config", "model_cls"} over every family the port has (JAX
    ``model_registry``; the HF converters of its ``from_hf`` / ``to_hf``
    come with the checkpoint converter, ROADMAP.md queue A item 7)."""
    reg = {}
    for configs, cls in ((LLAMA_CONFIGS, LlamaForCausalLM), (MIXTRAL_CONFIGS, MixtralForCausalLM),
                         (DBRX_CONFIGS, DbrxForCausalLM), (GPTNEOX_CONFIGS, GPTNeoXForCausalLM),
                         (BERT_CONFIGS, BertForPreTraining),
                         (MLLAMA_CONFIGS, MllamaForConditionalGeneration)):
        for name, cfg in configs.items():
            reg[name] = {"config": cfg, "model_cls": cls}
    return reg


def resolve_model(name: str):
    """The registry entry of ``name``; an unknown name raises KeyError (JAX
    ``resolve_model``)."""
    reg = model_registry()
    if name not in reg:
        raise KeyError(f"unknown model {name!r}; known: {', '.join(sorted(reg))}")
    return reg[name]
