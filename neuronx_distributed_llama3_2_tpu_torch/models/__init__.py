"""Model families: Llama-3 / Llama-3.2, Mixtral, DBRX, GPT-NeoX / CodeGen and
BERT, and the registry over them (JAX ``models/__init__.py:51-103``)."""

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

#: the JAX package's Mllama configurations, which come with the next slice
#: of the port (ROADMAP.md, slice 5 item 6: models/mllama.py,
#: parallel/conv.py, inference/mllama_decode.py)
MLLAMA_NAMES = ("llama3.2-11b-vision", "tiny-mllama")


def model_registry():
    """name -> {"config", "model_cls"} over every family the port has (JAX
    ``model_registry``; the HF converters of its ``from_hf`` / ``to_hf``
    come with the checkpoint converter, ROADMAP.md queue A item 7)."""
    reg = {}
    for configs, cls in ((LLAMA_CONFIGS, LlamaForCausalLM), (MIXTRAL_CONFIGS, MixtralForCausalLM),
                         (DBRX_CONFIGS, DbrxForCausalLM), (GPTNEOX_CONFIGS, GPTNeoXForCausalLM),
                         (BERT_CONFIGS, BertForPreTraining)):
        for name, cfg in configs.items():
            reg[name] = {"config": cfg, "model_cls": cls}
    return reg


def resolve_model(name: str):
    """The registry entry of ``name``; an Mllama name raises
    NotImplementedError naming the slice that ports it, any other unknown
    name KeyError (JAX ``resolve_model``)."""
    if name in MLLAMA_NAMES:
        raise NotImplementedError(
            f"{name}: the Mllama family (models/mllama.py, parallel/conv.py, "
            "inference/mllama_decode.py) is the next slice of the port (ROADMAP.md, slice 5 "
            "item 6)"
        )
    reg = model_registry()
    if name not in reg:
        raise KeyError(f"unknown model {name!r}; known: {', '.join(sorted(reg))}")
    return reg[name]
