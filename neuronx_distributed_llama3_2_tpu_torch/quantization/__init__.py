"""Quantized storage: weight-only int8 / fp8 quantization of the model's
parameters and its quantized layers, and the paged KV pool's scale math."""

from neuronx_distributed_llama3_2_tpu_torch.quantization.kv_cache import (
    KV_CACHE_DTYPES,
    KV_SCALE_DTYPE,
    kv_dequantize,
    kv_quantize,
)
from neuronx_distributed_llama3_2_tpu_torch.quantization.quantize import (
    DEFAULT_TARGETS,
    QuantizationConfig,
    QuantizationType,
    QuantizedTensor,
    dequantize_params,
    live_params,
    quantization_error,
    quantize_array,
    quantize_model,
    quantize_params,
)

__all__ = [
    "DEFAULT_QUANT_MODULE_MAPPINGS",
    "DEFAULT_TARGETS",
    "KV_CACHE_DTYPES",
    "KV_SCALE_DTYPE",
    "QuantizationConfig",
    "QuantizationType",
    "QuantizedColumnParallelLinear",
    "QuantizedRowParallelLinear",
    "QuantizedTensor",
    "convert",
    "dequantize_params",
    "kv_dequantize",
    "kv_quantize",
    "live_params",
    "quantization_error",
    "quantize_array",
    "quantize_model",
    "quantize_params",
]


def __getattr__(name):
    # the quantized layers import the model modules, which import this
    # package's kv_cache: loaded on first use
    if name in ("DEFAULT_QUANT_MODULE_MAPPINGS", "QuantizedColumnParallelLinear",
                "QuantizedRowParallelLinear", "convert"):
        from neuronx_distributed_llama3_2_tpu_torch.quantization import layers

        return getattr(layers, name)
    raise AttributeError(name)
