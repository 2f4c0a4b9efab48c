"""Quantized parallel layers: the payload and the scale held, dequantized
inside the forward.

Counterpart of ``neuronx_distributed_llama3_2_tpu/quantization/layers.py``
(``QuantizedColumnParallelLinear`` :39, ``QuantizedRowParallelLinear`` :82,
``DEFAULT_QUANT_MODULE_MAPPINGS`` :127, ``convert`` :133). Each quantized
layer is its float layer's class with :class:`DequantizeOnRead` in front:
the float weight is gone, a ``<name>_qvalue`` payload and a
``<name>_scale`` buffer hold it, and reading ``<name>`` (what the float
layer's forward does) dequantizes it to the layer's compute dtype. So a
layer's bf16 weights exist only while its own forward runs, one layer at a
time, never the whole model's at once.

Beside JAX's two linears, the port's other weight holders have their
quantized counterparts: the fused GQA projection, the dense SwiGLU's
``gate_up`` and the MoE layer's fused expert weights (per-(layer, expert)
scales). Under tp a rank quantizes its shard with the scales of the whole
weight: the absmax over a reduced dim that is split over tp (the
row-parallel kernel's input rows, say) is the maximum over the tp ranks,
so dequantize-then-matmul commutes with the partial-sum all-reduce as in
JAX (:94-99).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist
from torch import nn

from neuronx_distributed_llama3_2_tpu_torch.models.llama import LlamaMLP
from neuronx_distributed_llama3_2_tpu_torch.moe.experts import ExpertMLPs
from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    GQAQKVColumnParallelLinear,
    RowParallelLinear,
)
from neuronx_distributed_llama3_2_tpu_torch.quantization.quantize import (
    QuantizationConfig,
    QuantizedTensor,
    _absmax,
    quantize_array,
    reduce_axes_for,
)


class DequantizeOnRead:
    """Mixin of the quantized layers (module docstring): ``weights`` are
    the names of the float weights it holds quantized, ``split`` the mesh
    axis of each dim of each that a rank holds a part of."""

    weights: Tuple[str, ...] = ()

    def split(self) -> Dict[str, Dict[int, str]]:
        return {}

    def __getattr__(self, name: str):
        held = self.__dict__.get("_quantized")
        if held is not None and name in held:
            b = self.__dict__["_buffers"]
            return (b[name + "_qvalue"].float() * b[name + "_scale"]).to(held[name])
        return super().__getattr__(name)

    def quantized(self, name: str) -> QuantizedTensor:
        """The held (payload, scale) of weight ``name``."""
        return QuantizedTensor(getattr(self, name + "_qvalue"), getattr(self, name + "_scale"))

    def hold(self, name: str, qt: QuantizedTensor, dtype: torch.dtype) -> None:
        """Hold weight ``name`` as ``qt``, dequantized to ``dtype`` on read."""
        if name in self._parameters:
            del self._parameters[name]
        self.__dict__.setdefault("_quantized", {})[name] = dtype
        self.register_buffer(name + "_qvalue", qt.qvalue)
        self.register_buffer(name + "_scale", qt.scale)

    @classmethod
    def from_float(cls, mod: nn.Module,
                   q_config: QuantizationConfig = QuantizationConfig()) -> nn.Module:
        """``mod`` made this quantized layer in place and returned: each of
        its weights quantized by ``q_config``, with the scales of the whole
        weight under tp (module docstring)."""
        mod.__class__ = cls
        live = parallel_state.model_parallel_is_initialized()
        for name in cls.weights:
            w = mod._parameters[name]
            axes = reduce_axes_for(name, w.dim(), q_config, stacked=False)
            groups = [parallel_state.get_parallel_state().group(a)
                      for d, a in sorted(mod.split().get(name, {}).items()) if d in axes and live]
            groups = [g for g in groups if dist.get_world_size(g) > 1]
            with torch.no_grad():
                qt = quantize_array(w, q_config, axes, absmax=_absmax(w, axes, groups))
            mod.hold(name, qt, w.dtype)
        return mod


class QuantizedColumnParallelLinear(DequantizeOnRead, ColumnParallelLinear):
    """JAX ``QuantizedColumnParallelLinear`` (:39)."""

    weights = ("kernel",)

    def split(self):
        return {"kernel": {1: parallel_state.TP_AXIS}}


class QuantizedRowParallelLinear(DequantizeOnRead, RowParallelLinear):
    """JAX ``QuantizedRowParallelLinear`` (:82): per-channel scales along
    the output axis, which a row-parallel kernel holds whole."""

    weights = ("kernel",)

    def split(self):
        return {"kernel": {0: parallel_state.TP_AXIS}}


class QuantizedGQAQKVColumnParallelLinear(DequantizeOnRead, GQAQKVColumnParallelLinear):
    weights = ("q_kernel", "k_kernel", "v_kernel")

    def split(self):
        kv = {1: parallel_state.TP_AXIS} if self.kv_split else {}
        return {"q_kernel": {1: parallel_state.TP_AXIS}, "k_kernel": kv, "v_kernel": kv}


class QuantizedLlamaMLP(DequantizeOnRead, LlamaMLP):
    """The dense SwiGLU's fused ``gate_up`` (H, 2, I) quantized (its
    ``down`` is a row-parallel linear of its own)."""

    weights = ("gate_up",)

    def split(self):
        return {"gate_up": {2: parallel_state.TP_AXIS}}


class QuantizedExpertMLPs(DequantizeOnRead, ExpertMLPs):
    """The fused expert weights quantized, a scale per (expert, channel)."""

    weights = ("gate_up", "down")

    def split(self):
        ep, tp = parallel_state.EP_AXIS, parallel_state.TP_AXIS
        return {"gate_up": {0: ep, 3: tp}, "down": {0: ep, 1: tp}}


#: float layer -> its quantized counterpart (JAX :127, with the port's other
#: weight holders)
DEFAULT_QUANT_MODULE_MAPPINGS = {
    ColumnParallelLinear: QuantizedColumnParallelLinear,
    RowParallelLinear: QuantizedRowParallelLinear,
    GQAQKVColumnParallelLinear: QuantizedGQAQKVColumnParallelLinear,
    LlamaMLP: QuantizedLlamaMLP,
    ExpertMLPs: QuantizedExpertMLPs,
}


def _quantized_class(mod: nn.Module, mapping=None):
    qcls = (mapping or DEFAULT_QUANT_MODULE_MAPPINGS).get(type(mod))
    if qcls is None:
        raise TypeError(f"no quantized mapping for {type(mod).__name__}")
    return qcls


def convert(mod: nn.Module, q_config: QuantizationConfig = QuantizationConfig(),
            mapping=None) -> nn.Module:
    """Swap a float layer for its quantized counterpart, in place (JAX
    ``convert``, :133); a layer without a mapping raises TypeError."""
    return _quantized_class(mod, mapping).from_float(mod, q_config)


def convert_weights(mod: nn.Module, quantized: Mapping[str, QuantizedTensor],
                    mapping=None) -> nn.Module:
    """``mod`` swapped for its quantized counterpart with the given
    payloads and scales (:func:`..quantization.quantize.quantize_model`):
    those of ``quantized`` held, its other weights left float."""
    mod.__class__ = _quantized_class(mod, mapping)
    for name, qt in quantized.items():
        mod.hold(name, qt, mod._parameters[name].dtype)
    return mod
