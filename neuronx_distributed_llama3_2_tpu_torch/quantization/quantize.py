"""Weight-only int8 / fp8 quantization of a model's parameters.

Counterpart of ``neuronx_distributed_llama3_2_tpu/quantization/quantize.py``
(``QuantizationType``, ``QuantizationConfig``, ``QuantizedTensor``,
``quantize_array``, ``DEFAULT_TARGETS``, ``quantize_params``,
``dequantize_params``, ``quantization_error``, ``live_params``), over the
port's parameter names (``layers.<i>.attn.qkv.q_kernel``, ...). A quantized
weight is a :class:`QuantizedTensor`: the int8 / fp8 payload and an fp32
scale shaped to broadcast against it, ``dequantize(dtype) = (payload ·
scale)`` in fp32, cast to ``dtype``.

The scales are the JAX package's, bit for bit:

- per tensor: one scale, absmax / qmax, at least 1e-12. The JAX package
  quantizes the stacked (L, ...) leaf, so the layers of one leaf share it:
  :func:`quantize_params` takes the absmax over every layer of the leaf;
- per channel: the absmax over the contraction (input) axis, a scale per
  output channel and per layer, and per (layer, expert) for the fused
  expert weights (JAX :117-160); a fused ``gate_up`` (..., H, 2, I) reduces
  over H; a ``per_channel_axis`` other than -1 keeps that axis of JAX's
  stacked leaf, and the layer axis;
- int8 rounds half to even and clips to +-127, fp8 clips to +-qmax and
  casts (round to nearest even).

Under a mesh a rank holds a shard of a weight: the absmax over a reduced
dim that is split over tp (or ep, or the layers over pp) is the maximum
over those ranks (``specs``), so every rank's scales are the ones of the
whole weight.

:func:`quantize_model` swaps a model's layers for the quantized layers of
:mod:`.layers`, which hold the payloads and dequantize one layer's weights
inside that layer's forward; :func:`live_params` hands such a model on as
it is.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from neuronx_distributed_llama3_2_tpu_torch.quantization.kv_cache import QUANTIZED_DTYPES


class QuantizationType(str, enum.Enum):
    PER_TENSOR_SYMMETRIC = "per_tensor_symmetric"
    PER_CHANNEL_SYMMETRIC = "per_channel_symmetric"


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    quantization_type: QuantizationType = QuantizationType.PER_CHANNEL_SYMMETRIC
    quantized_dtype: str = "int8"
    # the output-channel axis of JAX's (stacked) kernel; -1 = the last
    per_channel_axis: int = -1

    def __post_init__(self):
        if self.quantized_dtype not in QUANTIZED_DTYPES:
            raise ValueError(
                f"quantized_dtype must be one of {sorted(QUANTIZED_DTYPES)}, "
                f"got {self.quantized_dtype!r}"
            )

    @property
    def torch_dtype(self) -> torch.dtype:
        return QUANTIZED_DTYPES[self.quantized_dtype]


def _qmax(dtype: torch.dtype) -> float:
    if dtype == torch.int8:
        return 127.0
    return float(torch.finfo(dtype).max)


@dataclasses.dataclass
class QuantizedTensor:
    """An int8 / fp8 payload and its broadcast-shaped fp32 scale."""

    qvalue: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.qvalue.shape

    @property
    def dtype(self):
        return self.qvalue.dtype

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.qvalue.float() * self.scale).to(dtype)


def _jax_reduce_axes(ndim: int, config: QuantizationConfig, path: str) -> Tuple[int, ...]:
    """The per-channel reduction axes of JAX's leaf of ``ndim`` dims
    (``_default_reduce_axes``, ``_reduce_axes_for``)."""
    if path.endswith("gate_up") and ndim >= 3:
        return (ndim - 3,)
    if config.per_channel_axis != -1:
        axis = config.per_channel_axis % ndim
        keep = {axis} | ({0} if ndim >= 3 else set())
        return tuple(i for i in range(ndim) if i not in keep)
    return (max(ndim - 2, 0),)


def reduce_axes_for(name: str, ndim: int, config: QuantizationConfig,
                    stacked: Optional[bool] = None) -> Tuple[int, ...]:
    """The axes of a port tensor (``ndim`` dims) that share a scale: every
    axis per tensor; per channel, JAX's axes of its (L, ...)-stacked leaf
    for a layer tensor (``layers.<i>....``), less the layer axis."""
    if config.quantization_type is QuantizationType.PER_TENSOR_SYMMETRIC:
        return tuple(range(ndim))
    stacked = name.startswith("layers.") if stacked is None else stacked
    if not stacked:
        return _jax_reduce_axes(ndim, config, name)
    return tuple(a - 1 for a in _jax_reduce_axes(ndim + 1, config, name) if a > 0)


def _absmax(w: torch.Tensor, axes: Sequence[int], groups: Sequence = ()) -> torch.Tensor:
    """max |w| over ``axes`` (kept), then over the ranks of ``groups``."""
    m = w.float().abs().amax(dim=tuple(axes), keepdim=True) if axes else w.float().abs()
    for group in groups:
        m = m.contiguous()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    return m


def quantize_array(w: torch.Tensor, config: QuantizationConfig = QuantizationConfig(),
                   reduce_axes: Optional[Tuple[int, ...]] = None,
                   absmax: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """Symmetric absmax quantization: scale = absmax / qmax (at least
    1e-12), payload = w / scale rounded (int8) or cast (fp8). Per channel
    the scale is shared over ``reduce_axes`` (JAX's default for a tensor of
    w's dims otherwise); ``absmax`` overrides the absmax (a maximum taken
    over more than ``w``)."""
    wf = w.float()
    qdt = config.torch_dtype
    qmax = _qmax(qdt)
    if absmax is None:
        if config.quantization_type is QuantizationType.PER_TENSOR_SYMMETRIC:
            axes = tuple(range(wf.dim()))
        else:
            axes = _jax_reduce_axes(wf.dim(), config, "") if reduce_axes is None else reduce_axes
        absmax = _absmax(wf, axes)
    scale = torch.clamp(absmax / qmax, min=1e-12)
    q = wf / scale
    if qdt == torch.int8:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    else:
        q = torch.clamp(q, -qmax, qmax)
    return QuantizedTensor(q.to(qdt), scale)


#: the weights quantized by default: the attention and MLP projections and
#: the fused expert weights; embeddings, norms, the router and the LM head
#: stay float (JAX ``DEFAULT_TARGETS``, :191, on the port's names)
DEFAULT_TARGETS = (
    r"attn\.qkv\.(q|k|v)_kernel$",
    r"attn\.o\.kernel$",
    r"mlp\.gate_up$",
    r"mlp\.(up|down)\.kernel$",
    r"experts\.gate_up$",
    r"experts\.down$",
)


def _match(name: str, patterns) -> bool:
    return any(re.search(p, name) for p in patterns)


def _leaf_of(name: str) -> str:
    """The JAX leaf a port tensor belongs to: the layer tensors of one name
    share ``layers.*.<rest>``."""
    parts = name.split(".")
    return "layers.*." + ".".join(parts[2:]) if parts[0] == "layers" else name


def _groups(leaf, dims: Sequence[int]) -> list:
    """The groups over which the rank's shard misses part of ``dims`` of
    ``leaf`` (a :class:`..parallel.layout.LeafSpec`): the split axes of
    those dims, the layer axis over pp for a stacked leaf."""
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
    from neuronx_distributed_llama3_2_tpu_torch.parallel.layout import axis_group

    if leaf is None or not parallel_state.model_parallel_is_initialized():
        return []
    spec = leaf.spec[1:] if leaf.stacked else leaf.spec
    axes = {spec[d] for d in dims if spec[d] is not None}
    if (leaf.stacked and parallel_state.PP_AXIS in leaf.spec
            and len(dims) == len(spec)):
        axes.add(parallel_state.PP_AXIS)
    return [axis_group(a) for a in sorted(axes)
            if dist.get_world_size(axis_group(a)) > 1]


def quantize_params(params: Mapping[str, torch.Tensor],
                    config: QuantizationConfig = QuantizationConfig(),
                    targets: Tuple[str, ...] = DEFAULT_TARGETS,
                    specs: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """Every tensor of ``params`` (port names) whose name matches a target
    and that has two dims or more, as a :class:`QuantizedTensor`; the rest
    as they are. Per tensor, the layers of one JAX leaf share the scale;
    ``specs`` (the model's ``param_specs()``) makes the absmax that of the
    whole weight under a mesh (module docstring)."""
    specs = specs or {}
    chosen = {k: w for k, w in params.items() if w.dim() >= 2 and _match(k, targets)}
    per_tensor = config.quantization_type is QuantizationType.PER_TENSOR_SYMMETRIC
    shared: Dict[str, torch.Tensor] = {}
    if per_tensor:
        for k, w in chosen.items():
            m = _absmax(w, range(w.dim()))
            leaf = _leaf_of(k)
            shared[leaf] = m if leaf not in shared else torch.maximum(shared[leaf], m)
        firsts = {}
        for k in chosen:
            firsts.setdefault(_leaf_of(k), k)
        for leaf, k in firsts.items():
            for group in _groups(specs.get(k), range(chosen[k].dim())):
                m = shared[leaf].contiguous()
                dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
                shared[leaf] = m
    out: Dict[str, Any] = {}
    for k, w in params.items():
        if k not in chosen:
            out[k] = w
            continue
        axes = reduce_axes_for(k, w.dim(), config)
        absmax = shared[_leaf_of(k)] if per_tensor else _absmax(w, axes, _groups(specs.get(k), axes))
        out[k] = quantize_array(w, config, axes, absmax=absmax)
    return out


def dequantize_params(params: Mapping[str, Any], dtype=torch.bfloat16) -> Dict[str, Any]:
    """A float dict again: each :class:`QuantizedTensor` dequantized to
    ``dtype``."""
    return {k: v.dequantize(dtype) if isinstance(v, QuantizedTensor) else v
            for k, v in params.items()}


def quantization_error(w: torch.Tensor, config: QuantizationConfig = QuantizationConfig()
                       ) -> torch.Tensor:
    """Max abs reconstruction error of :func:`quantize_array`."""
    return (quantize_array(w, config).dequantize(torch.float32) - w.float()).abs().max()


def live_params(params: Any, dtype=torch.bfloat16) -> Any:
    """The weights a serving program runs on, decided on what is passed at
    each call (JAX ``live_params``): a model (its quantized layers, if any,
    dequantize inside their own forward, one layer at a time) as it is; a
    dict holding :class:`QuantizedTensor` values dequantized; anything else
    as it is."""
    if isinstance(params, nn.Module) or not isinstance(params, Mapping):
        return params
    if any(isinstance(v, QuantizedTensor) for v in params.values()):
        return dequantize_params(params, dtype)
    return params


def quantize_model(model: nn.Module, config: QuantizationConfig = QuantizationConfig(),
                   targets: Tuple[str, ...] = DEFAULT_TARGETS) -> nn.Module:
    """Quantize ``model`` in place: every targeted weight
    (:func:`quantize_params` over its parameters) becomes a payload and a
    scale held by the quantized counterpart of its module
    (:data:`.layers.DEFAULT_QUANT_MODULE_MAPPINGS`). Returns the model."""
    from neuronx_distributed_llama3_2_tpu_torch.quantization.layers import convert_weights

    specs = model.param_specs() if hasattr(model, "param_specs") else None
    with torch.no_grad():
        q = quantize_params(dict(model.named_parameters()), config, targets, specs)
    by_module: Dict[str, Dict[str, QuantizedTensor]] = {}
    for k, v in q.items():
        if isinstance(v, QuantizedTensor):
            mod, _, attr = k.rpartition(".")
            by_module.setdefault(mod, {})[attr] = v
    for mod_name, weights in by_module.items():
        convert_weights(model.get_submodule(mod_name), weights)
    return model


def weight_bytes(model: nn.Module) -> int:
    """Bytes of a model's weights: its parameters, and the payloads and
    scales of its quantized layers."""
    return (sum(p.numel() * p.element_size() for p in model.parameters())
            + sum(b.numel() * b.element_size() for n, b in model.named_buffers()
                  if n.endswith(("_qvalue", "_scale"))))
