"""LoRA: low-rank adapters over a model's parameters, in PyTorch.

Counterpart of ``neuronx_distributed_llama3_2_tpu/lora/model.py``
(``LoraConfig`` :41, ``_iter_targets`` :73, ``register_grouped_stack``
:97, ``_split_shape`` :121, ``LoraModel`` :159, ``merged_params`` :276,
``merge_lora`` :327). Adapters are parameters of their own, keyed by the
base parameters they target: :class:`LoraModel` is an ``nn.Module`` whose
only parameters are the adapters, named ``<base parameter name>.a`` /
``.b`` (``layers.<i>.attn.qkv.q_kernel.a``: layer ``i`` of the JAX
adapter leaf ``layers/attn/qkv/q_kernel`` ``a``), so the trainer, ZeRO-1
and the checkpoints run on it unchanged and an adapter-only tag is the
JAX package's on-disk format. The base is frozen and not copied.

Targets are regexes over the JAX paths of the base's leaves (the
``/``-joined names of its ``param_specs()``), so a pattern selects the same
leaves in both packages. Each target's adapter has the JAX shapes: A
``(*stack, in, r)``, B ``(*stack, r, *out)`` over the JAX leaf's ``(*stack,
in, *out)`` (:func:`_split_shape`), held per layer here as the base's
layers are; A splits like the target's input dim, B like its output dims
(:meth:`LoraModel.param_specs`), so under tp each rank holds the factors of
its shard. A conv target (HWIO) has A ``(kh, kw, in, r)`` and B ``(r,
out)``.

The forward runs the base with ``W + scaling · A @ B`` built on the fly in
place of each target: the modules holding a target read it adapted (the
product in fp32, cast to the target's dtype, as JAX's), in the forward and
in a remat recompute alike; :meth:`LoraModel.merged_params` and
:func:`merge_lora` give those weights as a state dict for the base model,
to serve or export. :func:`adapters_from_jax` / :func:`adapters_to_jax`
carry the JAX adapter tree (``{path: {"a", "b"}}``) across.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from neuronx_distributed_llama3_2_tpu_torch.lora.stacks import (  # noqa: F401
    _grouped_kernel_re,
    register_grouped_stack,
)
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    jax_path,
    params_to_jax,
    tree_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.layout import (
    LeafSpec,
    mesh_coords,
    port_slice,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import (
    copy_to_tensor_model_parallel_region,
)

# default targets: the attention projections (reference default target_modules)
DEFAULT_TARGETS = (
    r"attn/qkv/(q|k|v)_kernel$",
    r"attn/o/kernel$",
)


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """Reference LoraConfig (modules/lora/config.py:6). ``dtype`` is a torch
    dtype, None for the target's."""

    r: int = 8
    alpha: float = 16.0
    # regexes matched against the '/'-joined JAX paths of the base's leaves
    target_modules: Tuple[str, ...] = DEFAULT_TARGETS
    # regexes naming HWIO conv kernels (A carries the spatial kernel, B is
    # the 1x1 mix); a (kh, kw, I, O) kernel is shape-indistinguishable from
    # a stacked fused linear, so the caller names conv targets here
    conv_target_modules: Tuple[str, ...] = ()
    # rsLoRA scaling alpha/sqrt(r) instead of alpha/r
    use_rslora: bool = False
    dtype: Any = None

    def __post_init__(self):
        if self.r < 1:
            raise ValueError(f"LoRA rank must be >= 1, got {self.r}")

    @property
    def scaling(self) -> float:
        return self.alpha / (self.r ** 0.5 if self.use_rslora else self.r)


def _path_of(name: str) -> str:
    return "/".join(jax_path(name)[0])


def _iter_targets(specs: Mapping[str, LeafSpec], patterns) -> Dict[str, LeafSpec]:
    """JAX path -> leaf spec (its global shape) for every leaf of ``specs``
    (port parameter name -> :class:`LeafSpec`) whose path matches a target
    regex."""
    return {
        path: leaf for path, leaf in ((_path_of(k), v) for k, v in specs.items())
        if any(re.search(p, path) for p in patterns)
    }


def _split_shape(shape, path: str = "") -> Tuple[Tuple[int, ...], int, Tuple[int, ...]]:
    """(leading stack dims, in_features, out dims) of a JAX kernel leaf:
    (in, out) [embeddings too], (L, in, out), (L, in, t, out) [fused
    gate_up]; a registered grouped layout carries two stack dims. MoE
    expert weights are refused at construction; the rank guard backstops
    unknown layouts."""
    grouped_re = _grouped_kernel_re(path)
    n_stack = 2 if grouped_re is not None else 1
    if len(shape) > 3 + n_stack:
        raise ValueError(
            f"kernel rank {len(shape)} is not LoRA-targetable; exclude it from target_modules"
        )
    if len(shape) == 2:
        return (), shape[0], (shape[1],)
    if n_stack == 2 and len(shape) == 3:
        raise ValueError(
            f"rank-3 leaf under a grouped stack is not LoRA-targetable: {path} "
            f"{tuple(shape)}; exclude it from target_modules"
        )
    if len(shape) == 3 or n_stack == 1:
        return (shape[0],), shape[1], tuple(shape[2:])
    if len(shape) == 4 and not grouped_re.search(path):
        raise ValueError(
            f"ambiguous rank-4 kernel under a grouped stack: {path} {tuple(shape)}; "
            "exclude it from target_modules"
        )
    return tuple(shape[:2]), shape[2], tuple(shape[3:])


def _adapter_specs(path: str, leaf: LeafSpec, r: int, conv: bool) -> Tuple[LeafSpec, LeafSpec]:
    """The A and B leaf specs of the target ``leaf``: A splits like its
    input dim, B like its output dims (JAX ``specs``)."""
    if conv:
        kh, kw, cin, cout = leaf.shape
        return (LeafSpec((kh, kw, cin, r), (None, None, leaf.spec[2], None)),
                LeafSpec((r, cout), (None, leaf.spec[3])))
    stack, fan_in, out = _split_shape(leaf.shape, path)
    n = len(stack)
    kw = dict(stacked=leaf.stacked, chunks=leaf.chunks, stages=leaf.stages)
    return (LeafSpec((*stack, fan_in, r), (*leaf.spec[:n], leaf.spec[n], None), **kw),
            LeafSpec((*stack, r, *out), (*leaf.spec[:n], None, *leaf.spec[n + 1:]), **kw))


class _Adapter(nn.Module):
    """One target tensor's A and B."""

    def __init__(self, a_shape, b_shape, dtype, device):
        super().__init__()
        self.a = nn.Parameter(torch.empty(a_shape, dtype=dtype, device=device))
        self.b = nn.Parameter(torch.empty(b_shape, dtype=dtype, device=device))


class _AdaptedOnRead:
    """Put in front of the class of a module that holds a target weight
    (``_adapted``): while its LoRA model is enabled, reading the weight's
    attribute (what the module's forward does) gives base + scaling · A @ B,
    built from the adapters at each read. A checkpointed layer's recompute
    in the backward reads it again, so remat sees the adapters too. The
    base parameter itself stays registered under its name."""

    def __getattr__(self, name: str):
        reads = self.__dict__.get("_lora_reads")
        if reads is not None and name in reads:
            lora, full = reads[name]
            w = super().__getattr__(name)
            return w + lora._delta(full, w) if lora._enabled else w
        return super().__getattr__(name)


_ADAPTED: Dict[type, type] = {}


def _adapted(cls: type) -> type:
    """``cls`` with :class:`_AdaptedOnRead` in front (one class per ``cls``)."""
    if issubclass(cls, _AdaptedOnRead):
        return cls
    if cls not in _ADAPTED:
        _ADAPTED[cls] = type(f"LoraAdapted{cls.__name__}", (_AdaptedOnRead, cls), {})
    return _ADAPTED[cls]


class LoraModel(nn.Module):
    """The base model's protocol (``init_weights``, ``param_specs``,
    ``forward``, ``loss``, ``config``) over the adapters alone, so the
    trainer, the checkpoints and ZeRO-1 run unchanged with the adapters as
    "the model parameters". The base (any port model with ``param_specs``)
    is held, not registered: its parameters are not this module's, and
    attaching freezes them. Each module of the base that holds a target
    reads it adapted (:class:`_AdaptedOnRead`) until :meth:`detach`, so
    the base's own forward runs the adapted model; :meth:`disabled` reads
    the base weights alone. ``attach=False`` builds the adapters without
    touching the base (to merge them, :func:`merge_lora`)."""

    def __init__(self, base_model: nn.Module, config: LoraConfig, attach: bool = True):
        super().__init__()
        if getattr(base_model, "stage", None) is not None:
            raise NotImplementedError("LoRA over a pipeline stage (pp > 1) is not supported")
        self.__dict__["base"] = base_model  # held, not a submodule
        self.lora_config = config
        specs = base_model.param_specs()
        self._targets = _iter_targets(specs, config.target_modules)
        self._conv_targets = (_iter_targets(specs, config.conv_target_modules)
                              if config.conv_target_modules else {})
        overlap = set(self._targets) & set(self._conv_targets)
        if overlap:
            raise ValueError(
                f"paths matched by both target_modules and conv_target_modules: {sorted(overlap)}"
            )
        bad_conv = [p for p, leaf in self._conv_targets.items() if len(leaf.shape) != 4]
        if bad_conv:
            raise ValueError(
                f"conv_target_modules must name HWIO rank-4 kernels; got "
                f"{[(p, self._conv_targets[p].shape) for p in bad_conv]}"
            )
        if not self._targets and not self._conv_targets:
            raise ValueError(
                f"no parameters match target_modules={config.target_modules} "
                f"or conv_target_modules={config.conv_target_modules}"
            )
        expert_hits = [p for p in self._targets if re.search(r"experts/", p)]
        if expert_hits:
            raise ValueError(
                f"MoE expert-fused weights are not LoRA-targetable (two stack dims): "
                f"{expert_hits}; exclude them from target_modules"
            )
        # held base parameter name -> (its leaf spec, A spec, B spec, is conv)
        self._plan: Dict[str, Tuple[LeafSpec, LeafSpec, LeafSpec, bool]] = {}
        held = dict(base_model.named_parameters())
        for name, (leaf, a_spec, b_spec, conv) in self._adapter_leaves(specs).items():
            if name not in held:
                continue
            w = held[name]
            k = len(a_spec.shape) - 2 - (1 if a_spec.stacked else 0)  # local stack dims
            lstack, fan_in, out = tuple(w.shape[:k]), w.shape[k], tuple(w.shape[k + 1:])
            if conv:
                a_shape, b_shape = (*w.shape[:3], config.r), (config.r, w.shape[3])
            else:
                a_shape, b_shape = (*lstack, fan_in, config.r), (*lstack, config.r, *out)
            self._insert(name, _Adapter(a_shape, b_shape, config.dtype or w.dtype, w.device))
            self._plan[name] = (leaf, a_spec, b_spec, conv)
        self._enabled = True
        self._attached = []
        if attach:
            for p in base_model.parameters():
                p.requires_grad_(False)
            for name in self._plan:
                owner, attr = self._owner(name)
                reads = owner.__dict__.setdefault("_lora_reads", {})
                if attr in reads:
                    raise ValueError(f"{name} is already adapted by another LoraModel: detach it")
                owner.__class__ = _adapted(type(owner))
                reads[attr] = (self, name)
                self._attached.append((owner, attr))

    def _owner(self, name: str):
        """(the base module holding parameter ``name``, its attribute)."""
        *path, attr = name.split(".")
        return self.base.get_submodule(".".join(path)), attr

    def detach(self) -> None:
        """Give the base back its own reads (and its own classes)."""
        for owner, attr in self._attached:
            reads = owner.__dict__["_lora_reads"]
            del reads[attr]
            if not reads:
                del owner.__dict__["_lora_reads"]
                owner.__class__ = owner.__class__.__bases__[1]
        self._attached = []

    @contextlib.contextmanager
    def disabled(self):
        """The base reads its own weights while the block runs."""
        self._enabled = False
        try:
            yield
        finally:
            self._enabled = True

    def _adapter_leaves(self, specs: Mapping[str, LeafSpec]):
        """Target base parameter name -> (its leaf spec, A's, B's, is conv),
        over every name of ``specs``."""
        out = {}
        for name, leaf in specs.items():
            path = _path_of(name)
            conv = path in self._conv_targets
            if conv or path in self._targets:
                out[name] = (leaf, *_adapter_specs(path, leaf, self.lora_config.r, conv), conv)
        return out

    def _insert(self, name: str, adapter: _Adapter) -> None:
        """Register ``adapter`` under the dotted ``name`` (nested containers)."""
        *parents, last = name.split(".")
        node: nn.Module = self
        for part in parents:
            child = node._modules.get(part)
            if child is None:
                child = nn.Module()
                node.add_module(part, child)
            node = child
        node.add_module(last, adapter)

    def adapter(self, name: str) -> _Adapter:
        """The adapter of base parameter ``name``."""
        return self.get_submodule(name)

    @property
    def config(self):  # model-protocol passthrough (vocab size etc.)
        return self.base.config

    @property
    def device(self) -> torch.device:
        return self.base.device

    # -- adapters ----------------------------------------------------------

    def init_weights(self, seed: int) -> "LoraModel":
        """A ~ N(0, 1 / fan_in), B = 0, so the adapted model starts equal
        to the base (JAX ``init``). Each whole JAX leaf is drawn, layer by
        layer, in path order, and each rank keeps its part, so the adapters
        are the same at any tp."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        coords = mesh_coords()
        by_path: Dict[str, Dict[Optional[int], str]] = {}
        for name in self._plan:
            by_path.setdefault(_path_of(name), {})[jax_path(name)[1]] = name
        with torch.no_grad():
            for path in sorted(by_path):
                names = by_path[path]
                _, a_spec, _, conv = self._plan[next(iter(names.values()))]
                shape = a_spec.shape[1:] if a_spec.stacked else a_spec.shape
                fan_in = math.prod(shape[:-1]) if conv else shape[-2]
                for layer in range(a_spec.shape[0]) if a_spec.stacked else (None,):
                    full = torch.empty(shape, dtype=torch.float32, device=self.device)
                    full.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
                    if layer not in names:
                        continue
                    ad = self.adapter(names[layer])
                    _, index = port_slice(a_spec, coords, layer)
                    ad.a.copy_(full[index])
                    ad.b.zero_()
        return self

    def param_specs(self) -> Dict[str, LeafSpec]:
        """Each adapter parameter name -> its :class:`LeafSpec` (the JAX
        leaf's global shape and split)."""
        out = {}
        for name, (_, a_spec, b_spec, _) in self._adapter_leaves(self.base.param_specs()).items():
            out[f"{name}.a"], out[f"{name}.b"] = a_spec, b_spec
        return out

    # -- forward -------------------------------------------------------------

    def _delta(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """scaling · A @ B of target ``name`` in fp32, cast to ``w``'s dtype.
        A factor replicated over tp whose target is split over it (A of a
        column-parallel target, B of a row-parallel one) meets this rank's
        shard only: its gradient is summed over tp."""
        leaf, a_spec, b_spec, conv = self._plan[name]
        ad = self.adapter(name)
        a, b = (
            copy_to_tensor_model_parallel_region(f)
            if leaf.mentions(parallel_state.TP_AXIS) and not spec.mentions(parallel_state.TP_AXIS)
            else f
            for f, spec in ((ad.a.float(), a_spec), (ad.b.float(), b_spec))
        )
        if conv:
            delta = torch.einsum("hwir,ro->hwio", a, b)
        else:
            lead = a.dim() - 2
            delta = torch.matmul(a, b.flatten(lead + 1)).reshape(w.shape)
        return (self.lora_config.scaling * delta).to(w.dtype)

    def merged_params(self) -> Dict[str, torch.Tensor]:
        """The base's parameters with base + scaling · A @ B on the targets
        (the reference's merge math), every other one the base's own tensor:
        a state dict for the base model."""
        out = dict(self.base.named_parameters())
        for name in self._plan:
            out[name] = out[name] + self._delta(name, out[name])
        return out

    def forward(self, *args, **kwargs):
        """The base's forward over the adapted weights."""
        self._require_attached()
        return self.base(*args, **kwargs)

    def loss(self, input_ids: torch.Tensor, labels: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        """The base's loss over the adapted weights (autograd reaches the
        adapters alone); further arguments go to the base's (Mllama's image
        inputs)."""
        self._require_attached()
        return self.base.loss(input_ids, labels, *args, **kwargs)

    def _require_attached(self) -> None:
        if not self._attached:
            raise RuntimeError("this LoraModel is not attached to its base (attach=False, or "
                               "detached): only merged_params() is defined")


def merge_lora(base_model: nn.Module, adapters: Mapping[str, torch.Tensor],
               config: LoraConfig) -> Dict[str, torch.Tensor]:
    """Merged weights for export or serving (reference ``merge_lora``
    model.py:357): ``adapters`` is a :class:`LoraModel` state dict; returns a
    state dict for ``base_model``. The base is left as it was."""
    lora = LoraModel(base_model, config, attach=False)
    lora.load_state_dict(adapters)
    with torch.no_grad():
        return {k: v.detach() for k, v in lora.merged_params().items()}


# ---------------------------------------------------------------------------
# bridge to the JAX package's adapter tree
# ---------------------------------------------------------------------------

def _nest(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"layers/attn/o/kernel": {"a", "b"}}`` -> nested dicts by path."""
    out: Dict[str, Any] = {}
    for path, ab in tree.items():
        node = out
        for k in path.split("/"):
            node = node.setdefault(k, {})
        node.update(ab)
    return out


def _unnest(tree: Mapping[str, Any], prefix: Iterable[str] = ()) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if set(v) == {"a", "b"} and all(isinstance(x, np.ndarray) for x in v.values()):
            out["/".join((*prefix, k))] = dict(v)
        else:
            out.update(_unnest(v, (*prefix, k)))
    return out


def adapters_from_jax(np_adapters: Mapping[str, Any], lora: LoraModel,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """The JAX adapter tree (``{path: {"a": ..., "b": ...}}``, numpy; the
    adapters or one of AdamW's moments) -> a state dict for ``lora``: this
    rank's part of each leaf, per layer, at the adapters' dtype (or
    ``dtype``)."""
    own = dict(lora.named_parameters())
    return tree_from_jax(
        _nest(np_adapters), lora.config, lambda name: dtype or own[name].dtype, lora.device,
        specs=lora.param_specs(),
    )


def adapters_to_jax(state_dict: Mapping[str, torch.Tensor], lora: LoraModel) -> Dict[str, Any]:
    """Inverse of :func:`adapters_from_jax`: the JAX adapter tree as fp32
    numpy, each leaf gathered over the mesh (every rank must call it)."""
    return _unnest(params_to_jax(state_dict, lora.config, specs=lora.param_specs()))
