"""AdamW with optional fp32 master weights and ZeRO-1.

Counterpart of ``neuronx_distributed_llama3_2_tpu/trainer/optimizer.py``
(``OptimizerState``, ``init_optimizer_state``, ``optimizer_state_specs``,
``apply_gradients``), with its order of operations: gradients to fp32 →
clip by the global norm → moments in fp32, stored in ``state_dtype`` →
AdamW on the fp32 master (or on the parameters themselves without one) →
parameters = cast(master).

ZeRO-1 (JAX ``_zero1_leaf_spec``, :56-108; the reference's
``NeuronZero1Optimizer``): with ``zero_one_enabled`` and more than one
data-parallel rank, ``master``, ``mu`` and ``nu`` are split over dp on the
first free dim of the JAX leaf that dp divides, and stay whole where none
does, exactly as JAX decides it (:func:`optimizer_state_specs`). For a
stacked layer leaf that dim is usually the layer stack itself: a dp rank
then holds the whole state of its layers and none of the others'. The
trainer reduce-scatters each gradient over dp (a reduce to the owning rank
for a layer split), each rank updates its part, and the new parameters are
all-gathered (broadcast from the owner) — :func:`zero1_reduce_grads`,
:func:`apply_gradients` and :func:`zero1_gather_params`. Under expert
parallelism the data-parallel ranks of a dense leaf are the (dp, ep) plane
and those of an expert leaf (split over ep) the mesh's dp alone: its
gradient is summed and its state split over dp only (JAX
``optimizer_state_specs``, :85-94; ``LeafSpec.data_axis``).

Parameters, gradients and the moments are dicts keyed by the model's
parameter names. :func:`apply_gradients` updates parameters and state IN
PLACE (the JAX package returns new pytrees and donates the old ones; here
the tensors are reused, which keeps one copy of each in device memory).

:func:`opt_state_from_jax` / :func:`opt_state_to_jax` carry the state
between the packages, a rank's part at a time, as
:func:`..models.llama.params_from_jax` / ``params_to_jax`` carry the
weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LlamaConfig,
    jax_path,
    param_specs,
    params_to_jax,
    tree_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.grads import (
    clip_coefficient,
    global_norm,
    world_group,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.layout import (
    LeafSpec,
    dim_range,
    axis_group,
    mesh_coords,
    pp_owner,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import all_gather, all_reduce, reduce_scatter
from neuronx_distributed_llama3_2_tpu_torch.trainer.config import OptimizerConfig
from neuronx_distributed_llama3_2_tpu_torch.utils.device import DeviceLike

Tensors = Dict[str, torch.Tensor]
DP = parallel_state.DP_AXIS
TP = parallel_state.TP_AXIS


class OptimizerState(NamedTuple):
    step: int                   # optimizer steps taken
    master: Optional[Tensors]   # master params (None without master weights)
    mu: Tensors                 # first moment
    nu: Tensors                 # second moment


@dataclasses.dataclass(frozen=True)
class Zero1Part:
    """The part of a parameter's optimizer state this rank holds."""

    held: bool            # the rank holds any of it
    dim: Optional[int]    # dim of the (tp-local) parameter split over dp, or None
    start: int = 0        # the part along ``dim``
    size: int = 0
    owner: int = -1       # dp rank holding the whole state, for a layer split
    axis: str = DP        # the leaf's data axis ("edp" for an expert leaf)


def zero1_part(leaf: LeafSpec, layer: Optional[int], coords=None) -> Zero1Part:
    """Where the rank at ``coords`` (the live mesh's by default) stands on
    one state leaf (:func:`optimizer_state_specs`)."""
    coords = mesh_coords() if coords is None else coords
    axis = leaf.data_axis
    if axis not in leaf.spec:
        return Zero1Part(True, None, axis=axis)
    i = leaf.spec.index(axis)
    lo, hi = dim_range(leaf, coords, i)
    if leaf.stacked and i == 0:
        per = hi - lo
        return Zero1Part(lo <= layer < hi, None, owner=layer // per, axis=axis)
    return Zero1Part(True, i - 1 if leaf.stacked else i, lo, hi - lo, axis=axis)


def optimizer_state_specs(
    specs: Mapping[str, LeafSpec], config: OptimizerConfig, dp: Optional[int] = None,
    edp: Optional[int] = None,
) -> OptimizerState:
    """The :class:`..parallel.layout.LeafSpec` of every state leaf (JAX
    ``optimizer_state_specs``): the parameter's, with ZeRO-1's split over
    its data axis added under ``zero_one_enabled``; ``dp`` (the (dp, ep)
    plane) and ``edp`` (the mesh's dp) are the live mesh's by default."""
    dp = parallel_state.data_parallel_size_or(1) if dp is None else dp
    edp = parallel_state.expert_data_parallel_size_or(1) if edp is None else edp
    state = (
        {k: s.with_dp_shard(dp, edp) for k, s in specs.items()}
        if config.zero_one_enabled else dict(specs)
    )
    return OptimizerState(
        step=LeafSpec((), ()),
        master=state if config.use_master_weights else None,
        mu=state,
        nu=dict(state),
    )


def _part_of(p: torch.Tensor, part: Zero1Part) -> torch.Tensor:
    return p if part.dim is None else p.narrow(part.dim, part.start, part.size)


def zero1_parts(state_specs: Optional[OptimizerState]) -> Optional[Dict[str, Zero1Part]]:
    if state_specs is None:
        return None
    return {k: zero1_part(s, jax_path(k)[1]) for k, s in state_specs.mu.items()}


def init_optimizer_state(params: Mapping[str, torch.Tensor], config: OptimizerConfig,
                         state_specs: Optional[OptimizerState] = None) -> OptimizerState:
    """Zero moments and the master copy; with ``state_specs`` only the
    part of each leaf this rank holds under ZeRO-1."""
    sd = config.state_torch_dtype
    parts = zero1_parts(state_specs)
    held = {
        k: _part_of(p, parts[k]) if parts else p
        for k, p in params.items() if not parts or parts[k].held
    }
    return OptimizerState(
        step=0,
        master=(
            {k: p.detach().to(sd, copy=True) for k, p in held.items()}
            if config.use_master_weights else None
        ),
        mu={k: torch.zeros(p.shape, dtype=sd, device=p.device) for k, p in held.items()},
        nu={k: torch.zeros(p.shape, dtype=sd, device=p.device) for k, p in held.items()},
    )


def _data_group(axis: str):
    """The group of a data axis, None when it has one rank."""
    group = axis_group(axis)
    return group if dist.get_world_size(group) > 1 else None


def zero1_reduce_grads(grads: Tensors, parts: Optional[Mapping[str, Zero1Part]],
                       specs: Optional[Mapping[str, LeafSpec]] = None) -> Tensors:
    """Sum each gradient over its data-parallel ranks (an expert leaf's
    over dp alone, ``specs`` telling them apart) and keep the rank's part: a
    reduce-scatter along the split dim, a reduce to the owner for a layer
    split, an all-reduce for a leaf whose state stays whole (or every leaf
    without ZeRO-1, ``parts`` None). Identity at dp = 1."""
    if parallel_state.data_parallel_size_or(1) == 1:
        return grads
    out: Tensors = {}
    for k, g in grads.items():
        axis = specs[k].data_axis if specs is not None else DP
        part = parts[k] if parts else Zero1Part(True, None, axis=axis)
        group = _data_group(part.axis)
        if group is None:
            out[k] = g
        elif part.dim is not None:
            out[k] = reduce_scatter(g, part.dim, group)
        elif part.owner >= 0:
            g = g.contiguous()
            dist.reduce(g, dst=dist.get_global_rank(group, part.owner), group=group)
            if part.held:
                out[k] = g
        else:
            out[k] = all_reduce(g, group)
    return out


def zero1_gather_params(params: Mapping[str, torch.Tensor],
                        parts: Optional[Mapping[str, Zero1Part]]) -> None:
    """After the update, every dp rank's parameters made whole again: the
    parts all-gathered along their dim, a layer broadcast from its owner."""
    if not parts or parallel_state.data_parallel_size_or(1) == 1:
        return
    with torch.no_grad():
        for k, p in params.items():
            part = parts[k]
            group = _data_group(part.axis)
            if group is None:
                continue
            if part.dim is not None:
                p.copy_(all_gather(_part_of(p, part), part.dim, group))
            elif part.owner >= 0:
                buf = p.detach().contiguous()
                dist.broadcast(buf, src=dist.get_global_rank(group, part.owner), group=group)
                if buf.data_ptr() != p.data_ptr():
                    p.copy_(buf)


def norm_owned(specs: Mapping[str, LeafSpec], parts: Optional[Mapping[str, Zero1Part]],
               zero1: bool) -> Dict[str, bool]:
    """Which of this rank's gradients count in the global norm: a
    tp-replicated leaf on tp rank 0 only, a leaf whole on every dp rank on
    dp rank 0 only, every leaf (all are replicated over cp) on cp rank 0
    only (``parallel/grads.py``), and under a pipeline each leaf on one
    stage: a layer on its own, the tied embedding on the first, the final
    norm on the last (:func:`..parallel.layout.pp_owner`). An expert leaf
    is distinct on every ep rank and whole on every rank of the mesh's dp."""
    coords = mesh_coords()
    tp_r, cp_r = coords[TP][0], coords[parallel_state.CP_AXIS][0]
    out = {}
    for k, leaf in specs.items():
        part = parts[k] if parts else Zero1Part(True, None)
        dp_split = zero1 and (part.dim is not None or part.owner >= 0)
        dp_r = coords[leaf.data_axis][0]
        out[k] = ((tp_r == 0 or leaf.mentions(TP))
                  and (dp_r == 0 or dp_split) and cp_r == 0 and pp_owner(leaf, coords))
    return out


@torch.no_grad()
def apply_gradients(
    state: OptimizerState,
    grads: Mapping[str, torch.Tensor],
    params: Mapping[str, torch.Tensor],
    config: OptimizerConfig,
    weight_decay_mask: Optional[Mapping[str, bool]] = None,
    parts: Optional[Mapping[str, Zero1Part]] = None,
    owned: Optional[Mapping[str, bool]] = None,
) -> Tuple[Mapping[str, torch.Tensor], OptimizerState, torch.Tensor]:
    """One AdamW step; returns (params, state, pre-clip grad norm).
    ``params`` and the tensors of ``state`` are updated in place and
    returned; ``step`` is the new count. A leaf decays unless
    ``weight_decay_mask`` says False for it. Under ZeRO-1 (``parts``) the
    rank updates the part of each parameter it holds the state of, and
    ``grads`` holds those parts (:func:`zero1_reduce_grads`); ``owned``
    says which gradients count in the norm, whose parts are summed over
    every rank."""
    group = world_group() if owned is not None else None
    norm = global_norm(grads, owned, group)
    scale = clip_coefficient(norm, config.max_grad_norm) if config.grad_clipping else None

    step = state.step + 1
    lr = config.lr_at(step)
    b1, b2 = config.beta1, config.beta2
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step
    sd = config.state_torch_dtype
    # leaf by leaf, so that only one leaf's fp32 temporaries are alive at once
    for name in state.mu:
        p = params[name]
        part = parts[name] if parts else Zero1Part(True, None)
        target = _part_of(p, part)
        g = grads[name].float()
        if scale is not None:
            g = g * scale
        mu, nu = state.mu[name], state.nu[name]
        mu.copy_((b1 * mu.float() + (1 - b1) * g).to(sd))
        nu.copy_((b2 * nu.float() + (1 - b2) * g * g).to(sd))
        current = (state.master[name] if state.master is not None else target).float()
        wd = config.weight_decay if (weight_decay_mask is None or weight_decay_mask[name]) else 0.0
        update = (mu.float() / c1) / (torch.sqrt(nu.float() / c2) + config.eps)
        new = current - lr * (update + wd * current)
        target.copy_(new.to(p.dtype))
        if state.master is not None:
            state.master[name].copy_(new.to(sd))
    return params, state._replace(step=step), norm


def state_bytes(state: OptimizerState) -> int:
    """Bytes of this rank's master, mu and nu."""
    trees = [t for t in (state.master, state.mu, state.nu) if t is not None]
    return sum(x.numel() * x.element_size() for t in trees for x in t.values())


# ---------------------------------------------------------------------------
# bridge to the JAX package's OptimizerState
# ---------------------------------------------------------------------------

def opt_state_from_jax(
    np_state: Any, config: LlamaConfig, opt_config: OptimizerConfig,
    device: DeviceLike = "cuda", state_specs: Optional[OptimizerState] = None,
) -> OptimizerState:
    """The JAX package's ``OptimizerState`` (step, master, mu, nu as numpy
    pytrees; master None without master weights) -> the port's, every leaf
    in ``opt_config.state_dtype``: this rank's part of each leaf by
    ``state_specs`` (:func:`optimizer_state_specs` at the live mesh by
    default)."""
    sd = opt_config.state_torch_dtype
    step, master, mu, nu = np_state
    if state_specs is None:
        state_specs = optimizer_state_specs(param_specs(config), opt_config)

    def tree(t, specs):
        return tree_from_jax(t, config, lambda name: sd, device, specs=specs)

    return OptimizerState(
        step=int(np.asarray(step)),
        master=tree(master, state_specs.mu) if master is not None else None,
        mu=tree(mu, state_specs.mu),
        nu=tree(nu, state_specs.nu),
    )


def opt_state_to_jax(state: OptimizerState, config: LlamaConfig,
                     state_specs: Optional[OptimizerState] = None) -> OptimizerState:
    """Inverse of :func:`opt_state_from_jax`: the same four fields with the
    JAX package's pytrees as fp32 numpy arrays, every part gathered back
    over the mesh, and ``step`` as int32, in the field order of its
    ``OptimizerState``. Under a mesh every rank must call it."""
    if state_specs is None:
        state_specs = optimizer_state_specs(param_specs(config), OptimizerConfig())
    return OptimizerState(
        step=np.int32(state.step),
        master=params_to_jax(state.master, config, state_specs.mu) if state.master is not None else None,
        mu=params_to_jax(state.mu, config, state_specs.mu),
        nu=params_to_jax(state.nu, config, state_specs.nu),
    )
