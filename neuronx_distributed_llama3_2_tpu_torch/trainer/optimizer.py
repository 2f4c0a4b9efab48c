"""AdamW with optional fp32 master weights, single device.

Counterpart of ``neuronx_distributed_llama3_2_tpu/trainer/optimizer.py``
(``OptimizerState``, ``init_optimizer_state``, ``apply_gradients``), with
its order of operations: gradients to fp32 → clip by the global norm →
moments in fp32, stored in ``state_dtype`` → AdamW on the fp32 master (or
on the parameters themselves without one) → parameters = cast(master).
ZeRO-1 sharding waits for the multi-GPU slice.

Parameters, gradients and the moments are dicts keyed by the model's
parameter names. :func:`apply_gradients` updates parameters and state IN
PLACE (the JAX package returns new pytrees and donates the old ones; here
the tensors are reused, which keeps one copy of each in device memory).

:func:`opt_state_from_jax` / :func:`opt_state_to_jax` carry the state
between the packages as :func:`..models.llama.params_from_jax` /
``params_to_jax`` carry the weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LlamaConfig,
    params_to_jax,
    tree_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.grads import (
    clip_coefficient,
    global_norm,
)
from neuronx_distributed_llama3_2_tpu_torch.trainer.config import OptimizerConfig
from neuronx_distributed_llama3_2_tpu_torch.utils.device import DeviceLike

Tensors = Dict[str, torch.Tensor]


class OptimizerState(NamedTuple):
    step: int                   # optimizer steps taken
    master: Optional[Tensors]   # master params (None without master weights)
    mu: Tensors                 # first moment
    nu: Tensors                 # second moment


def init_optimizer_state(params: Mapping[str, torch.Tensor],
                         config: OptimizerConfig) -> OptimizerState:
    sd = config.state_torch_dtype
    return OptimizerState(
        step=0,
        master=(
            {k: p.detach().to(sd, copy=True) for k, p in params.items()}
            if config.use_master_weights else None
        ),
        mu={k: torch.zeros(p.shape, dtype=sd, device=p.device) for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=sd, device=p.device) for k, p in params.items()},
    )


@torch.no_grad()
def apply_gradients(
    state: OptimizerState,
    grads: Mapping[str, torch.Tensor],
    params: Mapping[str, torch.Tensor],
    config: OptimizerConfig,
    weight_decay_mask: Optional[Mapping[str, bool]] = None,
) -> Tuple[Mapping[str, torch.Tensor], OptimizerState, torch.Tensor]:
    """One AdamW step; returns (params, state, pre-clip grad norm).
    ``params`` and the tensors of ``state`` are updated in place and
    returned; ``step`` is the new count. A leaf decays unless
    ``weight_decay_mask`` says False for it."""
    norm = global_norm(grads)
    scale = clip_coefficient(norm, config.max_grad_norm) if config.grad_clipping else None

    step = state.step + 1
    lr = config.lr_at(step)
    b1, b2 = config.beta1, config.beta2
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step
    sd = config.state_torch_dtype
    # leaf by leaf, so that only one leaf's fp32 temporaries are alive at once
    for name, p in params.items():
        g = grads[name].float()
        if scale is not None:
            g = g * scale
        mu, nu = state.mu[name], state.nu[name]
        mu.copy_((b1 * mu.float() + (1 - b1) * g).to(sd))
        nu.copy_((b2 * nu.float() + (1 - b2) * g * g).to(sd))
        current = (state.master[name] if state.master is not None else p).float()
        wd = config.weight_decay if (weight_decay_mask is None or weight_decay_mask[name]) else 0.0
        update = (mu.float() / c1) / (torch.sqrt(nu.float() / c2) + config.eps)
        new = current - lr * (update + wd * current)
        p.copy_(new.to(p.dtype))
        if state.master is not None:
            state.master[name].copy_(new.to(sd))
    return params, state._replace(step=step), norm


# ---------------------------------------------------------------------------
# bridge to the JAX package's OptimizerState
# ---------------------------------------------------------------------------

def opt_state_from_jax(
    np_state: Any, config: LlamaConfig, opt_config: OptimizerConfig,
    device: DeviceLike = "cuda",
) -> OptimizerState:
    """The JAX package's ``OptimizerState`` (step, master, mu, nu as numpy
    pytrees; master None without master weights) -> the port's, every leaf
    in ``opt_config.state_dtype``."""
    sd = opt_config.state_torch_dtype
    step, master, mu, nu = np_state

    def tree(t):
        return tree_from_jax(t, config, lambda name: sd, device)

    return OptimizerState(
        step=int(np.asarray(step)),
        master=tree(master) if master is not None else None,
        mu=tree(mu),
        nu=tree(nu),
    )


def opt_state_to_jax(state: OptimizerState, config: LlamaConfig) -> OptimizerState:
    """Inverse of :func:`opt_state_from_jax`: the same four fields with the
    JAX package's pytrees as fp32 numpy arrays and ``step`` as int32, in
    the field order of its ``OptimizerState``."""
    return OptimizerState(
        step=np.int32(state.step),
        master=params_to_jax(state.master, config) if state.master is not None else None,
        mu=params_to_jax(state.mu, config),
        nu=params_to_jax(state.nu, config),
    )
