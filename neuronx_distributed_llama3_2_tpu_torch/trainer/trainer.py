"""Training facade, single device.

Counterpart of ``neuronx_distributed_llama3_2_tpu/trainer/trainer.py``:
``initialize_parallel_model`` → ``make_train_step`` → ``step(state,
batch)``, with the JAX package's microbatching (strided split, each
microbatch weighted by its valid-token count) and its eval step.

A :class:`TrainState` holds the model's own parameters (a dict keyed by
parameter name, the same tensor objects as ``model.named_parameters()``)
and the optimizer state. A step updates both IN PLACE and returns the
same state with the new step count: the JAX step donates its input state
and returns a new one, and here the tensors are simply reused.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, NamedTuple, Optional, Tuple

import torch

from neuronx_distributed_llama3_2_tpu_torch.parallel.loss import valid_token_mask
from neuronx_distributed_llama3_2_tpu_torch.trainer.config import TrainingConfig
from neuronx_distributed_llama3_2_tpu_torch.trainer.optimizer import (
    OptimizerState,
    apply_gradients,
    init_optimizer_state,
)

Params = Dict[str, torch.nn.Parameter]


class TrainState(NamedTuple):
    params: Params
    opt: OptimizerState


def initialize_parallel_model(
    model: torch.nn.Module, config: TrainingConfig, key: Optional[int] = None,
) -> Tuple[TrainState, None]:
    """Draw the model's weights from seed ``key`` (``config.seed`` by
    default) and build its optimizer state. Returns (state, None): the
    second element stands where the JAX package returns the partition
    specs, which one device does not have."""
    config.require_single_device()
    model.init_weights(config.seed if key is None else key)
    params = dict(model.named_parameters())
    return TrainState(params, init_optimizer_state(params, config.optimizer)), None


def default_weight_decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True where weight decay applies: not norm scales or biases, and only
    matrices. The JAX package decides on its stacked (L, ...) layer leaves,
    which have one dimension more than the port's per-layer tensors; a
    layer leaf is counted here with that leading dimension."""

    def decide(name: str, p: torch.Tensor) -> bool:
        lowered = name.lower()
        if "norm" in lowered or "bias" in lowered or "scale" in lowered:
            return False
        return p.dim() + (1 if name.startswith("layers.") else 0) >= 2

    return {name: decide(name, p) for name, p in params.items()}


def _check_params(model: torch.nn.Module, params: Mapping[str, torch.Tensor]) -> None:
    own = dict(model.named_parameters())
    if own.keys() != params.keys() or any(own[k] is not params[k] for k in own):
        raise ValueError(
            "params must be the model's own parameters (the TrainState from "
            "initialize_parallel_model, or dict(model.named_parameters()))"
        )


def _valid_count(labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Tokens that carry loss: the CE's own rule on the shifted labels."""
    return valid_token_mask(labels[:, 1:], vocab_size).float().sum()


def make_train_step(model: torch.nn.Module, config: TrainingConfig) -> Callable:
    """A train step ``(state, batch) -> (state, metrics)``.

    ``batch = {"input_ids": (GBS, S), "labels": (GBS, S)}`` on the model's
    device. The global batch is split into ``config.num_microbatches``
    strided microbatches (row m of microbatch k is global row
    k + m * num_microbatches); each contributes its gradients weighted by
    its valid-token count, accumulated in fp32 under
    ``use_fp32_grad_acc`` (else in the parameters' dtype), so the step
    equals the global-batch mean CE. Then one AdamW step. ``metrics`` holds
    the loss and the pre-clip grad norm as fp32 device scalars, the
    learning rate after the step and the step count. The state is updated
    in place (module docstring)."""
    config.require_single_device()
    opt_cfg = config.optimizer
    n_micro = config.num_microbatches
    vocab = model.config.vocab_size

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        _check_params(model, state.params)
        input_ids, labels = batch["input_ids"], batch["labels"]
        names = list(state.params)
        leaves = [state.params[k] for k in names]
        if n_micro == 1:
            loss = model.loss(input_ids, labels)
            grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
            if opt_cfg.use_fp32_grad_acc:
                grads = {k: g.float() for k, g in grads.items()}
            loss = loss.detach()
        else:
            gbs = input_ids.shape[0]
            if gbs % n_micro:
                raise ValueError(
                    f"global batch {gbs} is not a multiple of num_microbatches {n_micro}"
                )
            grads = {
                k: torch.zeros(p.shape, device=p.device,
                               dtype=torch.float32 if opt_cfg.use_fp32_grad_acc else p.dtype)
                for k, p in state.params.items()
            }
            loss_sum = torch.zeros((), device=input_ids.device)
            tok_sum = torch.zeros((), device=input_ids.device)
            for k in range(n_micro):
                ids, lbl = input_ids[k::n_micro], labels[k::n_micro]
                loss = model.loss(ids, lbl)
                n = _valid_count(lbl, vocab)
                for name, g in zip(names, torch.autograd.grad(loss, leaves)):
                    acc = grads[name]
                    acc += g.to(acc.dtype) * n.to(acc.dtype)
                loss_sum += loss.detach() * n
                tok_sum += n
            denom = torch.clamp(tok_sum, min=1.0)
            for g in grads.values():
                g /= denom.to(g.dtype)
            loss = loss_sum / denom
        _, opt, grad_norm = apply_gradients(
            state.opt, grads, state.params, opt_cfg,
            weight_decay_mask=default_weight_decay_mask(state.params),
        )
        metrics = {
            "loss": loss.float(),
            "grad_norm": grad_norm,
            "learning_rate": opt_cfg.lr_at(opt.step),
            "step": opt.step,
        }
        return TrainState(state.params, opt), metrics

    return train_step


def make_eval_step(model: torch.nn.Module, config: TrainingConfig) -> Callable:
    """An eval step ``(params, batch) -> loss`` (fp32 device scalar): the
    training loss over the whole batch, without autograd, microbatches or
    an optimizer. ``params`` are the model's own (``state.params``)."""
    del config

    @torch.no_grad()
    def eval_step(params: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor]):
        _check_params(model, params)
        return model.loss(batch["input_ids"], batch["labels"]).float()

    return eval_step


def evaluate(
    model: torch.nn.Module, config: TrainingConfig, params: Mapping[str, torch.Tensor],
    batches: Iterable[Mapping[str, torch.Tensor]], eval_step: Optional[Callable] = None,
) -> float:
    """Mean eval loss over ``batches``."""
    step = eval_step if eval_step is not None else make_eval_step(model, config)
    total, n = 0.0, 0
    for batch in batches:
        total += float(step(params, batch))
        n += 1
    if n == 0:
        raise ValueError("evaluate() got an empty batch iterable")
    return total / n
