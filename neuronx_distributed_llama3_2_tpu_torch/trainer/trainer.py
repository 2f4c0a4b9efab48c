"""Training facade.

Counterpart of ``neuronx_distributed_llama3_2_tpu/trainer/trainer.py``
(:81-258): ``initialize_parallel_model`` → ``make_train_step`` →
``step(state, batch)``, with the JAX package's microbatching (strided
split, each microbatch weighted by its valid-token count) and its eval
step, on one device or over the mesh of :meth:`..trainer.config.
TrainingConfig.initialize`. Each rank holds its shard of the model and
of the optimizer state (ZeRO-1 under dp); a step takes the rank's rows of
the global batch by JAX's rule (dp rank r the r-th contiguous block; the
cp ranks of one dp rank take the same rows and each its chunk of their
sequences), sums the gradients over cp, then over dp (reduce-scattered
into ZeRO-1's parts, within each pipeline stage's dp group; under expert
parallelism a dense leaf's over the (dp, ep) plane, whose ranks hold
different rows, an expert leaf's over dp alone), clips by the
norm over every rank's parts (every pp rank's too) and all-gathers the
updated parameters. A pipelined model (:class:`..pipeline.PipelinedCausalLM`,
``uses_manual_vjp``) computes its own gradients and its own microbatches
(JAX ``make_train_step`` :155-162); its eval step runs the forward-only
schedule.

A :class:`TrainState` holds the model's own parameters (a dict keyed by
parameter name, the same tensor objects as ``model.named_parameters()``)
and the optimizer state. A step updates both IN PLACE and returns the
same state with the new step count: the JAX step donates its input state
and returns a new one, and here the tensors are simply reused.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, NamedTuple, Optional, Tuple

import torch

from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.layout import is_layer_name
from neuronx_distributed_llama3_2_tpu_torch.parallel.loss import valid_token_mask
from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import all_reduce
from neuronx_distributed_llama3_2_tpu_torch.trainer.config import (
    TrainingConfig,
    validate_pipeline_config,
)
from neuronx_distributed_llama3_2_tpu_torch.trainer.optimizer import (
    OptimizerState,
    apply_gradients,
    init_optimizer_state,
    norm_owned,
    optimizer_state_specs,
    zero1_gather_params,
    zero1_parts,
    zero1_reduce_grads,
)

Params = Dict[str, torch.nn.Parameter]


class TrainState(NamedTuple):
    params: Params
    opt: OptimizerState


def state_specs(model: torch.nn.Module, config: TrainingConfig) -> TrainState:
    """The :class:`..parallel.layout.LeafSpec` of every leaf of the train
    state on the live mesh (JAX's state specs): the parameters' by
    ``specs()``, the optimizer state's with ZeRO-1's dp split."""
    specs = model.param_specs()
    return TrainState(specs, optimizer_state_specs(specs, config.optimizer))


def initialize_parallel_model(
    model: torch.nn.Module, config: TrainingConfig, key: Optional[int] = None,
) -> Tuple[TrainState, TrainState]:
    """Draw the model's weights from seed ``key`` (``config.seed`` by
    default; every rank draws the whole tensors and keeps its shard) and
    build this rank's optimizer state. Returns (state, specs), the specs
    as :func:`state_specs` gives them."""
    config.require_ported()
    validate_pipeline_config(model, config)
    model.init_weights(config.seed if key is None else key)
    params = dict(model.named_parameters())
    specs = state_specs(model, config)
    return TrainState(params, init_optimizer_state(params, config.optimizer, specs.opt)), specs


def default_weight_decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True where weight decay applies: not norm scales or biases, and only
    matrices. The JAX package decides on its stacked (L, ...) layer leaves,
    which have one dimension more than the port's per-layer tensors; a
    layer leaf is counted here with that leading dimension."""

    def decide(name: str, p: torch.Tensor) -> bool:
        lowered = name.lower()
        if "norm" in lowered or "bias" in lowered or "scale" in lowered:
            return False
        return p.dim() + (1 if is_layer_name(name) else 0) >= 2

    return {name: decide(name, p) for name, p in params.items()}


def _check_params(model: torch.nn.Module, params: Mapping[str, torch.Tensor]) -> None:
    own = dict(model.named_parameters())
    if own.keys() != params.keys() or any(own[k] is not params[k] for k in own):
        raise ValueError(
            "params must be the model's own parameters (the TrainState from "
            "initialize_parallel_model, or dict(model.named_parameters()))"
        )


def _valid_count(labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Tokens that carry loss: the CE's own rule on the labels shifted over
    the whole sequence (under cp, the count over every cp rank's chunk)."""
    return valid_token_mask(labels[:, 1:], vocab_size).float().sum()


def dp_rows(batch: torch.Tensor) -> torch.Tensor:
    """This dp rank's rows of a global batch: the r-th of dp contiguous
    blocks (JAX shards the batch dim over ("dp", "ep"), not over cp: the cp
    ranks of one dp rank take the same rows)."""
    dp = parallel_state.data_parallel_size_or(1)
    if dp == 1:
        return batch
    if batch.shape[0] % dp:
        raise ValueError(f"global batch {batch.shape[0]} not divisible by dp={dp}")
    per = batch.shape[0] // dp
    r = parallel_state.get_data_parallel_rank()
    return batch[r * per:(r + 1) * per]


def _check_mesh(model, config: TrainingConfig) -> None:
    """The live mesh must be the config's (cp, pp, ep), and a model built
    under pp > 1 (a stage) must run through the pipeline."""
    for what, axis, live, want in (
            ("expert_parallel_size", "ep", parallel_state.expert_parallel_size_or(1),
             config.expert_parallel_size),
            ("context_parallel_size", "cp", parallel_state.context_parallel_size_or(1),
             config.context_parallel_size),
            ("pipeline_parallel_size", "pp", parallel_state.pipeline_parallel_size_or(1),
             config.pipeline_parallel_size)):
        if live != want:
            raise ValueError(f"{what}={want}, but the live mesh has {axis} = {live}: call "
                             "config.initialize() first")
    if getattr(model, "stage", None) is not None and not getattr(model, "uses_manual_vjp", False):
        raise ValueError("the model is one stage of a pipeline (pp > 1): wrap it in "
                         "PipelinedCausalLM")


def make_train_step(model: torch.nn.Module, config: TrainingConfig,
                    local_batch: bool = False) -> Callable:
    """A train step ``(state, batch) -> (state, metrics)``.

    ``batch = {"input_ids": (GBS, S), "labels": (GBS, S)}`` on the model's
    device, the global batch on every rank (any other entry, (GBS, ...),
    goes to ``model.loss`` by name with the same rows: Mllama's
    ``pixel_values``, ``aspect_ratio_ids``, ``aspect_ratio_mask`` and
    ``cross_attention_mask``); each dp rank takes its rows
    (:func:`dp_rows`), or is given them with ``local_batch`` (what
    :class:`..data.dataset.DistributedDataLoader` yields). The rank's rows
    are split into ``config.num_microbatches`` strided microbatches (row m
    of microbatch k is row k + m * num_microbatches, so each microbatch
    takes rows of every dp shard, as in JAX); each contributes its
    gradients weighted by its share of the step's valid tokens over every
    dp rank (its backward seeded with that share, so that a gradient
    crossing ranks, an expert's through the ep all-to-all, carries its own
    rank's weight), accumulated in fp32 under ``use_fp32_grad_acc`` (else
    in the parameters' dtype), so the step equals the global-batch mean
    CE. Under context parallelism the model's
    loss is the mean over every cp rank's chunk and each rank's gradient its
    chunk's share: the gradients are summed over cp first. They are summed
    over dp (into ZeRO-1's parts), then one AdamW step on every rank's part
    and the parameters gathered again. A model with ``uses_manual_vjp`` (a
    :class:`..pipeline.PipelinedCausalLM`) gives each (trainer) microbatch's
    loss and fp32 gradients itself (``loss_and_grad``: its own microbatches,
    the pipeline's sends, the tied embedding's sum over the first and last
    stage); ``config.num_microbatches`` is then 1 as a rule. ``metrics``
    holds the loss and the pre-clip grad norm as fp32 device scalars, the
    learning rate after the step and the step count. The state is updated
    in place (module docstring)."""
    config.require_ported()
    validate_pipeline_config(model, config)
    _check_mesh(model, config)
    opt_cfg = config.optimizer
    n_micro = config.num_microbatches
    vocab = model.config.vocab_size
    specs = state_specs(model, config)
    dp = parallel_state.data_parallel_size_or(1)
    cp = parallel_state.context_parallel_size_or(1)
    sharded = parallel_state.model_parallel_is_initialized() and parallel_state.get_parallel_state().world_size > 1
    parts = zero1_parts(specs.opt) if opt_cfg.zero_one_enabled else None
    owned = norm_owned(specs.params, parts, opt_cfg.zero_one_enabled) if sharded else None

    manual = getattr(model, "uses_manual_vjp", False)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        _check_params(model, state.params)
        input_ids, labels = batch["input_ids"], batch["labels"]
        # the batch's other inputs (Mllama's images and masks), row for row
        extra = {k: v for k, v in batch.items() if k not in ("input_ids", "labels")}
        if not local_batch:
            input_ids, labels = dp_rows(input_ids), dp_rows(labels)
            extra = {k: dp_rows(v) for k, v in extra.items()}
        names = list(state.params)
        leaves = [state.params[k] for k in names]

        def loss_and_grads(ids, lbl, weight=None, rows=slice(None)):
            """The loss and the gradients of ``weight`` x the loss (of the
            loss itself without a weight), over the batch's ``rows``."""
            if manual:
                loss, grads = model.loss_and_grad(ids, lbl)
                got = [grads[k] for k in names]
                return loss, got if weight is None else [g * weight for g in got]
            loss = model.loss(ids, lbl, **{k: v[rows] for k, v in extra.items()})
            seed = None if weight is None else weight.to(loss.dtype)
            # a parameter the loss does not read (BERT's NSP head under the
            # MLM loss) gets a zero gradient, as under jax.grad
            return loss.detach(), torch.autograd.grad(loss, leaves, seed, allow_unused=True,
                                                      materialize_grads=True)

        if n_micro == 1 and dp == 1 and cp == 1:
            loss, got = loss_and_grads(input_ids, labels)
            grads = dict(zip(names, got))
            if opt_cfg.use_fp32_grad_acc:
                grads = {k: g.float() for k, g in grads.items()}
        else:
            gbs = input_ids.shape[0]
            if gbs % n_micro:
                raise ValueError(
                    f"batch {gbs} (the rank's rows) is not a multiple of "
                    f"num_microbatches {n_micro}"
                )
            grads = {
                k: torch.zeros(p.shape, device=p.device,
                               dtype=torch.float32 if opt_cfg.use_fp32_grad_acc else p.dtype)
                for k, p in state.params.items()
            }
            # the step's token count over every dp rank first: each
            # microbatch's backward is seeded with its share of it, so a
            # gradient that reaches another rank's parameters (an expert's,
            # through the ep all-to-all) carries its own rank's weight
            counts = [_valid_count(labels[k::n_micro], vocab) for k in range(n_micro)]
            tok_sum = torch.stack(counts).sum()
            if dp > 1:
                tok_sum = all_reduce(tok_sum, parallel_state.get_data_parallel_group())
            denom = torch.clamp(tok_sum, min=1.0)
            loss_sum = torch.zeros((), device=input_ids.device)
            for k, n in enumerate(counts):
                ids, lbl = input_ids[k::n_micro], labels[k::n_micro]
                loss, got = loss_and_grads(ids, lbl, n / denom, slice(k, None, n_micro))
                for name, g in zip(names, got):
                    grads[name] += g.to(grads[name].dtype)
                loss_sum += loss * n
            if cp > 1:
                group = parallel_state.get_context_parallel_group()
                grads = {k: all_reduce(g, group) for k, g in grads.items()}
            if dp > 1:
                loss_sum = all_reduce(loss_sum, parallel_state.get_data_parallel_group())
                grads = zero1_reduce_grads(grads, parts, specs.params)
            loss = loss_sum / denom
        _, opt, grad_norm = apply_gradients(
            state.opt, grads, state.params, opt_cfg,
            weight_decay_mask=default_weight_decay_mask(state.params),
            parts=parts, owned=owned,
        )
        zero1_gather_params(state.params, parts)
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
    an optimizer (under cp the mean over every cp rank's chunk, the same on
    each; a pipelined model's forward-only schedule, the loss on every pp
    rank). ``params`` are the model's own (``state.params``)."""
    validate_pipeline_config(model, config)

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
