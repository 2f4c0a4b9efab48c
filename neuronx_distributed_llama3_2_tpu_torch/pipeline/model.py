"""Pipeline-parallel causal LM: each rank runs its stage's task list.

Counterpart of ``neuronx_distributed_llama3_2_tpu/pipeline/model.py``
(``PipelinedCausalLM``, with its fields and checks). The JAX package is
one SPMD program: the microbatch stream moves by ``jnp.roll`` (a
collective-permute), gpipe is one ``lax.scan`` with an autodiff backward,
1F1B a scan with a manual VJP a lane. The port runs one process per rank,
as the NxD reference does (``pipeline/model.py`` ``NxDPPModel``), and there
the reference's design is the natural one: the model on each pp rank is
its stage (:class:`..models.llama.Stage`: its layers under their global
names, the embedding on the first stage and, tied, on the last, the final
norm and the head on the last), and each rank walks the task list of
:mod:`.scheduler` for its rank:

- ``RecvForwardTask`` waits for the previous stage's output
  (:func:`..parallel.mappings.recv_forward`), a leaf that records its
  gradient; ``ForwardStepTask`` runs the stage's layers on it (the first
  virtual stage embeds the microbatch's tokens, the last runs the final
  norm and the head and gives the microbatch's CE sum over the step's
  token count); ``SendForwardTask`` sends the output without waiting. The
  stage's input and output stay until the microbatch's backward.
- ``RecvBackwardTask`` waits for the gradient of the output;
  ``BackwardStepTask`` differentiates the output (``torch.autograd.grad``)
  by the stage input and the stage's parameters, adds the parameters'
  gradients into fp32 accumulators and frees the pair;
  ``SendBackwardTask`` sends the input's gradient upstream.
- ``ReduceGradsTask`` sums the tied embedding's gradient over the first
  and the last stage (the reference's ``_reduce_shared_weights``; GSPMD's
  sum of the two uses in JAX). The trainer's dp / cp reductions follow.

Schedules: ``gpipe`` runs :class:`.scheduler.TrainGPipeSchedule`, ``1f1b``
:class:`.scheduler.Train1F1BSchedule` (at most ``min(pp - rank, M)`` stage
inputs held at once against M), ``interleaved``
:class:`.scheduler.TrainInterleavedSchedule` under
``memory_bounded_backward`` and every chunk's forward before any backward
otherwise (:class:`InterleavedGPipeSchedule`). The forward-only pass
(:meth:`PipelinedCausalLM.loss`, ``__call__``) runs
:class:`.scheduler.InferenceSchedule`. Microbatch ``m`` takes rows ``m::M``
(JAX's strided split); the loss is normalized by the valid-token count of
the whole batch, known from the labels up front. Every rank runs the same
task order for every message pair (sends never block), so a pair of ranks
matches its messages by order.

An MoE model (:class:`..models.mixtral.MixtralForCausalLM`) runs the same
way: each (chunk, microbatch) visit's forward leaves the mean
load-balancing loss of the chunk's layers, and the visit adds
``router_aux_loss_coef`` times it over ``pp · V · M`` into its own backward,
as a constant cotangent (JAX's 1F1B executor, :242-361, :454-508); the loss
sums the visits' terms over every stage.

By design, and unlike JAX: ``uses_manual_vjp`` is True for every schedule
(no autodiff spans processes; each rank runs its backward steps itself),
and ``head_sequence_split`` (JAX's way to spread the head over the SPMD
lanes) has no counterpart: the head runs on the last stage, and both values
give the same loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_llama3_2_tpu_torch.models.llama import LlamaForCausalLM, pipeline_stage
from neuronx_distributed_llama3_2_tpu_torch.models.mixtral import MixtralForCausalLM, aux_term
from neuronx_distributed_llama3_2_tpu_torch.parallel import mappings
from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.loss import valid_token_mask
from neuronx_distributed_llama3_2_tpu_torch.pipeline.scheduler import (
    BackwardStepTask,
    ForwardStepTask,
    InferenceSchedule,
    PipeSchedule,
    PipelineTask,
    RecvBackwardTask,
    RecvForwardTask,
    ReduceGradsTask,
    SendBackwardTask,
    SendForwardTask,
    Train1F1BSchedule,
    TrainGPipeSchedule,
    TrainInterleavedSchedule,
)

SCHEDULES = ("gpipe", "1f1b", "interleaved")
Params = Dict[str, Any]


class InterleavedGPipeSchedule(TrainInterleavedSchedule):
    """The interleaved schedule without its memory bound: every chunk's
    forward in the interleaved order, then every chunk's backward (the
    JAX executor's ``memory_bounded_backward=False``, whose autodiff
    backward holds every microbatch's streams)."""

    def __init__(self, num_microbatches: int, num_model_chunks: int, pp_size: int,
                 pp_rank: int):
        super().__init__(num_microbatches, num_model_chunks, pp_size, pp_rank)
        self.num_warmup = self.total_steps


class _ForwardOnly(PipeSchedule):
    """The forward tasks of another schedule, in its order."""

    def __init__(self, inner: PipeSchedule):
        super().__init__(inner.num_microbatches, inner.pp_size, inner.pp_rank)
        self.inner = inner

    def steps(self) -> Iterator[List[PipelineTask]]:
        fwd = (RecvForwardTask, ForwardStepTask, SendForwardTask)
        for step in self.inner.steps():
            tasks = [t for t in step if isinstance(t, fwd)]
            if tasks:
                yield tasks


@dataclasses.dataclass(frozen=True, eq=False)
class PipelinedCausalLM:
    """This rank's stage of a pipelined :class:`..models.llama.LlamaForCausalLM`
    (module docstring), with JAX's fields. It stands in for the model in
    the trainer (``named_parameters``, ``init_weights``, ``param_specs``,
    ``loss``) and computes its own gradients (:meth:`loss_and_grad`)."""

    model: LlamaForCausalLM
    num_microbatches: int
    schedule: str = "gpipe"
    num_model_chunks: int = 1
    memory_bounded_backward: bool = True
    head_sequence_split: bool = True
    #: what the last call saw: ``max_stashed`` (most stage inputs held at
    #: once), ``tasks`` (the task list run)
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict, init=False)

    def __post_init__(self):
        if not isinstance(self.model, LlamaForCausalLM):
            raise TypeError("PipelinedCausalLM supports the port's LlamaForCausalLM and its "
                            f"MoE subclasses, got {type(self.model).__name__}")
        if parallel_state.expert_parallel_size_or(1) > 1:
            raise NotImplementedError(
                "a pipeline under expert parallelism (pp > 1 and ep > 1) is not ported: "
                "a stage's expert gradients would take their weights from other ranks' "
                "tokens (ROADMAP.md)")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, got {self.schedule!r}")
        if self.num_model_chunks < 1:
            raise ValueError(f"num_model_chunks must be >= 1, got {self.num_model_chunks}")
        if self.num_model_chunks > 1 and self.schedule != "interleaved":
            raise ValueError("num_model_chunks > 1 requires schedule='interleaved'")
        if self.num_microbatches < 1:
            raise ValueError(f"num_microbatches must be >= 1, got {self.num_microbatches}")
        have = self.model.stage.chunks if self.model.stage is not None else 1
        if self._pp() > 1 and have != self.num_model_chunks:
            raise ValueError(
                f"the stage holds {have} model chunks; build the model with "
                f"LlamaForCausalLM(..., num_model_chunks={self.num_model_chunks})"
            )

    # -- the model's surface ---------------------------------------------

    @property
    def uses_manual_vjp(self) -> bool:
        """True: every schedule's gradients come from :meth:`loss_and_grad`
        (the trainer dispatches on this; module docstring)."""
        return True

    @property
    def config(self):
        return self.model.config

    @property
    def device(self) -> torch.device:
        return self.model.device

    def named_parameters(self, *args, **kwargs):
        return self.model.named_parameters(*args, **kwargs)

    def init_weights(self, seed: int) -> "PipelinedCausalLM":
        self.model.init_weights(seed)
        return self

    def param_specs(self):
        return self.model.param_specs()

    def _pp(self) -> int:
        return parallel_state.pipeline_parallel_size_or(1)

    def _layers_per_stage(self) -> int:
        L, pp, v = self.config.num_layers, self._pp(), self.num_model_chunks
        if L % (pp * v) != 0:
            raise ValueError(f"num_layers {L} not divisible by pp*chunks {pp}*{v}")
        return L // (pp * v)

    # -- the JAX package's pipelined layouts (numpy trees) ---------------

    def to_pipeline(self, params: Params) -> Params:
        """A JAX-format tree (``layers`` leaves (L, ...)) -> JAX's pipelined
        layout: (pp, L/pp, ...), or (V, pp, L/(pp·V), ...) interleaved."""
        pp, lps = self._pp(), self._layers_per_stage()
        lead = (self.num_model_chunks, pp, lps) if self.schedule == "interleaved" else (pp, lps)
        out = dict(params)
        out["layers"] = _tree_map(lambda p: np.reshape(p, lead + tuple(np.shape(p)[1:])),
                                  params["layers"])
        return out

    def from_pipeline(self, params: Params) -> Params:
        L = self.config.num_layers
        skip = 3 if self.schedule == "interleaved" else 2
        out = dict(params)
        out["layers"] = _tree_map(lambda p: np.reshape(p, (L,) + tuple(np.shape(p)[skip:])),
                                  params["layers"])
        return out

    # -- schedules ---------------------------------------------------------

    def _coords(self) -> Tuple[int, int]:
        return parallel_state.pipeline_parallel_size_or(1), parallel_state.pipeline_parallel_rank_or(0)

    def train_schedule(self) -> PipeSchedule:
        """The task list this rank runs for a train step."""
        pp, rank = self._coords()
        M, V = self.num_microbatches, self.num_model_chunks
        if self.schedule == "gpipe":
            return TrainGPipeSchedule(M, pp, rank)
        if self.schedule == "1f1b":
            return Train1F1BSchedule(M, pp, rank)
        if self.memory_bounded_backward:
            return TrainInterleavedSchedule(M, V, pp, rank)
        return InterleavedGPipeSchedule(M, V, pp, rank)

    def inference_schedule(self) -> PipeSchedule:
        """The forward-only task list of this rank."""
        pp, rank = self._coords()
        if self.schedule != "interleaved":
            return InferenceSchedule(self.num_microbatches, pp, rank)
        return _ForwardOnly(InterleavedGPipeSchedule(self.num_microbatches,
                                                     self.num_model_chunks, pp, rank))

    # -- execution ---------------------------------------------------------

    def _chunk_layers(self, chunk: int) -> list:
        m = self.model
        if m.stage is None:  # one stage holding every chunk
            block = pipeline_stage(self.config.num_layers, 1, 0,
                                   self.num_model_chunks).chunk_layers[chunk]
            return [m.layers[i] for i in block]
        held = m.layers.by_index()
        return [held[i] for i in m.stage.chunk_layers[chunk]]

    def _stream_shape(self, mbs: int, s: int) -> Tuple[int, ...]:
        """The shape of a stage boundary's tensor on this rank: its cp chunk
        of the sequence, and under SP its tp shard of that."""
        s //= parallel_state.context_parallel_size_or(1)
        if self.model.sequence_parallel:
            s //= self.model.tp
        return (mbs, s, self.config.hidden_size)

    def _microbatches(self, input_ids: torch.Tensor, labels: Optional[torch.Tensor]):
        M = self.num_microbatches
        if input_ids.shape[0] % M:
            raise ValueError(f"batch {input_ids.shape[0]} not divisible by microbatches {M}")
        return [(input_ids[m::M], None if labels is None else labels[m::M]) for m in range(M)]

    def _run(self, sched: PipeSchedule, input_ids: torch.Tensor, labels: Optional[torch.Tensor],
             train: bool, want_logits: bool = False):
        """Run ``sched``'s tasks: (loss on the last stage or None, fp32
        gradients of the rank's parameters or None, {mb: logits} on the
        last stage)."""
        m = self.model
        c = self.config
        pp, rank = self._coords()
        last_u = pp * self.num_model_chunks - 1
        if pp > 1:
            group = parallel_state.get_pipeline_model_parallel_group()
            prev = parallel_state.get_pipeline_model_parallel_prev_rank()
            nxt = parallel_state.get_pipeline_model_parallel_next_rank()
            send_forward, send_backward = mappings.send_forward, mappings.send_backward
            recv_forward, recv_backward = mappings.recv_forward, mappings.recv_backward
        else:
            # one stage: the interleaved chunks' messages go to the stage
            # itself, in order
            group = prev = nxt = None
            loop: list = []
            send_forward = send_backward = lambda t, dst, group: loop.append(t.detach())
            recv_forward = recv_backward = lambda shape, dtype, dev, src, group: loop.pop(0)
        dev = input_ids.device
        mbs_list = self._microbatches(input_ids, labels)
        mbs, s = mbs_list[0][0].shape
        plan = m._cp_plan(s, dev)
        positions, sin, cos = m._positions(mbs, s, plan, dev)
        shape = self._stream_shape(mbs, s)
        total = count = None
        if labels is not None:
            count = valid_token_mask(labels[:, 1:], c.vocab_size).float().sum()
            total = torch.clamp(count, min=1.0)
        moe = isinstance(m, MixtralForCausalLM) and total is not None
        aux_scale = (c.router_aux_loss_coef / (pp * self.num_model_chunks * self.num_microbatches)
                     if moe else 0.0)
        aux_terms: Dict[Tuple[int, int], torch.Tensor] = {}
        aux_sum = None
        names = [k for k, _ in m.named_parameters()]
        params = [p for _, p in m.named_parameters()]
        inputs: Dict[Tuple[int, int], Any] = {}
        outputs: Dict[Tuple[int, int], torch.Tensor] = {}
        out_grads: Dict[Tuple[int, int], torch.Tensor] = {}
        in_grads: Dict[Tuple[int, int], torch.Tensor] = {}
        acc: Dict[str, torch.Tensor] = {}
        logits: Dict[int, torch.Tensor] = {}
        loss = None
        max_stashed = 0
        tasks = []
        for step in sched.steps():
            for task in step:
                tasks.append(task)
                key = (task.mb, task.chunk)
                u = task.chunk * pp + rank
                if isinstance(task, RecvForwardTask):
                    x = recv_forward(shape, c.dtype, dev, prev, group)
                    inputs[key] = x.requires_grad_(train)
                elif isinstance(task, ForwardStepTask):
                    ids, lbl = mbs_list[task.mb]
                    with torch.set_grad_enabled(train):
                        x = m._embed_tokens(ids, plan) if u == 0 else inputs[key]
                        y = m._run_layers(x, self._chunk_layers(task.chunk), positions, sin,
                                          cos, plan)
                        if moe:
                            a = aux_scale * aux_term(m.aux, count) / total
                            aux_sum = a.detach() if aux_sum is None else aux_sum + a.detach()
                            if train:
                                aux_terms[key] = a
                        if u == last_u:
                            hidden = m._final(y)
                            if want_logits:
                                logits[task.mb] = self._gathered_logits(hidden, plan)
                            if total is not None:
                                y = m._head_sums(hidden, lbl, plan)[0] / total
                                loss = y.detach() if loss is None else loss + y.detach()
                    inputs.setdefault(key, None)
                    outputs[key] = y
                    max_stashed = max(max_stashed, len(outputs))
                    if not train and u == last_u:
                        del outputs[key], inputs[key]
                elif isinstance(task, SendForwardTask):
                    send_forward(outputs[key], nxt, group)
                    if not train:
                        del outputs[key], inputs[key]
                elif isinstance(task, RecvBackwardTask):
                    out_grads[key] = recv_backward(shape, c.dtype, dev, nxt, group)
                elif isinstance(task, BackwardStepTask):
                    y, x = self._take_stash(outputs, inputs, key)
                    g = None if u == last_u else out_grads.pop(key)
                    wrt = ([x] if u > 0 else []) + params
                    if key in aux_terms:  # the aux term's constant cotangent
                        a = aux_terms.pop(key)
                        y, g = (y + a, None) if u == last_u else ([y, a], [g, torch.ones_like(a)])
                    got = torch.autograd.grad(y, wrt, g, allow_unused=True)
                    if u > 0:
                        in_grads[key], got = got[0], got[1:]
                    for name, gp in zip(names, got):
                        if gp is None:
                            continue
                        if name in acc:
                            acc[name] += gp.float()
                        else:
                            acc[name] = gp.to(torch.float32, copy=True)
                elif isinstance(task, SendBackwardTask):
                    send_backward(in_grads.pop(key), prev, group)
                elif isinstance(task, ReduceGradsTask):
                    self._reduce_shared_grads(acc)
        mappings.finish_sends()
        if aux_sum is not None:
            loss = aux_sum if loss is None else loss + aux_sum
        self.stats.update(max_stashed=max_stashed, tasks=tasks)
        grads = None
        if train:
            grads = {k: acc[k] if k in acc else torch.zeros(p.shape, dtype=torch.float32,
                                                            device=p.device)
                     for k, p in zip(names, params)}
        return loss, grads, logits

    @staticmethod
    def _take_stash(outputs: dict, inputs: dict, key: Tuple[int, int]):
        """The stage output and input that the backward step of ``key``
        (microbatch, chunk) differentiates, taken out of the stash."""
        return outputs.pop(key), inputs.pop(key)

    def _reduce_shared_grads(self, acc: Dict[str, torch.Tensor]) -> None:
        """``ReduceGradsTask``: the tied embedding's gradient summed over the
        first and the last stage, which both hold the embedding (its lookup
        on the first, the head on the last)."""
        st = self.model.stage
        if st is None or not self.config.tie_word_embeddings or not (st.first or st.last):
            return
        name = "embed.embedding"
        g = acc.get(name)
        if g is None:
            g = acc[name] = torch.zeros(self.model.embed.embedding.shape, dtype=torch.float32,
                                        device=self.device)
        g.copy_(mappings.all_reduce(g, parallel_state.get_embedding_group()))

    def _broadcast_from_last(self, t: Optional[torch.Tensor], shape, dtype, device) -> torch.Tensor:
        """``t`` as the last stage has it, on every pp rank."""
        if self._pp() == 1:
            return t
        buf = t if t is not None else torch.zeros(shape, dtype=dtype, device=device)
        return mappings.all_reduce(buf, parallel_state.get_pipeline_model_parallel_group())

    def _gathered_logits(self, hidden: torch.Tensor, plan) -> torch.Tensor:
        """The whole (mbs, S, V) logits of the last stage's final hidden
        states (gathered over cp into sequence order, as ``forward``)."""
        if plan is not None:
            hidden = mappings.all_gather(hidden, 1, plan.group)
            if plan.inv is not None:
                hidden = hidden.index_select(1, plan.inv)
        return self.model._logits(hidden).float()

    def loss_and_grad(self, input_ids: torch.Tensor, labels: torch.Tensor):
        """One train step's forward and backward over this rank's rows:
        (masked-mean loss, fp32 scalar on every rank; {name: fp32 gradient}
        of this rank's parameters, the tied embedding's summed over the
        first and last stage). Each microbatch's CE sum is divided by the
        valid-token count of all the rows, so the gradients are those of
        the rows' mean loss."""
        loss, grads, _ = self._run(self.train_schedule(), input_ids, labels, train=True)
        loss = self._broadcast_from_last(loss, (), torch.float32, input_ids.device)
        return loss, grads

    @torch.no_grad()
    def loss(self, input_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The masked-mean loss over the rows, forward only
        (``InferenceSchedule``), fp32 scalar on every rank: the eval step."""
        loss, _, _ = self._run(self.inference_schedule(), input_ids, labels, train=False)
        return self._broadcast_from_last(loss, (), torch.float32, input_ids.device)

    @torch.no_grad()
    def __call__(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Logits (B, S, V) in fp32 on every rank, forward only."""
        _, _, logits = self._run(self.inference_schedule(), input_ids, None, train=False,
                                 want_logits=True)
        b, s = input_ids.shape
        full = None
        if logits:
            M = self.num_microbatches
            full = torch.empty((b, s, self.config.vocab_size), dtype=torch.float32,
                               device=input_ids.device)
            for mb, lg in logits.items():
                full[mb::M] = lg
        return self._broadcast_from_last(full, (b, s, self.config.vocab_size), torch.float32,
                                         input_ids.device)


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
