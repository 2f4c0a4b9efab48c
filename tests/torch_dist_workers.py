"""Child processes for the port's multi-process tests on the CPU.

The port runs one process per rank over ``torch.distributed``; these tests
start the ranks with ``torch.multiprocessing`` ``spawn`` over gloo, each
rank joining through a file under the test's own temporary directory
(``file://``, never a fixed TCP port, so tests on several pytest-xdist
workers do not meet). The children import torch and the port only, never
JAX: a worker function takes its weights and inputs as numpy arrays from
the parent and returns numpy results, which :func:`run` collects rank by
rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import numpy as np
import torch
import torch.distributed as dist

from neuronx_distributed_llama3_2_tpu_torch.parallel.multihost import spawn_gloo_ranks


def run(fn: Callable, world: int, tmp, *args) -> List[Any]:
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined over
    gloo (``multihost.spawn_gloo_ranks``), one thread each; the list of
    their return values, by rank. A child's exception fails the call."""
    return spawn_gloo_ranks(_one_thread, world, fn, *args, tmp_dir=str(tmp))


def _one_thread(rank, world, fn, *args):
    torch.set_num_threads(1)
    return fn(rank, world, *args)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_worker(rank, world, tp, sp, cfg_kw, opt_kw, n_micro, steps, np_params, ids, labels):
    """``steps`` train steps at (tp, dp = world / tp) from the JAX start
    weights. Returns per-step metrics, the gradient of the first step's
    loss gathered whole, the parameters and optimizer state after the
    steps gathered whole, this rank's own ZeRO-1 parts and its coordinates."""
    from neuronx_distributed_llama3_2_tpu_torch import trainer as T
    from neuronx_distributed_llama3_2_tpu_torch.models import llama as L
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S

    tc = T.TrainingConfig(tensor_parallel_size=tp, sequence_parallel=sp,
                          num_microbatches=n_micro, optimizer=T.OptimizerConfig(**opt_kw))
    try:
        tc.initialize("cpu")
        cfg = dataclasses.replace(L.LLAMA_CONFIGS["tiny"], **cfg_kw)
        model = L.LlamaForCausalLM(cfg, device="cpu")
        model.load_state_dict(L.params_from_jax(np_params, cfg, device="cpu"))
        params = dict(model.named_parameters())
        specs = T.trainer.state_specs(model, tc)
        state = T.TrainState(params, T.init_optimizer_state(params, tc.optimizer, specs.opt))
        out = _train_run(model, tc, state, specs, steps, ids, labels)
        del out["state"]
        return out
    finally:
        S.destroy_model_parallel()


def _train_run(model, tc, state, specs, steps, ids, labels):
    """The first step's gradient, then ``steps`` train steps from ``state``;
    what :func:`train_worker` returns."""
    from neuronx_distributed_llama3_2_tpu_torch import trainer as T
    from neuronx_distributed_llama3_2_tpu_torch.models import llama as L
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S

    cfg = model.config
    ids_t, lbl_t = torch.as_tensor(ids), torch.as_tensor(labels)
    grads = _first_grads(model, ids_t, lbl_t, cfg)
    step = T.make_train_step(model, tc)
    metrics = []
    for _ in range(steps):
        state, m = step(state, {"input_ids": ids_t, "labels": lbl_t})
        metrics.append({k: float(v) for k, v in m.items()})
    return {
        "coords": (S.get_data_parallel_rank(), S.get_tensor_model_parallel_rank()),
        "metrics": metrics,
        "grads": L.params_to_jax(grads, cfg),
        "params": L.params_to_jax(state.params, cfg),
        "opt": T.opt_state_to_jax(state.opt, cfg, specs.opt),
        "mu_local": {k: _np(v) for k, v in state.opt.mu.items()},
        "state_bytes": T.optimizer.state_bytes(state.opt),
        "specs": {k: (s.shape, s.spec) for k, s in specs.opt.mu.items()},
        "state": state,
    }


def _first_grads(model, ids, labels, cfg):
    """The gradient of the global batch's mean loss, summed over cp (each
    cp rank's is its chunk's share) and dp."""
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S
    from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import all_reduce
    from neuronx_distributed_llama3_2_tpu_torch.trainer.trainer import _valid_count, dp_rows

    ids, labels = dp_rows(ids), dp_rows(labels)
    names = [k for k, _ in model.named_parameters()]
    loss = model.loss(ids, labels)
    n = _valid_count(labels, cfg.vocab_size)
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    group, cp_group = S.get_data_parallel_group(), S.get_context_parallel_group()
    total = all_reduce(n, group)
    return {k: all_reduce(all_reduce(g * n, cp_group), group) / total
            for k, g in zip(names, grads)}


# ---------------------------------------------------------------------------
# the mesh, the regions, the TP layers, the vocab-parallel loss, the norm
# ---------------------------------------------------------------------------

def _part(full: np.ndarray, dim: int, rank: int, n: int) -> torch.Tensor:
    w = full.shape[dim] // n
    return torch.tensor(np.take(full, np.arange(rank * w, (rank + 1) * w), axis=dim))


def _set(p: torch.nn.Parameter, value: torch.Tensor) -> None:
    with torch.no_grad():
        p.copy_(value)


def _grad_gather(t: torch.Tensor, dim, group) -> np.ndarray:
    from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import all_gather

    t = t.detach()
    return _np(t if dim is None else all_gather(t.contiguous(), dim, group))


def parallel_worker(rank, world, tp, sp, inputs):
    """Every check of test_torch_parallel.py that needs the ranks, at
    tensor parallel size ``tp`` (dp = world / tp); returns what each
    computed (the parent holds it against the JAX package)."""
    from neuronx_distributed_llama3_2_tpu_torch.parallel import layers as PL
    from neuronx_distributed_llama3_2_tpu_torch.parallel import mappings as M
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S
    from neuronx_distributed_llama3_2_tpu_torch.parallel.grads import global_norm, world_group
    from neuronx_distributed_llama3_2_tpu_torch.parallel.loss import parallel_cross_entropy

    st = S.initialize_model_parallel(tensor_model_parallel_size=tp, sequence_parallel=sp, device="cpu")
    try:
        out: dict = {}
        g_tp, g_dp = S.get_tensor_model_parallel_group(), S.get_data_parallel_group()
        r = S.get_tensor_model_parallel_rank()
        out["mesh"] = dict(
            shape=tuple(st.mesh.shape), tp=st.tensor_parallel_size, dp=st.data_parallel_size,
            tp_rank=r, dp_rank=S.get_data_parallel_rank(),
            tp_ranks=dist.get_process_group_ranks(g_tp), dp_ranks=dist.get_process_group_ranks(g_dp),
            tp_only=S.mesh_is_tp_only(), kv4=S.kv_head_shard_size(4), kv3=S.kv_head_shard_size(3),
            sp=S.sequence_parallel_enabled(), axes=S.get_data_parallel_axes(),
        )

        # the regions: forward and backward of x (rank-dependent) with an
        # upstream gradient g (rank-dependent)
        x0, g0 = inputs["x"], inputs["g"]
        regions = {
            "copy_to": lambda x: M.copy_to_tensor_model_parallel_region(x),
            "reduce_from": lambda x: M.reduce_from_tensor_model_parallel_region(x),
            "gather_from": lambda x: M.gather_from_tensor_model_parallel_region(x, -1),
            "scatter_to": lambda x: M.scatter_to_tensor_model_parallel_region(x, -1),
            "sp_scatter_to": lambda x: M.scatter_to_sequence_parallel_region(x, 1),
            "sp_gather_from": lambda x: M.gather_from_sequence_parallel_region(x, 1),
            "sp_gather_from_split": lambda x: M.gather_from_sequence_parallel_region(
                x, 1, to_model_parallel=False),
            "sp_reduce_scatter": lambda x: M.reduce_scatter_to_sequence_parallel_region(x, 1),
        }
        out["regions"] = {}
        for name, fn in regions.items():
            x = torch.tensor(x0 + r).requires_grad_(True)
            y = fn(x)
            g = torch.tensor(g0[tuple(slice(0, n) for n in y.shape)] * (r + 1))
            y.backward(g)
            out["regions"][name] = (_np(y), _np(x.grad))

        # the TP layers: full weights in, this rank's slice loaded; each
        # output gathered and each weight gradient gathered (or whole)
        xin = torch.tensor(inputs["xin"])
        lay = {}
        for gather_output in (False, True):
            col = PL.ColumnParallelLinear(16, 24, use_bias=True, gather_output=gather_output)
            _set(col.kernel, _part(inputs["w_col"], 1, r, tp))
            _set(col.bias, _part(inputs["b_col"], 0, r, tp))
            x = xin.clone().requires_grad_(True)
            y = col(x)
            gy = torch.tensor(inputs["gy_col"])
            (y * (gy if gather_output else _part(inputs["gy_col"], 2, r, tp))).sum().backward()
            lay[f"col{int(gather_output)}"] = (
                _np(y) if gather_output else _grad_gather(y, 2, g_tp), _np(x.grad),
                _grad_gather(col.kernel.grad, 1, g_tp), _grad_gather(col.bias.grad, 0, g_tp))
        for row_sp in (False, True):
            row = PL.RowParallelLinear(24, 16, use_bias=True, sequence_parallel=row_sp)
            _set(row.kernel, _part(inputs["w_row"], 0, r, tp))
            _set(row.bias, torch.tensor(inputs["b_row"]))
            x = _part(inputs["xrow"], 2, r, tp).requires_grad_(True)
            y = row(x)
            gy = inputs["gy_row"]
            (y * (_part(gy, 1, r, tp) if row_sp else torch.tensor(gy))).sum().backward()
            lay[f"row{int(row_sp)}"] = (
                _grad_gather(y, 1, g_tp) if row_sp else _np(y), _grad_gather(x.grad, 2, g_tp),
                _grad_gather(row.kernel.grad, 0, g_tp), _np(row.bias.grad))
        ids = torch.tensor(inputs["ids"])
        for shard_dim, dim in (("vocab", 0), ("embed", 1)):
            emb = PL.ParallelEmbedding(32, 16, shard_dim=shard_dim)
            _set(emb.embedding, _part(inputs["w_emb"], dim, r, tp))
            y = emb(ids)
            (y * torch.tensor(inputs["gy_emb"])).sum().backward()
            lay[f"emb_{shard_dim}"] = (_np(y), _grad_gather(emb.embedding.grad, dim, g_tp))
        for key, (n, nkv, d) in inputs["gqa"].items():
            if n % tp:
                continue
            qkv = PL.GQAQKVColumnParallelLinear(16, n, nkv, d, use_bias=True)
            split = qkv.kv_split
            for nm in ("q", "k", "v"):
                whole = nm != "q" and not split
                _set(getattr(qkv, f"{nm}_kernel"),
                     torch.tensor(inputs[f"gqa_{key}_w{nm}"]) if whole else
                     _part(inputs[f"gqa_{key}_w{nm}"], 1, r, tp))
                _set(getattr(qkv, f"{nm}_bias"),
                     torch.tensor(inputs[f"gqa_{key}_b{nm}"]) if whole else
                     _part(inputs[f"gqa_{key}_b{nm}"], 0, r, tp))
            x = xin.clone().requires_grad_(True)
            q, k, v = qkv(x)
            loss = (q * _part(inputs[f"gqa_{key}_gq"], 2, r, tp)).sum()
            loss = loss + (k * torch.tensor(inputs[f"gqa_{key}_gk"][r])).sum()
            loss = loss + (v * torch.tensor(inputs[f"gqa_{key}_gv"][r])).sum()
            loss.backward()
            lay[f"gqa_{key}"] = dict(
                mode=PL.kv_mode(n, nkv, d, tp), q=_grad_gather(q, 2, g_tp), k=_np(k), v=_np(v),
                dx=_np(x.grad),
                **{f"d{nm}": _grad_gather(getattr(qkv, f"{nm}_kernel").grad,
                                          1 if (nm == "q" or split) else None, g_tp)
                   for nm in ("q", "k", "v")},
            )
        out["layers"] = lay

        # the vocab-parallel cross-entropy, with and without smoothing
        ce = {}
        for ls in (0.0, 0.1):
            logits = _part(inputs["logits"], 2, r, tp).requires_grad_(True)
            loss = parallel_cross_entropy(logits, torch.tensor(inputs["labels"]), ls)
            (loss * torch.tensor(inputs["w_ce"])).sum().backward()
            ce[ls] = (_np(loss), _grad_gather(logits.grad, 2, g_tp))
        out["ce"] = ce

        # the random streams: the tp one per tp rank, the dp one shared
        from neuronx_distributed_llama3_2_tpu_torch.parallel.random import (
            data_parallel_generator,
            tensor_parallel_generator,
        )

        out["rng"] = (_np(torch.rand(4, generator=tensor_parallel_generator(5, "cpu"))),
                      _np(torch.rand(4, generator=data_parallel_generator(5, "cpu"))))

        # the norm: a tp-sharded leaf counts on every rank, a replicated one
        # on tp rank 0 alone
        grads = {"shard": torch.tensor(inputs["x"][0] * (r + 1)), "rep": torch.tensor(inputs["g"][0])}
        owned = {"shard": S.get_data_parallel_rank() == 0, "rep": r == 0 and S.get_data_parallel_rank() == 0}
        out["norm"] = float(global_norm(grads, owned, world_group()))
        return out
    finally:
        S.destroy_model_parallel()


# ---------------------------------------------------------------------------
# checkpoints and the data loader over several processes
# ---------------------------------------------------------------------------

def ckpt_worker(rank, world, tp, mode, root, np_params, opt_kw, ids, labels):
    """``mode="save"``: from the JAX weights, one train step at (tp, dp =
    world / tp), then a save of the rank's shards; ``mode="load"``: a fresh
    model loads the latest tag into its shards. Returns the state gathered
    whole (JAX layout) and the tag's user content."""
    from neuronx_distributed_llama3_2_tpu_torch import trainer as T
    from neuronx_distributed_llama3_2_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from neuronx_distributed_llama3_2_tpu_torch.models import llama as L
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S

    tc = T.TrainingConfig(tensor_parallel_size=tp, optimizer=T.OptimizerConfig(**opt_kw))
    try:
        tc.initialize("cpu")
        cfg = dataclasses.replace(L.LLAMA_CONFIGS["tiny"], loss_chunk_size=8)
        model = L.LlamaForCausalLM(cfg, device="cpu")
        state, specs = T.initialize_parallel_model(model, tc)
        content = None
        if mode == "save":
            model.load_state_dict(L.params_from_jax(np_params, cfg, device="cpu"))
            state = T.TrainState(state.params, T.init_optimizer_state(state.params, tc.optimizer, specs.opt))
            state, _ = T.make_train_step(model, tc)(
                state, {"input_ids": torch.as_tensor(ids), "labels": torch.as_tensor(labels)})
            save_checkpoint(root, "step_1", model=state.params, optimizer=state.opt,
                            user_content={"step": 1}, model_specs=specs.params,
                            optimizer_specs=specs.opt)
        else:
            out = load_checkpoint(root, "latest", model=state.params, optimizer=state.opt,
                                  model_specs=specs.params, optimizer_specs=specs.opt)
            with torch.no_grad():
                for k, p in state.params.items():
                    p.copy_(out["model"][k])
            state = T.TrainState(state.params, out["optimizer"])
            content = out.get("user_content")
        return {
            "params": L.params_to_jax(state.params, cfg),
            "opt": T.opt_state_to_jax(state.opt, cfg, specs.opt),
            "user_content": content,
        }
    finally:
        S.destroy_model_parallel()


def loader_worker(rank, world, path, gbs, seq_len, steps, resume_at):
    """The rows this rank's loader yields for ``steps`` steps, and for the
    steps after ``resume_at`` from a loader resumed there (dp = world)."""
    from neuronx_distributed_llama3_2_tpu_torch.data import (
        DistributedDataLoader,
        LoaderState,
        TokenDataset,
    )
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S

    S.initialize_model_parallel(device="cpu")
    try:
        ds = TokenDataset(path, seq_len)
        it = iter(DistributedDataLoader(ds, gbs, seed=3))
        first = [next(it) for _ in range(steps)]
        it2 = iter(DistributedDataLoader(ds, gbs, seed=3, state=LoaderState(step=resume_at)))
        resumed = [next(it2) for _ in range(steps - resume_at)]
        return {"dp_rank": S.get_data_parallel_rank(), "first": first, "resumed": resumed}
    finally:
        S.destroy_model_parallel()


# ---------------------------------------------------------------------------
# the paged engine over a tp group
# ---------------------------------------------------------------------------

def _trace(eng):
    return [
        (pending, [(a.type.value, a.mode, a.meta.get("lag"), a.meta.get("lame_duck"),
                    a.meta.get("in_flight")) for a in acts])
        for _, pending, acts in eng.action_trace
    ]


def serve_worker(rank, world, tp, np_params, cfg_kw, engine_kw, cells, prompts, max_new):
    """Each cell's paged engine at (tp, dp = world / tp) over the same
    prompts: the streams, the action trace, the metrics the test reads and
    the kernel gate's answers."""
    from neuronx_distributed_llama3_2_tpu_torch.inference import GenerationConfig, InferenceEngine
    from neuronx_distributed_llama3_2_tpu_torch.inference.model import LlamaDecode
    from neuronx_distributed_llama3_2_tpu_torch.models import llama as L
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S
    from neuronx_distributed_llama3_2_tpu_torch.serving.engine import PagedConfig, PagedServingEngine

    S.initialize_model_parallel(tensor_model_parallel_size=tp, device="cpu")
    try:
        cfg = dataclasses.replace(L.LLAMA_CONFIGS["tiny"], **cfg_kw)
        model = L.LlamaForCausalLM(cfg, device="cpu")
        model.load_state_dict(L.params_from_jax(np_params, cfg, device="cpu"))
        dec = LlamaDecode(cfg)
        odd = LlamaDecode(dataclasses.replace(cfg, num_heads=6, num_kv_heads=3))
        out = {
            "gate": dict(
                t1=dec._paged_kernel_eligible(1, None),
                tmax=dec._paged_kernel_eligible(cfg.paged_kernel_max_t, None),
                past=dec._paged_kernel_eligible(cfg.paged_kernel_max_t + 1, None),
                tree=dec._paged_kernel_eligible(cfg.paged_kernel_max_t, object()),
                odd=odd._paged_kernel_eligible(1, None),
            ),
            "kv_heads": dec.kv_heads,
            "cells": {},
        }
        if cells:
            # the dense engine over the tp group: its cache holds this rank's
            # kv heads, and every rank generates the same tokens
            dense = InferenceEngine(cfg, model, **engine_kw)
            res = dense.generate(prompts, GenerationConfig(max_new_tokens=max_new))
            out["dense"] = dict(sequences=res.sequences, cache_heads=dense._cache.k.shape[3],
                                cache_specs=dense.model.cache_specs())
        from neuronx_distributed_llama3_2_tpu_torch.serving.faults import FaultInjector, FaultPlan

        for name, paged_kw in cells.items():
            paged_kw = dict(paged_kw)
            plan = paged_kw.pop("_fault_plan", None)
            # a rank-local difference (a clock reading, say) planted on rank 1
            paged_kw.update(paged_kw.pop("_rank1_paged", {}) if rank == 1 else {})
            paged_kw.pop("_rank1_paged", None)
            eng = PagedServingEngine(
                InferenceEngine(cfg, model, **engine_kw),
                GenerationConfig(max_new_tokens=max_new), PagedConfig(**paged_kw),
                injector=FaultInjector(FaultPlan(**plan)) if plan else None,
            )
            for p in prompts:
                eng.submit(p)
            levels = []
            while eng.step():
                levels.append(eng._degrade_level)
            streams = {rid: r.out for rid, r in sorted(eng._finished.items())}
            m = eng.metrics
            out["cells"][name] = dict(
                levels=levels, status=[eng.request_info(r)["status"] for r in sorted(streams)],
                streams=streams, trace=_trace(eng), tp_size=m.tp_size,
                pool_bytes_per_rank=m.pool_bytes_per_rank, pool_bytes_total=m.pool_bytes_total,
                pool_shape=tuple(eng.cache.k.shape), paths=dict(eng.model.attention_paths),
                verify_steps=m.verify_steps, accepted=m.accepted_tokens,
                async_steps=m.decode_steps_async, leaks=eng.allocator.leak_check(),
            )
        return out
    finally:
        S.destroy_model_parallel()


# ---------------------------------------------------------------------------
# context parallelism: the rings, the model and the trainer over cp ranks
# ---------------------------------------------------------------------------

def _ring_case(st, inputs, case, causal, impl, block_kv=None, grads=False):
    """``ring_attention_sharded`` over the mesh's cp group on the whole
    numpy inputs ``inputs[case]``: the output and, with ``grads``, the
    gradients of sum(out²), as numpy (rank 0's; every rank's are whole)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels.flash_attention import DEFAULT_BLOCK_KV
    from neuronx_distributed_llama3_2_tpu_torch.kernels.ring_attention import (
        ring_attention_sharded,
    )

    q, k, v = (torch.tensor(x, requires_grad=grads) for x in inputs[case])
    out = ring_attention_sharded(q, k, v, st.mesh, "cp", causal=causal, impl=impl,
                                 block_kv=block_kv or DEFAULT_BLOCK_KV)
    res = {"out": _np(out)}
    if grads:
        (out.float() ** 2).sum().backward()
        res["grads"] = [_np(x.grad) for x in (q, k, v)]
    return res


def ring_worker(rank, world, inputs):
    """Every ring check of test_torch_ring_attention.py, on four ranks:
    cp = 4 (the plain and kernel rings, causal and full, gradients, GQA,
    each rank's own chunk through the local executors, the rotation over
    either transport), then
    tp = 2 x cp = 2 (each tp rank's heads through the ring, gathered), then
    dp = 2 x cp = 2 (a multi-block padded tail)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import ring_attention as R
    from neuronx_distributed_llama3_2_tpu_torch.kernels.ring_attention_pallas import (
        ring_attention_pallas,
    )
    from neuronx_distributed_llama3_2_tpu_torch.parallel import mappings as M
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S

    out: dict = {}
    st = S.initialize_model_parallel(context_parallel_size=4, device="cpu")
    try:
        group = S.get_context_parallel_group()
        for causal in (True, False):
            out["dense", causal] = _ring_case(st, inputs, "s128", causal, "auto")
        out["grads"] = _ring_case(st, inputs, "s64", True, "jnp", grads=True)
        for impl in ("pallas", "zigzag"):
            for causal in (True, False):
                try:
                    out[impl, causal] = _ring_case(st, inputs, "s128", causal, impl)
                except ValueError as e:
                    out[impl, causal] = str(e)
            out["grads", impl] = _ring_case(st, inputs, "s64", True, impl, grads=True)
        for impl in ("jnp", "pallas", "zigzag"):
            out["gqa", impl] = _ring_case(st, inputs, "gqa", True, impl)
        # the local executors on this rank's contiguous chunk alone
        q, k, v = (torch.tensor(x).chunk(4, dim=1)[rank] for x in inputs["s256"])
        out["local"] = {"plain": _np(R.ring_attention(q, k, v, group, causal=True)),
                        "kernel": _np(ring_attention_pallas(q, k, v, group, causal=True))}
        # the rotation: rank i gets rank i - 1's tensor, and the gradient
        # goes back to rank i - 1
        x = torch.full((3,), float(rank), requires_grad=True)
        before = M.COLLECTIVE_COUNTS["ring_shift"]
        y = M.ring_shift_region(x, group)
        (y * (rank + 1)).sum().backward()
        out["shift"] = (M.ring_transport(group), _np(y), _np(x.grad),
                        M.COLLECTIVE_COUNTS["ring_shift"] - before)
        # NCCL's transport (batch_isend_irecv pairs) over gloo's CPU send /
        # recv, beside the all-gather: the rotation both ways, and the
        # kernel rings' outputs and gradients
        x = torch.arange(6.0).reshape(2, 3) + 10 * rank
        chosen = M.ring_transport
        out["transports"] = {}
        for transport in ("all_gather", "send_recv"):
            M.ring_transport = lambda g, t=transport: t
            try:
                out["transports"][transport] = (
                    [_np(M.ring_shift(x, group, hops)) for hops in (1, -1)],
                    {impl: _ring_case(st, inputs, "s64", True, impl, grads=True)
                     for impl in ("pallas", "zigzag")})
            finally:
                M.ring_transport = chosen
    finally:
        S.destroy_model_parallel()
    st = S.initialize_model_parallel(tensor_model_parallel_size=2, context_parallel_size=2,
                                     device="cpu")
    try:
        t = S.get_tensor_model_parallel_rank()
        q, k, v = (torch.tensor(x).chunk(2, dim=2)[t] for x in inputs["s64"])
        o = R.ring_attention_sharded(q, k, v, st.mesh, "cp", causal=True)
        out["tp"] = _np(M.all_gather(o, 2, S.get_tensor_model_parallel_group()))
    finally:
        S.destroy_model_parallel()
    st = S.initialize_model_parallel(context_parallel_size=2, device="cpu")
    try:
        for causal in (True, False):
            out["multiblock", causal] = _ring_case(st, inputs, "s80", causal, "auto", block_kv=16)
        out["multiblock grads"] = _ring_case(st, inputs, "s80", True, "auto", block_kv=16,
                                             grads=True)
    finally:
        S.destroy_model_parallel()
    return out


def cp_mesh_worker(rank, world, np_params, ids, token_path, gbs, seq_len):
    """Four ranks: at tp = 2 x cp = 2 the tiny model's eval logits and loss
    from the JAX weights; then at dp = 2 x cp = 2 the rows each rank's data
    loader yields for three steps, and its coordinates."""
    from neuronx_distributed_llama3_2_tpu_torch.data import DistributedDataLoader, TokenDataset
    from neuronx_distributed_llama3_2_tpu_torch.models import llama as L
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S

    out: dict = {}
    S.initialize_model_parallel(tensor_model_parallel_size=2, context_parallel_size=2,
                                device="cpu")
    try:
        cfg = L.LLAMA_CONFIGS["tiny"]
        model = L.LlamaForCausalLM(cfg, device="cpu")
        model.load_state_dict(L.params_from_jax(np_params, cfg, device="cpu"))
        ids_t = torch.as_tensor(ids)
        out["logits"] = _np(model(ids_t))
        with torch.no_grad():
            out["loss"] = float(model.loss(ids_t, ids_t))
    finally:
        S.destroy_model_parallel()
    S.initialize_model_parallel(context_parallel_size=2, device="cpu")
    try:
        it = iter(DistributedDataLoader(TokenDataset(token_path, seq_len), gbs, seed=3))
        out["rows"] = [next(it) for _ in range(3)]
        out["coords"] = (S.get_data_parallel_rank(), S.get_context_parallel_rank())
    finally:
        S.destroy_model_parallel()
    return out


def cp_train_worker(rank, world, layouts, cfg_kw, opt_kw, n_micro, steps, jax_root, save_root,
                    ids, labels):
    """cp = world ranks: in each layout, the train state loaded from the JAX
    package's tag at ``jax_root`` (each cp rank reads the whole replicated
    state), its eval loss, the first step's gradient and ``steps`` steps
    (``_train_run``);
    after the first layout's steps a save under ``save_root``, with the
    files this rank wrote, and the tag loaded back on every rank."""
    from neuronx_distributed_llama3_2_tpu_torch import trainer as T
    from neuronx_distributed_llama3_2_tpu_torch.checkpoint import checkpoint as C
    from neuronx_distributed_llama3_2_tpu_torch.models import llama as L
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S

    tc = T.TrainingConfig(context_parallel_size=world, num_microbatches=n_micro,
                          optimizer=T.OptimizerConfig(**opt_kw))
    tc.initialize("cpu")
    out: dict = {}
    try:
        for layout in layouts:
            cfg = dataclasses.replace(L.LLAMA_CONFIGS["tiny"], cp_ring_layout=layout, **cfg_kw)
            model = L.LlamaForCausalLM(cfg, device="cpu")
            state, specs = T.initialize_parallel_model(model, tc)
            start = C.load_checkpoint(jax_root, "latest", model=state.params, optimizer=state.opt,
                                      model_specs=specs.params, optimizer_specs=specs.opt)
            with torch.no_grad():
                for k, p in state.params.items():
                    p.copy_(start["model"][k])
            state = T.TrainState(state.params, start["optimizer"])
            batch = {"input_ids": torch.as_tensor(ids), "labels": torch.as_tensor(labels)}
            eval_loss = T.evaluate(model, tc, state.params, [batch])
            res = out[layout] = _train_run(model, tc, state, specs, steps, ids, labels)
            res["eval_loss"] = eval_loss
            state = res.pop("state")
            if layout == layouts[0]:
                written = res["written"] = []
                inner = C._save_npy

                def spy(storage, arr, name):
                    written.append(name)
                    return inner(storage, arr, name)

                C._save_npy = spy
                try:
                    C.save_checkpoint(save_root, "step_1", model=state.params, optimizer=state.opt,
                                      model_specs=specs.params, optimizer_specs=specs.opt)
                finally:
                    C._save_npy = inner
                dist.barrier()  # rank 0 marks the tag done after every rank's chunks
                back = C.load_checkpoint(save_root, "latest", model=state.params,
                                         optimizer=state.opt, model_specs=specs.params,
                                         optimizer_specs=specs.opt)
                res["loaded_back"] = (
                    all(torch.equal(back["model"][k], p) for k, p in state.params.items())
                    and all(torch.equal(back["optimizer"].mu[k], m)
                            for k, m in state.opt.mu.items()))
        out["cp_rank"] = S.get_context_parallel_rank()
    finally:
        S.destroy_model_parallel()
    return out


# ---------------------------------------------------------------------------
# pipeline parallelism
# ---------------------------------------------------------------------------

def pp_train_worker(rank, world, cases, cfg_kw, opt_kw, n_micro, jax_root, ids, labels):
    """Each case of ``cases`` (a dict: name, schedule, chunks,
    memory_bounded, head_split, tp, sp, cp, pp (2 by default), zero1,
    layout, save, logits) on a mesh of ``world`` ranks, through the trainer's entry points: the state
    loaded from the JAX package's tag at ``jax_root`` (gathered back, to
    hold the load), the eval loss (forward-only schedule), the first
    step's gradient (``loss_and_grad``, summed over cp and dp, gathered
    whole), the most stage inputs held at once and the point-to-point
    calls against the task list, one train step's metrics and end state
    gathered whole; with ``save``, a tag of the end state under that root,
    the files this rank wrote, and the tag loaded back; with ``logits``
    the forward's logits."""
    from neuronx_distributed_llama3_2_tpu_torch import trainer as T
    from neuronx_distributed_llama3_2_tpu_torch.checkpoint import checkpoint as C
    from neuronx_distributed_llama3_2_tpu_torch.models import llama as L
    from neuronx_distributed_llama3_2_tpu_torch.parallel import mappings as MP
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S
    from neuronx_distributed_llama3_2_tpu_torch.pipeline import PipelinedCausalLM
    from neuronx_distributed_llama3_2_tpu_torch.pipeline import scheduler as PS

    out = {}
    batch = {"input_ids": torch.as_tensor(ids), "labels": torch.as_tensor(labels)}
    p2p = ("send_forward", "recv_forward", "send_backward", "recv_backward")
    kinds = (PS.SendForwardTask, PS.RecvForwardTask, PS.SendBackwardTask, PS.RecvBackwardTask)
    for case in cases:
        chunks = case.get("chunks", 1)
        zero1 = case.get("zero1", False)
        tc = T.TrainingConfig(
            tensor_parallel_size=case.get("tp", 1), sequence_parallel=case.get("sp", False),
            context_parallel_size=case.get("cp", 1), pipeline_parallel_size=case.get("pp", 2),
            pipeline_schedule=case["schedule"], num_model_chunks=chunks,
            optimizer=T.OptimizerConfig(zero_one_enabled=zero1, **opt_kw))
        tc.initialize("cpu")
        try:
            cfg = dataclasses.replace(L.LLAMA_CONFIGS["tiny"],
                                      cp_ring_layout=case.get("layout", "auto"), **cfg_kw)
            model = PipelinedCausalLM(
                L.LlamaForCausalLM(cfg, device="cpu", num_model_chunks=chunks),
                num_microbatches=n_micro, schedule=case["schedule"], num_model_chunks=chunks,
                memory_bounded_backward=case.get("memory_bounded", True),
                head_sequence_split=case.get("head_split", True))
            state, specs = T.initialize_parallel_model(model, tc)
            start = C.load_checkpoint(jax_root, "latest", model=state.params,
                                      optimizer=state.opt, model_specs=specs.params,
                                      optimizer_specs=specs.opt)
            with torch.no_grad():
                for k, p in state.params.items():
                    p.copy_(start["model"][k])
            state = T.TrainState(state.params, start["optimizer"])
            res = {"loaded": L.params_to_jax(state.params, cfg, specs.params),
                   "eval_loss": T.evaluate(model, tc, state.params, [batch])}
            if case.get("logits"):
                res["logits"] = _np(model(batch["input_ids"]))
                res["to_pipeline"] = model.to_pipeline(res["loaded"])
            res["grads"] = L.params_to_jax(_pp_first_grads(model, ids, labels), cfg, specs.params)
            tasks = model.stats["tasks"]
            res["max_stashed"] = model.stats["max_stashed"]
            before = dict(MP.COLLECTIVE_COUNTS)
            step = T.make_train_step(model, tc)
            state, m = step(state, batch)
            res["p2p"] = [MP.COLLECTIVE_COUNTS[k] - before.get(k, 0) for k in p2p]
            res["p2p_tasks"] = [sum(isinstance(t, c) for t in tasks) for c in kinds]
            res["metrics"] = [{k: float(v) for k, v in m.items()}]
            res["params"] = L.params_to_jax(state.params, cfg, specs.params)
            res["opt"] = T.opt_state_to_jax(state.opt, cfg, specs.opt)
            res["coords"] = {a: S.get_parallel_state().rank(a) for a in S.MESH_AXES}
            res["holds"] = sorted(state.params)
            if case.get("save"):
                root = case["save"]
                written = res["written"] = []
                inner = C._save_npy

                def spy(storage, arr, name):
                    written.append(name)
                    return inner(storage, arr, name)

                C._save_npy = spy
                try:
                    C.save_checkpoint(root, "step_1", model=state.params, optimizer=state.opt,
                                      model_specs=specs.params, optimizer_specs=specs.opt)
                finally:
                    C._save_npy = inner
                dist.barrier()  # rank 0 marks the tag done after every rank's chunks
                back = C.load_checkpoint(root, "latest", model=state.params, optimizer=state.opt,
                                         model_specs=specs.params, optimizer_specs=specs.opt)
                res["loaded_back"] = (
                    all(torch.equal(back["model"][k], p) for k, p in state.params.items())
                    and all(torch.equal(back["optimizer"].mu[k], v)
                            for k, v in state.opt.mu.items()))
            out[case["name"]] = res
        finally:
            S.destroy_model_parallel()
    return out


def _pp_first_grads(model, ids, labels):
    """A pipelined model's gradient of the global batch's mean loss: the
    rank's ``loss_and_grad`` of its dp rows, summed over cp and dp."""
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S
    from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import all_reduce
    from neuronx_distributed_llama3_2_tpu_torch.trainer.trainer import _valid_count, dp_rows

    ids, labels = dp_rows(torch.as_tensor(ids)), dp_rows(torch.as_tensor(labels))
    _, grads = model.loss_and_grad(ids, labels)
    n = _valid_count(labels, model.config.vocab_size)
    group, cp_group = S.get_data_parallel_group(), S.get_context_parallel_group()
    total = all_reduce(n, group)
    return {k: all_reduce(all_reduce(g * n, cp_group), group) / total for k, g in grads.items()}


def pp_pretrain_worker(rank, world, runs):
    """The pretrain script's ``_run`` in each rank for each (argv, preempt
    at) of ``runs`` in turn (the mesh taken down between them): rank 0's
    records without the state (None for a preempted run), and each run's
    final parameters on this rank."""
    from neuronx_distributed_llama3_2_tpu_torch import trainer
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S
    from neuronx_distributed_llama3_2_tpu_torch.scripts import pretrain

    make = trainer.make_train_step
    records, params = [], []
    for argv, preempt in runs:
        def make_train_step(model, config, _n=preempt, **kw):
            step, calls = make(model, config, **kw), []

            def stepped(state, batch):
                if _n is not None and len(calls) == _n:
                    raise KeyboardInterrupt
                calls.append(1)
                return step(state, batch)

            return stepped

        trainer.make_train_step = make_train_step
        try:
            rec = pretrain._run(pretrain.parse_args(argv))
            params.append({k: _np(p) for k, p in rec.pop("state").params.items()})
            records.append(rec)
        except KeyboardInterrupt:
            records.append(None)
            params.append(None)
        finally:
            trainer.make_train_step = make
            S.destroy_model_parallel()
    return {"records": records if rank == 0 else None, "params": params}


# ---------------------------------------------------------------------------
# quantized layers under tensor parallelism
# ---------------------------------------------------------------------------

def quant_linear_worker(rank, world, cases, w, x):
    """For each (kind, QuantizationConfig kwargs) of ``cases``: a float
    ``kind`` ("row" / "column") parallel linear holding this tp rank's
    shard of the whole kernel ``w`` (in, out), converted to its quantized
    counterpart; the output of ``x`` (the whole input; a row-parallel layer
    reads its slice of the features) gathered whole, and the rank's payload
    and scale, as fp32 numpy."""
    from neuronx_distributed_llama3_2_tpu_torch.parallel import layers as PL
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S
    from neuronx_distributed_llama3_2_tpu_torch.quantization import QuantizationConfig, convert

    S.initialize_model_parallel(tensor_model_parallel_size=world, device="cpu")
    try:
        out = []
        for kind, q_kw in cases:
            n_in, n_out = w.shape
            cls = PL.RowParallelLinear if kind == "row" else PL.ColumnParallelLinear
            mod = cls(n_in, n_out, dtype=torch.float32, device="cpu")
            dim = 0 if kind == "row" else 1
            with torch.no_grad():
                mod.kernel.copy_(torch.as_tensor(w).chunk(world, dim)[rank])
            qmod = convert(mod, QuantizationConfig(**q_kw))
            xt = torch.as_tensor(x)
            if kind == "row":
                xt = xt.chunk(world, -1)[rank]
            y = qmod(xt)
            y = (_grad_gather(y, -1, S.get_tensor_model_parallel_group()) if kind == "column"
                 else _np(y))
            qt = qmod.quantized("kernel")
            out.append(dict(y=y, qvalue=_np(qt.qvalue), scale=_np(qt.scale)))
        return out
    finally:
        S.destroy_model_parallel()


# ---------------------------------------------------------------------------
# MoE: expert parallelism and the pipelined Mixtral
# ---------------------------------------------------------------------------

def moe_train_worker(rank, world, cases, cfg_kw, opt_kw, jax_root, batches):
    """Each case of ``cases`` (a dict: name, tp, ep, sp, pp, schedule,
    n_micro, zero1, batch (a key of ``batches``), save) with tiny-moe on a
    mesh of ``world`` ranks, through the trainer's entry points: the state
    loaded from the JAX package's tag at ``jax_root`` (gathered back); the
    first step's gradient of the batch's mean loss (unpipelined: each
    rank's backward seeded with its share of the tokens and the gradients
    summed as the trainer sums them; pipelined: ``loss_and_grad``),
    gathered whole; one train step's
    metrics and end state gathered whole; the ZeRO-1 specs and this rank's
    own mu; with ``save``, a tag of the end state under that root. An ep
    case also tries an MoE block without a capacity factor."""
    from neuronx_distributed_llama3_2_tpu_torch import trainer as T
    from neuronx_distributed_llama3_2_tpu_torch.checkpoint import checkpoint as C
    from neuronx_distributed_llama3_2_tpu_torch.models import llama as L
    from neuronx_distributed_llama3_2_tpu_torch.models import mixtral as M
    from neuronx_distributed_llama3_2_tpu_torch.moe.model import MoE
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S
    from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import all_reduce
    from neuronx_distributed_llama3_2_tpu_torch.pipeline import PipelinedCausalLM
    from neuronx_distributed_llama3_2_tpu_torch.trainer.optimizer import zero1_reduce_grads
    from neuronx_distributed_llama3_2_tpu_torch.trainer.trainer import _valid_count, dp_rows

    out = {}
    for case in cases:
        pp = case.get("pp", 1)
        tc = T.TrainingConfig(
            tensor_parallel_size=case.get("tp", 1), expert_parallel_size=case.get("ep", 1),
            sequence_parallel=case.get("sp", False), pipeline_parallel_size=pp,
            pipeline_schedule=case.get("schedule"), num_microbatches=1 if pp > 1 else case["n_micro"],
            optimizer=T.OptimizerConfig(zero_one_enabled=case.get("zero1", False), **opt_kw))
        tc.initialize("cpu")
        try:
            cfg = dataclasses.replace(M.MIXTRAL_CONFIGS["tiny-moe"], **cfg_kw)
            model = M.MixtralForCausalLM(cfg, device="cpu")
            if pp > 1:
                model = PipelinedCausalLM(model, num_microbatches=case["n_micro"],
                                          schedule=case["schedule"])
            state, specs = T.initialize_parallel_model(model, tc)
            start = C.load_checkpoint(jax_root, "latest", model=state.params, optimizer=state.opt,
                                      model_specs=specs.params, optimizer_specs=specs.opt)
            with torch.no_grad():
                for k, p in state.params.items():
                    p.copy_(start["model"][k])
            state = T.TrainState(state.params, start["optimizer"])
            ids, labels = (torch.as_tensor(a) for a in batches[case["batch"]])
            res = {"loaded": L.params_to_jax(state.params, cfg, specs.params)}
            names = list(state.params)
            if pp > 1:
                _, grads = model.loss_and_grad(ids, labels)
            else:
                # each rank's backward seeded with its share of the tokens
                # (an expert's gradient gathers other ranks' tokens' shares)
                rows, lbl = dp_rows(ids), dp_rows(labels)
                n = _valid_count(lbl, cfg.vocab_size)
                total = all_reduce(n, S.get_data_parallel_group())
                got = torch.autograd.grad(model.loss(rows, lbl),
                                          [state.params[k] for k in names], n / total)
                grads = zero1_reduce_grads(dict(zip(names, got)), None, specs.params)
            res["grads"] = L.params_to_jax(grads, cfg, specs.params)
            state, m = T.make_train_step(model, tc)(state, {"input_ids": ids, "labels": labels})
            res["metrics"] = {k: float(v) for k, v in m.items()}
            res["params"] = L.params_to_jax(state.params, cfg, specs.params)
            res["opt"] = T.opt_state_to_jax(state.opt, cfg, specs.opt)
            res["specs"] = {k: (s.shape, s.spec) for k, s in specs.opt.mu.items()}
            res["mu_local"] = {k: _np(v) for k, v in state.opt.mu.items()}
            res["coords"] = {a: S.get_parallel_state().rank(a) for a in S.MESH_AXES}
            res["state_bytes"] = T.optimizer.state_bytes(state.opt)
            if case.get("ep", 1) > 1:
                block = MoE(dataclasses.replace(cfg.moe_config(), capacity_factor=None))
                try:
                    block(torch.zeros((1, 4, cfg.hidden_size)))
                    res["refused"] = None
                except ValueError as e:
                    res["refused"] = str(e)
            if case.get("save"):
                C.save_checkpoint(case["save"], "step_1", model=state.params, optimizer=state.opt,
                                  model_specs=specs.params, optimizer_specs=specs.opt)
                dist.barrier()
            out[case["name"]] = res
        finally:
            S.destroy_model_parallel()
    return out


# ---------------------------------------------------------------------------
# LoRA, GPT-NeoX / CodeGen and BERT
# ---------------------------------------------------------------------------

def family_worker(rank, world, inputs):
    """Every multi-rank check of ``tests/test_torch_gptneox.py`` in one
    spawn of ``world`` = 2 ranks, the mesh rebuilt for each case: tiny-neox
    and tiny-codegen at tp = 2 (logits, loss, gradients gathered whole),
    tiny-bert at tp = 2 (MLM and NSP logits, the pretraining loss and its
    gradients), LoRA over tiny at tp = 2 (logits, loss, adapter gradients,
    the adapter tag saved at tp = 2 loaded back, JAX's adapter tag loaded),
    LoRA's train steps at dp = 2 under ZeRO-1, tiny-neox at pp = 2 under
    gpipe and 1f1b (loss and gradients). Returns {case: result} as numpy."""
    from neuronx_distributed_llama3_2_tpu_torch import trainer as T
    from neuronx_distributed_llama3_2_tpu_torch.checkpoint import checkpoint as C
    from neuronx_distributed_llama3_2_tpu_torch.lora import (
        LoraConfig,
        LoraModel,
        adapters_from_jax,
        adapters_to_jax,
    )
    from neuronx_distributed_llama3_2_tpu_torch.models import bert as B
    from neuronx_distributed_llama3_2_tpu_torch.models import gptneox as G
    from neuronx_distributed_llama3_2_tpu_torch.models import llama as L
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S
    from neuronx_distributed_llama3_2_tpu_torch.pipeline import PipelinedCausalLM

    ids, labels = torch.as_tensor(inputs["ids"]), torch.as_tensor(inputs["labels"])
    out = {}

    def grads_of(model, loss, to_jax):
        params = dict(model.named_parameters())
        return to_jax(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))

    def mesh(**kw):
        S.destroy_model_parallel()
        T.TrainingConfig(**kw).initialize("cpu")

    try:
        mesh(tensor_parallel_size=2)
        for name in ("tiny-neox", "tiny-codegen"):
            cfg = G.GPTNEOX_CONFIGS[name]
            model = G.GPTNeoXForCausalLM(cfg, device="cpu")
            model.load_state_dict(L.params_from_jax(inputs[name], cfg, device="cpu"))
            loss = model.loss(ids, labels)
            out[f"{name} tp2"] = dict(
                logits=_np(model(ids)), loss=float(loss),
                grads=grads_of(model, loss, lambda g: L.params_to_jax(g, cfg)))
        cfg = B.BERT_CONFIGS["tiny-bert"]
        bp, bbatch = inputs["tiny-bert"]
        model = B.BertForPreTraining(cfg, device="cpu")
        model.load_state_dict(L.params_from_jax(bp, cfg, device="cpu"))
        batch = {k: torch.as_tensor(v) for k, v in bbatch.items()}
        mlm, nsp = model(batch["input_ids"], batch["token_type_ids"], batch["attention_mask"])
        loss = model.pretraining_loss(batch)
        out["tiny-bert tp2"] = dict(mlm=_np(mlm), nsp=_np(nsp), loss=float(loss),
                                    grads=grads_of(model, loss,
                                                   lambda g: L.params_to_jax(g, cfg)))
        lp, ad, jroot, root = inputs["lora"]
        cfg = L.LLAMA_CONFIGS["tiny"]
        base = L.LlamaForCausalLM(cfg, device="cpu")
        base.load_state_dict(L.params_from_jax(lp, cfg, device="cpu"))
        lora = LoraModel(base, LoraConfig(r=4, alpha=8.0))
        lora.load_state_dict(adapters_from_jax(ad, lora))
        loss = lora.loss(ids, labels)
        res = out["lora tp2"] = dict(
            logits=_np(lora(ids)), loss=float(loss),
            grads=grads_of(lora, loss, lambda g: adapters_to_jax(g, lora)))
        own = dict(lora.named_parameters())
        specs = lora.param_specs()
        C.save_checkpoint(root, "adapters", model=own, model_specs=specs)
        dist.barrier()  # rank 0 marks the tag done after every rank's chunks
        back = C.load_checkpoint(root, "adapters", model=own, model_specs=specs)["model"]
        res["own_tag_loaded"] = all(torch.equal(back[k], p) for k, p in own.items())
        theirs = C.load_checkpoint(jroot, "adapters", model=own, model_specs=specs)["model"]
        res["jax_tag_loaded"] = all(torch.equal(theirs[k], p) for k, p in own.items())
        # the adapters' train steps at dp = 2 under ZeRO-1, from JAX's start
        start, opt_kw, ids2, steps = inputs["lora_dp2"]
        tc = T.TrainingConfig(optimizer=T.OptimizerConfig(zero_one_enabled=True, **opt_kw))
        mesh(optimizer=tc.optimizer)
        base = L.LlamaForCausalLM(cfg, device="cpu")
        base.load_state_dict(L.params_from_jax(lp, cfg, device="cpu"))
        lora = LoraModel(base, LoraConfig(r=4, alpha=8.0))
        state, sspecs = T.initialize_parallel_model(lora, tc)
        with torch.no_grad():
            for k, v in adapters_from_jax(start, lora).items():
                state.params[k].copy_(v)
        state = T.TrainState(state.params, T.init_optimizer_state(state.params, tc.optimizer,
                                                                  sspecs.opt))
        step = T.make_train_step(lora, tc)
        batch = {"input_ids": torch.as_tensor(ids2), "labels": torch.as_tensor(ids2)}
        metrics = []
        for _ in range(steps):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        out["lora dp2 zero1"] = dict(
            metrics=metrics, adapters=adapters_to_jax(state.params, lora),
            dp=S.get_data_parallel_size(),
            sharded=any(sp.mentions(S.DP_AXIS) for sp in sspecs.opt.mu.values()))
        cfg = G.GPTNEOX_CONFIGS["tiny-neox"]
        for sched in ("gpipe", "1f1b"):
            mesh(pipeline_parallel_size=2, pipeline_schedule=sched)
            stage = G.GPTNeoXForCausalLM(cfg, device="cpu")
            stage.load_state_dict(L.params_from_jax(inputs["tiny-neox"], cfg, device="cpu"))
            pm = PipelinedCausalLM(stage, num_microbatches=2, schedule=sched)
            loss, grads = pm.loss_and_grad(ids, labels)
            out[f"tiny-neox pp2 {sched}"] = dict(
                loss=float(loss), grads=L.params_to_jax(grads, cfg, stage.param_specs()))
    finally:
        S.destroy_model_parallel()
    return out


# ---------------------------------------------------------------------------
# Mllama: the channel-parallel convs, the model under tp / SP, the
# indivisible-vocab fallbacks, a ZeRO-1 step and tags
# ---------------------------------------------------------------------------

def _load_sharded(module, specs, full: dict) -> None:
    """``module``'s parameters from whole numpy arrays, each cut to this
    rank's part by ``specs`` (name -> LeafSpec)."""
    from neuronx_distributed_llama3_2_tpu_torch.parallel.layout import mesh_coords, port_slice

    coords = mesh_coords()
    with torch.no_grad():
        for name, p in module.named_parameters():
            _, index = port_slice(specs[name], coords, None)
            p.copy_(torch.as_tensor(full[name][index]))


def _gather_grads(module, specs) -> dict:
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import gather_leaf

    return {n: gather_leaf({None: p.grad}, specs[n]) for n, p in module.named_parameters()}


def mllama_worker(rank, world, inputs):
    """Every multi-rank check of ``tests/test_torch_mllama_tp.py`` in one
    spawn of ``world`` = 4 ranks (tp 2 x dp 2), the mesh rebuilt for each
    case: the conv layers at tp = 2 (the output-channel layer gathered,
    the output -> input pair, the pair's gradients), the tiny Mllama's
    logits, loss and gradients at tp = 2 with SP off and on, the
    indivisible-vocab fallbacks (vocab 125: the embedding split on its dim,
    the head row-parallel) under SP, one ZeRO-1 AdamW step through the
    trainer with the step's tag saved and JAX's tag loaded. Returns {case:
    result} as numpy."""
    from neuronx_distributed_llama3_2_tpu_torch import trainer as T
    from neuronx_distributed_llama3_2_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from neuronx_distributed_llama3_2_tpu_torch.models import mllama as M
    from neuronx_distributed_llama3_2_tpu_torch.parallel import conv as Cv
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as S

    out = {}

    def mesh(**kw):
        S.destroy_model_parallel()
        tc = T.TrainingConfig(**kw)
        tc.initialize("cpu")
        return tc

    def batch_of(b):
        return [torch.as_tensor(b[k]) for k in ("ids", "pix", "ar_ids", "ar_mask", "xmask")]

    try:
        mesh(tensor_parallel_size=2)
        cv = inputs["conv"]
        x = torch.as_tensor(cv["x"])
        one = Cv.OutputChannelParallelConv2d(16, 32, 3, padding=1, gather_output=True,
                                             device="cpu")
        _load_sharded(one, one.specs(), cv["one"])
        c1 = Cv.OutputChannelParallelConv2d(16, 32, 3, padding=1, device="cpu")
        c2 = Cv.InputChannelParallelConv2d(32, 8, 1, device="cpu")
        _load_sharded(c1, c1.specs(), cv["c1"])
        _load_sharded(c2, c2.specs(), cv["c2"])
        mid = c1(x)
        g1 = Cv.OutputChannelParallelConv2d(8, 16, 3, padding=1, device="cpu")
        g2 = Cv.InputChannelParallelConv2d(16, 4, 1, device="cpu")
        _load_sharded(g1, g1.specs(), cv["g1"])
        _load_sharded(g2, g2.specs(), cv["g2"])
        gx = torch.as_tensor(cv["gx"]).requires_grad_(True)
        (g2(g1(gx)) ** 2).sum().backward()
        out["conv tp2"] = dict(
            one=_np(one(x)), pair=_np(c2(mid)), mid_channels=mid.shape[-1],
            g1=_gather_grads(g1, g1.specs()), g2=_gather_grads(g2, g2.specs()), gx=_np(gx.grad))

        cfg = inputs["cfg"]
        for sp in (False, True):
            mesh(tensor_parallel_size=2, sequence_parallel=sp)
            model = M.MllamaForConditionalGeneration(cfg, device="cpu")
            model.load_state_dict(M.params_from_jax(inputs["params"], cfg, device="cpu"))
            ids, pix, ar, arm, xm = batch_of(inputs["batch"])
            params = dict(model.named_parameters())
            loss = model.loss(ids, ids, pix, ar, arm, xm)
            grads = torch.autograd.grad(loss, list(params.values()))
            out[f"mllama tp2 sp={sp}"] = dict(
                logits=_np(model(ids, pix, ar, arm, xm)), loss=float(loss.detach()),
                grads=M.params_to_jax(dict(zip(params, grads)), cfg),
                sequence_parallel=model.sequence_parallel)

        cfg125 = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, vocab_size=125))
        mesh(tensor_parallel_size=2, sequence_parallel=True)
        model = M.MllamaForConditionalGeneration(cfg125, device="cpu")
        model.load_state_dict(M.params_from_jax(inputs["params125"], cfg125, device="cpu"))
        ids, pix, ar, arm, xm = batch_of(inputs["batch125"])
        out["mllama tp2 vocab125"] = dict(
            logits=_np(model(ids, pix, ar, arm, xm)),
            loss=float(model.loss(ids, ids, pix, ar, arm, xm).detach()),
            embed_spec=model.param_specs()["embed.embedding"].spec,
            head_spec=model.param_specs()["lm_head.kernel"].spec,
            head_is_column=model.head_is_column)

        tc = mesh(tensor_parallel_size=2, sequence_parallel=True,
                  optimizer=T.OptimizerConfig(**inputs["opt_kw"]))
        model = M.MllamaForConditionalGeneration(cfg, device="cpu")
        state, specs = T.initialize_parallel_model(model, tc)
        model.load_state_dict(M.params_from_jax(inputs["params"], cfg, device="cpu"))
        state = T.TrainState(state.params,
                             T.init_optimizer_state(state.params, tc.optimizer, specs.opt))
        ids, pix, ar, arm, xm = batch_of(inputs["train_batch"])
        state, m = T.make_train_step(model, tc)(state, {
            "input_ids": ids, "labels": ids, "pixel_values": pix, "aspect_ratio_ids": ar,
            "aspect_ratio_mask": arm, "cross_attention_mask": xm})
        save_checkpoint(inputs["port_root"], "step_1", model=state.params, optimizer=state.opt,
                        model_specs=specs.params, optimizer_specs=specs.opt)
        result = dict(
            loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
            params=M.params_to_jax(state.params, cfg),
            opt=T.opt_state_to_jax(state.opt, cfg, specs.opt),
            dp_split=sorted(k for k, s in specs.opt.mu.items() if s.mentions(S.DP_AXIS)))
        # JAX's tag of its own step, loaded at tp 2 x dp 2
        fresh = M.MllamaForConditionalGeneration(cfg, device="cpu")
        fstate, fspecs = T.initialize_parallel_model(fresh, tc)
        got = load_checkpoint(inputs["jax_root"], "step_1", model=fstate.params,
                              optimizer=fstate.opt, model_specs=fspecs.params,
                              optimizer_specs=fspecs.opt)
        result["jax_tag"] = dict(params=M.params_to_jax(got["model"], cfg),
                                 opt=T.opt_state_to_jax(got["optimizer"], cfg, fspecs.opt))
        out["mllama tp2 dp2 zero1"] = result
        return out
    finally:
        S.destroy_model_parallel()
