"""Launchable Llama pretraining with checkpoint and resume.

Counterpart of ``examples/pretrain_llama.py``, with its flags, its loop
and its log lines: tokens from a ``.npy`` file (``--data``) or a synthetic
stream (``--synthetic N``), the numpy or the native (``--native-loader``)
loader, a held-out eval (``--eval-every``), checkpoints in the JAX
package's format (``--ckpt-dir``, ``--save-every``, ``--async-save``,
``--keep-ckpts``), a metrics file, TensorBoard scalars, a Chrome-trace host
timeline and a device trace of steps 2-4. Re-running the same command
resumes from the newest complete checkpoint ("resumed from step_K at step
K"); a tag written by the JAX script resumes here, and the other way round.
Runs on the card unless ``--device cpu`` is given.

Example (the 1B at full width under its default remat "selective")::

    python -m neuronx_distributed_llama3_2_tpu_torch.scripts.pretrain \\
        --model llama3.2-1b --data tokens.npy --native-loader \\
        --global-batch 4 --seq-len 2048 --steps 100 --lr 1e-3 \\
        --ckpt-dir ckpt --save-every 50 --tensorboard-dir tb

Tensor parallelism (``--tp``, with ``--sp`` for Megatron sequence
parallelism) and data parallelism with ZeRO-1 (``--dp``, what the world
size leaves by default) run one process per rank: under ``torchrun``
(``torchrun --nproc-per-node 4 -m neuronx_distributed_llama3_2_tpu_torch.
scripts.pretrain --tp 2 --dp 2 ...``), or, on the CPU, with the JAX
script's ``--cpu-devices N``, which starts N processes over gloo itself.
Each dp rank reads its rows of every global batch; each rank saves and
loads its own shards of the checkpoint.

Pipeline parallelism (``--pp``, with the JAX script's rules): the model is
wrapped in a :class:`..pipeline.PipelinedCausalLM` under ``--pp-schedule``
(gpipe, 1f1b or interleaved with ``--model-chunks`` chunks a stage) with
``max(--microbatches, --pp)`` microbatches, and the trainer's own
microbatching stays at 1; each stage saves its own layers, in the
canonical layout, so a run resumes at another pp. ``--pp-schedule`` and
``--model-chunks`` need ``--pp`` above 1.

The port pretrains the Llama family (``LLAMA_CONFIGS``) and the MoE
families (``MIXTRAL_CONFIGS``: ``mixtral-8x7b``, ``tiny-moe``;
``DBRX_CONFIGS``: ``dbrx``, ``tiny-dbrx``), with ``--capacity-factor`` to
set an MoE model's capacity and ``--ep`` to split its experts over ep ranks
of the data-parallel ranks (JAX ``examples/run_mixtral_ep.sh``: ``--tp 4
--ep 8 --sp``); the other families raise ``SystemExit`` naming the slice
that ports them.
"""

from __future__ import annotations

import argparse
import sys
import atexit
import dataclasses
import os
import time
from typing import List, Optional

#: the JAX package's other model families, and the slice of the port that
#: brings each (ROADMAP.md, queue A)
OTHER_FAMILIES = {
    "gpt-neox-20b": 6, "pythia-6.9b": 6, "tiny-neox": 6, "codegen25-7b": 6,
    "tiny-codegen": 6, "bert-base": 6, "bert-large": 6, "tiny-bert": 6,
    "llama3.2-11b-vision": 6, "tiny-mllama": 6,
}


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="tiny",
                   help="LLAMA_CONFIGS, MIXTRAL_CONFIGS or DBRX_CONFIGS key")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--ep", type=int, default=1)
    p.add_argument("--sp", action="store_true", help="sequence parallelism")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ranks (0: what the world size leaves after --tp)")
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--pp-schedule", default="gpipe",
                   choices=["gpipe", "1f1b", "interleaved"], help="pipeline executor")
    p.add_argument("--model-chunks", type=int, default=1,
                   help="interleaved VPP chunks per pp lane (--pp-schedule interleaved)")
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=10)
    p.add_argument("--data", help="path to a .npy token stream")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate a synthetic token stream of this many tokens")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--save-every", type=int, default=50)
    p.add_argument("--async-save", action="store_true")
    p.add_argument("--keep-ckpts", type=int, default=3)
    p.add_argument("--metrics-file", default=None)
    p.add_argument("--eval-every", type=int, default=0,
                   help="run a held-out eval every N steps (0 = off)")
    p.add_argument("--eval-batches", type=int, default=4)
    p.add_argument("--tensorboard-dir", default=None,
                   help="write TensorBoard scalar events (loss/grad_norm/lr/seq_s)")
    p.add_argument("--native-loader", action="store_true",
                   help="use the C++ mmap+prefetch token loader (native/token_loader.cc)")
    p.add_argument("--timeline", default=None,
                   help="write a Chrome-trace host timeline (events: step/data/ckpt)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of steps 2-4 into this dir")
    p.add_argument("--capacity-factor", type=float, default=None,
                   help="MoE capacity factor (required for --ep > 1 on MoE models)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="start this many ranks over gloo on the CPU (instead of torchrun; "
                        "the JAX script's virtual CPU mesh)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def model_families():
    """{config key: (config, model class)} of every family the port
    pretrains."""
    from neuronx_distributed_llama3_2_tpu_torch.models.dbrx import DBRX_CONFIGS, DbrxForCausalLM
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import LLAMA_CONFIGS, LlamaForCausalLM
    from neuronx_distributed_llama3_2_tpu_torch.models.mixtral import (
        MIXTRAL_CONFIGS,
        MixtralForCausalLM,
    )

    out = {k: (c, LlamaForCausalLM) for k, c in LLAMA_CONFIGS.items()}
    out.update({k: (c, MixtralForCausalLM) for k, c in MIXTRAL_CONFIGS.items()})
    out.update({k: (c, DbrxForCausalLM) for k, c in DBRX_CONFIGS.items()})
    return out


def _refuse_unported(args, families) -> None:
    if args.model in OTHER_FAMILIES:
        raise SystemExit(
            f"--model {args.model}: this model family is not ported yet "
            f"(ROADMAP.md, slice 5 item {OTHER_FAMILIES[args.model]}); the port "
            f"pretrains: {sorted(families)}"
        )
    if args.model not in families:
        raise SystemExit(f"unknown model {args.model!r}; one of {sorted(families)}")
    if args.pp == 1:
        for flag, value, default in (("pp-schedule", args.pp_schedule, "gpipe"),
                                     ("model-chunks", args.model_chunks, 1)):
            if value != default:
                raise SystemExit(f"--{flag} {value}: needs --pp above 1 (a pipeline)")
    moe = hasattr(families[args.model][0], "capacity_factor")
    if args.capacity_factor is not None and not moe:
        raise SystemExit(f"--capacity-factor: {args.model} is not a MoE model")
    if args.ep != 1 and not moe:
        raise SystemExit(f"--ep {args.ep}: {args.model} is not a MoE model")


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the script; returns what it did: ``start_step``, ``losses``
    ({step: loss}), ``eval_losses``, the final ``state``, the ``dataset``
    class name, the resumed ``tag`` and the seconds each save and the load
    took. With ``--cpu-devices`` it starts the ranks and returns rank 0's
    record, without the state."""
    args = parse_args(argv)
    if args.cpu_devices > 1:
        if args.device != "cpu":
            raise SystemExit("--cpu-devices starts CPU ranks (--device cpu); on the card "
                             "use torchrun")
        from neuronx_distributed_llama3_2_tpu_torch.parallel.multihost import spawn_gloo_ranks

        argv = list(sys.argv[1:] if argv is None else argv)
        return spawn_gloo_ranks(_rank_main, args.cpu_devices, argv)[0]
    return _run(args)


def _rank_main(rank: int, nproc: int, argv) -> Optional[dict]:
    """One rank of a ``--cpu-devices`` run: rank 0's record without the
    state, nothing from the others."""
    del nproc
    out = _run(parse_args(argv))
    if rank == 0:
        out.pop("state")
        return out
    return None


def _run(args) -> dict:
    import numpy as np

    from neuronx_distributed_llama3_2_tpu_torch.checkpoint import (
        finalize_async_saves,
        load_checkpoint,
        save_checkpoint,
    )
    from neuronx_distributed_llama3_2_tpu_torch.data import (
        DistributedDataLoader,
        LoaderState,
        TokenDataset,
        batch_to_device,
        write_token_file,
    )
    from neuronx_distributed_llama3_2_tpu_torch.trainer import (
        OptimizerConfig,
        TensorBoardLogger,
        TrainingConfig,
        TrainState,
        evaluate,
        initialize_parallel_model,
        make_eval_step,
        make_train_step,
    )
    from neuronx_distributed_llama3_2_tpu_torch.trainer.metrics import (
        Throughput,
        TrainingMetrics,
    )
    from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger
    from neuronx_distributed_llama3_2_tpu_torch.utils.profiler import (
        Timeline,
        device_trace,
        step_annotation,
    )

    import torch

    logger = get_logger()
    families = model_families()
    _refuse_unported(args, families)
    model_cfg, model_cls = families[args.model]
    model_cfg = dataclasses.replace(
        model_cfg, max_seq_len=max(args.seq_len, model_cfg.max_seq_len)
    )
    if args.capacity_factor is not None:
        model_cfg = dataclasses.replace(model_cfg, capacity_factor=args.capacity_factor)
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
    from neuronx_distributed_llama3_2_tpu_torch.parallel.multihost import (
        initialize_distributed,
        is_coordinator,
        sync_global_devices,
        world_size,
    )

    # the ep ranks are data-parallel ranks: --dp counts them (dp = dp_exp * ep)
    ranks = args.tp * args.pp * max(args.dp, args.ep, 1)
    if ranks > 1 and world_size() == 1 and "WORLD_SIZE" not in os.environ:
        ep = f" --ep {args.ep}" if args.ep > 1 else ""
        raise SystemExit(
            f"--tp {args.tp} --pp {args.pp} --dp {args.dp}{ep}: {ranks} ranks run one process "
            f"each: start them with torchrun, or with --cpu-devices {ranks} on the CPU"
        )
    if "WORLD_SIZE" in os.environ:
        # one process per rank, from torchrun's environment
        initialize_distributed(device=args.device)
    if args.dp and ranks != world_size():
        raise SystemExit(f"--tp {args.tp} x --pp {args.pp} x --dp {args.dp} != the "
                         f"{world_size()} processes")
    pipelined = args.pp > 1
    config = TrainingConfig(
        tensor_parallel_size=args.tp,
        pipeline_parallel_size=args.pp,
        expert_parallel_size=args.ep,
        # the pipeline knobs are pinned only when there is a pipeline
        pipeline_schedule=args.pp_schedule if pipelined else None,
        num_model_chunks=args.model_chunks if pipelined else None,
        sequence_parallel=args.sp,
        # under pp the pipelined model makes its own microbatches; the
        # trainer must not split the batch again
        num_microbatches=1 if pipelined else args.microbatches,
        seed=args.seed,
        optimizer=OptimizerConfig(
            learning_rate=args.lr,
            warmup_steps=args.warmup_steps,
            total_steps=args.steps,
        ),
    )
    device = config.initialize(args.device)
    model = model_cls(model_cfg, device=device,
                      num_model_chunks=args.model_chunks if pipelined else 1)
    if pipelined:
        from neuronx_distributed_llama3_2_tpu_torch.pipeline import PipelinedCausalLM

        model = PipelinedCausalLM(model, num_microbatches=max(args.microbatches, args.pp),
                                  schedule=args.pp_schedule,
                                  num_model_chunks=args.model_chunks)

    # -- data -------------------------------------------------------------
    data_path = args.data
    if args.synthetic:
        data_path = os.path.join(args.ckpt_dir, "synthetic_tokens.npy")
        if not os.path.exists(data_path) and is_coordinator():
            os.makedirs(args.ckpt_dir, exist_ok=True)
            rng = np.random.default_rng(args.seed)
            write_token_file(
                data_path,
                rng.integers(0, model_cfg.vocab_size, args.synthetic, dtype=np.int32),
            )
        sync_global_devices("synthetic data written")
    if not data_path:
        raise SystemExit("pass --data FILE.npy or --synthetic N")
    dataset = None
    if args.native_loader:
        from neuronx_distributed_llama3_2_tpu_torch.data.native_loader import (
            NativeTokenDataset,
            native_available,
        )

        if native_available():
            dataset = NativeTokenDataset(data_path, args.seq_len)
        else:
            logger.warning("--native-loader requested but no C++ toolchain; "
                           "using the numpy loader")
    if dataset is None:
        dataset = TokenDataset(data_path, args.seq_len)
    # train / eval holdout: eval owns the tail of the sample space and its
    # own numpy dataset (the native dataset's one-slot prefetch belongs to
    # the train loop alone)
    n_samples = len(dataset)
    eval_loader = None
    train_range = None
    if args.eval_every:
        if args.eval_batches < 1:
            raise SystemExit("--eval-batches must be >= 1 when --eval-every is set")
        eval_n = max(args.global_batch * args.eval_batches, n_samples // 20)
        if n_samples - eval_n < args.global_batch:
            raise SystemExit(f"dataset too small to hold out {eval_n} eval samples")
        train_range = (0, n_samples - eval_n)
        eval_loader = DistributedDataLoader(
            TokenDataset(data_path, args.seq_len), args.global_batch, shuffle=False,
            sample_range=(n_samples - eval_n, n_samples),
        )
    loader = DistributedDataLoader(
        dataset, args.global_batch, seed=args.seed, sample_range=train_range,
    )
    eval_step_fn = None

    # -- model / optimizer state (fresh, then maybe replaced by a resume) --
    state, specs = initialize_parallel_model(model, config)
    # each dp rank is given its rows of the global batch by the loader
    step_fn = make_train_step(model, config, local_batch=True)
    sharded = parallel_state.model_parallel_is_initialized() and world_size() > 1
    spec_kw = dict(model_specs=specs.params, optimizer_specs=specs.opt) if sharded else {}
    start_step = 0
    t0 = time.perf_counter()
    loaded = load_checkpoint(
        args.ckpt_dir, tag="latest_if_exists", model=state.params, optimizer=state.opt,
        **spec_kw,
    )
    load_s = None
    resumed = None
    if loaded is not None:
        with torch.no_grad():
            for name, p in state.params.items():
                p.copy_(loaded["model"][name])
        state = TrainState(state.params, loaded["optimizer"])
        if device.type == "cuda":
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        uc = loaded.get("user_content") or {}
        start_step = int(uc.get("step", 0))
        loader.state = LoaderState.from_json(uc.get("loader", {}))
        resumed = loaded["tag"]
        del loaded
        logger.info("resumed from %s at step %d", resumed, start_step)

    # -- train loop --------------------------------------------------------
    # rank 0 alone writes the scalars and the metrics file
    tb = TensorBoardLogger(args.tensorboard_dir) if args.tensorboard_dir and is_coordinator() else None
    metrics_file = (TrainingMetrics(args.metrics_file)
                    if args.metrics_file and is_coordinator() else None)
    throughput = Throughput(args.global_batch)
    batches = iter(loader)
    save_s: List[float] = []

    def save(tag_step: int):
        t = time.perf_counter()
        save_checkpoint(
            args.ckpt_dir,
            tag=f"step_{tag_step}",
            model=state.params,
            optimizer=state.opt,
            user_content={"step": tag_step, "loader": loader.state.to_json()},
            async_save=args.async_save,
            num_kept_ckpts=args.keep_ckpts,
            **spec_kw,
        )
        save_s.append(time.perf_counter() - t)

    timeline = Timeline(args.timeline if is_coordinator() else None)
    profile_ctx = None

    def stop_profile():
        nonlocal profile_ctx
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
            profile_ctx = None

    # stop the trace even when the run ends (or raises) inside the window:
    # an unstopped trace is never written
    atexit.register(stop_profile)
    losses, eval_losses = {}, {}
    try:
        for step in range(start_step, args.steps):
            if args.profile_dir and step == start_step + 2 and is_coordinator():
                profile_ctx = device_trace(args.profile_dir)
                profile_ctx.__enter__()
            with timeline.event("load_batch", cat="data"):
                ids = batch_to_device(next(batches), device)
            t0 = time.perf_counter()
            with timeline.event("train_step", cat="step"), step_annotation(step):
                state, m = step_fn(state, {"input_ids": ids, "labels": ids})
                loss = float(m["loss"])  # waits for the step
            if args.profile_dir and step == start_step + 4:
                stop_profile()
            if not np.isfinite(loss):
                raise RuntimeError(f"non-finite loss {loss} at step {step}")
            losses[step] = loss
            seqs_per_s = throughput.tick()
            grad_norm, lr = float(m["grad_norm"]), float(m["learning_rate"])
            logger.info(
                "step %d loss %.4f grad_norm %.3f lr %.2e (%.0f ms)%s",
                step, loss, grad_norm, lr, (time.perf_counter() - t0) * 1e3,
                f" {seqs_per_s:.2f} seq/s" if seqs_per_s else "",
            )
            if metrics_file:
                metrics_file.log(step, loss=loss, grad_norm=grad_norm, lr=lr,
                                 seqs_per_s=seqs_per_s)
            if tb:
                tb.log_scalars(step, {
                    "train/loss": loss, "train/grad_norm": grad_norm, "train/lr": lr,
                    **({"train/seqs_per_s": seqs_per_s} if seqs_per_s else {}),
                })
            if eval_loader is not None and (step + 1) % args.eval_every == 0:
                if eval_step_fn is None:
                    eval_step_fn = make_eval_step(model, config)

                def eval_batches():
                    # a fixed slice (batch_at): the same samples every
                    # interval, so successive eval losses compare
                    for i in range(args.eval_batches):
                        ev = batch_to_device(eval_loader.batch_at(i), device)
                        yield {"input_ids": ev, "labels": ev}

                ev_loss = evaluate(model, config, state.params, eval_batches(),
                                   eval_step=eval_step_fn)
                eval_losses[step] = ev_loss
                logger.info("step %d eval_loss %.4f", step, ev_loss)
                if tb:
                    tb.log_scalars(step, {"eval/loss": ev_loss})
                if metrics_file:
                    metrics_file.log(step, eval_loss=ev_loss)
                throughput.reset()  # eval wall time must not read as a dip
            if (args.save_every > 0 and (step + 1) % args.save_every == 0
                    and step + 1 < args.steps):
                with timeline.event("save_checkpoint", cat="ckpt", step=step + 1):
                    save(step + 1)
                throughput.reset()  # a blocking save is not training time
            timeline.step_end(step)
        # skip on a no-op resume: rewriting the completed final checkpoint
        # would unmark done and could lose it if killed mid-write
        if start_step < args.steps:
            save(args.steps)
    finally:
        stop_profile()
        atexit.unregister(stop_profile)
        timeline.close()
        if tb:
            tb.close()
        if hasattr(dataset, "close"):
            dataset.close()
    finalize_async_saves()
    logger.info("done: %d steps", args.steps)
    return dict(start_step=start_step, losses=losses, eval_losses=eval_losses,
                state=state, dataset=type(dataset).__name__, tag=resumed,
                save_seconds=save_s, load_seconds=load_s)


if __name__ == "__main__":
    main()
