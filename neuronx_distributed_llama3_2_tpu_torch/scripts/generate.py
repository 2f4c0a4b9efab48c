"""Launchable text generation and latency report.

Counterpart of ``examples/generate.py``: build the dense engine
(:class:`..inference.engine.InferenceEngine`) over a registry model,
generate, print the streams and the p50 / p90 / p99 latency report. Runs
on the card unless ``--device cpu`` is given.

Examples::

    # random 1B weights, greedy, raw token ids, 8 tokens a host round trip
    python -m neuronx_distributed_llama3_2_tpu_torch.scripts.generate \\
        --model llama3.2-1b --random-init --prompt-ids 12,99,4,7 \\
        --greedy --on-device-steps 8 --aot

    # sampled, on the CPU at the tiny config
    python -m neuronx_distributed_llama3_2_tpu_torch.scripts.generate \\
        --model tiny --random-init --prompt-ids 1,2,3 --temperature 0.8 \\
        --top-p 0.95 --device cpu

    # the weights of a checkpoint written by scripts.pretrain (or by the
    # JAX package), greedy
    python -m neuronx_distributed_llama3_2_tpu_torch.scripts.generate \\
        --model llama3.2-1b --ckpt-dir ckpt --tag latest --prompt-ids 12,99,4,7 \\
        --greedy

    # tensor parallel over two ranks: torchrun on the card, --nproc on the CPU
    torchrun --nproc-per-node 2 -m neuronx_distributed_llama3_2_tpu_torch.scripts.generate \
        --model llama3.2-1b --random-init --prompt-ids 12,99,4,7 --greedy --tp 2

``--tp N`` runs one process per rank (``torchrun``, or, on the CPU,
``--nproc``, which starts the N ranks over gloo itself): each holds its
shard of the weights and of the cache, and every rank generates the same
tokens; rank 0 prints them. Weights from an
HF checkpoint (``--hf-dir``) and a text ``--prompt`` (it needs the HF
tokenizer) are not ported yet: each raises, naming the slice it comes with.

``--model`` is any key of the model registry (:func:`..models.
resolve_model`, as the JAX script resolves it): the Llama, Mixtral / DBRX
and GPT-NeoX / CodeGen families serve; BERT has no KV-cache decode and the
engine refuses it, as the JAX one does; an Mllama name raises, as in JAX:
multimodal decode needs image inputs (:class:`..inference.MllamaDecoder`).
"""

from __future__ import annotations

import argparse
import sys
import json
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True, help="model registry key (models.model_registry)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf-dir", help="HF checkpoint directory (not ported yet)")
    src.add_argument("--ckpt-dir", help="native checkpoint root (the JAX package's format)")
    src.add_argument("--random-init", action="store_true",
                     help="random weights from --seed (smoke and latency runs)")
    p.add_argument("--tag", default="latest", help="native checkpoint tag")
    p.add_argument("--prompt", help="text prompt (needs the HF tokenizer)")
    p.add_argument("--prompt-ids", help="comma-separated token ids")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--on-device-steps", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--nproc", action="store_true",
                   help="start the --tp ranks over gloo on the CPU (instead of torchrun)")
    p.add_argument("--aot", action="store_true",
                   help="build (on the card: capture) every bucket program before the "
                        "first request")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the script; returns {"sequences": the generated token ids per
    request, "report": the latency report it prints} (rank 0's, with
    ``--nproc``)."""
    args = parse_args(argv)
    if args.nproc and args.tp > 1:
        if args.device != "cpu":
            raise SystemExit("--nproc starts CPU ranks (--device cpu); on the card use torchrun")
        from neuronx_distributed_llama3_2_tpu_torch.parallel.multihost import spawn_gloo_ranks

        argv = list(sys.argv[1:] if argv is None else argv)
        return spawn_gloo_ranks(_rank_main, args.tp, argv)[0]
    return _run(args)


def _rank_main(rank: int, nproc: int, argv) -> dict:
    del rank, nproc
    return _run(parse_args(argv))


def _run(args) -> dict:
    import os

    from neuronx_distributed_llama3_2_tpu_torch.inference import (
        GenerationConfig,
        InferenceEngine,
        SamplingConfig,
    )
    from neuronx_distributed_llama3_2_tpu_torch.models import MllamaConfig, resolve_model
    from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger

    logger = get_logger()
    if args.hf_dir:
        raise NotImplementedError(
            "--hf-dir: the HF checkpoint converter is not ported yet "
            "(ROADMAP.md, slice 5 item 7)"
        )
    try:
        entry = resolve_model(args.model)
    except KeyError as e:
        raise SystemExit(str(e.args[0])) from e
    if isinstance(entry["config"], MllamaConfig):  # JAX examples/generate.py:88
        raise SystemExit(
            f"{args.model}: multimodal decode needs image inputs; use inference.MllamaDecoder "
            "from the library instead of this text-only CLI.")
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
    from neuronx_distributed_llama3_2_tpu_torch.parallel.multihost import (
        initialize_distributed,
        is_coordinator,
        world_size,
    )

    if args.tp > 1:
        if world_size() == 1 and "WORLD_SIZE" not in os.environ:
            raise SystemExit(
                f"--tp {args.tp}: one process a rank: start them with torchrun, or "
                f"with --nproc on the CPU"
            )
        initialize_distributed(device=args.device)
        parallel_state.initialize_model_parallel(
            tensor_model_parallel_size=args.tp, device=args.device)
    config = entry["config"]
    params = entry["model_cls"](config, device=args.device)
    if args.ckpt_dir:
        from neuronx_distributed_llama3_2_tpu_torch.checkpoint import load_checkpoint

        # each rank reads the regions of its shards (whole tensors at tp 1)
        loaded = load_checkpoint(args.ckpt_dir, tag=args.tag,
                                 model=dict(params.named_parameters()),
                                 model_specs=params.param_specs() if args.tp > 1 else None)
        if loaded is None:
            raise SystemExit(f"no checkpoint {args.tag} under {args.ckpt_dir}")
        params.load_state_dict(loaded["model"])
        logger.info("loaded the model of %s/%s", args.ckpt_dir, loaded["tag"])
        del loaded
    else:
        params.init_weights(args.seed)

    if args.prompt_ids:
        prompt = [int(t) for t in args.prompt_ids.split(",")]
    elif args.prompt:
        raise NotImplementedError(
            "--prompt needs the HF tokenizer, which comes with the HF converter "
            "(ROADMAP.md, slice 5 item 7); pass --prompt-ids"
        )
    else:
        raise SystemExit("pass --prompt-ids")

    sampling = SamplingConfig(
        greedy=args.greedy, temperature=args.temperature, top_k=args.top_k,
        top_p=args.top_p,
    )
    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens, sampling=sampling, seed=args.seed,
        on_device_steps=args.on_device_steps,
    )
    engine = InferenceEngine(
        config, params, max_batch=args.batch, max_seq_len=args.max_seq_len
    )
    if args.aot:
        secs = engine.aot_compile(
            sampling=sampling,
            on_device_steps=(args.on_device_steps,) if args.on_device_steps > 1 else (),
        )
        logger.info("built every bucket program in %.1fs", secs)

    result = engine.generate([prompt] * args.batch, gen)
    report = result.benchmark.report()
    if is_coordinator():
        for i, toks in enumerate(result.sequences):
            print(f"--- request {i}: {toks}")
        print(json.dumps(report, indent=2))
    return {"sequences": result.sequences, "report": report}


if __name__ == "__main__":
    main()
