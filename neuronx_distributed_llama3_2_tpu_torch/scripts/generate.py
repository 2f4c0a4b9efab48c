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

Weights from an HF checkpoint (``--hf-dir``) or a native checkpoint
(``--ckpt-dir``), a text ``--prompt`` (it needs the HF tokenizer) and
``--tp > 1`` are not ported yet: each raises, naming the slice it comes
with.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True, help="model registry key (LLAMA_CONFIGS)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf-dir", help="HF checkpoint directory (not ported yet)")
    src.add_argument("--ckpt-dir", help="native checkpoint root (not ported yet)")
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
    p.add_argument("--aot", action="store_true",
                   help="build (on the card: capture) every bucket program before the "
                        "first request")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    from neuronx_distributed_llama3_2_tpu_torch.inference import (
        GenerationConfig,
        InferenceEngine,
        SamplingConfig,
    )
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
        LLAMA_CONFIGS,
        LlamaForCausalLM,
    )
    from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger

    logger = get_logger()
    if args.hf_dir:
        raise NotImplementedError(
            "--hf-dir: the HF checkpoint converter is not ported yet "
            "(ROADMAP.md, slice 5 item 7)"
        )
    if args.ckpt_dir:
        raise NotImplementedError(
            "--ckpt-dir: checkpointing is not ported yet (ROADMAP.md, slice 4)"
        )
    if args.tp > 1:
        raise NotImplementedError(
            "--tp > 1: tensor-parallel decode is not ported yet "
            "(ROADMAP.md, slice 5 item 1)"
        )
    if args.model not in LLAMA_CONFIGS:
        raise SystemExit(f"unknown model {args.model!r}; one of {sorted(LLAMA_CONFIGS)}")
    config = LLAMA_CONFIGS[args.model]
    params = LlamaForCausalLM(config, device=args.device).init_weights(args.seed)

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
    for i, toks in enumerate(result.sequences):
        print(f"--- request {i}: {toks}")
    report = result.benchmark.report()
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
