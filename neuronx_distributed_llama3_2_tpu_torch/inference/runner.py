"""Inference runner: the logit-accuracy gate and the latency benchmarks.

Counterpart of ``neuronx_distributed_llama3_2_tpu/inference/runner.py``
(``check_accuracy_logits``, ``benchmark_generation``,
``benchmark_serving_churn``, ``benchmark_prefill_on_device``).
``check_accuracy_logits`` compares the dense engine's prefill logits with
a reference: logits the caller passes (an HF model's), else the port's own
forward of an fp32 copy of the weights. On the card every time is read on
the host clock after a synchronizing readback (or an explicit
``torch.cuda.synchronize``), so it spans the device work it waited for.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
    ContinuousBatchingEngine,
    GenerationConfig,
    InferenceEngine,
    pick_bucket,
    read_host_tokens,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import SamplingConfig
from neuronx_distributed_llama3_2_tpu_torch.inference import sampling as sampling_mod
from neuronx_distributed_llama3_2_tpu_torch.models.llama import LlamaForCausalLM
from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger

logger = get_logger()


def _sync(engine: InferenceEngine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def check_accuracy_logits(
    engine: InferenceEngine,
    input_ids,
    ref_logits: Optional[np.ndarray] = None,
    atol: float = 1e-3,
) -> Dict[str, float]:
    """Logit-accuracy gate: the engine's prefill logits against
    ``ref_logits`` (an HF model's, or by default the port's own forward
    over an fp32 copy of the weights). Raises on failure."""
    ids = torch.as_tensor(np.asarray(input_ids), device=engine.device)
    got = engine.prefill_logits(ids).float().cpu().numpy()
    if ref_logits is None:
        cfg = dataclasses.replace(engine.config, dtype=torch.float32)
        ref = LlamaForCausalLM(cfg, device=engine.device)
        ref.load_state_dict({k: v.float() for k, v in engine.params.state_dict().items()})
        ref_logits = ref(ids).float().cpu().numpy()
    ref_logits = np.asarray(ref_logits, np.float32)
    err = np.abs(got - ref_logits)
    report = {
        "max_abs_err": float(err.max()),
        "mean_abs_err": float(err.mean()),
        "top1_agreement": float((got.argmax(-1) == ref_logits.argmax(-1)).mean()),
    }
    if report["max_abs_err"] > atol:
        raise AssertionError(f"logit accuracy gate failed: {report} (atol={atol})")
    logger.info("logit accuracy gate passed: %s", report)
    return report


def benchmark_generation(
    engine: InferenceEngine,
    prompt_len: int = 128,
    max_new_tokens: int = 64,
    n_runs: int = 5,
    warmup: int = 1,
    seed: int = 0,
) -> Dict[str, Any]:
    """p50 / p90 / p99 TTFT and per-token latency over ``n_runs``
    generate() calls of random prompts (TTFT = prefill + first-token
    sample)."""
    rng = np.random.default_rng(seed)
    gen = GenerationConfig(max_new_tokens=max_new_tokens, sampling=SamplingConfig(greedy=True))
    reports: List[Dict] = []
    tok_rates: List[float] = []
    for run in range(warmup + n_runs):
        prompts = [
            rng.integers(0, engine.config.vocab_size, size=(prompt_len,)).tolist()
            for _ in range(engine.max_batch)
        ]
        t0 = time.perf_counter()
        res = engine.generate(prompts, gen)
        dt = time.perf_counter() - t0
        if run < warmup:
            continue
        tok_rates.append(sum(len(s) for s in res.sequences) / dt)
        reports.append(res.benchmark.report())

    def pctl(key: str, sub: str) -> float:
        return float(np.median([r[key][sub] for r in reports]))

    return {
        "prompt_len": prompt_len,
        "max_new_tokens": max_new_tokens,
        "batch": engine.max_batch,
        "ttft_p50_ms": pctl("ttft", "p50_ms"),
        "per_token_p50_ms": pctl("per_token", "p50_ms"),
        "per_token_p90_ms": pctl("per_token", "p90_ms"),
        "per_token_p99_ms": pctl("per_token", "p99_ms"),
        "tokens_per_s": float(np.median(tok_rates)),
    }


def benchmark_serving_churn(
    engine: InferenceEngine,
    n_requests: int = 16,
    prompt_len: int = 64,
    max_new_tokens: int = 32,
    admit_every: int = 4,
    seed: int = 0,
    prompts: Optional[List[List[int]]] = None,
) -> Dict[str, Any]:
    """Continuous-batching throughput under staggered admissions: requests
    arrive ``admit_every`` decode steps apart, so slots churn (admissions,
    completions and kv-bucket growth all happen mid-run). Returns
    requests/s and tokens/s over the run, the program-table size after
    warm-up and after the run (``compiled_under_traffic``, their
    difference, counts captures under traffic) and the streams by request
    (``outputs``). ``prompts`` replaces the random ones."""
    rng = np.random.default_rng(seed)
    cb = ContinuousBatchingEngine(
        engine,
        GenerationConfig(max_new_tokens=max_new_tokens, sampling=SamplingConfig(greedy=True)),
    )
    programs_after_warmup = len(engine._programs)
    if prompts is None:
        prompts = [
            rng.integers(0, engine.config.vocab_size, size=(prompt_len,)).tolist()
            for _ in range(n_requests)
        ]
    n_requests = len(prompts)
    _sync(engine)
    t0 = time.perf_counter()
    submitted = steps = 0
    alive = True
    while alive or submitted < n_requests:
        if steps % admit_every == 0 and submitted < n_requests:
            cb.submit(prompts[submitted])
            submitted += 1
        alive = cb.step()
        steps += 1
    _sync(engine)
    dt = time.perf_counter() - t0
    n_tokens = sum(len(r.out) for r in cb._finished.values())
    return {
        "n_requests": n_requests,
        "prompt_len": prompt_len,
        "max_new_tokens": max_new_tokens,
        "decode_steps": steps,
        "requests_per_s": n_requests / dt,
        "tokens_per_s": n_tokens / dt,
        "programs_after_warmup": programs_after_warmup,
        "programs_after_run": len(engine._programs),
        "compiled_under_traffic": len(engine._programs) - programs_after_warmup,
        "outputs": {rid: r.out for rid, r in sorted(cb._finished.items())},
    }


def benchmark_prefill_on_device(
    engine: InferenceEngine,
    prompt_len: int = 128,
    repeats: int = 16,
    n_runs: int = 3,
    seed: int = 0,
) -> Dict[str, Any]:
    """The prefill's device time with the host round trip amortized out:
    ``repeats`` calls of the engine's own ``prefill_compute`` (the body
    serving runs) back to back over the engine's cache, each with its own
    split of a key, then one readback; the median over ``n_runs`` of wall
    / repeats (a first, untimed run warms up)."""
    b = engine.max_batch
    bucket = pick_bucket(engine.buckets, prompt_len)
    rng = np.random.default_rng(seed)
    dev = engine.device
    ids = torch.as_tensor(rng.integers(0, engine.config.vocab_size, (b, bucket)), device=dev)
    lengths = torch.full((b,), prompt_len, dtype=torch.int32, device=dev)
    slots = torch.arange(b, dtype=torch.int32, device=dev)
    cfg = SamplingConfig(greedy=True)

    @torch.no_grad()
    def many() -> np.ndarray:
        key = sampling_mod.key(seed, device=dev)
        firsts = []
        for _ in range(repeats):
            key, k = sampling_mod.split(key)
            toks, _, engine.cache = engine.prefill_compute(
                engine.params, engine.cache, ids, lengths, slots, k, cfg
            )
            firsts.append(toks[0])
        return read_host_tokens(torch.stack(firsts))

    many()  # warm-up
    per_prefill = []
    for _ in range(n_runs):
        _sync(engine)
        t0 = time.perf_counter()
        many()
        per_prefill.append((time.perf_counter() - t0) / repeats)
    return {
        "prompt_len": prompt_len,
        "bucket": bucket,
        "batch": b,
        "repeats": repeats,
        "ttft_on_device_ms": round(float(np.median(per_prefill)) * 1e3, 3),
        "note": "median over runs of wall/repeats; excludes the per-request "
                "host round trip (see benchmark_generation for e2e)",
    }
