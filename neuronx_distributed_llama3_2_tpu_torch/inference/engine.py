"""Inference engine: bucketed programs over a dense per-slot KV cache, the
generate loop and continuous batching.

Counterpart of ``neuronx_distributed_llama3_2_tpu/inference/engine.py``
(``read_host_tokens``, ``default_buckets`` / ``pick_bucket``,
``GenerationConfig``, ``GenerateResult``, ``InferenceEngine``,
``ContinuousBatchingEngine``).

The JAX engine keeps a table of programs, each a jit specialization of the
decode model at one (batch, bucket, sampling, kv bucket) key, compiled
ahead of time by ``ensure_serving_compiled`` / ``aot_compile``. Here the
same keys name :class:`DenseProgram` records. A record runs its step over
the engine's cache and the static input buffers its family shares (a
prefill's ids, lengths and slots; a decode's resident tokens, positions and
slots); on the card the ahead-of-time counterpart of a compile is a CUDA
graph capture, and every call of a record replays its graph (a record
first called before any capture is captured then, the counterpart of a
lazy jit compile): no program runs eagerly on the card. On the CPU the
records run their steps eagerly through the same buffers, so
``len(engine._programs)`` means what it means in JAX.

Sampling keys chain as in JAX: the engine holds one resident key (``_key``,
threefry key data on the device, :func:`..inference.sampling.key`), and
each sampled program splits it in place where the JAX caller splits its
key (a prefill, each decode step, each of a multi-step decode's steps), so
a replayed graph advances the chain and no key crosses from the host
during a steady step. Greedy programs draw nothing and leave it be.

Through :meth:`InferenceEngine.generate` the tokens and positions stay on
the device between steps (each decode writes its tokens and the advanced
positions back into its family's buffers); the host reads the tokens once
a step, or once a chunk of ``on_device_steps``.

Divergences from the JAX package: the cache is allocated at the first
dense program, not in the constructor (the paged engine also builds an
``InferenceEngine`` and reads no dense cache); ``_live_params`` is the
identity (quantized weights wait for ``quantization/layers.py``).

Under tensor parallelism (a model built under a live mesh, one process a
rank) the cache holds this rank's kv heads (``LlamaDecode.cache_specs``,
JAX ``inference/engine.py:140-154``) and every rank generates the same
tokens from the gathered logits; its CUDA graphs need NCCL.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neuronx_distributed_llama3_2_tpu_torch.inference import sampling as sampling_mod
from neuronx_distributed_llama3_2_tpu_torch.inference.benchmark import (
    GenerationBenchmark,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.model import KVCache, LlamaDecode
from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import (
    SamplingConfig,
    sample,
)
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.multihost import require_capturable_collectives
from neuronx_distributed_llama3_2_tpu_torch.serving import catalog
from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger

logger = get_logger()


def read_host_tokens(tokens: torch.Tensor) -> np.ndarray:
    """The host readback of every generate and serving loop here: one copy
    to host memory (a synchronizing one from the card). On the CPU the
    copy is a real one, since the tensor may be a static buffer that the
    next step rewrites in place."""
    return tokens.detach().to("cpu", copy=True).numpy()


def default_buckets(max_seq_len: int, min_bucket: int = 128) -> List[int]:
    """Powers-of-2 bucket ladder up to max_seq_len (canonical
    implementation in ``serving/catalog.py``)."""
    return catalog.default_buckets(max_seq_len, min_bucket)


def pick_bucket(buckets: Sequence[int], length: int) -> int:
    """Smallest bucket >= length (canonical implementation in
    ``serving/catalog.py``)."""
    return catalog.pick_bucket(buckets, length)


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 128
    eos_token_id: Optional[int] = None
    sampling: SamplingConfig = SamplingConfig()
    seed: int = 0
    # tokens generated per host round trip: one program runs this many
    # decode steps (unrolled in its graph on the card), amortizing the
    # readback. 1 = the per-token loop. EOS is detected per chunk on the
    # host; surplus tokens of the final chunk are discarded
    on_device_steps: int = 1
    # capture every program this generation can reach before the first
    # token, so none is captured mid-stream; programs stay on the engine,
    # so repeat calls pay nothing
    precompile: bool = True


@dataclasses.dataclass
class GenerateResult:
    sequences: List[List[int]]      # new tokens only (no prompt), per request
    benchmark: GenerationBenchmark


@dataclasses.dataclass
class DenseProgram:
    """One program of :class:`InferenceEngine`'s table (the counterpart of a
    compiled JAX executable): ``fn`` runs the step over the engine's cache
    and ``inputs``, its family's static buffers, and returns the tensors
    the caller reads. ``compiled`` is set once the program was built ahead
    of its first call (:meth:`InferenceEngine.ensure_serving_compiled`);
    on the card that is its CUDA graph capture, and ``capture`` captures a
    program first called before that. ``outputs`` are the tensors of the
    capture, in the graph pool all the engine's programs share: the next
    replay of any of them may overwrite them, so read them before the next
    call. ``calls`` counts the calls."""

    key: tuple
    fn: Callable[[], tuple]
    inputs: Dict[str, torch.Tensor]
    capture: Optional[Callable] = None
    graph: Any = None
    outputs: tuple = ()
    compiled: bool = False
    calls: int = 0

    def __call__(self) -> tuple:
        if self.capture is not None and self.graph is None:
            self.graph, self.outputs = self.capture(self)
            self.compiled = True
        if self.graph is None:
            self.outputs = self.fn()
        else:
            self.graph.replay()
        self.calls += 1
        return self.outputs


class InferenceEngine:
    """Owns the model and its weights, the bucket ladder, the dense cache
    and the table of programs.

    ``params`` is the :class:`LlamaForCausalLM` module holding the weights
    (on the card unless it was built elsewhere; the engine takes its
    device); ``model`` is the weightless :class:`LlamaDecode` that runs
    them over a cache. ``cache`` is the dense :class:`KVCache` of
    ``max_batch`` slots of ``max_seq_len`` rows at ``cache_dtype`` (the
    config's dtype by default), allocated at first use and then written in
    place by every program, so a captured graph holds its address."""

    def __init__(
        self,
        config: LlamaConfig,
        params: LlamaForCausalLM,
        *,
        max_batch: int = 4,
        max_seq_len: int = 2048,
        buckets: Optional[Sequence[int]] = None,
        cache_dtype: Any = None,
    ) -> None:
        self.config = config
        self.model = LlamaDecode(config)
        self.params = params
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.buckets = list(buckets) if buckets else default_buckets(max_seq_len)
        if self.buckets[-1] > max_seq_len:
            raise ValueError("largest bucket exceeds max_seq_len")
        self.cache_dtype = cache_dtype
        self._cache: Optional[KVCache] = None
        self._programs: Dict[Tuple, DenseProgram] = {}
        self._inputs: Dict[tuple, Dict[str, torch.Tensor]] = {}
        # the resident key every sampled program splits in place
        self._key = sampling_mod.key(0, device=self.device)
        self._graph_pool = None
        self._warm_stream = None

    @property
    def device(self) -> torch.device:
        return self.params.device

    @property
    def cache(self) -> KVCache:
        """The dense cache, allocated at its first use (an 8 x 2048-row 1B
        cache is 536,870,912 B, which a paged serve never reads)."""
        if self._cache is None:
            self._cache = self.model.init_cache(
                self.max_batch, self.max_seq_len, self.cache_dtype, device=self.device
            )
        return self._cache

    @cache.setter
    def cache(self, value: KVCache) -> None:
        self._cache = value

    def _live_params(self, params):
        """The weights a program runs on: the identity on float weights
        (the JAX package dequantizes ``QuantizedTensor`` leaves here)."""
        return params

    def _kv_bucket(self, needed: int) -> int:
        """Token-gen cache bucket covering ``needed`` rows; positions past a
        short custom ladder fall back to the full cache."""
        if needed > self.buckets[-1]:
            return self.max_seq_len
        return pick_bucket(self.buckets, needed)

    # -- program table ----------------------------------------------------

    def _family(self, kind: str, batch: int, block: int = 0) -> Dict[str, torch.Tensor]:
        """The static buffers every program of (``kind``, ``batch``) reads
        (a verify's also by ``block``): int32, slots ``arange(batch)``, a
        prefill's lengths 1. A prefill reads ``ids[:, :bucket]`` of one
        (batch, top bucket) buffer."""
        fam = (kind, batch, block)
        inputs = self._inputs.get(fam)
        if inputs is None:
            shapes = {
                "prefill": dict(ids=(batch, self.buckets[-1]), lengths=(batch,)),
                "decode": dict(tokens=(batch,), positions=(batch,)),
                "verify": dict(tokens=(batch, block), positions=(batch,)),
            }[kind]
            dev = self.device
            inputs = {
                name: torch.zeros(shape, dtype=torch.int32, device=dev)
                for name, shape in shapes.items()
            }
            inputs["slots"] = torch.arange(batch, dtype=torch.int32, device=dev)
            if kind == "prefill":
                inputs["lengths"].fill_(1)
            self._inputs[fam] = inputs
        return inputs

    def _register(self, key_: tuple, family: Dict[str, torch.Tensor],
                  fn: Callable[[], tuple]) -> DenseProgram:
        # the cache exists before any capture: nothing of it may come from
        # the graphs' pool
        self.cache  # noqa: B018
        prog = DenseProgram(
            key=key_, fn=torch.no_grad()(fn), inputs=family,
            capture=self._capture if self.device.type == "cuda" else None,
        )
        self._programs[key_] = prog
        return prog

    def _capture(self, prog: DenseProgram):
        """Capture ``prog`` as a CUDA graph into the engine's pool. First an
        eager warm-up call on a side stream (library handles, the rope
        tables and the kernels' lazy state are built outside the capture);
        the resident key and the family's buffers are put back after it,
        so the capture leaves the key chain where it was. The warm-up of a
        decode or verify runs at positions ``max_seq_len``, whose writes
        the cache drops; a prefill's lands in its slots' rows, which the
        prefill itself writes. Returns ``(graph, outputs)``; a failure
        raises. Under tp the graph holds the model's collectives, which
        only NCCL can be captured with: over gloo it raises."""
        if getattr(self.params, "tp", 1) > 1:
            require_capturable_collectives("the dense engine's CUDA graphs")
        dev = self.device
        saved = {name: x.clone() for name, x in prog.inputs.items()}
        saved_key = self._key.clone()
        if "positions" in prog.inputs:
            prog.inputs["positions"].fill_(self.max_seq_len)
        main = torch.cuda.current_stream(dev)
        if self._warm_stream is None:
            self._warm_stream = torch.cuda.Stream(dev)
        self._warm_stream.wait_stream(main)
        with torch.cuda.stream(self._warm_stream):
            prog.fn()
        main.wait_stream(self._warm_stream)
        for name, x in saved.items():
            prog.inputs[name].copy_(x)
        self._key.copy_(saved_key)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool):
            outputs = prog.fn()
        if self._graph_pool is None:
            self._graph_pool = graph.pool()
        return graph, outputs

    def _compile(self, prog: DenseProgram) -> bool:
        """Build ``prog`` ahead of its first call (on the card, capture
        it). Returns whether anything was built."""
        if prog.compiled:
            return False
        if prog.capture is not None and prog.graph is None:
            prog.graph, prog.outputs = prog.capture(prog)
        prog.compiled = True
        return True

    def _draw_key(self, cfg: SamplingConfig) -> Optional[torch.Tensor]:
        """The key of a sampled draw, a split of the resident key; None for
        greedy sampling, which draws nothing."""
        return None if cfg.greedy else sampling_mod.next_key(self._key)

    def prefill_compute(self, params, cache, ids, lengths, slots, key, cfg):
        """The context-encode computation: bucket-causal forward, the last
        valid token's hidden state, the LM head on it, the sample with
        ``key``. Run by :meth:`_prefill_program` and by
        ``runner.benchmark_prefill_on_device``, so the benchmark runs what
        serving runs. Returns (tokens (b,) int32, logits (b, V), cache)."""
        model = self.model
        params = self._live_params(params)
        positions = torch.zeros((ids.shape[0],), dtype=torch.int32, device=ids.device)
        hidden, cache = model.forward(
            params, cache, ids, positions, slots, context_encode=True, return_hidden=True,
        )
        # the last real row, at the lengths on the device
        rows = torch.arange(ids.shape[0], device=ids.device)
        last = hidden[rows, lengths.long() - 1]                       # (b, H)
        logits = params._logits(last)
        tokens = sample(logits, key, cfg)
        return tokens, logits, cache

    def _prefill_program(self, batch: int, bucket: int, cfg: SamplingConfig) -> DenseProgram:
        key_ = ("prefill", batch, bucket, cfg)
        prog = self._programs.get(key_)
        if prog is not None:
            return prog
        inp = self._family("prefill", batch)

        def prefill():
            tokens, logits, _ = self.prefill_compute(
                self.params, self.cache, inp["ids"][:, :bucket], inp["lengths"],
                inp["slots"], self._draw_key(cfg), cfg,
            )
            return tokens, logits

        return self._register(key_, inp, prefill)

    def _decode_body(self, inp, cfg, kv_limit):
        """One T=1 step over the decode family's residents: forward, sample
        (a split of the resident key), the new tokens and advanced
        positions written back in place. Returns the logits (b, V)."""
        logits, _ = self.model.forward(
            self._live_params(self.params), self.cache, inp["tokens"][:, None],
            inp["positions"], inp["slots"], kv_limit=kv_limit,
        )
        logits = logits[:, 0, :]
        inp["tokens"].copy_(sample(logits, self._draw_key(cfg), cfg))
        inp["positions"].add_(1)
        return logits

    def _decode_program(
        self, batch: int, cfg: SamplingConfig, kv_limit: Optional[int] = None
    ) -> DenseProgram:
        """Token-gen program: T=1 forward + sample. ``kv_limit`` is the
        token-gen cache bucket: attention reads only that many cache rows;
        one program per bucket in use. Returns ``(tokens, logits)``, the
        tokens being the family's resident buffer."""
        key_ = ("decode", batch, cfg, kv_limit)
        prog = self._programs.get(key_)
        if prog is not None:
            return prog
        inp = self._family("decode", batch)

        def decode():
            logits = self._decode_body(inp, cfg, kv_limit)
            return inp["tokens"], logits

        return self._register(key_, inp, decode)

    def _decode_multi_program(
        self, batch: int, cfg: SamplingConfig, steps: int,
        kv_limit: Optional[int] = None,
    ) -> DenseProgram:
        """Token-gen program emitting ``steps`` tokens in one call: the
        decode step unrolled ``steps`` times (the JAX package's
        ``lax.scan``), each step with its own split of the resident key, so
        any ``on_device_steps`` yields the per-token loop's sampled
        sequence. One host round trip per ``steps`` tokens; ``kv_limit``
        must cover position + steps for every row. Returns ``(outs (steps,
        b), tokens)``."""
        key_ = ("decode_multi", batch, cfg, steps, kv_limit)
        prog = self._programs.get(key_)
        if prog is not None:
            return prog
        inp = self._family("decode", batch)

        def decode_n():
            outs = []
            for _ in range(steps):
                self._decode_body(inp, cfg, kv_limit)
                outs.append(inp["tokens"].clone())
            return torch.stack(outs), inp["tokens"]

        return self._register(key_, inp, decode_n)

    def _verify_program(self, batch: int, block: int) -> DenseProgram:
        """Speculation program: a T=block forward returning the block's
        full logits (b, block, V)."""
        key_ = ("verify", batch, block)
        prog = self._programs.get(key_)
        if prog is not None:
            return prog
        inp = self._family("verify", batch, block)

        def verify():
            logits, _ = self.model.forward(
                self._live_params(self.params), self.cache, inp["tokens"],
                inp["positions"], inp["slots"],
            )
            return (logits,)

        return self._register(key_, inp, verify)

    @staticmethod
    def _load(prog: DenseProgram, **payload) -> DenseProgram:
        """Write ``payload`` into ``prog``'s static buffers (host values
        are uploaded, device tensors copied on the device); ``ids`` fills
        the first columns of the prefill buffer."""
        for name, value in payload.items():
            dst = prog.inputs[name]
            if not isinstance(value, torch.Tensor):
                value = torch.as_tensor(np.asarray(value, dtype=np.int32))
            if name == "ids":
                dst = dst[:, : value.shape[1]]
            dst.copy_(value.reshape(dst.shape), non_blocking=False)
        return prog

    def ensure_serving_compiled(
        self,
        prefill_batches: Sequence[int] = (),
        decode_batches: Sequence[int] = (),
        sampling: SamplingConfig = SamplingConfig(),
        buckets: Optional[Sequence[int]] = None,
        multi_steps: Sequence[int] = (),
        include_single_decode: bool = True,
    ) -> float:
        """Build exactly the (batch x bucket) programs a serving path can
        reach, skipping any already built (on the card: capture them).
        Callers name the prefill and decode batch sizes apart: continuous
        batching admits at B=1 and decodes at B=max_batch. Without
        ``buckets``, decode also gets the full-cache fallback past a short
        ladder (``_kv_bucket`` reaches it; prefill cannot). Returns the
        wall seconds spent (0.0 when everything was built)."""
        t0 = time.perf_counter()
        if buckets is not None:
            bucket_list = decode_bucket_list = list(buckets)
        else:
            bucket_list = list(self.buckets)
            decode_bucket_list = list(self.buckets)
            if decode_bucket_list[-1] < self.max_seq_len:
                decode_bucket_list.append(self.max_seq_len)
        compiled_any = False
        for b in prefill_batches:
            for bucket in bucket_list:
                compiled_any |= self._compile(self._prefill_program(b, bucket, sampling))
        for b in decode_batches:
            for bucket in decode_bucket_list:
                if include_single_decode:
                    compiled_any |= self._compile(self._decode_program(b, sampling, bucket))
                for steps in multi_steps:
                    compiled_any |= self._compile(
                        self._decode_multi_program(b, sampling, steps, bucket)
                    )
        return time.perf_counter() - t0 if compiled_any else 0.0

    def aot_compile(
        self,
        batch_sizes: Optional[Sequence[int]] = None,
        sampling: SamplingConfig = SamplingConfig(),
        speculative_blocks: Sequence[int] = (),
        on_device_steps: Sequence[int] = (),
    ) -> float:
        """Build every (bucket x batch) program ahead of traffic: prefill
        and decode per bucket, a multi-step decode per bucket for each of
        ``on_device_steps``, a verify per speculative block. Returns wall
        seconds."""
        t0 = time.perf_counter()
        for b in batch_sizes or (self.max_batch,):
            for bucket in self.buckets:
                self._compile(self._prefill_program(b, bucket, sampling))
                self._compile(self._decode_program(b, sampling, bucket))
                for steps in on_device_steps:
                    self._compile(self._decode_multi_program(b, sampling, steps, bucket))
            for block in speculative_blocks:
                self._compile(self._verify_program(b, block))
        return time.perf_counter() - t0

    def _prefill_dev(
        self, prompts: Sequence[Sequence[int]], slots: Sequence[int],
        sampling: SamplingConfig,
    ) -> torch.Tensor:
        """:meth:`prefill_batch` without the readback: the sampled tokens
        (b,) on the device, in the program's output."""
        b = len(prompts)
        if b != len(slots):
            raise ValueError("prompts and slots must have equal length")
        max_len = max((len(p) for p in prompts), default=1)
        if max_len > self.max_seq_len:
            raise ValueError(
                f"prompt length {max_len} exceeds max_seq_len {self.max_seq_len}"
            )
        bucket = pick_bucket(self.buckets, max_len)
        ids = np.zeros((b, bucket), np.int32)
        lengths = np.ones((b,), np.int32)
        for i, p in enumerate(prompts):
            ids[i, : len(p)] = p
            lengths[i] = max(len(p), 1)
        prog = self._prefill_program(b, bucket, sampling)
        tokens, _ = self._load(prog, ids=ids, lengths=lengths, slots=slots)()
        return tokens

    def prefill_batch(
        self,
        prompts: Sequence[Sequence[int]],
        slots: Sequence[int],
        sampling: SamplingConfig,
    ) -> np.ndarray:
        """Context-encode a batch of prompts into the given cache slots:
        route to the smallest fitting bucket, right-pad, run the prefill
        program, return the first sampled token per row (host array). A
        sampled prefill draws with a split of the resident key (the JAX
        callers split theirs and pass the half). Shared by generate(),
        continuous batching and speculative decoding."""
        return read_host_tokens(self._prefill_dev(prompts, slots, sampling))

    # -- generate ---------------------------------------------------------

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        gen: GenerationConfig = GenerationConfig(),
    ) -> GenerateResult:
        """Batch generate: route by shape to the right bucket program,
        right-pad, then run the token-gen loop with on-device sampling.
        The key chain starts at ``gen.seed``."""
        nreq = len(prompts)
        if nreq == 0 or nreq > self.max_batch:
            raise ValueError(f"need 1..{self.max_batch} prompts, got {nreq}")
        max_len = max(len(p) for p in prompts)
        if max_len + gen.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({max_len}) + max_new_tokens ({gen.max_new_tokens}) "
                f"exceeds max_seq_len ({self.max_seq_len})"
            )
        b = self.max_batch  # fixed program batch; pad requests
        padded = list(prompts) + [[0]] * (b - nreq)
        lengths = np.asarray([max(len(p), 1) for p in padded], np.int32)

        bench = GenerationBenchmark()
        self._key.copy_(sampling_mod.key(gen.seed, device=self.device))

        if gen.precompile:
            # walk the decode loop's exact (program, bucket) reachability
            # and build it all up front: no capture after the first token
            steps_ = max(1, gen.on_device_steps)
            single_buckets, multi_buckets = set(), set()
            p, rem = int(lengths.max()), gen.max_new_tokens - 1
            while rem > 0:
                if steps_ > 1 and steps_ <= rem:
                    multi_buckets.add(self._kv_bucket(p + steps_))
                    p, rem = p + steps_, rem - steps_
                else:
                    single_buckets.add(self._kv_bucket(p + 1))
                    p, rem = p + 1, rem - 1
            self.ensure_serving_compiled(
                prefill_batches=(b,), sampling=gen.sampling,
                buckets=[pick_bucket(self.buckets, int(lengths.max()))],
            )
            if single_buckets:
                self.ensure_serving_compiled(
                    decode_batches=(b,), sampling=gen.sampling,
                    buckets=sorted(single_buckets),
                )
            if multi_buckets:
                self.ensure_serving_compiled(
                    decode_batches=(b,), sampling=gen.sampling,
                    buckets=sorted(multi_buckets), multi_steps=(steps_,),
                    include_single_decode=False,
                )

        t_start = time.perf_counter()
        with bench.ttft.timed():
            tok_dev = self._prefill_dev(padded, np.arange(b), gen.sampling)
            tokens_host = read_host_tokens(tok_dev)
        # the decode family's residents: the first tokens (a copy on the
        # device), the next write positions (= prompt lengths), the slots
        dec = self._family("decode", b)
        dec["tokens"].copy_(tok_dev)
        dec["positions"].copy_(torch.as_tensor(lengths))
        dec["slots"].copy_(torch.arange(b, dtype=torch.int32))

        out: List[List[int]] = [[int(tokens_host[i])] for i in range(nreq)]
        done = [
            gen.eos_token_id is not None and out[i][-1] == gen.eos_token_id
            for i in range(nreq)
        ]
        remaining = gen.max_new_tokens - 1
        steps = max(1, gen.on_device_steps)
        pos_max = int(lengths.max())  # host mirror of the write frontier
        while remaining > 0 and not all(done):
            # the multi-step program for full chunks, single steps for the
            # tail; the kv bucket covers the chunk's final write position
            use_multi = steps > 1 and steps <= remaining
            kv_limit = self._kv_bucket(pos_max + (steps if use_multi else 1))
            if use_multi:
                prog = self._decode_multi_program(b, gen.sampling, steps, kv_limit)
                t0 = time.perf_counter()
                toks_block, _ = prog()
                block_host = read_host_tokens(toks_block)  # (steps, b)
                dt = time.perf_counter() - t0
                for _ in range(steps):
                    bench.per_token.record(dt / steps)
                emitted = steps
            else:
                prog = self._decode_program(b, gen.sampling, kv_limit)
                with bench.per_token.timed():
                    toks, _ = prog()
                    block_host = read_host_tokens(toks)[None, :]
                emitted = 1
            pos_max += emitted
            remaining -= emitted
            for t in range(emitted):
                for i in range(nreq):
                    if not done[i]:
                        out[i].append(int(block_host[t, i]))
                        if gen.eos_token_id is not None and out[i][-1] == gen.eos_token_id:
                            done[i] = True
        bench.e2e.record(time.perf_counter() - t_start)
        return GenerateResult(sequences=out, benchmark=bench)

    def prefill_logits(self, input_ids) -> torch.Tensor:
        """Full (B, S, V) prefill logits, the logit-accuracy gate's input
        (runner ``check_accuracy_logits``), over a cache of its own (the
        engine's is untouched)."""
        ids = torch.as_tensor(input_ids, device=self.device)
        b, s = ids.shape
        cache = self.model.init_cache(b, s, device=self.device)
        positions = torch.zeros((b,), dtype=torch.int32, device=self.device)
        logits, _ = self.model.forward(
            self._live_params(self.params), cache, ids, positions, context_encode=True,
        )
        return logits


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Request:
    rid: int
    prompt: List[int]
    out: List[int]
    slot: Optional[int] = None
    position: int = 0
    done: bool = False


class ContinuousBatchingEngine:
    """Slot-scheduled serving loop over the engine's dense cache: requests
    are admitted into free cache rows (slots) by a B=1 prefill program
    (written at the slot), and one batched T=1 decode program advances
    every slot per step; finished slots are freed and refilled without
    stalling the others.

    The loop keeps its own key chain (``gen.seed``): an admission splits it
    for its prefill and each step for its decode, in the JAX engine's
    order; around each sampled dispatch it is swapped into the engine's
    resident key, which the programs split."""

    def __init__(
        self,
        engine: InferenceEngine,
        gen: GenerationConfig = GenerationConfig(),
        precompile: bool = True,
    ) -> None:
        self.engine = engine
        self.gen = gen
        if precompile:
            # everything the loop can reach: a B=1 prefill per context
            # bucket (admission), a full-batch decode per kv bucket and the
            # full-cache fallback, so no request waits for a capture
            secs = engine.ensure_serving_compiled(
                prefill_batches=(1,),
                decode_batches=(engine.max_batch,),
                sampling=gen.sampling,
            )
            if secs:
                logger.info(
                    "continuous-batching warmup: built serving programs in %.1fs", secs,
                )
        if gen.on_device_steps > 1:
            # admission and slot-recycling decisions happen on the host per
            # token; a multi-token device loop would stall new requests for
            # its whole chunk, so the serving loop always runs per token
            logger.warning(
                "ContinuousBatchingEngine ignores on_device_steps=%d: the "
                "slot scheduler admits/finishes requests per decode step",
                gen.on_device_steps,
            )
        self._next_rid = 0
        self._queue: List[_Request] = []
        self._active: Dict[int, _Request] = {}  # slot -> request
        self._finished: Dict[int, _Request] = {}
        self._free_slots = list(range(engine.max_batch))
        self._key = sampling_mod.key(gen.seed, device=engine.device)
        # per-slot decode state mirrored on the host
        self._tokens = np.zeros((engine.max_batch,), np.int32)
        self._positions = np.zeros((engine.max_batch,), np.int32)

    def submit(self, prompt: Sequence[int]) -> int:
        if len(prompt) + self.gen.max_new_tokens > self.engine.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({self.gen.max_new_tokens}) exceeds cache capacity "
                f"({self.engine.max_seq_len})"
            )
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(rid=rid, prompt=list(prompt), out=[]))
        return rid

    def _keyed(self, dispatch: Callable[[], Any]) -> Any:
        """Run ``dispatch`` on this loop's key chain: swapped into the
        engine's resident key before, taken back after (device copies);
        greedy dispatches draw nothing and skip it."""
        if self.gen.sampling.greedy:
            return dispatch()
        self.engine._key.copy_(self._key)
        out = dispatch()
        self._key.copy_(self.engine._key)
        return out

    def _admit(self) -> None:
        eng = self.engine
        while self._queue and self._free_slots:
            req = self._queue.pop(0)
            slot = self._free_slots.pop(0)
            req.slot = slot
            first = int(self._keyed(
                lambda: eng.prefill_batch([req.prompt], [slot], self.gen.sampling)
            )[0])
            req.out.append(first)
            req.position = len(req.prompt)
            self._tokens[slot] = first
            self._positions[slot] = req.position
            self._active[slot] = req
            self._maybe_finish(req)

    def _maybe_finish(self, req: _Request) -> None:
        eos = self.gen.eos_token_id
        if (
            req.done  # e.g. the cache-capacity cap set in step()
            or (eos is not None and req.out and req.out[-1] == eos)
            or len(req.out) >= self.gen.max_new_tokens
        ):
            req.done = True
            if req.slot is not None:
                del self._active[req.slot]
                self._free_slots.append(req.slot)
                req.slot = None
            self._finished[req.rid] = req

    def step(self) -> bool:
        """Admit waiting requests, advance every active slot one token.
        Returns False when nothing is left to do."""
        self._admit()
        if not self._active:
            return bool(self._queue)
        eng = self.engine
        b = eng.max_batch
        # the kv bucket must cover the furthest active slot's write row
        # (idle slots hold stale positions: their reads are discarded and
        # their writes land at their own stale rows)
        kv_limit = eng._kv_bucket(int(max(self._positions[s] for s in self._active)) + 1)
        prog = eng._decode_program(b, self.gen.sampling, kv_limit)
        eng._load(prog, tokens=self._tokens, positions=self._positions, slots=np.arange(b))
        toks = read_host_tokens(self._keyed(prog)[0])
        for slot, req in list(self._active.items()):
            req.out.append(int(toks[slot]))
            req.position += 1
            self._tokens[slot] = toks[slot]
            self._positions[slot] = req.position
            if req.position >= eng.max_seq_len - 1:
                req.done = True
            self._maybe_finish(req)
        return bool(self._active or self._queue)

    def run_to_completion(self) -> Dict[int, List[int]]:
        while self.step():
            pass
        return {rid: r.out for rid, r in sorted(self._finished.items())}
