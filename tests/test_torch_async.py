"""The port's async double-buffered decode loop (``PagedConfig.async_loop``)
against the JAX package's, on the CPU at the tiny config (fp32) with the
same weights.

Both engines run the FIFO policy's async branch: in the steady state
step N+1 is dispatched from the device-resident state before step N is
read back, a finish is seen one step late and the finished lane's
lookahead token is discarded (the lame-duck drain), and a step that
would have to preempt drops to the synchronous sequence. The greedy
streams, the async counters (``decode_steps_async``, ``lame_duck_tokens``,
``sync_fallbacks``) and the recorded step actions (type, mode, readback
lag, lame-duck and in-flight flags) must be the JAX engine's, and the
streams the port's synchronous loop's (JAX: tests/test_async_serving.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.inference import (
    GenerationConfig as JaxGenerationConfig,
    InferenceEngine as JaxInferenceEngine,
)
from neuronx_distributed_llama3_2_tpu.models.llama import (
    LLAMA_CONFIGS as JAX_CONFIGS,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_llama3_2_tpu.serving import (
    PagedConfig as JaxPagedConfig,
    PagedServingEngine as JaxPagedServingEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
    GenerationConfig,
    InferenceEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import SamplingConfig
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LLAMA_CONFIGS,
    LlamaForCausalLM,
    params_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.engine import (
    PagedConfig,
    PagedServingEngine,
)

torch.set_num_threads(1)

JAX_TINY = JAX_CONFIGS["tiny"]
TINY = LLAMA_CONFIGS["tiny"]
PATHS = {"gather": False, "kernel": True}
ENGINE_KW = dict(max_batch=4, max_seq_len=64, buckets=[8, 16, 32])
ASYNC_COUNTERS = (
    "decode_steps_async", "lame_duck_tokens", "sync_fallbacks", "decode_steps",
    "prefill_chunks", "preemptions", "verify_steps", "table_deltas", "lane_syncs",
)


#: the decoder layers' kernels are scaled up from the init's std 0.02: at
#: the init scale the residual stream is the embedding's, and every greedy
#: stream repeats one token, which would hide a readback one step off
LAYER_SCALE = 10.0


def _scaled(path, x):
    name = jax.tree_util.keystr(path)
    return x * LAYER_SCALE if "layers" in name and "scale" not in name else x


@pytest.fixture(scope="module")
def weights():
    """(JAX pytree, port module) holding the same seeded weights."""
    jp = jax.tree_util.tree_map_with_path(
        _scaled, JaxLlama(JAX_TINY).init(jax.random.key(0))
    )
    model = LlamaForCausalLM(TINY, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), TINY, device="cpu"))
    return jp, model


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY.vocab_size, size=(n,)).tolist() for n in lengths]


def _port(model, gen, path="kernel", **paged_kw):
    cfg = dataclasses.replace(TINY, use_paged_kernel=PATHS[path])
    return PagedServingEngine(
        InferenceEngine(cfg, model, **ENGINE_KW), gen, PagedConfig(**paged_kw),
    )


def _jax(jp, max_new, path="kernel", **paged_kw):
    cfg = dataclasses.replace(JAX_TINY, use_paged_kernel=PATHS[path])
    return JaxPagedServingEngine(
        JaxInferenceEngine(cfg, jp, **ENGINE_KW),
        JaxGenerationConfig(max_new_tokens=max_new),
        JaxPagedConfig(**paged_kw), precompile=False,
    )


def _run(eng, prompts):
    for p in prompts:
        eng.submit(p)
    out = eng.run_to_completion()
    # a drained lookahead and a clean pool, whatever the path taken
    assert eng._pending is None
    assert eng.allocator.active_blocks == 0
    assert eng.allocator.leak_check() == []
    return out


def _trace(eng):
    """The recorded step actions: per step (pending at its start, and
    each action's type, mode, readback lag, lame-duck and in-flight
    flags)."""
    return [
        (pending, [
            (a.type.value, a.mode, a.meta.get("lag"), a.meta.get("lame_duck"),
             a.meta.get("in_flight"))
            for a in acts
        ])
        for _, pending, acts in eng.action_trace
    ]


def _hold_to_jax(weights, prompts, max_new, path="kernel", drafter=None, **paged_kw):
    """Serve ``prompts`` through the JAX engine and the port's, both with
    ``paged_kw``; the streams, counters and action traces must agree.
    Returns the port engine and its outputs."""
    jp, model = weights
    jax_eng = _jax(jp, max_new, path, **paged_kw)
    port = _port(model, GenerationConfig(max_new_tokens=max_new), path, **paged_kw)
    if drafter is not None:
        jax_eng.drafter = port.drafter = drafter
    j_out, p_out = _run(jax_eng, prompts), _run(port, prompts)
    assert p_out == j_out
    for name in ASYNC_COUNTERS:
        assert getattr(port.metrics, name) == getattr(jax_eng.metrics, name), name
    assert _trace(port) == _trace(jax_eng)
    assert port._dispatch_count == jax_eng._dispatch_count
    return port, p_out


#: (id, path, PagedConfig knobs) of the async matrix
MATRIX = {
    "gather-whole": ("gather", dict()),
    "gather-chunked": ("gather", dict(prefill_chunk_tokens=6)),
    "kernel-whole": ("kernel", dict()),
    "kernel-chunked": ("kernel", dict(prefill_chunk_tokens=6)),
    "kernel-int8-chunked": ("kernel", dict(kv_cache_dtype="int8", prefill_chunk_tokens=6)),
}


@pytest.mark.parametrize("case", sorted(MATRIX))
def test_async_matches_jax(weights, case):
    """Greedy streams, async counters and action traces equal the JAX
    async engine's over {gather, kernel} x {whole, chunked} and an int8
    chunked pool, and the streams equal the port's sync loop's (JAX:
    test_async_parity_matrix)."""
    path, knobs = MATRIX[case]
    prompts = _prompts(3, (5, 28, 20, 9, 17, 3))
    pool = dict(block_size=8, num_blocks=64, **knobs)
    port, out = _hold_to_jax(weights, prompts, 8, path, async_loop=True, **pool)
    m = port.metrics
    assert m.decode_steps_async > 0
    assert m.lame_duck_tokens > 0  # finishes were seen one step late
    sync = _port(weights[1], GenerationConfig(max_new_tokens=8), path, **pool)
    assert _run(sync, prompts) == out
    assert sync.metrics.decode_steps_async == sync.metrics.lame_duck_tokens == 0


def test_async_under_preemption_matches_jax(weights):
    """Pool exhaustion mid-decode: the async step drops to the sync
    sequence (sync_fallbacks counts it), as in the JAX engine, and the
    streams still equal the sync loop's (JAX:
    test_async_parity_under_preemption)."""
    prompts = _prompts(11, (12, 10, 14, 9))
    pool = dict(block_size=8, num_blocks=10, decode_reserve_blocks=1)
    port, out = _hold_to_jax(weights, prompts, 36, async_loop=True, **pool)
    assert port.metrics.preemptions > 0 and port.metrics.sync_fallbacks > 0
    assert port.metrics.decode_steps_async > 0
    sync = _port(weights[1], GenerationConfig(max_new_tokens=36), **pool)
    assert _run(sync, prompts) == out


def test_steady_async_step_is_resident(weights):
    """Once in the steady state (no admission, and no block growth: a
    short decode in 32-row blocks), an async step uploads nothing, syncs
    no lane and writes no table entry, and its readback lags its dispatch
    by one step (JAX: test_steady_state_step_is_fully_resident)."""
    port = _port(
        weights[1], GenerationConfig(max_new_tokens=24),
        block_size=32, num_blocks=8, async_loop=True,
    )
    port.submit(_prompts(0, (4,))[0])
    port.step()  # admission and prefill (uploads; the lane is dirty)
    port.step()  # the first async dispatch flushes the lane
    m = port.metrics
    for _ in range(12):
        before = (m.h2d_uploads, m.lane_syncs, m.table_deltas)
        assert port.step()
        assert (m.h2d_uploads, m.lane_syncs, m.table_deltas) == before
        assert port._last_readback_lag == 1 and port._pending is not None
    port.run_to_completion()
    assert port._pending is None and m.lame_duck_tokens == 1


class _Repeater:
    """An n-gram-free drafter that proposes the history's last token
    while the history is shorter than ``until``, then runs dry: drafting
    steps first, then the dry drafter's ``spec_retry_steps`` pauses."""

    def __init__(self, until: int) -> None:
        self.until = until

    def propose(self, history, k):
        return [history[-1]] * k if len(history) < self.until else []


@pytest.mark.parametrize("retry", [4, 1])
def test_dry_drafter_hands_steps_to_async_like_jax(weights, retry):
    """Speculation with a drafter that runs dry: each dry VERIFY takes a
    sync decode and hands the next ``spec_retry_steps`` steps to the
    async lookahead, which READBACK drains before the next VERIFY; the
    streams, counters and traces equal the JAX engine's."""
    prompts = _prompts(7, (6, 13, 9))
    port, out = _hold_to_jax(
        weights, prompts, 12, drafter=_Repeater(until=16), async_loop=True,
        spec_draft_tokens=3, spec_retry_steps=retry, block_size=8, num_blocks=64,
    )
    m = port.metrics
    assert m.verify_steps > 0 and m.decode_steps_async > 0
    sync = _port(
        weights[1], GenerationConfig(max_new_tokens=12), spec_draft_tokens=3,
        block_size=8, num_blocks=64,
    )
    sync.drafter = _Repeater(until=16)
    assert _run(sync, prompts) == out


def test_eager_async_host_sampling_is_the_sync_stream(weights):
    """Host sampling draws from the engine's generator in dispatch order:
    the async loop dispatches the same steps in the same order as the sync
    loop (the lame-duck step last), so its sampled streams are the sync
    loop's."""
    gen = GenerationConfig(
        max_new_tokens=10, seed=3,
        sampling=SamplingConfig(greedy=False, temperature=0.9, top_k=40),
    )
    prompts = _prompts(13, (7, 19, 4, 11, 25, 9))
    outs = []
    for async_loop in (False, True):
        eng = _port(weights[1], gen, block_size=8, num_blocks=64, async_loop=async_loop)
        outs.append(_run(eng, prompts))
    assert outs[0] == outs[1]
    assert eng.metrics.decode_steps_async > 0 and eng.metrics.lame_duck_tokens > 0


def test_async_prewarmed_records_match_jax(weights):
    """Prewarm and the async loop together: every prefill and decode goes
    through a registered record (on the CPU, run eagerly), none is
    registered after the freeze, and the serve is the JAX async engine's."""
    prompts = _prompts(3, (5, 28, 20, 9, 17, 3))
    port, _ = _hold_to_jax(
        weights, prompts, 8, async_loop=True, prewarm=True, block_size=8,
        num_blocks=64, prefill_chunk_tokens=6,
    )
    m = port.metrics
    assert m.steadystate_compiles == 0 and m.decode_steps_async > 0
    assert sum(r.replays for r in port.program_registry().values()) == m.compute_dispatches
