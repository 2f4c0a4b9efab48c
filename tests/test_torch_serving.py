"""The PyTorch port's paged serving engine against the JAX package's, on
the CPU at the tiny config (fp32) with the same weights.

Both engines run with ``use_paged_kernel=True``: the JAX side through its
Pallas kernel in interpret mode, the port through the plain version of
its CUDA kernel (the tensors lie on the CPU). The greedy token streams
must be identical — the two differ only in summation order (fp32, ~1e-6
on the logits), far below the gaps argmax decides on at this size — and so
must the prefix-cache and preemption bookkeeping, which is host logic
copied from the JAX package.
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
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LLAMA_CONFIGS,
    LlamaForCausalLM,
    params_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.faults import FaultInjector, FaultPlan
from neuronx_distributed_llama3_2_tpu_torch.serving.engine import (
    UNPORTED_KNOBS,
    PagedConfig,
    PagedServingEngine,
    make_serving_engine,
)

torch.set_num_threads(1)

JAX_TINY = dataclasses.replace(JAX_CONFIGS["tiny"], use_paged_kernel=True)
TINY = dataclasses.replace(LLAMA_CONFIGS["tiny"], use_paged_kernel=True)
ENGINE_KW = dict(max_batch=4, max_seq_len=64, buckets=[8, 16, 32])


@pytest.fixture(scope="module")
def weights():
    """(JAX pytree, port module) holding the same seeded weights."""
    jp = JaxLlama(JAX_TINY).init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jp)
    model = LlamaForCausalLM(TINY, device="cpu")
    model.load_state_dict(params_from_jax(np_params, TINY, device="cpu"))
    return jp, model


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY.vocab_size, size=(n,)).tolist() for n in lengths]


def _serve_both(weights, phases, max_new_tokens, engine_kw=None, **paged_kw):
    """Run the same submission phases through both engines. Each phase is
    a list of prompts submitted together and run to completion. Returns
    per engine (outputs, request infos, engine)."""
    jp, model = weights
    kw = dict(ENGINE_KW, **(engine_kw or {}))
    jax_eng = JaxPagedServingEngine(
        JaxInferenceEngine(JAX_TINY, jp, **kw),
        JaxGenerationConfig(max_new_tokens=max_new_tokens),
        JaxPagedConfig(**paged_kw), precompile=False,
    )
    port = PagedServingEngine(
        InferenceEngine(TINY, model, **kw),
        GenerationConfig(max_new_tokens=max_new_tokens),
        PagedConfig(**paged_kw),
    )
    results = []
    for eng in (jax_eng, port):
        outs = {}
        for prompts in phases:
            for p in prompts:
                eng.submit(p)
            outs.update(eng.run_to_completion())
        infos = [eng.request_info(r) for r in sorted(outs)]
        results.append((outs, infos, eng))
    return results


def _bookkeeping(infos):
    keys = ("generated_tokens", "cached_tokens", "preemptions", "status")
    return [{k: i[k] for k in keys} for i in infos]


def test_greedy_streams_match_jax_on_mixed_lengths(weights):
    prompts = _prompts(3, (5, 12, 20, 9, 17, 3))
    (j_out, j_info, _), (p_out, p_info, port) = _serve_both(
        weights, [prompts], 8, block_size=8, num_blocks=64,
    )
    assert p_out == j_out
    assert _bookkeeping(p_info) == _bookkeeping(j_info)
    assert port.allocator.active_blocks == 0
    assert port.allocator.leak_check() == []
    # every decode layer call went through the kernel's wrapper
    paths = port.model.attention_paths
    assert paths["kernel"] >= port.metrics.decode_steps * TINY.num_layers
    assert paths["gather"] == 0


def test_serving_records_no_autograd(weights, monkeypatch):
    """The parameters are trainable, yet no tensor a serve produces carries
    autograd history: every logits tensor the engine samples from, on
    prefill and decode, has no grad_fn."""
    import neuronx_distributed_llama3_2_tpu_torch.serving.engine as serving_engine

    _, model = weights
    assert all(p.requires_grad for p in model.parameters())
    seen = []
    inner = serving_engine.sample

    def recording(logits, *args, **kwargs):
        seen.append(logits.grad_fn is None and not logits.requires_grad)
        return inner(logits, *args, **kwargs)

    monkeypatch.setattr(serving_engine, "sample", recording)
    (j_out, _, _), (p_out, _, _) = _serve_both(
        weights, [_prompts(6, (4, 11, 7))], 4, block_size=8, num_blocks=32,
    )
    assert p_out == j_out
    assert len(seen) > 3 and all(seen)


def test_shared_prefix_cached_tokens_match_jax(weights):
    # 24 shared tokens = 3 full blocks admitted by reference; the 4-token
    # suffix prefills through the kernel with t = 8 (bucket 8)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, TINY.vocab_size, size=(24,)).tolist()
    prompts = [
        shared + rng.integers(0, TINY.vocab_size, size=(4,)).tolist()
        for _ in range(4)
    ]
    (j_out, j_info, jax_eng), (p_out, p_info, port) = _serve_both(
        weights, [prompts], 6, engine_kw=dict(max_batch=2),
        block_size=8, num_blocks=64,
    )
    assert p_out == j_out
    assert _bookkeeping(p_info) == _bookkeeping(j_info)
    assert [i["cached_tokens"] for i in p_info] == [0, 24, 24, 24]
    assert port.metrics.cached_tokens == jax_eng.metrics.cached_tokens


def test_copy_on_write_partial_block_matches_jax(weights):
    # the second prompt diverges at token 27, inside block 3 (block_size 8):
    # token-granular match, copy-on-write before the suffix write
    base = _prompts(11, (27,))[0]
    (j_out, j_info, jax_eng), (p_out, p_info, port) = _serve_both(
        weights, [[base + [1]], [base + [2, 3]]], 4,
        block_size=8, num_blocks=64,
    )
    assert p_out == j_out
    assert _bookkeeping(p_info) == _bookkeeping(j_info)
    assert p_info[1]["cached_tokens"] == 27
    assert port.allocator.cow_copies == jax_eng.allocator.cow_copies >= 1


@pytest.mark.parametrize("caching", [False, True])
def test_pool_exhaustion_preempts_like_jax(weights, caching):
    # 9 usable blocks, 4 requests that each grow to 6 blocks: decode must
    # exhaust the pool, preempt the youngest and requeue it
    prompts = _prompts(5, (12, 12, 12, 12))
    (j_out, j_info, jax_eng), (p_out, p_info, port) = _serve_both(
        weights, [prompts], 36, block_size=8, num_blocks=10,
        decode_reserve_blocks=1, enable_prefix_caching=caching,
    )
    assert p_out == j_out
    assert _bookkeeping(p_info) == _bookkeeping(j_info)
    assert port.metrics.preemptions == jax_eng.metrics.preemptions > 0
    assert port.metrics.finished == 4
    assert port.allocator.evictions == jax_eng.allocator.evictions


@pytest.mark.parametrize("knob", sorted(UNPORTED_KNOBS))
def test_unported_knobs_raise(weights, knob):
    default = getattr(PagedConfig(), knob)
    if isinstance(default, bool):
        value = not default
    elif isinstance(default, str):
        value = default + "-other"
    elif default is None:
        value = 1 if knob != "policy_table_path" else "table.json"
    else:
        value = default + 1
    eng = InferenceEngine(TINY, weights[1], **ENGINE_KW)
    with pytest.raises(NotImplementedError, match=knob):
        PagedServingEngine(eng, GenerationConfig(), PagedConfig(**{knob: value}))


#: the knobs ported with the tiered KV storage, the cost ledger, the SLO
#: monitor, the degradation ladder and the SLO-aware step policy, each with
#: a value other than its default (and what it needs)
PORTED_KNOBS = {
    "spill_enabled": dict(spill_enabled=True, host_tier_bytes=1 << 20),
    "host_tier_bytes": dict(host_tier_bytes=1 << 20),
    "restore_crossover": dict(spill_enabled=True, host_tier_bytes=1 << 20,
                              restore_crossover=0.5),
    "spill_queue_depth": dict(spill_enabled=True, host_tier_bytes=1 << 20,
                              spill_queue_depth=1),
    "cost_accounting": dict(cost_accounting=False, prewarm=True),
    "hbm_budget_bytes": dict(hbm_budget_bytes=1 << 28, prewarm=True),
    "slo_ttft_p99_ms": dict(slo_ttft_p99_ms=100.0),
    "slo_tpot_p99_ms": dict(slo_tpot_p99_ms=5.0),
    "slo_eval_steps": dict(slo_tpot_p99_ms=5.0, slo_eval_steps=2),
    "slo_burn_window": dict(slo_tpot_p99_ms=5.0, slo_burn_window=2),
    "slo_burn_threshold": dict(slo_tpot_p99_ms=5.0, slo_burn_threshold=2.0),
    "slo_degrade": dict(slo_degrade=True, slo_tpot_p99_ms=5.0, degrade_after_faults=1),
    "degrade_after_faults": dict(degrade_after_faults=2),
    "degrade_window_steps": dict(degrade_after_faults=1, degrade_window_steps=8),
    "degrade_recover_steps": dict(degrade_after_faults=1, degrade_recover_steps=8),
    "step_policy": dict(step_policy="slo"),
}


@pytest.mark.parametrize("knob", sorted(PORTED_KNOBS))
def test_ported_knobs_build_an_engine(weights, knob):
    """Each knob that left UNPORTED_KNOBS builds an engine on the CPU and
    serves a request."""
    assert knob not in UNPORTED_KNOBS
    eng = PagedServingEngine(
        InferenceEngine(TINY, weights[1], **ENGINE_KW), GenerationConfig(max_new_tokens=3),
        PagedConfig(block_size=8, num_blocks=16, kv_buckets=(8, 16), prefill_buckets=(8, 16),
                    **PORTED_KNOBS[knob]),
    )
    assert getattr(eng.paged, knob) == PORTED_KNOBS[knob][knob]
    rid = eng.submit(_prompts(4, (9,))[0])
    assert len(eng.run_to_completion()[rid]) == 3


def test_unported_knobs_are_the_ladder_and_policies():
    # the ladder and the SLO-aware policy are ported; the certified policy
    # tables come with the analyzers
    assert sorted(UNPORTED_KNOBS) == ["policy_table_path"]


def test_engine_options_that_raise(weights):
    eng = InferenceEngine(TINY, weights[1], **ENGINE_KW)
    # a drafter is accepted and used with speculation on
    drafter = object()
    spec = PagedServingEngine(eng, paged=PagedConfig(spec_draft_tokens=2), drafter=drafter)
    assert spec.drafter is drafter and spec._spec_k == 2
    # an injector is accepted and hooked into the allocator (fault
    # tolerance is ported; tests/test_torch_faults.py holds it to JAX)
    inj = FaultInjector(FaultPlan(alloc_rate=0.5))
    faulty = PagedServingEngine(eng, injector=inj)
    assert faulty.injector is inj and faulty.allocator.fault_hook == inj.alloc_fault
    with pytest.raises(NotImplementedError, match="dense"):
        make_serving_engine(eng, paged=None)
    assert isinstance(
        make_serving_engine(eng, paged=PagedConfig(block_size=8, num_blocks=16)),
        PagedServingEngine,
    )


def test_cancel_and_request_lifecycle(weights):
    eng = PagedServingEngine(
        InferenceEngine(TINY, weights[1], **dict(ENGINE_KW, max_batch=1)),
        GenerationConfig(max_new_tokens=4),
        PagedConfig(block_size=8, num_blocks=64),
    )
    r0, r1, r2 = (eng.submit(p) for p in _prompts(0, (10, 10, 10)))
    eng.step()  # r0 holds the only lane, r1 and r2 wait
    assert eng.request_info(r0)["status"] == "active"
    assert eng.request_info(r1)["status"] == "queued"
    assert eng.cancel(r1) is True and eng.cancel(r1) is False
    out = eng.run_to_completion()
    assert len(out[r0]) == len(out[r2]) == 4 and out[r1] == []
    assert eng.request_info(r1)["status"] == "failed"
    assert eng.request_tokens(r2) == out[r2]
    assert eng.allocator.active_blocks == 0
    with pytest.raises(KeyError, match="unknown request id"):
        eng.request_info(99)


def test_submit_validation(weights):
    eng = PagedServingEngine(
        InferenceEngine(TINY, weights[1], **ENGINE_KW),
        GenerationConfig(max_new_tokens=8),
        PagedConfig(block_size=8, num_blocks=6),
    )
    with pytest.raises(ValueError, match="cache capacity"):
        eng.submit(list(range(60)))  # 60 + 8 > max_seq_len 64
    with pytest.raises(ValueError, match="blocks"):
        eng.submit(list(range(30)))  # needs 5 + reserve > 5 usable
    with pytest.raises(ValueError, match="decode_reserve_blocks"):
        PagedServingEngine(eng.engine, paged=PagedConfig(decode_reserve_blocks=0))


# -- the quantized pool and chunked prefill ------------------------------------


def _pair_prompts():
    """Eight prompts: a pair sharing a 19-token prefix (2 full blocks of 8
    and 3 rows of a third, so a later hit copies that block on write),
    the first of the pair first and the second sixth, after the first has
    finished; one of 40 tokens, which chunks."""
    rng = np.random.default_rng(21)
    shared = rng.integers(0, TINY.vocab_size, size=(19,)).tolist()
    others = _prompts(22, (12, 40, 9, 17, 3, 26))
    return [shared + [1, 2, 3]] + others[:4] + [shared + [4, 5]] + others[4:]


QUANT_SERVE_CASES = [
    (kv, mxu, chunk)
    for kv in ("int8", "fp8_e4m3") for mxu in (False, True) for chunk in (None, 8)
]


@pytest.mark.parametrize(
    "kv_dtype,mxu,chunk", QUANT_SERVE_CASES,
    ids=[f"{k}-{'mxu' if m else 'deq'}-{'chunk' if c else 'whole'}"
         for k, m, c in QUANT_SERVE_CASES],
)
def test_quantized_serve_matches_jax(weights, kv_dtype, mxu, chunk):
    """The JAX engine's greedy streams and counters from a quantized pool,
    with and without quant_mxu and chunked prefill."""
    (j_out, j_info, jax_eng), (p_out, p_info, port) = _serve_both(
        weights, [_pair_prompts()], 6, engine_kw=dict(max_batch=3),
        block_size=8, num_blocks=64, kv_cache_dtype=kv_dtype, quant_mxu=mxu,
        prefill_chunk_tokens=chunk,
    )
    assert p_out == j_out
    assert _bookkeeping(p_info) == _bookkeeping(j_info)
    pm, jm = port.metrics, jax_eng.metrics
    assert pm.cached_tokens == jm.cached_tokens and p_info[5]["cached_tokens"] > 0
    assert port.allocator.cow_copies == jax_eng.allocator.cow_copies >= 1
    assert pm.prefill_chunks == jm.prefill_chunks
    assert (pm.prefill_chunks > 0) == bool(chunk)
    assert pm.pool_bytes_total == jm.pool_bytes_total
    c = port.cache
    assert pm.pool_bytes_total == sum(
        x.numel() * x.element_size() for x in (c.k, c.v, c.k_scale, c.v_scale)
    )
    assert pm.kv_dtype == kv_dtype and port.model.config.quant_mxu == mxu
    assert port.allocator.leak_check() == []
    # every layer call of a decode step went through the kernel's wrapper
    paths = port.model.attention_paths
    assert paths["kernel"] >= pm.decode_steps * TINY.num_layers


def test_chunked_prefill_preempted_mid_prefill_matches_jax(weights, monkeypatch):
    """Pool pressure preempts the youngest request while it is still
    chunking; it re-prefills from scratch after re-admission, as in the
    JAX engine."""
    caught = []
    inner = PagedServingEngine._preempt

    def recording(self, req):
        caught.append(req.prefilling)
        inner(self, req)

    monkeypatch.setattr(PagedServingEngine, "_preempt", recording)
    (j_out, j_info, jax_eng), (p_out, p_info, port) = _serve_both(
        weights, [_prompts(5, (5, 5, 40))], 8, block_size=8, num_blocks=9,
        decode_reserve_blocks=1, prefill_chunk_tokens=4,
    )
    assert True in caught
    assert p_out == j_out
    assert _bookkeeping(p_info) == _bookkeeping(j_info)
    assert port.metrics.preemptions == jax_eng.metrics.preemptions > 0
    assert port.metrics.prefill_chunks == jax_eng.metrics.prefill_chunks
    assert port.allocator.leak_check() == []


def test_short_request_decodes_while_a_long_one_chunks(weights):
    """A prefilling lane rides the batched decode with an all-null table
    but is no decode lane: the short request's tokens grow step by step
    while the long one has none, and both streams equal the JAX engine's."""
    long_p, short_p = _prompts(31, (44, 5))
    port = PagedServingEngine(
        InferenceEngine(TINY, weights[1], **ENGINE_KW),
        GenerationConfig(max_new_tokens=6),
        PagedConfig(block_size=8, num_blocks=32, prefill_chunk_tokens=8),
    )
    r_long, r_short = port.submit(long_p), port.submit(short_p)
    lane_long = None
    for step in range(4):
        port.step()
        info = port.request_info(r_long)
        assert info["status"] == "prefilling" and info["generated_tokens"] == 0
        assert port.request_info(r_short)["generated_tokens"] == step + 2
        lane_long = next(l for l, r in port._active.items() if r.rid == r_long)
        decoded = [a.meta["lanes"] for a in port._step_actions
                   if a.type.value == "DECODE_DISPATCH"]
        assert decoded and lane_long not in decoded[0]
        assert port._tables[lane_long].tolist() == [0] * port.table_width
    out = port.run_to_completion()
    assert port.metrics.prefill_chunks == 6  # 44 tokens in chunks of 8
    jax_eng = JaxPagedServingEngine(
        JaxInferenceEngine(JAX_TINY, weights[0], **ENGINE_KW),
        JaxGenerationConfig(max_new_tokens=6),
        JaxPagedConfig(block_size=8, num_blocks=32, prefill_chunk_tokens=8),
        precompile=False,
    )
    for p in (long_p, short_p):
        jax_eng.submit(p)
    assert jax_eng.run_to_completion() == out


def test_copy_on_write_copies_scale_rows(weights):
    """A quantized block's scales are part of its value: the copy takes
    them with the payload (the JAX engine's _copy_block_fn)."""
    eng = PagedServingEngine(
        InferenceEngine(TINY, weights[1], **ENGINE_KW), GenerationConfig(),
        PagedConfig(block_size=8, num_blocks=8, kv_cache_dtype="int8"),
    )
    c = eng.cache
    c.k[:, 2] = 7
    c.v[:, 2] = -7
    c.k_scale[:, 2] = 3.0
    c.v_scale[:, 2] = 5.0
    eng._copy_block(2, 5)
    assert bool((c.k[:, 5] == 7).all()) and bool((c.v[:, 5] == -7).all())
    assert bool((c.k_scale[:, 5] == 3.0).all()) and bool((c.v_scale[:, 5] == 5.0).all())
    assert bool((c.k[:, 4] == 0).all())


def test_quantized_and_chunked_knobs_are_validated(weights):
    eng = InferenceEngine(TINY, weights[1], **ENGINE_KW)
    for kw, match in (
        (dict(kv_cache_dtype="int8", cache_dtype=torch.float16), "mutually exclusive"),
        (dict(quant_mxu=True), "quant_mxu requires a quantized kv_cache_dtype"),
        (dict(kv_cache_dtype="int4"), "kv_cache_dtype must be one of"),
        (dict(prefill_chunk_tokens=-8), "prefill_chunk_tokens must be positive"),
    ):
        with pytest.raises(ValueError, match=match):
            PagedServingEngine(eng, GenerationConfig(), PagedConfig(**kw))
    # a PREFILL_CHUNK budget caps the wave: one 8-token chunk spends a
    # budget of 8, and the other prefilling lane waits; no budget advances
    # every prefilling lane one chunk
    paged = PagedServingEngine(
        eng, GenerationConfig(max_new_tokens=8), PagedConfig(prefill_chunk_tokens=8),
    )
    for p in _prompts(8, (20, 20)):
        paged.submit(p)
    paged._admit()
    assert sum(r.prefilling for r in paged._active.values()) == 2
    paged._advance_prefills(budget_tokens=8)
    assert paged.metrics.prefill_chunks == 1
    paged._advance_prefills()
    assert paged.metrics.prefill_chunks == 3
    # quant_mxu rides a twin of the decode model; the caller's is untouched
    mxu = PagedServingEngine(
        eng, GenerationConfig(), PagedConfig(kv_cache_dtype="fp8_e4m3", quant_mxu=True),
    )
    assert mxu.model.config.quant_mxu and not eng.model.config.quant_mxu
