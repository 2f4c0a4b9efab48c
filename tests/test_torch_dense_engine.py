"""The port's dense inference engine against the JAX package's, on the CPU.

Mirrors ``tests/test_inference.py`` case for case (but the HF and tensor
parallel cases, which wait for the HF converter and the mesh): the bucket
ladder, the prefill logits, incremental decode, ragged batches, continuous
batching, the program table, ``cache_dtype``, capacity, EOS,
``on_device_steps`` (greedy and sampled), the kv buckets, short ladders,
no program built under churn, and the runner's gate and benchmarks. Each
case runs the JAX engine and the port's on the same weights (the tiny
config in fp32, the decoder layers scaled up so that the streams do not
repeat one token): greedy streams must be identical, sampled streams
identical token for token under the same seed (the port reproduces JAX's
key chain), logits within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.inference import (
    ContinuousBatchingEngine as JaxCB,
    GenerationConfig as JaxGen,
    InferenceEngine as JaxEngine,
    LlamaDecode as JaxDecode,
    SamplingConfig as JaxSampling,
)
from neuronx_distributed_llama3_2_tpu.inference.engine import (
    default_buckets as jax_default_buckets,
    pick_bucket as jax_pick_bucket,
)
from neuronx_distributed_llama3_2_tpu.inference.runner import (
    benchmark_serving_churn as jax_churn,
)
from neuronx_distributed_llama3_2_tpu.models.llama import (
    LLAMA_CONFIGS as JAX_CONFIGS,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_llama3_2_tpu_torch.inference import (
    ContinuousBatchingEngine,
    GenerationConfig,
    InferenceEngine,
    KVCache,
    LlamaDecode,
    SamplingConfig,
    default_buckets,
    pick_bucket,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.runner import (
    benchmark_generation,
    benchmark_prefill_on_device,
    benchmark_serving_churn,
    check_accuracy_logits,
)
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LLAMA_CONFIGS,
    LlamaForCausalLM,
    params_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.engine import (
    PagedConfig,
    PagedServingEngine,
    make_serving_engine,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.faults import FaultInjector, FaultPlan
from tests.test_torch_async import _scaled

torch.set_num_threads(1)

JAX_TINY = JAX_CONFIGS["tiny"]
TINY = LLAMA_CONFIGS["tiny"]
GREEDY = dict(greedy=True)
SAMPLED = dict(greedy=False, temperature=1.0, top_k=8)
NUCLEUS = dict(greedy=False, temperature=0.8, top_p=0.9)

_JAX_ENGINES = {}


@pytest.fixture(scope="module")
def weights():
    """(JAX pytree, port module) holding the same seeded weights, the
    decoder layers scaled up (``tests/test_torch_async.py``)."""
    jp = jax.tree_util.tree_map_with_path(
        _scaled, JaxLlama(JAX_TINY).init(jax.random.key(0))
    )
    model = LlamaForCausalLM(TINY, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), TINY, device="cpu"))
    return jp, model


def _jax_engine(jp, **kw):
    """One JAX engine per engine shape, kept across cases: its compiled
    programs are reused, and every generate() re-prefills its slots."""
    key_ = tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in kw.items()))
    if key_ not in _JAX_ENGINES:
        _JAX_ENGINES[key_] = JaxEngine(JAX_TINY, jp, **kw)
    return _JAX_ENGINES[key_]


def _pair(weights, **kw):
    """(JAX engine, a fresh port engine) of the same shape."""
    jp, model = weights
    return _jax_engine(jp, **kw), InferenceEngine(TINY, model, **kw)


def _gens(max_new, sampling=GREEDY, **kw):
    return (JaxGen(max_new_tokens=max_new, sampling=JaxSampling(**sampling), **kw),
            GenerationConfig(max_new_tokens=max_new, sampling=SamplingConfig(**sampling), **kw))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY.vocab_size, size=(n,)).tolist() for n in lengths]


def _both_generate(weights, prompts, max_new, sampling=GREEDY, engine_kw=None, **gen_kw):
    """The JAX and the port engine's generate() streams, asserted equal."""
    je, te = _pair(weights, **(engine_kw or dict(max_batch=len(prompts), max_seq_len=64)))
    jg, tg = _gens(max_new, sampling, **gen_kw)
    want = [list(map(int, s)) for s in je.generate(prompts, jg).sequences]
    got = te.generate(prompts, tg).sequences
    assert got == want
    return got, te


def _program_shape(key_):
    """A program key without its sampling config (the two packages' config
    classes differ), for comparing program tables."""
    return tuple(
        (dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x) for x in key_
    )


# -- bucketing, prefill, incremental decode -----------------------------------------


def test_bucketing():
    for n in (64, 2048, 4096):
        assert default_buckets(n) == jax_default_buckets(n)
    buckets = default_buckets(2048)
    assert buckets == [128, 256, 512, 1024, 2048]
    for n in (1, 128, 129, 2048):
        assert pick_bucket(buckets, n) == jax_pick_bucket(buckets, n)
    with pytest.raises(ValueError):
        pick_bucket(buckets, 4096)


def test_prefill_logits_match_forward(weights):
    """The context-encode path equals the training model's forward and the
    JAX engine's prefill logits."""
    jp, model = weights
    ids = np.random.default_rng(3).integers(0, TINY.vocab_size, (2, 16))
    je, te = _pair(weights, max_batch=2, max_seq_len=64)
    got = te.prefill_logits(ids).numpy()
    np.testing.assert_allclose(got, model(torch.as_tensor(ids)).numpy(), atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(je.prefill_logits(jnp.asarray(ids))), atol=1e-4)


def test_incremental_decode_matches_recompute(weights):
    """KV-cache token-gen equals the full-sequence recompute at every step,
    and the JAX engine's stream."""
    _, model = weights
    prompt = _prompts(7, (12,))[0]
    toks, _ = _both_generate(weights, [prompt], 8,
                             engine_kw=dict(max_batch=1, max_seq_len=64, buckets=[16, 32, 64]))
    seq = list(prompt)
    for t in toks[0]:
        expect = int(torch.argmax(model(torch.as_tensor([seq]))[0, -1]))
        assert t == expect, f"divergence at len {len(seq)}: {t} != {expect}"
        seq.append(t)


def test_batched_generate_ragged(weights):
    """Ragged batch: each row equals its single-request generation and the
    JAX engine's batched row."""
    _, model = weights
    prompts = _prompts(11, (5, 11, 17))
    batched, _ = _both_generate(weights, prompts, 6)
    _, gen = _gens(6)
    for p, want in zip(prompts, batched):
        single = InferenceEngine(TINY, model, max_batch=1, max_seq_len=64)
        assert single.generate([p], gen).sequences[0] == want


# -- continuous batching ----------------------------------------------------------


@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_continuous_batching_matches_batch(weights, sampling):
    """Slot-scheduled serving returns the JAX loop's streams (3 requests over
    2 slots: a slot is reused); greedy, also each prompt's own generate()
    stream. Sampled, the loop's key chain is JAX's: one split per
    admission and per step."""
    jp, model = weights
    prompts = _prompts(5, (6, 9, 13))
    jg, tg = _gens(5, sampling, seed=3)
    je, te = _pair(weights, max_batch=2, max_seq_len=64)
    jcb = JaxCB(je, jg)
    cb = ContinuousBatchingEngine(te, tg)
    for p in prompts:
        jcb.submit(p)
        cb.submit(p)
    want = {k: list(map(int, v)) for k, v in jcb.run_to_completion().items()}
    out = cb.run_to_completion()
    assert out == want
    if sampling is GREEDY:
        for i, p in enumerate(prompts):
            eng = InferenceEngine(TINY, model, max_batch=2, max_seq_len=64)
            assert eng.generate([p], tg).sequences[0] == out[i]


def test_make_serving_engine_dense(weights):
    """paged=None builds the dense continuous-batching loop (its programs
    built ahead of traffic unless precompile=False); an injector raises
    ValueError, as in the JAX package."""
    _, model = weights
    eng = InferenceEngine(TINY, model, max_batch=2, max_seq_len=64, buckets=[16, 32, 64])
    gen = GenerationConfig(max_new_tokens=4)
    lazy = make_serving_engine(eng, gen, paged=None, precompile=False)
    assert isinstance(lazy, ContinuousBatchingEngine) and not eng._programs
    cb = make_serving_engine(eng, gen)
    assert isinstance(cb, ContinuousBatchingEngine) and eng._programs
    rid = cb.submit([1, 2, 3])
    assert len(cb.run_to_completion()[rid]) == 4
    with pytest.raises(ValueError, match="paged engine"):
        make_serving_engine(eng, gen, injector=FaultInjector(FaultPlan()))
    assert isinstance(make_serving_engine(eng, gen, paged=PagedConfig(block_size=8,
                                                                      num_blocks=16)),
                      PagedServingEngine)


# -- the program table -------------------------------------------------------------


def test_aot_compile_real_and_equivalent(weights):
    """aot_compile builds JAX's program table (prefill and decode per bucket,
    a verify per speculative block), every program built, and the built
    programs give the lazily built engine's tokens."""
    jp, model = weights
    prompt = _prompts(7, (12,))[0]
    kw = dict(max_batch=1, max_seq_len=64, buckets=[16, 64])
    jg, gen = _gens(5)
    lazy = InferenceEngine(TINY, model, **kw).generate([prompt], gen).sequences[0]
    engine = InferenceEngine(TINY, model, **kw)
    je = JaxEngine(JAX_TINY, jp, **kw)
    secs = engine.aot_compile(sampling=gen.sampling, speculative_blocks=(4,))
    je.aot_compile(sampling=jg.sampling, speculative_blocks=(4,))
    assert secs >= 0.0
    assert {k[0] for k in engine._programs} == {"prefill", "decode", "verify"}
    assert sorted(map(_program_shape, engine._programs), key=str) == sorted(
        map(_program_shape, je._programs), key=str)
    assert all(p.compiled for p in engine._programs.values())
    got = engine.generate([prompt], gen).sequences[0]
    assert got == lazy == list(map(int, je.generate([prompt], jg).sequences[0]))


def test_cache_dtype_preserved(weights):
    """cache_dtype survives decode steps (writes cast to the cache dtype),
    and the fp16 cache gives the JAX engine's stream."""
    prompt = _prompts(7, (12,))[0]
    jp, model = weights
    engine = InferenceEngine(TINY, model, max_batch=1, max_seq_len=64,
                             cache_dtype=torch.float16)
    je = JaxEngine(JAX_TINY, jp, max_batch=1, max_seq_len=64, cache_dtype=jnp.float16)
    jg, gen = _gens(3)
    got = engine.generate([prompt], gen).sequences
    assert got == [list(map(int, s)) for s in je.generate([prompt], jg).sequences]
    assert engine.cache.k.dtype == torch.float16 and engine.cache.v.dtype == torch.float16


def test_capacity_validation(weights):
    from neuronx_distributed_llama3_2_tpu_torch.inference import SpeculativeDecoder

    _, model = weights
    long_prompt = list(range(50))
    engine = InferenceEngine(TINY, model, max_batch=1, max_seq_len=64)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        engine.generate([long_prompt], GenerationConfig(max_new_tokens=32))
    cb = ContinuousBatchingEngine(
        InferenceEngine(TINY, model, max_batch=1, max_seq_len=64),
        GenerationConfig(max_new_tokens=32),
    )
    with pytest.raises(ValueError, match="cache capacity"):
        cb.submit(long_prompt)
    spec = SpeculativeDecoder(
        InferenceEngine(TINY, model, max_batch=1, max_seq_len=64),
        InferenceEngine(TINY, model, max_batch=1, max_seq_len=64),
        gamma=4,
    )
    with pytest.raises(ValueError, match="cache capacity"):
        spec.generate(long_prompt, max_new_tokens=32)


def test_eos_stops_generation(weights):
    prompt = _prompts(7, (12,))[0]
    full, _ = _both_generate(weights, [prompt], 8, engine_kw=dict(max_batch=1, max_seq_len=64))
    full = full[0]
    # eos = the first generated token: stops right after it
    stopped, _ = _both_generate(weights, [prompt], 8, engine_kw=dict(max_batch=1, max_seq_len=64),
                                eos_token_id=full[0])
    assert stopped[0] == full[:1]
    # eos = a token never generated: full-length output
    unused = next(t for t in range(TINY.vocab_size) if t not in full)
    unstopped, _ = _both_generate(weights, [prompt], 8,
                                  engine_kw=dict(max_batch=1, max_seq_len=64),
                                  eos_token_id=unused)
    assert unstopped[0] == full


def test_on_device_steps_matches_per_token_loop(weights):
    """Chunked decode (one program per 4 tokens) emits the per-token loop's
    greedy streams and the JAX engine's, EOS inside a chunk included."""
    prompts = _prompts(0, (9, 5))
    kw = dict(max_batch=2, max_seq_len=128)
    ref, _ = _both_generate(weights, prompts, 21, engine_kw=kw)
    got, _ = _both_generate(weights, prompts, 21, engine_kw=kw, on_device_steps=4)
    assert got == ref
    eos = ref[0][2]
    ref_e, _ = _both_generate(weights, prompts, 21, engine_kw=kw, eos_token_id=eos)
    got_e, _ = _both_generate(weights, prompts, 21, engine_kw=kw, eos_token_id=eos,
                              on_device_steps=4)
    assert got_e == ref_e and got_e != got


@pytest.mark.parametrize("sampling", [SAMPLED, NUCLEUS], ids=["top-k", "top-p"])
def test_on_device_steps_sampling_rng_parity(weights, sampling):
    """Sampled decoding: the chunked path consumes the per-token loop's key
    chain (one split per token), so a seed gives one stream at any
    on_device_steps, and that stream is the JAX engine's token for token;
    aot_compile builds the chunk program under JAX's key."""
    _, model = weights
    kw = dict(max_batch=1, max_seq_len=64)
    eng = InferenceEngine(TINY, model, **kw)
    cfg = SamplingConfig(**sampling)
    eng.aot_compile(sampling=cfg, on_device_steps=(4,))
    assert ("decode_multi", 1, cfg, 4, 64) in eng._programs
    prompts = _prompts(2, (6,))
    ref, _ = _both_generate(weights, prompts, 13, sampling, engine_kw=kw, seed=5)
    got, _ = _both_generate(weights, prompts, 13, sampling, engine_kw=kw, seed=5,
                            on_device_steps=4)
    assert got == ref
    assert eng.generate(prompts, GenerationConfig(
        max_new_tokens=13, sampling=cfg, seed=5, on_device_steps=4)).sequences == ref
    other, _ = _both_generate(weights, prompts, 13, sampling, engine_kw=kw, seed=6)
    assert other != ref


def test_decode_kv_bucket_parity(weights):
    """kv_limit reads only the bucket's rows but gives the full read's step
    logits, and the JAX model's."""
    jp, model = weights
    prompt = _prompts(7, (12,))[0]
    dec, jdec = LlamaDecode(TINY), JaxDecode(JAX_TINY)
    cache = dec.init_cache(1, 128, device="cpu")
    assert isinstance(cache, KVCache) and (cache.max_batch, cache.max_len) == (1, 128)
    jcache = jdec.init_cache(1, 128)
    ids = torch.as_tensor([prompt])
    dec.forward(model, cache, ids, torch.zeros((1,), dtype=torch.int32), context_encode=True)
    _, jcache = jdec.forward(jp, jcache, jnp.asarray([prompt], jnp.int32),
                             jnp.zeros((1,), jnp.int32), context_encode=True)
    tok = torch.as_tensor([[prompt[-1]]])
    pos = torch.as_tensor([len(prompt)], dtype=torch.int32)
    full, _ = dec.forward(model, cache, tok, pos)
    jfull, _ = jdec.forward(jp, jcache, jnp.asarray([[prompt[-1]]], jnp.int32),
                            jnp.asarray([len(prompt)], jnp.int32))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=1e-4)
    for limit in (16, 32, 128):
        bucketed, _ = dec.forward(model, cache, tok, pos, kv_limit=limit)
        np.testing.assert_allclose(bucketed.numpy(), full.numpy(), atol=1e-5, rtol=1e-5)


def test_generate_with_buckets_matches_single_bucket(weights):
    """The bucket ladder gives the single-bucket engine's greedy tokens."""
    prompts = _prompts(9, (10,))
    ladder, _ = _both_generate(weights, prompts, 8, engine_kw=dict(max_batch=1, max_seq_len=128))
    single, _ = _both_generate(weights, prompts, 8,
                               engine_kw=dict(max_batch=1, max_seq_len=128, buckets=[128]))
    assert ladder == single


def test_short_bucket_ladder_decodes_past_top_bucket(weights):
    """A ladder topping out below max_seq_len decodes on past its top
    bucket through the full-cache fallback."""
    prompts = _prompts(13, (10,))
    short, eng = _both_generate(weights, prompts, 16,
                                engine_kw=dict(max_batch=1, max_seq_len=64, buckets=[16]))
    full, _ = _both_generate(weights, prompts, 16, engine_kw=dict(max_batch=1, max_seq_len=64))
    assert short == full
    assert any(k[0] == "decode" and k[-1] == 64 for k in eng._programs)


# -- no program built under traffic -------------------------------------------------


def _churn(cb, prompts, every):
    cb.submit(prompts[0])
    cb.submit(prompts[1])
    steps, alive, nxt = 0, True, 2
    while alive or nxt < len(prompts):
        if steps % every == 0 and nxt < len(prompts):
            cb.submit(prompts[nxt])
            nxt += 1
        alive = cb.step()
        steps += 1
    return {k: r.out for k, r in sorted(cb._finished.items())}


def test_no_compile_under_churn(weights):
    """After the loop's construction (its programs built: JAX's set of
    keys), a churn run whose staggered admissions cross the 16 and 32 kv
    buckets adds no program, and its streams are the JAX loop's."""
    kw = dict(max_batch=2, max_seq_len=64, buckets=[16, 32, 64])
    je, te = _pair(weights, **kw)
    jg, tg = _gens(24)
    jcb, cb = JaxCB(je, jg), ContinuousBatchingEngine(te, tg)
    keys_after_warmup = set(te._programs)
    assert keys_after_warmup
    assert sorted(map(_program_shape, keys_after_warmup), key=str) == sorted(
        map(_program_shape, je._programs), key=str)
    assert all(p.compiled for p in te._programs.values())
    prompts = _prompts(11, (5, 9, 13, 7, 11))
    out = _churn(cb, prompts, 3)
    assert len(out) == len(prompts)
    assert set(te._programs) == keys_after_warmup
    assert out == {k: list(map(int, v)) for k, v in _churn(jcb, prompts, 3).items()}


def test_generate_precompiles_reachable_buckets(weights):
    """generate(precompile=True) builds its whole reachable set before the
    first token (JAX's keys); the decode loop then finds every program
    built."""
    kw = dict(max_batch=1, max_seq_len=64, buckets=[16, 32, 64])
    _, engine = _both_generate(weights, [list(range(1, 10))], 30, engine_kw=kw)
    je = JaxEngine(JAX_TINY, weights[0], **kw)
    je.generate([list(range(1, 10))], _gens(30)[0])
    assert all(p.compiled for p in engine._programs.values())
    assert sorted(map(_program_shape, engine._programs), key=str) == sorted(
        map(_program_shape, je._programs), key=str)


def test_serving_churn_benchmark(weights):
    """The churn benchmark reports throughput and no program built under
    traffic, and its streams are the JAX benchmark's."""
    kw = dict(max_batch=2, max_seq_len=64, buckets=[16, 32, 64])
    je, te = _pair(weights, **kw)
    args = dict(n_requests=4, prompt_len=8, max_new_tokens=6, admit_every=2)
    rep = benchmark_serving_churn(te, **args)
    jrep = jax_churn(je, **args)
    assert rep["compiled_under_traffic"] == 0 == jrep["compiled_under_traffic"], rep
    assert rep["requests_per_s"] > 0 and rep["tokens_per_s"] > 0
    assert rep["decode_steps"] == jrep["decode_steps"]
    assert rep["programs_after_run"] == jrep["programs_after_run"]
    assert len(rep["outputs"]) == 4


def test_no_compile_under_churn_with_bucket_fallback(weights):
    """A ladder topping out below max_seq_len: the warm-up builds the
    full-cache decode fallback too, so a long request builds nothing
    mid-traffic."""
    kw = dict(max_batch=1, max_seq_len=64, buckets=[16, 32])
    je, te = _pair(weights, **kw)
    jg, tg = _gens(40)
    cb = ContinuousBatchingEngine(te, tg)
    keys_after_warmup = set(te._programs)
    assert ("decode", 1, tg.sampling, 64) in keys_after_warmup
    rid = cb.submit(list(range(1, 9)))  # 8-token prompt + 40 new crosses 32
    out = cb.run_to_completion()
    assert set(te._programs) == keys_after_warmup
    jcb = JaxCB(je, jg)
    jcb.submit(list(range(1, 9)))
    assert out[rid] == list(map(int, jcb.run_to_completion()[0]))


def test_benchmark_prefill_on_device(weights):
    """The prefill timer runs the engine's own prefill_compute, returns a
    positive amortized latency, and leaves the engine serving correctly."""
    _, model = weights
    engine = InferenceEngine(TINY, model, max_batch=2, max_seq_len=64, buckets=[16, 32, 64])
    rep = benchmark_prefill_on_device(engine, prompt_len=12, repeats=4, n_runs=2)
    assert rep["bucket"] == 16 and rep["ttft_on_device_ms"] > 0
    gen = GenerationConfig(max_new_tokens=4)
    out = engine.generate([[1, 2, 3]], gen).sequences[0]
    fresh = InferenceEngine(TINY, model, max_batch=2, max_seq_len=64, buckets=[16, 32, 64])
    assert out == fresh.generate([[1, 2, 3]], gen).sequences[0]


def test_accuracy_gate_and_latency_report(weights):
    """check_accuracy_logits passes against the JAX model's logits and
    against the port's own fp32 forward, and fails past its tolerance;
    benchmark_generation gives the percentile report."""
    jp, model = weights
    ids = np.random.default_rng(21).integers(0, TINY.vocab_size, size=(1, 16))
    jax_logits = np.asarray(jax.jit(JaxLlama(JAX_TINY).__call__)(jp, jnp.asarray(ids)))
    engine = InferenceEngine(TINY, model, max_batch=1, max_seq_len=64)
    report = check_accuracy_logits(engine, ids, jax_logits, atol=1e-3)
    assert report["top1_agreement"] == 1.0
    assert check_accuracy_logits(engine, ids)["max_abs_err"] <= 1e-3
    with pytest.raises(AssertionError, match="gate failed"):
        check_accuracy_logits(engine, ids, jax_logits + 0.5, atol=1e-3)
    bench = benchmark_generation(engine, prompt_len=8, max_new_tokens=4, n_runs=2, warmup=1)
    for k in ("ttft_p50_ms", "per_token_p50_ms", "tokens_per_s"):
        assert bench[k] > 0


# -- the dense cache -----------------------------------------------------------------


def test_write_past_the_cache_is_dropped(weights):
    """A block that runs past max_len: its rows past the cache are dropped
    (JAX's scatter drops them), the rows inside land, the rest of the cache
    is untouched, and the in-range rows' logits are JAX's."""
    jp, model = weights
    dec, jdec = LlamaDecode(TINY), JaxDecode(JAX_TINY)
    cache = dec.init_cache(2, 16, device="cpu")
    jcache = jdec.init_cache(2, 16)
    prompt = _prompts(1, (14,))[0]
    ids = torch.as_tensor([prompt, prompt[::-1]])
    z = torch.zeros((2,), dtype=torch.int32)
    dec.forward(model, cache, ids, z, context_encode=True)
    _, jcache = jdec.forward(jp, jcache, jnp.asarray(ids.numpy(), jnp.int32),
                             jnp.zeros((2,), jnp.int32), context_encode=True)
    before = cache.k.clone()
    block = np.asarray([[5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    pos = np.asarray([14, 10], np.int32)  # lane 0 runs rows 14..17 past 16
    logits, _ = dec.forward(model, cache, torch.as_tensor(block), torch.as_tensor(pos))
    jlogits, jcache = jdec.forward(jp, jcache, jnp.asarray(block), jnp.asarray(pos))
    assert torch.isfinite(cache.k).all() and torch.isfinite(cache.v).all()
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=1e-5)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), atol=1e-5)
    # lane 0's rows 14, 15 landed and rows 0..13 kept; row 0 was not
    # clobbered by the dropped rows
    assert not torch.equal(cache.k[:, 0, 14:], before[:, 0, 14:])
    assert torch.equal(cache.k[:, 0, :14], before[:, 0, :14])
    np.testing.assert_allclose(logits[0, :2].numpy(), np.asarray(jlogits)[0, :2], atol=1e-4)
    np.testing.assert_allclose(logits[1].numpy(), np.asarray(jlogits)[1], atol=1e-4)


def test_dense_cache_is_allocated_lazily(weights):
    """The paged engine builds an InferenceEngine and reads no dense cache:
    none is allocated until a dense program needs it."""
    _, model = weights
    eng = InferenceEngine(TINY, model, max_batch=2, max_seq_len=64)
    paged = PagedServingEngine(eng, GenerationConfig(max_new_tokens=3),
                               PagedConfig(block_size=8, num_blocks=16))
    rid = paged.submit([1, 2, 3])
    paged.run_to_completion()
    assert len(paged.request_tokens(rid)) == 3
    assert eng._cache is None
    eng.generate([[1, 2, 3]], GenerationConfig(max_new_tokens=2))
    c = TINY
    assert eng.cache.k.shape == (c.num_layers, 2, 64, c.num_kv_heads, c.head_dim)
