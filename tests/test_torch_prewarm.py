"""The port's ``PagedConfig.prewarm``: the catalog manifest, the program
registry and the freeze, on the CPU at the tiny config (fp32).

The manifest is held to the JAX package's (``CatalogManifest.from_engine``
on a JAX engine with the same ``PagedConfig``, built and not run). On a
CPU engine there is no CUDA graph: each registered program runs its step
eagerly through the same static input buffers and the same in-place
write-back into the resident decode state that a graph replays on the
card. The prewarmed engine's greedy streams and counters are held here
to the JAX engine's and to the port's engine without prewarm on the same
prompts: they must be identical.
"""

import contextlib
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
from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LLAMA_CONFIGS,
    LlamaForCausalLM,
    params_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.catalog import (
    GRAPH_KINDS,
    CatalogManifest,
    format_key,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.engine import (
    PagedConfig,
    PagedServingEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.policy import ActionType

torch.set_num_threads(1)

JAX_TINY = dataclasses.replace(JAX_CONFIGS["tiny"], use_paged_kernel=True)
TINY = dataclasses.replace(LLAMA_CONFIGS["tiny"], use_paged_kernel=True)
ENGINE_KW = dict(max_batch=4, max_seq_len=64, buckets=[8, 16, 32])
GREEDY = SamplingConfig()

#: (id, PagedConfig knobs) of the configurations held here
CASES = {
    "plain": dict(),
    "int8-mxu-chunk": dict(kv_cache_dtype="int8", quant_mxu=True, prefill_chunk_tokens=8),
    "spec": dict(spec_draft_tokens=3),
    "spec-fused": dict(spec_draft_tokens=3, prefill_chunk_tokens=6, fused_step=True),
    "tree-fused": dict(spec_draft_tokens=3, spec_tree=True, prefill_chunk_tokens=6,
                       fused_step=True),
    # on-device sampling: the "lane" sentinel in every sampling slot
    "lane": dict(on_device_sampling=True),
    "tree-fused-lane": dict(spec_draft_tokens=3, spec_tree=True, prefill_chunk_tokens=6,
                            fused_step=True, on_device_sampling=True),
}
POOL = dict(block_size=8, num_blocks=64)


@pytest.fixture(scope="module")
def weights():
    """(JAX pytree, port module) holding the same seeded weights."""
    jp = JaxLlama(JAX_TINY).init(jax.random.key(0))
    model = LlamaForCausalLM(TINY, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), TINY, device="cpu"))
    return jp, model


def _engine(model, max_new=8, gen=None, **paged_kw):
    return PagedServingEngine(
        InferenceEngine(TINY, model, **ENGINE_KW),
        gen or GenerationConfig(max_new_tokens=max_new),
        PagedConfig(**POOL, **paged_kw),
    )


def _prompts():
    """Random prompts, and repeated 3-token patterns (the JAX package's
    ``_rep_prompts`` recipe) so that the n-gram drafter proposes; two
    share a 16-token prefix, and one is longer than a chunk."""
    rng = np.random.default_rng(5)
    rand = [rng.integers(0, TINY.vocab_size, size=(n,)).tolist() for n in (5, 20, 11)]
    reps = []
    for n in (10, 22, 14):
        pat = rng.integers(1, 9, size=3).tolist()
        reps.append((pat * (n // 3 + 1))[:n])
    shared = rng.integers(0, TINY.vocab_size, size=(16,)).tolist()
    return rand + reps + [shared + [1, 2, 3], shared + [4, 5]]


def _graph_keys(manifest):
    return {k for k in manifest.keys() if k[0] in GRAPH_KINDS}


@pytest.mark.parametrize("case", sorted(CASES))
def test_manifest_lines_match_jax(weights, case):
    """The port's manifest renders to the JAX package's lines for the same
    PagedConfig (the JAX engine is built, not run)."""
    jp, model = weights
    jax_eng = _jax_engine(jp, CASES[case])
    port = _engine(model, **CASES[case])
    manifest = CatalogManifest.from_engine(port)
    assert manifest.lines() == jax_eng.catalog.lines()
    assert port.catalog_manifest().lines() == manifest.lines()
    # and prewarm walks the keys in the JAX package's order
    assert [format_key(k) for k in manifest.prewarm_keys()] == [
        format_key(k) for k in jax_eng.catalog.prewarm_keys()
    ]
    # the port's description is the JAX package's plus what it captures
    assert manifest.describe().startswith(jax_eng.catalog.describe())
    assert f"{len(manifest.graph_keys())} captured as CUDA graphs" in manifest.describe()


@pytest.mark.parametrize("case", ["plain", "spec", "tree-fused", "lane"])
def test_registry_is_the_captured_manifest(weights, case):
    """After prewarm the registry holds exactly the manifest's pctx /
    psfx / pdecode / pverify / ptree / pmixed keys, each counted as a
    prewarm capture, and nothing counts as a steady-state capture. On the
    CPU no record holds a graph."""
    eng = _engine(weights[1], prewarm=True, **CASES[case])
    registry = eng.program_registry()
    want = _graph_keys(eng.catalog)
    assert set(registry) == want and want
    # the prefills too; a fused serve has no suffix prefill
    kinds = {k[0] for k in registry}
    assert "pctx" in kinds and ("psfx" in kinds) != bool(CASES[case].get("fused_step"))
    assert eng.catalog.graph_keys() == [
        k for k in eng.catalog.prewarm_keys() if k in want
    ]
    m = eng.metrics
    assert m.prewarm_compiles == m.programs_compiled == len(want)
    assert m.steadystate_compiles == 0
    assert eng._frozen_keys == frozenset(want)
    assert all(rec.graph is None and rec.kind == k[0] for k, rec in registry.items())
    # the families share one set of static input buffers
    for rec in registry.values():
        assert rec.inputs is eng._family_inputs(rec.kind)


def test_served_ladder_captures_the_prefills(weights):
    """At the served ladder (8 lanes, 2048-token sequences, prefill rungs 8
    .. 2048, kv rungs 128 .. 2048) the captured keys are 9 pctx, the 31
    (prefill, kv) pairs of psfx and 5 pdecode; fused with drafts of 4, the
    psfx pairs leave and pverify and pmixed come in. The manifest's lines
    are the JAX engine's (built, not run)."""
    jp, model = weights
    kw = dict(max_batch=8, max_seq_len=2048)
    paged = dict(block_size=16, num_blocks=8, prefill_buckets=tuple(8 << i for i in range(9)))
    counts = {}
    for name, knobs in (("plain", {}), ("fused", dict(spec_draft_tokens=4,
                                                      prefill_chunk_tokens=16, fused_step=True))):
        port = PagedServingEngine(
            InferenceEngine(TINY, model, **kw), GenerationConfig(),
            PagedConfig(**paged, **knobs),
        )
        jax_eng = JaxPagedServingEngine(
            JaxInferenceEngine(JAX_TINY, jp, **kw), JaxGenerationConfig(),
            JaxPagedConfig(**paged, **knobs), precompile=False,
        )
        assert port.catalog.lines() == jax_eng.catalog.lines()
        keys = port.catalog.graph_keys()
        counts[name] = {k: sum(key[0] == k for key in keys) for k in sorted({x[0] for x in keys})}
        assert len(keys) == len(set(keys))
    assert counts == {
        "plain": {"pctx": 9, "pdecode": 5, "psfx": 31},
        "fused": {"pctx": 9, "pdecode": 5, "pmixed": 5, "pverify": 5},
    }


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefill_records_are_the_direct_forward(weights, kv):
    """A pctx and then a psfx dispatch through their records (the static
    ids, start, length and table buffers; the last real row gathered at
    the length on the device) give the token and the pool that the
    model's forward gives when called directly on a copy of the pool."""
    model = weights[1]
    eng = _engine(model, kv_cache_dtype=kv)
    dec, params = eng.model, eng.engine.params
    ref = type(eng.cache)(*(None if x is None else x.clone() for x in eng.cache))
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, TINY.vocab_size, size=(21,)).tolist()
    table = [3, 5, 7, 2]
    tbl = torch.zeros((1, eng.table_width), dtype=torch.int32)
    tbl[0, : len(table)] = torch.tensor(table)
    for start, stop in ((0, 13), (13, 21)):
        piece = prompt[start:stop]
        tok = eng._prefill(piece, start, table)
        bucket = 16 if start == 0 else 8
        ids = torch.zeros((1, bucket), dtype=torch.int32)
        ids[0, : len(piece)] = torch.tensor(piece)
        kw = dict(context_encode=True) if start == 0 else dict(
            kv_limit=eng._kv_bucket(start + bucket))
        hidden, _ = dec.forward(
            params, ref, ids, torch.tensor([start], dtype=torch.int32), None,
            return_hidden=True, block_tables=tbl, **kw,
        )
        with torch.no_grad():
            want = int(torch.argmax(params._logits(hidden[:, len(piece) - 1]), dim=-1))
        assert tok == want
        for a, b in zip(eng.cache, ref):
            if a is not None:
                assert torch.equal(a, b)
    keys = sorted(k[0] for k in eng.program_registry())
    assert keys == ["pctx", "psfx"]
    assert eng.metrics.compute_dispatches == 2


def _jax_engine(jp, knobs):
    return JaxPagedServingEngine(
        JaxInferenceEngine(JAX_TINY, jp, **ENGINE_KW), JaxGenerationConfig(max_new_tokens=8),
        JaxPagedConfig(**POOL, **knobs), precompile=False,
    )


def _serve(eng, prompts):
    """The prompts submitted in two waves, the second after the first has
    finished, so that the shared prefix is cached."""
    outs = {}
    for wave in (prompts[:-1], prompts[-1:]):
        for p in wave:
            eng.submit(p)
        outs.update(eng.run_to_completion())
    return outs


#: counters held to the JAX engine's; the eager engine's also match on
#: h2d_uploads
COUNTERS = (
    "cached_tokens", "verify_steps", "accepted_tokens", "draft_tokens",
    "mixed_dispatches", "decode_steps", "prefill_chunks",
)
DISPATCHES = (ActionType.DECODE_DISPATCH, ActionType.VERIFY, ActionType.MIXED_DISPATCH)
PREFILL_KINDS = ("pctx", "psfx")


@pytest.mark.parametrize("case", ["plain", "int8-mxu-chunk", "spec-fused", "tree-fused",
                                  "tree-fused-lane"])
def test_prewarmed_streams_match_jax(weights, case):
    """The prewarmed engine's greedy streams, per-request cached tokens
    and counters equal the JAX engine's and the eager port engine's on the
    same prompts, every dispatch goes through a registered program, and
    none is registered after the freeze."""
    prompts = _prompts()
    jax_eng = _jax_engine(weights[0], CASES[case])
    eager = _engine(weights[1], **CASES[case])
    warm = _engine(weights[1], prewarm=True, **CASES[case])
    j_out = _serve(jax_eng, prompts)
    e_out, w_out = _serve(eager, prompts), _serve(warm, prompts)
    assert w_out == j_out and e_out == j_out
    for name in COUNTERS:
        want = getattr(jax_eng.metrics, name)
        assert getattr(warm.metrics, name) == getattr(eager.metrics, name) == want, name
    assert warm.metrics.h2d_uploads == eager.metrics.h2d_uploads
    assert [warm.request_info(r)["cached_tokens"] for r in w_out] == [
        jax_eng.request_info(r)["cached_tokens"] for r in j_out
    ]
    assert warm.metrics.cached_tokens > 0
    if "spec" in case or "tree" in case:
        assert warm.metrics.accepted_tokens > 0 and warm.metrics.mixed_dispatches > 0
    assert warm.metrics.steadystate_compiles == 0
    assert set(warm.program_registry()) == _graph_keys(warm.catalog)
    dispatched = sum(
        a.type in DISPATCHES for _, _, acts in warm.action_trace for a in acts
    )
    assert sum(
        r.replays for r in warm.program_registry().values() if r.kind not in PREFILL_KINDS
    ) == dispatched > 0
    # every dispatch, each prefill and chunk too, is one call of a record
    assert sum(r.replays for r in warm.program_registry().values()) == (
        warm.metrics.compute_dispatches
    )
    assert {k[0] for k, r in warm.program_registry().items() if r.replays} >= {"pctx", "psfx"} - (
        {"psfx"} if CASES[case].get("fused_step") else set()
    )
    # the pools end equal outside the null block, which holds garbage
    for a, b in zip(warm.cache, eager.cache):
        if a is not None:
            assert torch.equal(a[:, 1:], b[:, 1:])
    # without prewarm the same dispatches go through the registry too, each
    # key registered on first use (and none counted as a prewarm)
    assert eager.metrics.prewarm_compiles == eager.metrics.steadystate_compiles == 0
    assert set(eager.program_registry()) <= _graph_keys(eager.catalog)
    assert sum(r.replays for r in eager.program_registry().values()) == (
        eager.metrics.compute_dispatches
    )
    assert eager.metrics.programs_compiled == len(eager.program_registry()) > 0


def test_out_of_catalog_capture_is_counted(weights):
    """A key past the manifest dispatched after mark_steady() is captured
    (never run eagerly in its place) and counts in steadystate_compiles
    (JAX: test_catalog.py::test_out_of_catalog_compile_is_caught)."""
    eng = _engine(weights[1], prewarm=True)
    before = eng.metrics.programs_compiled
    key_ = ("pdecode", GREEDY, 12, False, False)  # no such rung
    assert key_ not in eng.catalog.keys()
    rec = eng._program(key_)
    assert eng._program(key_) is rec
    assert eng.metrics.steadystate_compiles == 1
    assert eng.metrics.programs_compiled == before + 1
    assert key_ in eng.program_registry() and key_ not in eng._frozen_keys
    assert eng.metrics.prewarm_compiles == before
    with pytest.raises(ValueError, match="eager"):
        eng._program(("copy_block", False))


@pytest.mark.parametrize("case", ["plain", "tree-fused"])
def test_prewarm_leaves_the_engine_as_it_found_it(weights, case):
    """prewarm counts no upload, leaves the resident tokens, positions and
    tables as they were, and writes nothing outside the null block
    (JAX: test_catalog.py::test_prewarm_keeps_uploads_at_zero)."""
    eager = _engine(weights[1], **CASES[case])
    warm = _engine(weights[1], prewarm=True, **CASES[case])
    assert warm.metrics.programs_compiled > 0
    assert warm.metrics.h2d_uploads == eager.metrics.h2d_uploads
    for name in ("_d_tokens", "_d_positions", "_d_tables"):
        assert torch.equal(getattr(warm, name), getattr(eager, name)), name
    for x in warm.cache:
        if x is not None:
            assert not x[:, 1:].any()
    # a second prewarm captures nothing more
    n = warm.metrics.programs_compiled
    warm.prewarm()
    assert warm.metrics.programs_compiled == n


def test_prewarm_with_sampled_decoding_raises(weights):
    """Host-sampled decoding prewarms now (it raised before the key chain
    moved onto the device): every catalog key is registered, none after
    the freeze, and the prewarmed engine serves the eager host-sampled
    streams (tests/test_torch_sampling.py holds them to the JAX engine's)."""
    gen = GenerationConfig(
        max_new_tokens=4, sampling=SamplingConfig(greedy=False, temperature=0.7)
    )
    warm = _engine(weights[1], gen=gen, prewarm=True)
    assert [r.key for r in warm.program_registry().values()] == warm.catalog.graph_keys()
    prompts = _prompts()
    eager = _engine(weights[1], gen=gen)
    assert not eager.program_registry()
    assert _serve(warm, prompts) == _serve(eager, prompts)
    assert warm.metrics.steadystate_compiles == 0
    assert sum(r.replays for r in warm.program_registry().values()) == \
        warm.metrics.compute_dispatches


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    def pool(self):
        return None


@pytest.mark.parametrize("planted", [False, True], ids=["capture", "planted"])
def test_capture_leaves_the_key_chain_where_it_was(weights, monkeypatch, planted):
    """A capture runs its step once as a warm-up, which splits the
    host-sampling key: _capture puts the key back, so the graph's first
    replay draws with the key the eager step would. The CUDA calls are
    stood in for on the CPU (a capture records and runs nothing, so the
    stand-in puts back what its body wrote). A planted capture that keeps
    its warm-up's split leaves the chain one split ahead, and the check
    sees it."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import split

    gen = GenerationConfig(
        max_new_tokens=4, sampling=SamplingConfig(greedy=False, temperature=0.7)
    )
    eng = _engine(weights[1], gen=gen)

    class _Capture:
        def __init__(self, graph, pool=None):
            pass

        def __enter__(self):
            self.saved = [x.clone() for x in (eng._key, eng._d_tokens, eng._d_positions)]

        def __exit__(self, *exc):
            for dst, x in zip((eng._key, eng._d_tokens, eng._d_positions), self.saved):
                dst.copy_(x)
            return False

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _Capture)
    key_ = next(k for k in eng.catalog.graph_keys() if k[0] == "pdecode")
    fn = eng._step_fn(key_, eng._family_inputs("pdecode"))
    k0 = eng._key.clone()
    if planted:
        fn()  # the warm-up, its split kept
        with _Capture(None):
            fn()
    else:
        eng._capture(fn)
    moved = not torch.equal(eng._key, k0)
    assert moved == planted
    if planted:
        assert torch.equal(eng._key, split(k0)[0])
    # a replay (the eager step here) then advances the chain by one split
    fn()
    assert torch.equal(eng._key, split(split(k0)[0] if planted else k0)[0])


def test_t1_arrivals_raise_when_they_would_grow_under_capture(monkeypatch):
    """The t1 source's arrival counters are sized by an eager launch
    before any capture: an allocation while a stream captures raises and
    names the buffer; a buffer already large enough is handed out."""
    cuda = torch.device("cuda")  # never allocated on here: the raise comes first
    monkeypatch.setattr(pa, "_T1_ARRIVALS", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="_t1_arrivals"):
        pa._t1_arrivals(cuda, 8)
    assert cuda not in pa._T1_ARRIVALS
    # a buffer sized before the capture is handed out under it
    buf = pa._T1_ARRIVALS[cuda] = torch.zeros(32, dtype=torch.int32)
    assert pa._t1_arrivals(cuda, 32) is buf
    with pytest.raises(RuntimeError, match="before the first capture"):
        pa._t1_arrivals(cuda, 33)
    # outside a capture the buffer grows (a CPU buffer here)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    cpu = torch.device("cpu")
    got = pa._t1_arrivals(cpu, 16)
    assert pa._T1_ARRIVALS[cpu] is got
    assert got.numel() == 16 and got.dtype == torch.int32 and not got.any()
