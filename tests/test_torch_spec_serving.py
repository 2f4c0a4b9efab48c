"""Speculative decoding and the fused mixed-mode step of the port's paged
engine against the JAX engine, on the CPU at the tiny config (fp32) with
the same weights.

Every leg runs the same prompts through both engines with the same
``PagedConfig`` and compares the greedy streams, the per-request
bookkeeping and the speculation and fused-step counters, which are host
logic copied from the JAX package. The JAX side runs its Pallas kernel in
interpret mode (or the gather); the port the plain version of its CUDA
kernel (or the gather). The two differ only in fp32 summation order,
~1e-6 on the logits, far below the gaps argmax decides on at this size.
Prompts follow the JAX package's ``_rep_prompts`` recipe (a short repeated
pattern, so that the n-gram drafter proposes).
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
from neuronx_distributed_llama3_2_tpu.inference.sampling import (
    SamplingConfig as JaxSamplingConfig,
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
from neuronx_distributed_llama3_2_tpu_torch.serving.drafter import NGramDrafter
from neuronx_distributed_llama3_2_tpu_torch.serving.engine import (
    PagedConfig,
    PagedServingEngine,
    make_serving_engine,
)

ENGINE_KW = dict(max_batch=4, max_seq_len=64, buckets=[8, 16, 32])


def _configs(kernel: bool):
    return (
        dataclasses.replace(JAX_CONFIGS["tiny"], use_paged_kernel=kernel),
        dataclasses.replace(LLAMA_CONFIGS["tiny"], use_paged_kernel=kernel),
    )


@pytest.fixture(scope="module")
def weights():
    """(JAX pytree, port module) holding the same seeded weights."""
    jcfg, cfg = _configs(True)
    jp = JaxLlama(jcfg).init(jax.random.key(0))
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu"))
    return jp, model


def _rep_prompts(rng, lengths, period=3):
    """Repetitive prompts (a short repeated pattern), so that the
    prompt-lookup drafter proposes: the JAX package's recipe."""
    out = []
    for n in lengths:
        pat = rng.integers(1, 9, size=period).tolist()
        out.append((pat * (n // period + 1))[:n])
    return out


def _prompts(rng, lengths):
    return [rng.integers(0, 256, size=(n,)).tolist() for n in lengths]


def _engines(weights, max_new, kernel=True, drafter=None, engine_kw=None, **paged_kw):
    """(JAX engine, port engine) over the same weights and config; a
    drafter is passed to both (it holds no state)."""
    jp, model = weights
    jcfg, cfg = _configs(kernel)
    kw = dict(ENGINE_KW, **(engine_kw or {}))
    jax_eng = JaxPagedServingEngine(
        JaxInferenceEngine(jcfg, jp, **kw), JaxGenerationConfig(max_new_tokens=max_new),
        JaxPagedConfig(**paged_kw), drafter=drafter, precompile=False,
    )
    port = PagedServingEngine(
        InferenceEngine(cfg, model, **kw), GenerationConfig(max_new_tokens=max_new),
        PagedConfig(**paged_kw), drafter=drafter,
    )
    return jax_eng, port


def _run(eng, phases):
    """Each phase's prompts submitted together, then run to completion."""
    outs = {}
    for prompts in phases:
        for p in prompts:
            eng.submit(p)
        outs.update(eng.run_to_completion())
    return outs


COUNTERS = (
    "verify_steps", "draft_tokens", "accepted_tokens", "spec_disabled_lanes",
    "drafter_faults", "mixed_dispatches", "decode_steps", "prefill_chunks",
    "prefill_tokens", "compute_dispatches", "engine_steps", "preemptions",
    "cached_tokens", "finished",
)


def _assert_same(jax_eng, port, j_out, p_out):
    assert p_out == j_out
    keys = ("generated_tokens", "cached_tokens", "preemptions", "status")
    assert [{k: port.request_info(r)[k] for k in keys} for r in sorted(p_out)] == [
        {k: jax_eng.request_info(r)[k] for k in keys} for r in sorted(j_out)
    ]
    jm, pm = jax_eng.metrics, port.metrics
    assert {c: getattr(pm, c) for c in COUNTERS} == {c: getattr(jm, c) for c in COUNTERS}
    ja, pa_ = jm.hist_accept_len, pm.hist_accept_len
    assert (pa_.counts, pa_.count, pa_.total) == (ja.counts, ja.count, ja.total)
    assert (port.metrics.snapshot(port.allocator, port.index)["dispatches_per_step"]
            == jax_eng.metrics.snapshot(jax_eng.allocator, jax_eng.index)["dispatches_per_step"])
    assert port.allocator.active_blocks == 0
    assert port.allocator.leak_check() == []


def _leg_phases(spec: bool):
    """Five prompts straddling the 6-token chunk (the fifth queues behind
    max_batch 4), then a sixth that shares 20 tokens of the second and
    arrives after it finished: a prefix hit, whose suffix walks the fused
    grid while the seventh, a fresh prompt, decodes beside it."""
    if spec:
        first = _rep_prompts(np.random.default_rng(31), (9, 26, 12, 7, 15))
        tail = _rep_prompts(np.random.default_rng(32), (5, 10))
    else:
        first = _prompts(np.random.default_rng(29), (5, 26, 9, 7, 12))
        tail = _prompts(np.random.default_rng(30), (5, 10))
    return [first, [first[1][:20] + tail[0], tail[1]]]


LEGS = [(m, s, c) for m in ("kernel", "gather") for s in ("spec", "nospec")
        for c in ("chunk", "whole")]


@pytest.mark.parametrize("model,spec,chunk", LEGS, ids=["-".join(leg) for leg in LEGS])
def test_fused_legs_match_jax(weights, model, spec, chunk):
    """fused_step on: {kernel, gather} x {spec, nospec} x {chunked, whole}.
    Streams, bookkeeping and every spec / fused counter equal the JAX
    engine's; the prefix hit's suffix went through the grid."""
    jax_eng, port = _engines(
        weights, 8, kernel=model == "kernel", block_size=8, num_blocks=64,
        spec_draft_tokens=3 if spec == "spec" else 0,
        prefill_chunk_tokens=6 if chunk == "chunk" else None, fused_step=True,
    )
    phases = _leg_phases(spec == "spec")
    j_out, p_out = _run(jax_eng, phases), _run(port, phases)
    _assert_same(jax_eng, port, j_out, p_out)
    m = port.metrics
    assert port.request_info(5)["cached_tokens"] >= 20
    assert m.mixed_dispatches > 0 and m.prefill_chunks > 0
    assert (m.draft_tokens > 0) == (spec == "spec")
    paths = port.model.attention_paths
    assert (paths["gather"] == 0) == (model == "kernel")


@pytest.mark.parametrize("model,chunk", [("kernel", 6), ("gather", None)],
                         ids=["kernel-chunk", "gather-whole"])
def test_spec_without_fused_matches_jax(weights, model, chunk):
    """Speculation on the unfused engine: a verify dispatch per step, chunks
    through the suffix prefill; the accept rate is what JAX's is."""
    jax_eng, port = _engines(
        weights, 10, kernel=model == "kernel", block_size=8, num_blocks=64,
        spec_draft_tokens=4, prefill_chunk_tokens=chunk,
    )
    phases = [_rep_prompts(np.random.default_rng(3), (12, 22, 9, 17))]
    j_out, p_out = _run(jax_eng, phases), _run(port, phases)
    _assert_same(jax_eng, port, j_out, p_out)
    m = port.metrics
    assert m.verify_steps > 0 and m.accepted_tokens > 0 and m.mixed_dispatches == 0
    assert m.accept_rate() == jax_eng.metrics.accept_rate() > 0


def test_spec_under_preemption_matches_jax(weights):
    """A pool too small for four growing requests: drafts are trimmed to
    the backed rows (never preempting), base-row backing preempts the
    youngest, as in the JAX engine."""
    jax_eng, port = _engines(
        weights, 36, block_size=8, num_blocks=10, decode_reserve_blocks=1,
        spec_draft_tokens=4,
    )
    phases = [_rep_prompts(np.random.default_rng(11), (12, 10, 14, 9))]
    j_out, p_out = _run(jax_eng, phases), _run(port, phases)
    _assert_same(jax_eng, port, j_out, p_out)
    assert port.metrics.preemptions > 0 and port.metrics.verify_steps > 0


def test_fused_preemption_mid_grid_matches_jax(weights):
    """An older lane's decode growth exhausts a tight pool while a younger
    request is mid-chunk inside the mixed grid: the victim is requeued and
    re-admits through the fused route, as in the JAX engine."""
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 256, size=(n,)).tolist() for n in (8, 30)]
    jax_eng, port = _engines(
        weights, 8, block_size=4, num_blocks=12, decode_reserve_blocks=1,
        prefill_chunk_tokens=4, fused_step=True,
    )
    caught = []
    inner = port._preempt

    def spy(req):
        caught.append((req.rid, req.prefilling))
        inner(req)

    port._preempt = spy
    j_out, p_out = _run(jax_eng, [prompts]), _run(port, [prompts])
    _assert_same(jax_eng, port, j_out, p_out)
    assert (1, True) in caught
    assert port.metrics.mixed_dispatches > 0


class _WrongDrafter:
    """Always drafts a token the tiny model is very unlikely to emit."""

    def propose(self, history, max_tokens):
        return [LLAMA_CONFIGS["tiny"].vocab_size - 1] * max_tokens


class _FlakyDrafter:
    """The n-gram drafter, raising on every third call."""

    def __init__(self):
        self.inner, self.calls = NGramDrafter(), 0

    def propose(self, history, max_tokens):
        self.calls += 1
        if self.calls % 3 == 0:
            raise RuntimeError("drafter fault")
        return self.inner.propose(history, max_tokens)


def test_spec_disable_heuristic_matches_jax(weights):
    """A hopeless drafter costs verify width until probation ends, then
    every lane drops to plain decode (spec_disabled_lanes), on the same
    step in both engines; the streams are still exact."""
    prompts = _prompts(np.random.default_rng(2), (6, 11, 9))
    jax_eng, port = _engines(
        weights, 24, drafter=_WrongDrafter(), block_size=8, num_blocks=64,
        spec_draft_tokens=4, spec_probation_tokens=8, spec_min_accept_rate=0.2,
    )
    j_out, p_out = _run(jax_eng, [prompts]), _run(port, [prompts])
    _assert_same(jax_eng, port, j_out, p_out)
    m = port.metrics
    assert m.spec_disabled_lanes == len(prompts)
    assert m.accept_rate() < 0.2 and m.decode_steps > m.verify_steps


def test_drafter_faults_are_absorbed_like_jax(weights):
    """A drafter that raises costs its lane one step of speculation, never
    the request, and is counted as in the JAX engine."""
    prompts = _rep_prompts(np.random.default_rng(4), (10, 14))
    jax_eng, _ = _engines(weights, 10, drafter=_FlakyDrafter(), block_size=8,
                          num_blocks=64, spec_draft_tokens=3)
    _, port = _engines(weights, 10, drafter=_FlakyDrafter(), block_size=8,
                       num_blocks=64, spec_draft_tokens=3)
    j_out, p_out = _run(jax_eng, [prompts]), _run(port, [prompts])
    _assert_same(jax_eng, port, j_out, p_out)
    assert port.metrics.drafter_faults > 0


def _staggered(eng, prompts):
    eng.submit(prompts[0])
    for p in prompts[1:]:
        eng.step()
        eng.step()
        eng.submit(p)
    return eng.run_to_completion()


def test_dispatches_per_step_on_mixed_traffic_match_jax(weights):
    """Long prompts arriving while earlier lanes decode: the unfused engine
    pays a chunk prefill and a decode dispatch per step, the fused one a
    single mixed dispatch. Both engines count the same dispatches, and the
    fused ratio is below the unfused one's."""
    prompts = _prompts(np.random.default_rng(9), (21, 25, 18, 23))
    ratios = {}
    for fused in (True, False):
        jax_eng, port = _engines(weights, 8, block_size=8, num_blocks=64,
                                 prefill_chunk_tokens=6, fused_step=fused)
        j_out, p_out = _staggered(jax_eng, prompts), _staggered(port, prompts)
        _assert_same(jax_eng, port, j_out, p_out)
        snap = port.metrics.snapshot(port.allocator, port.index)
        assert snap["dispatches_per_step"] == pytest.approx(
            port.metrics.compute_dispatches / port.metrics.engine_steps, abs=1e-4)
        ratios[fused] = snap["dispatches_per_step"]
        assert (port.metrics.mixed_dispatches > 0) == fused
    assert ratios[True] < ratios[False]
    # a step with prefills in flight is one dispatch: no mixed step shares
    # its step with a decode or a chunk prefill (the last traces kept are
    # the fused engine's)
    _, port = _engines(weights, 8, block_size=8, num_blocks=64,
                       prefill_chunk_tokens=6, fused_step=True)
    _staggered(port, prompts)
    mixed_steps = 0
    for _, _, actions in port.action_trace:
        kinds = [a.type.value for a in actions]
        if "MIXED_DISPATCH" in kinds:
            mixed_steps += 1
            assert "DECODE_DISPATCH" not in kinds and "VERIFY" not in kinds
    assert mixed_steps == port.metrics.mixed_dispatches


def test_int8_fused_spec_leg_matches_jax(weights):
    """The fused speculative serve from an int8 pool (K4 mode 3 with
    row_live on the kernel path)."""
    jax_eng, port = _engines(
        weights, 8, block_size=8, num_blocks=64, kv_cache_dtype="int8",
        spec_draft_tokens=3, prefill_chunk_tokens=6, fused_step=True,
    )
    phases = _leg_phases(True)
    j_out, p_out = _run(jax_eng, phases), _run(port, phases)
    _assert_same(jax_eng, port, j_out, p_out)
    assert port.metrics.mixed_dispatches > 0 and port.metrics.verify_steps > 0


def test_greedy_and_overflow_guards(weights):
    """As in the JAX engine: speculation and fused_step need greedy
    sampling on the host-sampling path (on_device_sampling lifts that),
    and k rows past max_seq_len must fit the table's overflow region. A
    drafter is accepted, and one is made when spec is on."""
    _, model = weights
    eng = InferenceEngine(_configs(True)[1], model, **ENGINE_KW)
    sampled = GenerationConfig(
        max_new_tokens=4, sampling=SamplingConfig(greedy=False, temperature=0.7),
    )
    for kw, match in (
        (dict(spec_draft_tokens=4), "greedy"),
        (dict(prefill_chunk_tokens=4, fused_step=True), "fused_step"),
    ):
        with pytest.raises(ValueError, match=match):
            PagedServingEngine(eng, sampled, PagedConfig(block_size=8, **kw))
        lifted = PagedServingEngine(
            eng, sampled, PagedConfig(block_size=8, on_device_sampling=True, **kw)
        )
        assert lifted._fused and lifted.catalog.sampling == "lane"
    with pytest.raises(ValueError, match="overflow region"):
        PagedServingEngine(eng, paged=PagedConfig(block_size=8, spec_draft_tokens=65))
    with pytest.raises(ValueError, match="spec_draft_tokens must be >= 0"):
        PagedServingEngine(eng, paged=PagedConfig(spec_draft_tokens=-1))
    spec = PagedServingEngine(eng, paged=PagedConfig(spec_draft_tokens=2, spec_ngram_max=4))
    assert isinstance(spec.drafter, NGramDrafter) and spec.drafter.max_n == 4
    assert spec._mixed_t == 0
    fused = make_serving_engine(
        eng, paged=PagedConfig(spec_draft_tokens=4, prefill_chunk_tokens=3, fused_step=True),
        drafter=_WrongDrafter(),
    )
    assert isinstance(fused.drafter, _WrongDrafter) and fused._mixed_t == 5
    # the JAX engine makes the same choices
    jax_sampled = JaxGenerationConfig(
        max_new_tokens=4, sampling=JaxSamplingConfig(greedy=False, temperature=0.7),
    )
    jeng = JaxInferenceEngine(_configs(True)[0], weights[0], **ENGINE_KW)
    with pytest.raises(ValueError, match="greedy"):
        JaxPagedServingEngine(jeng, jax_sampled, JaxPagedConfig(block_size=8, spec_draft_tokens=4),
                              precompile=False)


# -- tree speculation ---------------------------------------------------------


def _tree_prompts(rng, lengths):
    """Prompts of two 4-token patterns that share their first three tokens
    (a b c x a b c y ...): every (a, b, c) site is followed by x or by y,
    so the n-gram drafter's trie opens a second branch."""
    out = []
    for n in lengths:
        a, b, c, x, y = rng.choice(np.arange(1, 40), size=5, replace=False).tolist()
        out.append(([a, b, c, x, a, b, c, y] * (n // 8 + 1))[:n])
    return out


class _ChainOnly:
    """The n-gram drafter without ``propose_tree``: the engine proposes its
    chain as a one-branch tree."""

    def __init__(self):
        self.inner = NGramDrafter()

    def propose(self, history, max_tokens):
        return self.inner.propose(history, max_tokens)


class _DecoyOracle:
    """Knows the greedy streams: while a lane's history is a prefix of one,
    proposes a two-branch tree, a decoy token first (the greedy stream's
    next token plus one) and then the greedy continuation, so that every
    accept goes through nodes whose index is one past their depth and the
    frontier commit moves rows. Abstains otherwise."""

    def __init__(self, streams, vocab):
        self.streams, self.vocab = [list(s) for s in streams], vocab

    def propose(self, history, max_tokens):
        return []

    def propose_tree(self, history, max_nodes, branches=2):
        h = list(history)
        for s in self.streams:
            if len(h) < len(s) and s[: len(h)] == h:
                cont = s[len(h): len(h) + max_nodes - 1]
                if not cont:
                    return [], []
                tokens = [(cont[0] + 1) % self.vocab] + cont
                return tokens, [0, 0] + list(range(2, len(cont) + 1))
        return [], []


TREE_COUNTERS = COUNTERS + ("tree_verify_steps", "tree_draft_tokens")


def _assert_same_tree(jax_eng, port, j_out, p_out):
    _assert_same(jax_eng, port, j_out, p_out)
    jm, pm = jax_eng.metrics, port.metrics
    assert {c: getattr(pm, c) for c in TREE_COUNTERS} == {c: getattr(jm, c) for c in TREE_COUNTERS}
    assert pm.tree_accept_by_shape == jm.tree_accept_by_shape


TREE_LEGS = [(d, f) for d in ("ngram", "chain") for f in ("unfused", "fused")]


@pytest.mark.parametrize("drafter,fused", TREE_LEGS, ids=["-".join(x) for x in TREE_LEGS])
def test_tree_legs_match_jax(weights, drafter, fused):
    """spec_tree on the kernel path, unfused (tree verify dispatches) and
    fused (trees inside the mixed step while prompts prefill in chunks),
    with the branching n-gram drafter and with a chain-only one: streams,
    bookkeeping, every counter, tree_accept_by_shape and accepted_tokens
    equal the JAX engine's. The n-gram legs dispatch trees that branch; the
    chain-only legs give the tokens and accepts of linear speculation."""
    prompts = [_tree_prompts(np.random.default_rng(51), (23, 17, 30))]
    kw = dict(block_size=8, num_blocks=64, spec_draft_tokens=5, spec_tree=True,
              prefill_chunk_tokens=6 if fused == "fused" else None,
              fused_step=fused == "fused")
    mk = (lambda: _ChainOnly()) if drafter == "chain" else (lambda: None)
    jax_eng, port = _engines(weights, 10, drafter=mk(), **kw)
    branched = []
    inner = port.model.tree_verify_step if fused == "unfused" else port.model.mixed_step

    def spy(*a, **k):
        # a tree branches where two live nodes share a parent
        if fused == "unfused":
            par, live = a[5], a[6]
        else:
            par, live = k["parents"], torch.where(a[8] > 0, 1, a[7] + 1)
        branched.extend(len(set(par[i, 1:n].tolist())) < n - 1
                        for i, n in enumerate(live.tolist()))
        return inner(*a, **k)

    if fused == "unfused":
        port.model.tree_verify_step = spy
    else:
        port.model.mixed_step = spy
    j_out, p_out = _run(jax_eng, prompts), _run(port, prompts)
    _assert_same_tree(jax_eng, port, j_out, p_out)
    m = port.metrics
    assert m.tree_verify_steps > 0 and m.tree_draft_tokens == m.draft_tokens > 0
    assert (m.mixed_dispatches > 0) == (fused == "fused")
    assert port.model.attention_paths["gather"] == 0
    if drafter == "ngram":
        assert any(branched)
    else:
        # the same drafter through linear speculation: the same tokens,
        # drafts and accepts
        _, lin = _engines(weights, 10, drafter=mk(), **dict(kw, spec_tree=False))
        assert _run(lin, prompts) == p_out
        for c in ("verify_steps", "draft_tokens", "accepted_tokens"):
            assert getattr(lin.metrics, c) == getattr(m, c)


COMMIT_LEGS = [(m, d) for d in ("fp32", "int8", "fp8_e4m3") for m in ("kernel", "gather")]


@pytest.mark.parametrize(
    "model,pool", COMMIT_LEGS,
    ids=[m if d == "fp32" else f"{m}-{d}" for m, d in COMMIT_LEGS])
def test_tree_commits_through_the_second_branch_match_jax(weights, model, pool):
    """The decoy oracle's trees, fused: every accept runs through the
    second branch, so each step that accepts moves rows to the frontier
    (in the mixed step while prompts prefill, in the tree verify after).
    The streams are the plain greedy streams, and equal JAX's with every
    counter; the pools after the serve agree with JAX's (an identity
    commit fails here: the tiny model's streams do not show it). From the
    model's own fp32 pool, and from int8 and fp8 e4m3 pools, whose
    payloads and scales the commit moves together (byte views in the
    port)."""
    prompts = [_prompts(np.random.default_rng(52), (19, 26, 11))]
    quant = {} if pool == "fp32" else dict(kv_cache_dtype=pool)
    _, plain = _engines(weights, 12, kernel=model == "kernel", block_size=8, num_blocks=64,
                        **quant)
    greedy = _run(plain, prompts)
    oracle = _DecoyOracle([p + greedy[r] for r, p in enumerate(prompts[0])],
                          LLAMA_CONFIGS["tiny"].vocab_size)
    jax_eng, port = _engines(
        weights, 12, kernel=model == "kernel", drafter=oracle, block_size=8, num_blocks=64,
        spec_draft_tokens=4, spec_tree=True, prefill_chunk_tokens=6, fused_step=True,
        **quant,
    )
    moved = {5: 0, 6: 0}  # lanes whose commit moved rows, by width (verify, mixed)
    inner = port.model._tree_frontier_commit

    def spy(cache, tables, positions, depths, ancestors, best):
        moved[depths.shape[1]] += int((best != depths.gather(1, best.long()[:, None])[:, 0]).sum())
        return inner(cache, tables, positions, depths, ancestors, best)

    port.model._tree_frontier_commit = spy
    j_out, p_out = _run(jax_eng, prompts), _run(port, prompts)
    _assert_same_tree(jax_eng, port, j_out, p_out)
    assert p_out == greedy
    assert port.metrics.accepted_tokens > 0
    assert moved[5] > 0 and moved[6] > 0
    # the pools agree after the serve, committed rows included (block 0,
    # the null block, takes every lane's garbage rows in no set order)
    names = ("k", "v") if pool == "fp32" else ("k", "v", "k_scale", "v_scale")
    for name in names:
        got, want = getattr(port.cache, name)[:, 1:], np.asarray(getattr(jax_eng.cache, name))[:, 1:]
        if pool == "fp32" or name.endswith("scale"):
            np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), atol=1e-5)
        else:
            # payload bytes: torch has no numpy view of its fp8 types
            np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want.view(np.uint8))


def test_tree_knobs_are_validated_as_jax_does(weights):
    jp, model = weights
    eng = InferenceEngine(_configs(True)[1], model, **ENGINE_KW)
    jeng = JaxInferenceEngine(_configs(True)[0], jp, **ENGINE_KW)
    for kw, match in (
        (dict(spec_tree=True), "requires spec_draft_tokens"),
        (dict(spec_tree=True, spec_draft_tokens=32), "must be <= 31"),
        (dict(spec_draft_tokens=2, spec_tree_branches=0), "spec_tree_branches"),
    ):
        with pytest.raises(ValueError, match=match):
            PagedServingEngine(eng, paged=PagedConfig(block_size=8, **kw))
        with pytest.raises(ValueError, match=match):
            JaxPagedServingEngine(jeng, paged=JaxPagedConfig(block_size=8, **kw),
                                  precompile=False)
    tree = PagedServingEngine(eng, paged=PagedConfig(spec_draft_tokens=31, spec_tree=True))
    assert tree._spec_tree and isinstance(tree.drafter, NGramDrafter)
