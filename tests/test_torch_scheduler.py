"""The port's SLO-aware step policy (``serving/scheduler.py``) against the
JAX package's, on the CPU at the tiny config (fp32) with the same
weights.

``rank_queue`` must rank seeded queues of mixed classes, tenants and
weights exactly as the JAX package's does, and a chunked serve under
``SloPolicy`` must match the JAX engine's action for action: the ADMIT
``admit_order`` and the PREFILL_CHUNK ``budget_tokens`` the policy
yields, the actions the engine records, the streams and the counters.
The latency objectives are set where every observation misses (or none
does), so that the burn gauges the policy reads do not depend on the
host's clock.
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
from neuronx_distributed_llama3_2_tpu.serving.policy import (
    QueuedRequest as JaxQueuedRequest,
)
from neuronx_distributed_llama3_2_tpu.serving.scheduler import (
    CLASS_RANK as JAX_CLASS_RANK,
    BURN_BOOST as JAX_BURN_BOOST,
    SloPolicy as JaxSloPolicy,
    rank_queue as jax_rank_queue,
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
from neuronx_distributed_llama3_2_tpu_torch.serving.engine import (
    PagedConfig,
    PagedServingEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.invariants import audit_engine
from neuronx_distributed_llama3_2_tpu_torch.serving.policy import (
    POLICIES,
    FifoPolicy,
    QueuedRequest,
    make_policy,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.scheduler import (
    BURN_BOOST,
    CLASS_RANK,
    SloPolicy,
    rank_queue,
)

torch.set_num_threads(1)

JAX_TINY = dataclasses.replace(JAX_CONFIGS["tiny"], use_paged_kernel=True)
TINY = dataclasses.replace(LLAMA_CONFIGS["tiny"], use_paged_kernel=True)
ENGINE_KW = dict(max_batch=2, max_seq_len=64, buckets=[8, 16, 32])
#: the decoder layers' kernels scaled from the init (as in
#: tests/test_torch_faults.py): at the init scale every greedy stream
#: repeats one token, which would hide a token committed one step off
LAYER_SCALE = 10.0
CLASSES = ("interactive", "batch")
TENANTS = ("acme", "bolt", "crux")

#: chunked prefill under the SLO policy; every finished request misses
#: the TPOT objective and no first token misses TTFT's, so TPOT burns as
#: soon as its window holds a finish (the budget then falls to the
#: smallest rung) and the classes that finished burn (their rank boost)
SLO_CHUNKED = dict(block_size=8, num_blocks=64, prefill_chunk_tokens=8,
                   slo_ttft_p99_ms=1e9, slo_tpot_p99_ms=1e-6, slo_eval_steps=2,
                   slo_burn_window=2)
SLO_PROMPT_LENGTHS = (20, 13, 9, 25, 17, 11, 22, 6)


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


def _queue(seed, n):
    """A seeded waiting queue: rids shuffled against positions, classes
    (two known, one not) and tenants drawn at random."""
    rng = np.random.default_rng(seed)
    rids = rng.permutation(100)[:n]
    classes = ("interactive", "batch", "bulk")
    return [dict(rid=int(rids[i]), service_class=classes[int(rng.integers(3))],
                 tenant=TENANTS[int(rng.integers(3))], tokens=int(rng.integers(1, 64)),
                 position=i) for i in range(n)]


def test_constants_match_jax():
    assert CLASS_RANK == JAX_CLASS_RANK and BURN_BOOST == JAX_BURN_BOOST


@pytest.mark.parametrize("seed", range(6))
def test_rank_queue_matches_jax(seed):
    rows = _queue(seed, 5 + 3 * seed)
    rng = np.random.default_rng(100 + seed)
    weights = {t: float(w) for t, w in zip(TENANTS, rng.choice([0.0, 0.5, 1.0, 3.0], 3))}
    burning = frozenset(c for c in CLASSES if rng.random() < 0.5)
    rank = lambda cls: CLASS_RANK.get(cls, 2) - (BURN_BOOST if cls in burning else 0)  # noqa: E731
    for w in (None, weights):
        got = rank_queue([QueuedRequest(**r) for r in rows], rank, tenant_weights=w)
        want = jax_rank_queue([JaxQueuedRequest(**r) for r in rows], rank, tenant_weights=w)
        assert got == want
        assert sorted(got) == sorted(r["rid"] for r in rows)


def test_make_policy_resolves_slo_and_refuses_tables(weights):
    pol = make_policy("slo")
    assert isinstance(pol, SloPolicy) and pol.name == "slo" and POLICIES["slo"] is SloPolicy
    assert isinstance(make_policy("fifo"), FifoPolicy)
    with pytest.raises(ValueError, match="unknown step_policy"):
        make_policy("lottery")
    with pytest.raises(NotImplementedError, match="analyzer"):
        make_policy("table")
    eng = InferenceEngine(TINY, weights[1], **ENGINE_KW)
    with pytest.raises(NotImplementedError, match="policy_table_path.*analyzer"):
        PagedServingEngine(eng, GenerationConfig(), PagedConfig(policy_table_path="t.json"))
    with pytest.raises(NotImplementedError, match="analyzer"):
        PagedServingEngine(eng, GenerationConfig(), PagedConfig(step_policy="table"))
    # the policy knob and an instance both build an SLO-scheduled engine
    by_name = PagedServingEngine(eng, GenerationConfig(), PagedConfig(step_policy="slo"))
    assert isinstance(by_name.policy, SloPolicy)
    inst = SloPolicy(tenant_weights={"acme": 2.0})
    assert PagedServingEngine(eng, GenerationConfig(), PagedConfig(), policy=inst).policy is inst
    assert by_name._view.catalog_description == by_name.catalog.describe()


def _recording(policy):
    """Record every action ``policy`` yields: (step, type, mode, meta)."""
    seen = []
    inner = policy.actions

    def actions(view):
        for act in inner(view):
            seen.append((view._engine._step_index, act.type.value, act.mode, dict(act.meta)))
            yield act

    policy.actions = actions
    return seen


def _trace(eng):
    return [(step, pending, [(a.type.value, a.mode, dict(a.meta)) for a in acts])
            for step, pending, acts in eng.action_trace]


COUNTERS = ("admitted", "engine_steps", "decode_steps", "prefill_chunks", "prefill_tokens",
            "preemptions", "slo_alerts", "finished")


def _slo_serve(eng, prompts):
    for i, p in enumerate(prompts):
        eng.submit(p, service_class=CLASSES[i % 2], tenant=TENANTS[i % 3])
    return eng.run_to_completion()


def test_slo_chunked_serve_matches_jax(weights):
    jp, model = weights
    prompts = _prompts(30, SLO_PROMPT_LENGTHS)
    tenants = {"acme": 2.0, "bolt": 1.0}
    jax_pol, port_pol = JaxSloPolicy(tenant_weights=tenants), SloPolicy(tenant_weights=tenants)
    jax_seen, port_seen = _recording(jax_pol), _recording(port_pol)
    jax_eng = JaxPagedServingEngine(
        JaxInferenceEngine(JAX_TINY, jp, **ENGINE_KW), JaxGenerationConfig(max_new_tokens=6),
        JaxPagedConfig(**SLO_CHUNKED), precompile=False, policy=jax_pol,
    )
    port = PagedServingEngine(
        InferenceEngine(TINY, model, **ENGINE_KW), GenerationConfig(max_new_tokens=6),
        PagedConfig(**SLO_CHUNKED), policy=port_pol,
    )
    want, got = _slo_serve(jax_eng, prompts), _slo_serve(port, prompts)
    assert got == want
    assert port_seen == jax_seen
    assert _trace(port) == _trace(jax_eng)
    for name in COUNTERS:
        assert getattr(port.metrics, name) == getattr(jax_eng.metrics, name), name
    assert port.metrics.slo_burn_by_class == jax_eng.metrics.slo_burn_by_class
    # the policy ranked a queue out of FCFS order, and its budget both
    # allowed every chunk and, with TPOT burning, held a wave to one
    orders = [m["admit_order"] for _, t, _, m in port_seen if t == "ADMIT" and m]
    assert any(o != sorted(o) for o in orders)
    budget = {step: m["budget_tokens"] for step, t, _, m in port_seen
              if t == "PREFILL_CHUNK" and m}
    # the ladder's top rung (64, max_seq_len) is unobserved, so the budget
    # is 64 until TPOT burns, then the smallest rung
    assert set(budget.values()) == {8, 64}
    # a wave stops once its chunks reach the budget: every chunk but its
    # last starts under it
    chunks = {step: [a[2]["tokens"] for a in acts if a[0] == "PREFILL_CHUNK"]
              for step, _, acts in _trace(port)}
    assert all(sum(chunks[s][:-1]) < b for s, b in budget.items())
    assert any(sum(chunks[s]) > 8 for s, b in budget.items() if b == 64)
    assert port.allocator.leak_check() == [] and audit_engine(port) == []


def test_slo_budget_lands_on_captured_keys(weights):
    """Under prewarm every chunk a budget paces is a registered prefill
    key: nothing is registered after the freeze, and the streams equal
    the FIFO engine's (a budget delays chunks, never changes them)."""
    model = weights[1]
    prompts = _prompts(31, SLO_PROMPT_LENGTHS)
    outs = {}
    for policy in ("slo", "fifo"):
        eng = PagedServingEngine(
            InferenceEngine(TINY, model, **ENGINE_KW), GenerationConfig(max_new_tokens=6),
            PagedConfig(**SLO_CHUNKED, prewarm=True, step_policy=policy),
        )
        registered = set(eng.program_registry())
        outs[policy] = _slo_serve(eng, prompts)
        assert eng.metrics.steadystate_compiles == 0
        assert set(eng.program_registry()) == registered
    assert outs["slo"] == outs["fifo"]
