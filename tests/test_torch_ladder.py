"""The port's degradation ladder against the JAX package's, on the CPU at
the tiny config (fp32) with the same weights and the same FaultPlan.

Every failed request, fault without a victim, pool-pressure preemption,
drafter fault and (under ``slo_degrade``) SLO alert is an event;
``degrade_after_faults`` events inside ``degrade_window_steps`` climb one
rung (1 sheds speculation, 2 the async lookahead, 3 the paged-attention
kernel through a gather twin of the decode model, 4 sheds the youngest
lane), and ``degrade_recover_steps`` clean steps step one rung back down.
Both engines run the same serve with an injector each, built from one
plan, and the port must climb and recover on the same steps as the JAX
engine, fail the same requests and serve the survivors the same tokens.

The decoder layers' kernels are scaled by 10 from the init (as in
tests/test_torch_faults.py): at the init scale every greedy stream
repeats one token, which would hide a token committed one step off.
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
    FaultInjector as JaxFaultInjector,
    FaultPlan as JaxFaultPlan,
    PagedConfig as JaxPagedConfig,
    PagedServingEngine as JaxPagedServingEngine,
)
from neuronx_distributed_llama3_2_tpu.serving.catalog import format_key as jax_format_key
from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
    GenerationConfig,
    InferenceEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LLAMA_CONFIGS,
    LlamaForCausalLM,
    params_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.catalog import format_key
from neuronx_distributed_llama3_2_tpu_torch.serving.faults import FaultInjector, FaultPlan
from neuronx_distributed_llama3_2_tpu_torch.serving.invariants import audit_engine
from neuronx_distributed_llama3_2_tpu_torch.serving.engine import (
    PagedConfig,
    PagedServingEngine,
)

torch.set_num_threads(1)

JAX_TINY = dataclasses.replace(JAX_CONFIGS["tiny"], use_paged_kernel=True)
TINY = dataclasses.replace(LLAMA_CONFIGS["tiny"], use_paged_kernel=True)
ENGINE_KW = dict(max_batch=4, max_seq_len=64, buckets=[8, 16, 32])
LAYER_SCALE = 10.0

#: JAX's test_degradation_ladder_climbs_and_recovers
#: (tests/test_fault_tolerance.py): one event a rung, a 4-step recovery
LADDER = dict(block_size=8, num_blocks=64, async_loop=True, degrade_after_faults=1,
              degrade_window_steps=16, degrade_recover_steps=4)
LADDER_PLAN = dict(seed=17, schedule=((4, "device"), (7, "device"), (10, "device")))
LADDER_PROMPT_LENGTHS = (5, 12, 9, 17, 6, 11, 8, 14)


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


def _port(model, max_new, paged, plan=None):
    return PagedServingEngine(
        InferenceEngine(TINY, model, **ENGINE_KW), GenerationConfig(max_new_tokens=max_new),
        PagedConfig(**paged),
        injector=None if plan is None else FaultInjector(FaultPlan(**plan)),
    )


def _jax(jp, max_new, paged, plan=None):
    return JaxPagedServingEngine(
        JaxInferenceEngine(JAX_TINY, jp, **ENGINE_KW),
        JaxGenerationConfig(max_new_tokens=max_new), JaxPagedConfig(**paged),
        precompile=False,
        injector=None if plan is None else JaxFaultInjector(JaxFaultPlan(**plan)),
    )


def _serve_levels(eng, prompts):
    """Submit ``prompts`` and step to the end; returns the ladder level
    after every step."""
    for p in prompts:
        eng.submit(p)
    levels = []
    while eng.step():
        levels.append(eng._degrade_level)
        assert len(levels) < 1000
    return levels


def _outcome(eng):
    m = eng.metrics
    return dict(
        fired=None if eng.injector is None else list(eng.injector.fired),
        info={rid: (eng.request_info(rid)["status"], eng.request_info(rid)["error"])
              for rid in sorted(eng._requests)},
        outs={rid: list(r.out) for rid, r in sorted(eng._finished.items())},
        degradations=m.degradations, degradation_level=m.degradation_level,
        failed_requests=m.failed_requests, preemptions=m.preemptions,
        slo_alerts=m.slo_alerts,
    )


def _preempts(eng):
    """(step, rid, lane, shed) of every PREEMPT in the action trace."""
    return [(step, a.meta["rid"], a.meta["lane"], a.meta["shed"])
            for step, _, actions in eng.action_trace for a in actions
            if a.type.value == "PREEMPT"]


def _clean(eng):
    assert eng._pending is None
    assert eng.allocator.active_blocks == 0
    assert eng.allocator.leak_check() == []
    assert audit_engine(eng) == []


def _survivors_match(eng, baseline):
    """Finished requests equal the fault-free serve; failed ones carry an
    error and a prefix of it. Returns (finished, failed)."""
    n_finished = n_failed = 0
    for rid, req in eng._finished.items():
        info = eng.request_info(rid)
        if info["status"] == "failed":
            n_failed += 1
            assert info["error"] and req.out == baseline[rid][: len(req.out)]
        else:
            n_finished += 1
            assert info["error"] is None and req.out == baseline[rid]
    return n_finished, n_failed


def _pair(weights, max_new, paged, plan, prompts):
    """The same serve through both engines; the port's per-step levels
    and outcome must equal the JAX engine's. Returns (port, levels)."""
    jp, model = weights
    jax_eng, port = _jax(jp, max_new, paged, plan), _port(model, max_new, paged, plan)
    want = _serve_levels(jax_eng, prompts)
    got = _serve_levels(port, prompts)
    assert got == want
    assert _outcome(port) == _outcome(jax_eng)
    assert _preempts(port) == _preempts(jax_eng)
    _clean(port)
    return port, jax_eng, got


def test_degradation_ladder_climbs_and_recovers(weights):
    prompts = _prompts(16, LADDER_PROMPT_LENGTHS)
    baseline = _port(weights[1], 24, dict(LADDER, degrade_after_faults=0))
    for p in prompts:
        baseline.submit(p)
    base = baseline.run_to_completion()
    port, _, levels = _pair(weights, 24, LADDER, LADDER_PLAN, prompts)
    # three events, one rung each: speculation, the async lookahead, the kernel
    assert max(levels) == 3 and port.metrics.degradations == 3
    # rung 3 served through the gather twins, and clean steps stepped back
    # down to level 0 and to the kernel
    gather_keys = [k for k in port.program_registry() if k[0] == "pdecode" and k[3]]
    assert gather_keys and all(format_key(k).endswith(",gather]") for k in gather_keys)
    paths = port._gather_model.attention_paths
    assert paths["gather"] > 0 and paths["kernel"] == 0
    assert levels[-1] == 0 and port.metrics.degradation_level == 0
    assert not port._gather_shed()
    assert _survivors_match(port, base) == (5, 3)


def test_ladder_off_by_default_under_faults(weights):
    port, _, levels = _pair(weights, 8, dict(block_size=8, num_blocks=64),
                            dict(schedule=((3, "device"),)), _prompts(18, (5, 9)))
    assert port.metrics.degradations == 0 and set(levels) == {0}
    assert port.metrics.failed_requests == 1
    assert port._gather_model is None


def test_fault_free_engine_builds_no_checked_or_gather_programs(weights):
    jp, model = weights
    prompts = _prompts(19, (5, 12))
    port = _port(model, 8, dict(block_size=8, num_blocks=64))
    jax_eng = _jax(jp, 8, dict(block_size=8, num_blocks=64))
    for eng in (port, jax_eng):
        for p in prompts:
            eng.submit(p)
        eng.run_to_completion()
    assert port.injector is None and port._check_logits is False
    for key in port.program_registry():
        if key[0] == "pdecode":
            assert key[3] is False and key[4] is False  # gather, checked
    assert port._gather_model is None
    jax_model_keys = sorted(jax_format_key(k) for k in jax_eng._programs
                            if k[0] in ("pctx", "psfx", "pdecode"))
    assert sorted(map(format_key, port.program_registry())) == jax_model_keys
    m = port.metrics
    assert (m.faults_injected, m.failed_requests, m.degradation_level, m.degradations) == (
        0, 0, 0, 0)


def test_top_rung_sheds_the_youngest_lane(weights):
    """Four events climb to rung 4, which preempts the youngest lane
    (PREEMPT with shed=True, which is no event itself); the shed lane
    resumes and ends with its fault-free stream."""
    paged = dict(LADDER, degrade_recover_steps=32)
    plan = dict(seed=3, schedule=((3, "device"), (4, "device"), (5, "device"),
                                  (6, "device")))
    prompts = _prompts(21, (5, 12, 9, 17, 6, 11))
    baseline = _port(weights[1], 16, dict(paged, degrade_after_faults=0))
    for p in prompts:
        baseline.submit(p)
    base = baseline.run_to_completion()
    port, jax_eng, levels = _pair(weights, 16, paged, plan, prompts)
    assert max(levels) == 4 and port.metrics.degradations == 4
    shed = [p for p in _preempts(port) if p[3]]
    assert len(shed) == 1 and shed == [p for p in _preempts(jax_eng) if p[3]]
    step, rid, lane, _ = shed[0]
    assert step == 6 and levels[step - 1] == 4
    assert port.request_info(rid)["preemptions"] == 1
    assert port.request_info(rid)["status"] == "finished"
    assert port._finished[rid].out == base[rid]
    assert _survivors_match(port, base) == (2, 4)


def test_slo_alert_climbs_the_ladder_with_jax(weights):
    """Under slo_degrade an SLO alert is an event: with a TTFT objective
    every first token misses, the monitor alerts as soon as its window is
    full, and the ladder climbs on the same steps as the JAX engine's."""
    paged = dict(block_size=8, num_blocks=64, degrade_after_faults=1,
                 degrade_window_steps=8, degrade_recover_steps=6, slo_degrade=True,
                 slo_ttft_p99_ms=1e-6, slo_eval_steps=2, slo_burn_window=2)
    port, _, levels = _pair(weights, 12, paged, None,
                            _prompts(22, (5, 12, 9, 17, 6, 11, 8, 14)))
    assert port.metrics.slo_alerts > 0
    first = levels.index(1)
    assert first + 1 == 4  # the first full window is step 4's evaluation
    assert port.metrics.degradations > 0 and port.metrics.failed_requests == 0


def test_prewarm_gather_twins_are_not_steady_state_compiles(weights):
    """The gather twins are legal catalog keys (the JAX package's lines),
    kept out of what prewarm registers; the kernel-shed rung registers
    them at first use without counting them in steadystate_compiles."""
    jp, model = weights
    paged = dict(LADDER, prewarm=True, kv_buckets=(16, 32, 64), prefill_buckets=(8, 16, 32))
    jax_eng = _jax(jp, 24, dict(paged, prewarm=False))
    port = _port(model, 24, paged, LADDER_PLAN)
    assert port.catalog.gather_variants and "gather-variants" in port.catalog.describe()
    assert port.catalog.lines() == jax_eng.catalog.lines()
    assert [format_key(k) for k in port.catalog.prewarm_keys()] == [
        jax_format_key(k) for k in jax_eng.catalog.prewarm_keys()]
    gather = {k for k in port.catalog.keys() if k[0] in ("pctx", "psfx", "pdecode")
              and k[3 if k[0] != "psfx" else 4]}
    assert gather and not gather & set(port.catalog.graph_keys())
    assert set(port.program_registry()) == set(port.catalog.graph_keys())
    levels = _serve_levels(port, _prompts(16, LADDER_PROMPT_LENGTHS))
    assert max(levels) == 3
    minted = set(port.program_registry()) - set(port.catalog.graph_keys())
    assert minted and minted <= gather
    m = port.metrics
    assert m.steadystate_compiles == 0
    assert m.programs_compiled == m.prewarm_compiles + len(minted)
    _clean(port)
