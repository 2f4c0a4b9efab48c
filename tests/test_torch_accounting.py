"""The port's device-cost ledger (``serving/accounting.py``) and SLO monitor
(``serving/slo.py``) against the JAX package's, on the CPU at the tiny
config (fp32) with the same weights.

The JAX package's harvest reads XLA's ``cost_analysis()`` off each
lowered program where a prewarmed engine has one; PyTorch has none, so
the port's profiles are all analytic. The analytic figures are what is
held here: ``cost_table_lines(analytic_profiles(...))`` line for line,
the HBM ledger field for field at a stated budget, and the per-dispatch
fold (``dispatched_flops`` / ``dispatched_bytes``) after the same
prewarmed serve, with the JAX engine's fold given its own analytic
figures. The SLO monitor is held to the JAX package's on the same
histogram observations, and the engine's burn gauges and alerts to the
JAX engine's on the same serve.
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
from neuronx_distributed_llama3_2_tpu.serving import accounting as jax_acc
from neuronx_distributed_llama3_2_tpu.serving.metrics import ServingMetrics as JaxMetrics
from neuronx_distributed_llama3_2_tpu.serving.slo import (
    SLOMonitor as JaxSLOMonitor,
    SLOPolicy as JaxSLOPolicy,
)
from neuronx_distributed_llama3_2_tpu_torch import flops
from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
    GenerationConfig,
    InferenceEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LLAMA_CONFIGS,
    LlamaForCausalLM,
    params_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.serving import accounting as acc
from neuronx_distributed_llama3_2_tpu_torch.serving.catalog import format_key
from neuronx_distributed_llama3_2_tpu_torch.serving.engine import (
    PagedConfig,
    PagedServingEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.metrics import ServingMetrics
from neuronx_distributed_llama3_2_tpu_torch.serving.slo import SLOMonitor, SLOPolicy

torch.set_num_threads(1)

JAX_TINY = dataclasses.replace(JAX_CONFIGS["tiny"], use_paged_kernel=True)
TINY = dataclasses.replace(LLAMA_CONFIGS["tiny"], use_paged_kernel=True)
ENGINE_KW = dict(max_batch=4, max_seq_len=64, buckets=[8, 16, 32])
POOL = dict(block_size=8, num_blocks=32)

#: (id, PagedConfig knobs) of the engines whose cost tables are held
CASES = {
    "bf16": dict(),
    "int8": dict(kv_cache_dtype="int8"),
    "fp8-mxu": dict(kv_cache_dtype="fp8_e4m3", quant_mxu=True),
    "fused": dict(spec_draft_tokens=3, prefill_chunk_tokens=6, fused_step=True),
    "tree": dict(spec_draft_tokens=3, spec_tree=True, prefill_chunk_tokens=6, fused_step=True),
    "lane-spec": dict(spec_draft_tokens=3, on_device_sampling=True),
    "spill-int8": dict(kv_cache_dtype="int8", spill_enabled=True, host_tier_bytes=1 << 20),
}


@pytest.fixture(scope="module")
def weights():
    """(JAX pytree, port module) holding the same seeded weights."""
    jp = JaxLlama(JAX_TINY).init(jax.random.key(0))
    model = LlamaForCausalLM(TINY, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), TINY, device="cpu"))
    return jp, model


def _port(model, max_new=6, **knobs):
    return PagedServingEngine(
        InferenceEngine(TINY, model, **ENGINE_KW), GenerationConfig(max_new_tokens=max_new),
        PagedConfig(**{**POOL, **knobs}),
    )


def _jax(jp, max_new=6, **knobs):
    return JaxPagedServingEngine(
        JaxInferenceEngine(JAX_TINY, jp, **ENGINE_KW), JaxGenerationConfig(max_new_tokens=max_new),
        JaxPagedConfig(**{**POOL, **knobs}), precompile=False,
    )


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY.vocab_size, size=(n,)).tolist() for n in lengths]


def _run(eng, prompts):
    for p in prompts:
        eng.submit(p)
    return eng.run_to_completion()


# -- cost profiles and the HBM ledger ---------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_cost_table_lines_match_jax(weights, case):
    """The analytic cost table of every catalog key, line for line the JAX
    package's for the same PagedConfig (the JAX engine is built, not
    run): the same dimensions, formulas and keys."""
    jp, model = weights
    port, jax_eng = _port(model, **CASES[case]), _jax(jp, **CASES[case])
    assert dataclasses.asdict(acc.EngineDims.from_engine(port)) == dataclasses.asdict(
        jax_acc.EngineDims.from_engine(jax_eng))
    lines = acc.cost_table_lines(acc.analytic_profiles(port))
    assert lines == jax_acc.cost_table_lines(jax_acc.analytic_profiles(jax_eng))
    assert len(lines) == len(port.catalog.keys())
    # and every profile's roofline and dict rendering agree at the same peaks
    # (keyed by label: the two packages' SamplingConfig classes differ)
    want = {p.label: p for p in jax_acc.analytic_profiles(jax_eng).values()}
    for p in acc.analytic_profiles(port).values():
        w = want[p.label]
        assert p.roofline_mfu(197e12, 819e9) == w.roofline_mfu(197e12, 819e9)
        assert {k: v for k, v in p.to_dict().items() if k != "roofline_mfu"} == {
            k: v for k, v in w.to_dict().items() if k != "roofline_mfu"}


@pytest.mark.parametrize("case", ["bf16", "int8"])
def test_hbm_ledger_matches_jax(weights, case):
    """At a stated budget the ledger's parameter, pool, resident and
    workspace bytes, footprint and headroom are the JAX package's."""
    jp, model = weights
    port, jax_eng = _port(model, **CASES[case]), _jax(jp, **CASES[case])
    budget = 1 << 28
    got = acc.hbm_ledger(port, acc.analytic_profiles(port), budget_bytes=budget)
    want = jax_acc.hbm_ledger(jax_eng, jax_acc.analytic_profiles(jax_eng), budget_bytes=budget)
    assert got.to_dict() == want.to_dict()
    assert got.param_bytes == sum(p.nbytes for p in model.parameters())
    c = port.cache
    assert got.pool_bytes == sum(x.nbytes for x in (c.k, c.v) + (
        (c.k_scale, c.v_scale) if c.quantized else ()))
    assert got.footprint_bytes == (got.param_bytes + got.pool_bytes + got.resident_bytes
                                   + got.workspace_bytes)


def test_profiles_are_analytic_and_peaks_are_the_h100s(weights):
    """No profile claims XLA provenance, and the MFU denominators are the
    H100's (flops.py), not the JAX package's TPU figures."""
    port = _port(weights[1], prewarm=True)
    assert port.cost_profiles and set(port.cost_profiles) == set(port.program_registry())
    srcs = {p.flops_source for p in port.cost_profiles.values()}
    assert srcs == {"analytic"}
    assert {p.flops_source for p in acc.analytic_profiles(port).values()} == {
        "analytic", "analytic-move"}
    m = port.metrics
    assert m.peak_flops_per_chip == flops.H100_BF16_FLOPS_PER_S == 989e12
    assert m.peak_hbm_bw_per_chip == flops.H100_HBM_BYTES_PER_S
    p = next(iter(port.cost_profiles.values()))
    assert p.roofline_mfu() == p.roofline_mfu(989e12, 3.35e12)
    assert acc.device_hbm_budget() == flops.H100_HBM_BYTES
    assert port.hbm.budget_bytes == int(flops.H100_HBM_BYTES)
    # each kv rung's decode roofline, from its plain decode profile
    assert set(m.mfu_by_rung) == set(port._kv_buckets)
    assert all(0.0 < r["roofline_mfu"] <= 1.0 for r in m.mfu_by_rung.values())


def test_default_prewarmed_engine_reports_mfu(weights):
    """A default PagedConfig engine, prewarmed: every registered program
    carries a profile, and a serve reports a nonzero MFU and bandwidth
    utilization."""
    port = PagedServingEngine(
        InferenceEngine(TINY, weights[1], **ENGINE_KW), GenerationConfig(max_new_tokens=6),
        PagedConfig(prewarm=True),
    )
    assert port.metrics.cost_profiled_programs == len(port.program_registry()) > 0
    _run(port, _prompts(0, (5, 11, 20)))
    snap = port.metrics.snapshot(port.allocator, port.index)
    # the snapshot rounds to 6 places, below which the tiny model's share
    # of an H100 lies: the estimates themselves are read
    assert port.metrics.mfu_estimate() > 0 and port.metrics.bandwidth_util_estimate() > 0
    assert snap["achieved_flops_per_s"] > 0
    assert snap["cost_profiled_programs"] == len(port.program_registry())
    assert snap["hbm_headroom_bytes"] > 0
    prom = port.metrics.prometheus()
    assert "serving_dispatched_flops" in prom and "serving_roofline_mfu_rung{rung=" in prom


def test_hbm_budget_override(weights):
    budget = 1 << 28
    port = _port(weights[1], prewarm=True, hbm_budget_bytes=budget)
    assert port.hbm.budget_bytes == port.metrics.hbm_budget_bytes == budget
    assert port.metrics.hbm_headroom_bytes == budget - port.hbm.footprint_bytes


@pytest.mark.parametrize("case", ["bf16", "fused"])
def test_dispatched_flops_match_jax(weights, case):
    """The same prewarmed serve on both engines folds the same FLOPs and
    bytes: the port's harvest at the end of its prewarm, the JAX engine's
    fold given the analytic figures of its own keys (its harvest reads
    XLA's cost analysis instead)."""
    jp, model = weights
    knobs = dict(CASES[case], prewarm=True, kv_buckets=(8, 16), prefill_buckets=(8, 16))
    port, jax_eng = _port(model, **knobs), _jax(jp, **knobs)
    jax_eng._flops_by_key = {
        k: (p.flops, p.bytes_accessed)
        for k, p in jax_acc.analytic_profiles(jax_eng).items()
        if p.kind in jax_acc.COMPUTE_KINDS
    }
    labels = {format_key(k) for k in port._flops_by_key}
    assert labels == {format_key(k) for k in port.program_registry()}
    assert labels <= {format_key(k) for k in jax_eng._flops_by_key}
    prompts = _prompts(1, (5, 11, 14))
    assert _run(port, prompts) == _run(jax_eng, prompts)
    pm, jm = port.metrics, jax_eng.metrics
    assert pm.compute_dispatches == jm.compute_dispatches > 0
    assert pm.dispatched_flops == jm.dispatched_flops > 0
    assert pm.dispatched_bytes == jm.dispatched_bytes > 0
    assert pm.decode_pad_by_rung == jm.decode_pad_by_rung
    assert pm.prefill_pad_by_rung == jm.prefill_pad_by_rung


def test_cost_accounting_changes_no_tokens_uploads_or_programs(weights):
    """The JAX package's zero-interference contract: accounting on or off
    serves the same tokens with the same uploads, lane syncs, table deltas
    and programs; only the ledger differs."""
    prompts = _prompts(3, (5, 9, 13))

    def run(on):
        port = _port(weights[1], max_new=10, prewarm=True, async_loop=True,
                     kv_buckets=(8, 16), prefill_buckets=(8, 16), cost_accounting=on)
        out = _run(port, prompts)
        m = port.metrics
        return port, out, (m.h2d_uploads, m.lane_syncs, m.table_deltas, m.compute_dispatches,
                           m.decode_steps), sorted(map(str, port.program_registry()))

    on, out_on, counts_on, progs_on = run(True)
    off, out_off, counts_off, progs_off = run(False)
    assert (out_on, counts_on, progs_on) == (out_off, counts_off, progs_off)
    assert on.metrics.cost_profiled_programs == len(progs_on)
    assert on.metrics.dispatched_flops > 0
    assert off.cost_profiles is None and off.metrics.cost_profiled_programs == 0
    assert off.metrics.dispatched_flops == 0.0


# -- the SLO monitor --------------------------------------------------------------


def _drive(monitor_cls, policy_cls, metrics_cls, script, **policy):
    """Feed ``script`` (per step: (tpot ms, ttft ms, class) observations)
    through a monitor; returns each step's (alert, burn gauges, per-class
    burns) and the alert count."""
    m = metrics_cls()
    mon = monitor_cls(policy_cls(**policy), m)
    trace = []
    for step, obs in enumerate(script, start=1):
        for tpot, ttft, cls in obs:
            if tpot is not None:
                m.hist_tpot_ms.observe(tpot)
                m.observe_class_latency("tpot", cls, tpot)
            if ttft is not None:
                m.hist_ttft_ms.observe(ttft)
                m.observe_class_latency("ttft", cls, ttft)
        alert = mon.on_step(step)
        trace.append((alert, m.slo_burn_ttft, m.slo_burn_tpot,
                      {c: dict(v) for c, v in m.slo_burn_by_class.items()}))
    return trace, m.slo_alerts


SLO_SCRIPTS = {
    # the JAX package's sustained-burn drive: misses, then a drained window
    "sustained": (dict(tpot_p99_ms=1.0, eval_steps=1, window_evals=2),
                  [[(10.0, None, "batch")] * 50] * 2 + [[], []]),
    # off-cadence steps are not evaluated
    "cadence": (dict(tpot_p99_ms=1.0, eval_steps=8, window_evals=1),
                [[(10.0, None, "batch")] * 10] + [[]] * 8),
    # both objectives, two service classes, a mix of hits and misses
    "mixed": (dict(ttft_p99_ms=50.0, tpot_p99_ms=5.0, eval_steps=2, window_evals=3,
                   burn_threshold=20.0),
              [[(3.0, 40.0, "interactive"), (7.5, 80.0, "batch")] * (i % 4)
               for i in range(24)]),
}


@pytest.mark.parametrize("name", sorted(SLO_SCRIPTS))
def test_slo_monitor_matches_jax(name):
    """The same observations through the port's monitor and the JAX
    package's: the same alert at every step, the same burn gauges and
    per-class burns, the same alert count."""
    policy, script = SLO_SCRIPTS[name]
    got = _drive(SLOMonitor, SLOPolicy, ServingMetrics, script, **policy)
    want = _drive(JaxSLOMonitor, JaxSLOPolicy, JaxMetrics, script, **policy)
    assert got == want
    assert got[1] > 0 or name == "mixed"


def test_slo_policy_from_paged_matches_jax():
    knobs = dict(slo_ttft_p99_ms=80.0, slo_tpot_p99_ms=4.0, slo_eval_steps=0,
                 slo_burn_window=3, slo_burn_threshold=2.5)
    got = SLOPolicy.from_paged(PagedConfig(**knobs))
    want = JaxSLOPolicy.from_paged(JaxPagedConfig(**knobs))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.active and not SLOPolicy().active
    assert got.budget == pytest.approx(0.01)


def test_engine_slo_alerts_match_jax(weights):
    """The monitor driven from the engine's step: with a 1 ms TPOT target
    and a synthetic 50 ms observation every step, both engines evaluate at
    the same steps and raise the same alerts; the alert lands in the
    flight recorder."""
    jp, model = weights
    knobs = dict(slo_tpot_p99_ms=1.0, slo_eval_steps=2, slo_burn_window=2,
                 trace_enabled=True)
    port, jax_eng = _port(model, max_new=12, **knobs), _jax(jp, max_new=12, **knobs)
    trace = {}
    for eng in (port, jax_eng):
        eng.submit(_prompts(7, (5,))[0])
        burns = []
        while eng.step():
            eng.metrics.hist_tpot_ms.observe(50.0)
            burns.append((eng.metrics.slo_alerts, eng.metrics.slo_burn_tpot))
        trace[eng is port] = burns
    assert trace[True] == trace[False]
    assert port.metrics.slo_alerts == jax_eng.metrics.slo_alerts >= 1
    assert any(e["name"] == "slo_burn" for e in port.tracer.chrome_events())
    # no objective declared: no monitor, no gauge moves
    plain = _port(model)
    assert plain._slo is None
