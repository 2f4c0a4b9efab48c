"""The port's fault tolerance (``serving/faults.py``, ``serving/invariants.py``
and the engine's failure domains) against the JAX package's, on the CPU
at the tiny config (fp32) with the same weights and the same FaultPlan.

A fault (an injected device error, NaN logits, a drafter bug, a
transient alloc failure, transfer latency) aborts only the request it
hits. Both engines get a fresh injector built from the same plan, and
the port must match the JAX engine fault for fault: the same
``injector.fired`` (step, kind, site, lanes), the same failed requests
with the same statuses and error strings, the same survivors' streams,
and the same ``failed_requests``, ``lane_quarantines`` and
``faults_injected``. The survivors' streams must also equal a fault-free
run of the port, and a failed request's partial output is a prefix of
its fault-free stream.

Latency faults are held by outcome only: the port's lane-set flush
uploads once for all dirty lanes where the JAX engine uploads per lane,
so the plan's rng, drawn at every upload, fires at other points there.
With ``latency_rate`` 0 the upload count draws nothing and every other
kind fires fired-for-fired.

The decoder layers' kernels are scaled by 10 from the init (as in
tests/test_torch_async.py): at the init scale every greedy stream
repeats one token, which would hide a token committed one step off.
"""

import dataclasses
import json
import logging

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
    EngineStalledError as JaxEngineStalledError,
    FaultInjector as JaxFaultInjector,
    FaultPlan as JaxFaultPlan,
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
from neuronx_distributed_llama3_2_tpu_torch.serving.block_allocator import (
    AllocatorError,
    BlockAllocator,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.faults import (
    FAULT_KINDS,
    EngineStalledError,
    FaultInjector,
    FaultPlan,
    InjectedFault,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.invariants import (
    InvariantViolation,
    audit_engine,
)
from neuronx_distributed_llama3_2_tpu_torch.serving import engine as engine_module
from neuronx_distributed_llama3_2_tpu_torch.serving.engine import (
    PagedConfig,
    PagedServingEngine,
    make_serving_engine,
)

torch.set_num_threads(1)

JAX_TINY = dataclasses.replace(JAX_CONFIGS["tiny"], use_paged_kernel=True)
TINY = dataclasses.replace(LLAMA_CONFIGS["tiny"], use_paged_kernel=True)
ENGINE_KW = dict(max_batch=4, max_seq_len=64, buckets=[8, 16, 32])
LAYER_SCALE = 10.0
SAMPLED = dict(greedy=False, temperature=0.8, top_k=40, top_p=0.9)

PLAIN = dict(block_size=8, num_blocks=64)
ASYNC = dict(PLAIN, async_loop=True)
SPEC = dict(PLAIN, spec_draft_tokens=4)
FUSED = dict(PLAIN, prefill_chunk_tokens=6, fused_step=True)


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


def _rep_prompts(seed, lengths, period=3):
    """Repetitive prompts, so that the n-gram drafter proposes."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        pat = rng.integers(1, 9, size=period).tolist()
        out.append((pat * (n // period + 1))[:n])
    return out


PLAIN_PROMPTS = _prompts(3, (5, 12, 20, 9))
REP_PROMPTS = _rep_prompts(6, (9, 12, 15))


def _port(model, max_new, paged, plan=None, drafter=None, sampled=False):
    gen = GenerationConfig(
        max_new_tokens=max_new,
        sampling=SamplingConfig(**SAMPLED) if sampled else SamplingConfig(),
    )
    return PagedServingEngine(
        InferenceEngine(TINY, model, **ENGINE_KW), gen, PagedConfig(**paged),
        drafter=drafter, injector=None if plan is None else FaultInjector(FaultPlan(**plan)),
    )


def _jax(jp, max_new, paged, plan=None, drafter=None, sampled=False):
    gen = JaxGenerationConfig(
        max_new_tokens=max_new,
        sampling=JaxSamplingConfig(**SAMPLED) if sampled else JaxSamplingConfig(),
    )
    return JaxPagedServingEngine(
        JaxInferenceEngine(JAX_TINY, jp, **ENGINE_KW), gen, JaxPagedConfig(**paged),
        precompile=False, drafter=drafter,
        injector=None if plan is None else JaxFaultInjector(JaxFaultPlan(**plan)),
    )


def _run(eng, prompts):
    for p in prompts:
        eng.submit(p)
    return eng.run_to_completion()


def _clean(eng):
    """A drained lookahead, an empty pool, no leak, a clean audit."""
    assert eng._pending is None
    assert eng.allocator.active_blocks == 0
    assert eng.allocator.leak_check() == []
    assert audit_engine(eng) == []


_BASELINES = {}


def _baseline(model, max_new, paged, prompts, sampled=False):
    """The port's fault-free streams for (config, workload), cached."""
    key = (json.dumps(paged, sort_keys=True), json.dumps(prompts), max_new, sampled)
    if key not in _BASELINES:
        _BASELINES[key] = _run(_port(model, max_new, paged, sampled=sampled), prompts)
    return _BASELINES[key]


def _outcome(eng):
    """What a faulted serve is held to, engine for engine."""
    m = eng.metrics
    return dict(
        fired=None if eng.injector is None else list(eng.injector.fired),
        info={rid: (eng.request_info(rid)["status"], eng.request_info(rid)["error"])
              for rid in sorted(eng._requests)},
        outs={rid: list(r.out) for rid, r in sorted(eng._finished.items())},
        failed_requests=m.failed_requests, lane_quarantines=m.lane_quarantines,
        faults_injected=m.faults_injected,
    )


def _faulted_pair(weights, max_new, paged, prompts, plan, drafter=None, sampled=False):
    """Serve ``prompts`` through both engines under ``plan``: the port's
    outcome equals the JAX engine's, the port drains clean, and its
    survivors equal its fault-free run. Returns (port engine, outcome)."""
    jp, model = weights
    jax_eng = _jax(jp, max_new, paged, plan, drafter=drafter, sampled=sampled)
    port = _port(model, max_new, paged, plan, drafter=drafter, sampled=sampled)
    _run(jax_eng, prompts)
    _run(port, prompts)
    got, want = _outcome(port), _outcome(jax_eng)
    assert got == want
    _clean(port)
    base = _baseline(model, max_new, paged, prompts, sampled=sampled)
    for rid, (status, error) in got["info"].items():
        out = got["outs"][rid]
        if status == "failed":
            assert error and out == base[rid][: len(out)]
        else:
            assert status == "finished" and error is None and out == base[rid]
    return port, got


def _n_failed(outcome):
    return sum(status == "failed" for status, _ in outcome["info"].values())


# -- the injector and the allocator ------------------------------------------------


def _drive(inj):
    for step in range(30):
        inj.begin_step(step)
        inj.device_fault("decode", [0, 1, 2, 3])
        inj.nan_lanes("decode", [0, 1])
        inj.alloc_fault()
        try:
            inj.drafter_fault()
        except RuntimeError:
            pass
    return list(inj.fired)


def test_injector_is_deterministic_and_matches_jax():
    plan = dict(seed=5, device_rate=0.3, nan_rate=0.2, alloc_rate=0.1, drafter_rate=0.2,
                schedule=((4, "nan"), (7, "device")))
    fired = _drive(FaultInjector(FaultPlan(**plan)))
    assert fired == _drive(FaultInjector(FaultPlan(**plan)))
    assert fired == _drive(JaxFaultInjector(JaxFaultPlan(**plan)))
    assert {f[1] for f in fired} == {"device", "nan", "alloc", "drafter"}
    assert FaultInjector(FaultPlan(**plan)).total_fired == 0  # nothing until consulted


def test_injector_schedule_fires_exactly_once():
    for cls, plan_cls in ((FaultInjector, FaultPlan), (JaxFaultInjector, JaxFaultPlan)):
        inj = cls(plan_cls(schedule=((3, "device"), (3, "drafter"))))
        assert inj.wants("device") and inj.wants("drafter") and not inj.wants("nan")
        for step in range(10):
            inj.begin_step(step)
            inj.device_fault("decode", [0, 1])
            try:
                inj.drafter_fault()
            except RuntimeError as exc:
                assert isinstance(exc, InjectedFault) == (cls is FaultInjector)
        assert inj.counts["device"] == 1 and inj.counts["drafter"] == 1
        assert [f[0] for f in inj.fired] == [3, 3]


def test_fault_plan_rejects_unknown_kind():
    assert "host_tier" in FAULT_KINDS  # declared, its hook comes with the spill tier
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan(schedule=((0, "gremlin"),))


def test_make_serving_engine_takes_an_injector(weights):
    eng = InferenceEngine(TINY, weights[1], **ENGINE_KW)
    inj = FaultInjector(FaultPlan(schedule=((1, "alloc"),)))
    paged = make_serving_engine(eng, paged=PagedConfig(**PLAIN), injector=inj)
    assert paged.injector is inj
    assert paged.allocator.fault_hook == inj.alloc_fault
    assert inj.on_fire == paged._trace_fault
    assert not paged._check_logits  # the plan fires no nan
    with pytest.raises(ValueError, match="paged"):
        make_serving_engine(eng, injector=FaultInjector(FaultPlan()))


@pytest.mark.parametrize("case", ["double release", "incref after free", "leak", "fault hook"])
def test_allocator_typed_errors(case):
    a = BlockAllocator(num_blocks=8, block_size=4)
    b = a.alloc()
    if case == "double release":
        a.release(b)
        with pytest.raises(AllocatorError, match="double release") as ei:
            a.release(b)
        assert ei.value.bid == b and ei.value.op == "release"
    elif case == "incref after free":
        a.release(b)
        with pytest.raises(AllocatorError, match="not allocated") as ei:
            a.incref(b)
        assert ei.value.bid == b and ei.value.op == "incref"
    elif case == "leak":
        assert a.leak_check() == []
        a._free.append(b)  # a registered block also on the free list
        assert b in a.leak_check()
        a._free.pop()
        a.release(b)
        assert a.leak_check() == []
    else:
        a.release(b)
        fires = iter([True, False])
        a.fault_hook = lambda: next(fires)
        assert a.alloc() is None and a.free_blocks == 7  # injected, pool untouched
        b = a.alloc()
        assert b is not None
        a.release(b)
        assert a.leak_check() == []


# -- the stall watchdog ------------------------------------------------------------


def test_stall_watchdog_names_stuck_work(weights):
    jp, model = weights
    paged = dict(block_size=8, num_blocks=32, stall_step_limit=3)
    errors = []
    for eng, err in ((_jax(jp, 4, paged), JaxEngineStalledError),
                     (_port(model, 4, paged), EngineStalledError)):
        eng.submit([1, 2, 3])
        eng._free_lanes.clear()  # wedged: queued work, no lane can open
        with pytest.raises(err) as ei:
            for _ in range(10):
                eng.step()
        errors.append((ei.value.limit, ei.value.active, ei.value.queued, str(ei.value)))
    assert errors[0] == errors[1]
    assert errors[1][:3] == (3, {}, [0]) and "no progress for 3" in errors[1][3]


def test_watchdog_tolerates_slow_but_progressing_steps(weights):
    """Latency faults on every transfer: held by outcome (see the module
    note), the streams equal the JAX engine's and nothing fails."""
    jp, model = weights
    paged = dict(block_size=8, num_blocks=32, stall_step_limit=2)
    plan = dict(latency_rate=1.0, latency_ms=0.1)
    prompts = _prompts(0, (5, 9))
    jax_eng, port = _jax(jp, 6, paged, plan), _port(model, 6, paged, plan)
    assert _run(port, prompts) == _run(jax_eng, prompts)
    assert port.injector.counts["latency"] > 0
    assert port.metrics.failed_requests == 0
    assert port.metrics.faults_injected == port.injector.counts["latency"]
    _clean(port)


# -- failure domains: one lane dies, the rest are untouched ------------------------


def test_prefill_fault_fails_only_the_admitting_request(weights):
    port, got = _faulted_pair(weights, 10, PLAIN, PLAIN_PROMPTS,
                              dict(schedule=((0, "device"),)))
    assert got["fired"][0][1:3] == ("device", "prefill")
    assert _n_failed(got) == 1 and got["failed_requests"] == 1


@pytest.mark.parametrize("paged", [PLAIN, ASYNC], ids=["sync", "async"])
def test_decode_fault_fails_one_lane_others_identical(weights, paged):
    port, got = _faulted_pair(weights, 10, paged, PLAIN_PROMPTS,
                              dict(seed=2, schedule=((6, "device"),)))
    assert [f[1:3] for f in got["fired"]] == [("device", "decode")]
    assert _n_failed(got) == 1 and got["faults_injected"] == 1


@pytest.mark.parametrize("paged", [ASYNC, SPEC], ids=["async", "spec"])
def test_nan_quarantine_fails_the_poisoned_lane(weights, paged):
    """Six requests on four lanes: a waiting request takes the quarantined
    lane, so a poison mask left set past its step would fail it too."""
    port, got = _faulted_pair(weights, 10, paged, REP_PROMPTS + _rep_prompts(7, (10, 7, 13)),
                              dict(seed=3, schedule=((5, "nan"),)))
    assert port._check_logits  # a nan plan implies the checked programs
    assert all(k[-1] for k in port._programs if k[0] in ("pdecode", "pverify"))
    assert got["lane_quarantines"] == 1 and _n_failed(got) == 1
    failed = [err for status, err in got["info"].values() if status == "failed"]
    assert "non-finite" in failed[0]


def test_nan_quarantine_under_on_device_sampling(weights):
    """A poisoned lane's draw is garbage and never committed, and the other
    lanes' keyed draws do not move: the sampled survivors equal the JAX
    engine's and the port's own fault-free sampled streams."""
    paged = dict(ASYNC, on_device_sampling=True)
    port, got = _faulted_pair(weights, 10, paged, PLAIN_PROMPTS,
                              dict(seed=3, schedule=((4, "nan"),)), sampled=True)
    assert got["lane_quarantines"] == 1 and _n_failed(got) == 1
    assert port.metrics.sampled_steps > 0


@pytest.mark.parametrize("kind", ["device", "nan"])
def test_fused_step_fault_fails_one_lane_others_identical(weights, kind):
    """A fault at the one mixed dispatch of a fused step still fails one
    lane; the survivors equal the unfused fault-free run too."""
    port, got = _faulted_pair(weights, 10, FUSED, PLAIN_PROMPTS,
                              dict(seed=4, schedule=((2, kind),)))
    assert got["fired"][0][1:3] == (kind, "mixed")
    assert port.metrics.mixed_dispatches > 0
    assert got["lane_quarantines"] == (kind == "nan")
    assert _n_failed(got) == 1
    unfused = _baseline(weights[1], 10, dict(FUSED, fused_step=False), PLAIN_PROMPTS)
    for rid, (status, _) in got["info"].items():
        if status == "finished":
            assert got["outs"][rid] == unfused[rid]


def test_detect_nonfinite_clean_run_changes_nothing(weights):
    jp, model = weights
    paged = dict(ASYNC, detect_nonfinite=True)
    jax_eng, port = _jax(jp, 10, paged), _port(model, 10, paged)
    assert port._check_logits
    out = _run(port, PLAIN_PROMPTS)
    assert out == _run(jax_eng, PLAIN_PROMPTS) == _baseline(model, 10, ASYNC, PLAIN_PROMPTS)
    assert port.metrics.lane_quarantines == 0
    assert not port._poisoned  # no nan fired: no mask written
    _clean(port)


def test_drafter_fault_is_absorbed_without_failing_requests(weights):
    port, got = _faulted_pair(weights, 10, SPEC, REP_PROMPTS,
                              dict(seed=9, drafter_rate=0.5))
    assert port.injector.counts["drafter"] > 0
    assert port.metrics.drafter_faults == port.injector.counts["drafter"]
    assert _n_failed(got) == 0


def test_real_drafter_exception_is_absorbed_too(weights):
    class BuggyDrafter:
        def propose(self, history, max_tokens):
            raise ZeroDivisionError("drafter bug")

    jp, model = weights
    port = _port(model, 10, SPEC, drafter=BuggyDrafter())
    out = _run(port, REP_PROMPTS)
    assert out == _run(_jax(jp, 10, SPEC, drafter=BuggyDrafter()), REP_PROMPTS)
    assert port.metrics.drafter_faults > 0 and port.metrics.failed_requests == 0


def test_alloc_fault_causes_backoff_not_failure(weights):
    port, got = _faulted_pair(weights, 10, PLAIN, PLAIN_PROMPTS,
                              dict(seed=12, alloc_rate=0.25))
    assert port.injector.counts["alloc"] > 0
    assert _n_failed(got) == 0


# -- request lifecycle and the auditor ------------------------------------------------


def test_request_info_status_lifecycle(weights):
    jp, model = weights
    paged = dict(block_size=4, num_blocks=10, decode_reserve_blocks=1,
                 prefill_chunk_tokens=4, audit_debug=True)
    prompts = _prompts(13, (14, 14, 12))
    seen = []
    for eng in (_jax(jp, 12, paged), _port(model, 12, paged)):
        for p in prompts:
            eng.submit(p)
        trail = [sorted(eng.request_info(r)["status"] for r in eng._requests)]
        alive = True
        while alive:
            alive = eng.step()
            trail.append(sorted(eng.request_info(r)["status"] for r in eng._requests))
            assert len(trail) < 500
        seen.append(trail)
    # strict audits at every finish and preemption passed on both
    assert seen[0] == seen[1]
    walked = {s for statuses in seen[1] for s in statuses}
    assert {"queued", "prefilling", "active", "preempted", "finished"} <= walked
    assert seen[1][-1] == ["finished"] * 3
    _clean(eng)


def test_auditor_passes_mid_flight_and_detects_corruption(weights):
    port = _port(weights[1], 16, dict(PLAIN, audit_interval=2))
    for p in _prompts(14, (5, 12, 9)):
        port.submit(p)
    for _ in range(4):
        port.step()
    assert audit_engine(port) == []
    assert port.metrics.audit_violations == 0
    req = next(iter(port._active.values()))
    bid = req.table[0]
    port.allocator._ref[bid] += 1  # a phantom reference
    assert any(f"block {bid}" in v for v in audit_engine(port))
    with pytest.raises(InvariantViolation):
        port._audit(strict=True)
    assert port.metrics.audit_violations > 0
    port.allocator._ref[bid] -= 1
    # a mirror row that disagrees with its table, and a parked lane's
    # sampling mirror: both named
    lane = req.lane
    port._tables[lane, 0] += 1
    assert any("mirror row" in v for v in audit_engine(port))
    port._tables[lane, 0] -= 1
    assert audit_engine(port) == []
    port.run_to_completion()
    _clean(port)


def test_periodic_audit_counts_violations_without_raising(weights):
    port = _port(weights[1], 8, dict(PLAIN, audit_interval=1))
    port.submit(_prompts(15, (6,))[0])
    port.step()
    req = next(iter(port._active.values()))
    port.allocator._ref[req.table[0]] += 1
    port.step()  # the periodic audit logs and counts
    assert port.metrics.audit_violations > 0
    port.allocator._ref[req.table[0]] -= 1
    port.run_to_completion()


def test_fault_free_engine_builds_no_checked_programs(weights):
    port = _port(weights[1], 8, PLAIN)
    _run(port, _prompts(19, (5, 12)))
    assert port.injector is None and port._check_logits is False
    for key in port._programs:
        if key[0] in ("pdecode", "pverify", "ptree", "pmixed"):
            assert key[-1] is False
    assert all("poison" not in inputs for inputs in port._graph_inputs.values())
    m = port.metrics
    assert (m.faults_injected, m.failed_requests, m.lane_quarantines) == (0, 0, 0)


# -- prewarm: the checked catalog and the static poison buffers ------------------------


def test_prewarmed_checked_catalog_matches_jax_and_serves(weights):
    """Under prewarm with detect_nonfinite the manifest lists the checked
    keys, line for line the JAX engine's; every record is registered (run
    eagerly on the CPU) before traffic, a nan fault through the async loop
    quarantines one lane fired-for-fired with JAX, no key is registered
    after the freeze, and a clean step's poison mask is cleared on the
    device, not uploaded."""
    jp, model = weights
    paged = dict(ASYNC, detect_nonfinite=True, spec_draft_tokens=3)
    plan = dict(seed=3, schedule=((5, "nan"),))
    port = _port(model, 10, dict(paged, prewarm=True), plan)
    jax_eng = _jax(jp, 10, paged, plan)
    assert port.catalog.lines() == jax_eng.catalog.lines()
    assert any(line.endswith(",checked]") for line in port.catalog.lines())
    assert port.metrics.prewarm_compiles == len(port.catalog.graph_keys())
    assert all(k[-1] for k in port._programs if k[0] in ("pdecode", "pverify"))
    _run(jax_eng, REP_PROMPTS)
    _run(port, REP_PROMPTS)
    assert _outcome(port) == _outcome(jax_eng)
    assert port.metrics.lane_quarantines == 1
    assert port.metrics.steadystate_compiles == 0
    assert not port._poisoned
    for kind in ("pdecode", "pverify"):
        assert int(port._graph_inputs[kind]["poison"].abs().sum()) == 0
    _clean(port)


def test_clean_checked_steady_state_uploads_nothing(weights):
    """A checked decode step whose mask stays clean adds no upload: the
    async steady state of a detect_nonfinite engine uploads as much as the
    unchecked engine's."""
    _, model = weights
    uploads = []
    for checked in (False, True):
        port = _port(model, 10, dict(ASYNC, detect_nonfinite=checked))
        _run(port, PLAIN_PROMPTS)
        uploads.append(port.metrics.h2d_uploads)
    assert uploads[0] == uploads[1]


# -- the flight recorder and the metrics log --------------------------------------------


def test_trace_export_records_faults_and_failures(weights, tmp_path):
    port = _port(weights[1], 10, dict(PLAIN, trace_enabled=True),
                 dict(seed=2, schedule=((6, "device"),)))
    _run(port, PLAIN_PROMPTS)
    path = port.export_trace(str(tmp_path / "trace.json"))
    events = json.loads(open(path).read())
    events = events["traceEvents"] if isinstance(events, dict) else events
    names = {e.get("name") for e in events}
    assert {"fault", "request_failed", "dispatch", "readback"} <= names
    fault = next(e for e in events if e.get("name") == "fault")
    assert fault["args"]["kind"] == "device" and fault["args"]["site"] == "decode"
    # off by default: the recorder stays empty
    quiet = _port(weights[1], 4, PLAIN)
    _run(quiet, PLAIN_PROMPTS[:1])
    assert not quiet.tracer.enabled


def test_metrics_log_every(weights):
    """One metrics line every ``metrics_log_every`` decode steps, the
    snapshot as JSON."""
    port = _port(weights[1], 8, dict(PLAIN, metrics_log_every=3))
    lines = []

    class Recorder(logging.Handler):
        def emit(self, record):
            if "serving metrics" in record.getMessage():
                lines.append(record.getMessage())

    handler = Recorder(level=logging.INFO)
    serving_logger = engine_module.logger
    level = serving_logger.level
    serving_logger.addHandler(handler)
    serving_logger.setLevel(logging.INFO)
    try:
        _run(port, PLAIN_PROMPTS[:2])
    finally:
        serving_logger.removeHandler(handler)
        serving_logger.setLevel(level)
    assert len(lines) == port.metrics.decode_steps // 3 >= 2
    steps = [json.loads(line.split("serving metrics: ", 1)[1])["decode_steps"] for line in lines]
    assert steps == [3 * (i + 1) for i in range(len(lines))]


@pytest.mark.parametrize("paged,step", [(PLAIN, 0), (dict(PLAIN, prefill_chunk_tokens=6), 1)],
                         ids=["prefill", "chunk"])
def test_host_sampled_prefill_fault_keeps_the_key_chain(weights, paged, step):
    """Host sampling under a device fault that stops a prefill (an
    admission's, or a chunk's): the JAX engine split its key before the
    fault fired, so the port advances its chain there too, and every
    survivor's sampled stream stays the JAX engine's token for token."""
    jp, model = weights
    plan = dict(schedule=((step, "device"),))
    jax_eng = _jax(jp, 8, paged, plan, sampled=True)
    port = _port(model, 8, paged, plan, sampled=True)
    prompts = _prompts(3, (5, 12, 20, 9))
    _run(jax_eng, prompts)
    _run(port, prompts)
    got, want = _outcome(port), _outcome(jax_eng)
    assert got == want
    assert [f[2] for f in got["fired"]] == ["prefill"] and _n_failed(got) == 1
    _clean(port)
    assert sum(len(o) for o in got["outs"].values()) > 3 * 8 - 8
