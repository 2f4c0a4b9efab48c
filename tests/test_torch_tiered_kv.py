"""The port's tiered KV storage (the host-RAM spill tier behind the radix
index) against the JAX package's, on the CPU at the tiny config (fp32) with
the same weights.

The workload is the JAX package's churn (``tests/test_tiered_kv.py``): a
12-block pool of 8-row blocks, a 20-token shared prefix served once,
four fillers that evict it, then two requests that re-hit it with
different tails (the prefix ends mid-block, so the re-hit copies the
restored partial block on write). Both engines serve it; the port must
match the JAX engine stream for stream and counter for counter, and the
payloads it restores must carry the JAX engine's bits. The decoder
layers' kernels are scaled by 10 from the init (as in
``tests/test_torch_async.py``): at the init scale every greedy stream
repeats one token, and a corrupted restore would not show.

``h2d_uploads`` is held as the spill tier's share: the port's lane-set
flush uploads once for all dirty lanes where the JAX engine uploads per
lane, so the totals differ by the same amount with and without spill;
the difference each engine's spill run adds to its own resident run must
be equal.
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
from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
    GenerationConfig,
    InferenceEngine,
)
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
from neuronx_distributed_llama3_2_tpu_torch.serving.faults import FaultInjector, FaultPlan
from neuronx_distributed_llama3_2_tpu_torch.serving.invariants import audit_engine
from neuronx_distributed_llama3_2_tpu_torch.serving.policy import ActionType
from neuronx_distributed_llama3_2_tpu_torch.serving.radix_index import SPILLED_BLOCK

torch.set_num_threads(1)

JAX_TINY = dataclasses.replace(JAX_CONFIGS["tiny"], use_paged_kernel=True)
TINY = dataclasses.replace(LLAMA_CONFIGS["tiny"], use_paged_kernel=True)
ENGINE_KW = dict(max_batch=2, max_seq_len=64, buckets=[8, 16, 32])
LAYER_SCALE = 10.0
POOLS = ("bf16", "int8")
#: the churn's configurations: the fp pool, the int8 pool (scale tiles
#: with the payloads), and tree speculation in the fused step
CHURNS = {
    "bf16": dict(),
    "int8": dict(kv_cache_dtype="int8"),
    "tree-fused": dict(spec_draft_tokens=3, spec_tree=True, prefill_chunk_tokens=6,
                       fused_step=True),
}

#: the spill tier's counters, held to the JAX engine's
COUNTERS = (
    "blocks_spilled", "blocks_restored", "restore_hits", "restore_bytes",
    "restore_declined", "restore_fallbacks", "restore_uploads", "spill_bytes",
    "cached_tokens", "prefill_tokens", "admitted",
)


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


def _churn_prompts(seed=7, n_fillers=4, prefix_tokens=20):
    """The JAX package's churn: a 20-token prefix (2.5 blocks), and
    fillers of 20 tokens."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, TINY.vocab_size, size=(prefix_tokens,)).tolist()
    fillers = [rng.integers(0, TINY.vocab_size, size=(20,)).tolist() for _ in range(n_fillers)]
    return shared, fillers


def _knobs(spill, kv_dtype="bf16", crossover=1e9, **kw):
    kw.setdefault("kv_cache_dtype", kv_dtype)
    return dict(
        block_size=8, num_blocks=12, spill_enabled=spill,
        host_tier_bytes=(1 << 30) if spill else 0,
        restore_crossover=crossover if spill else 1.0, **kw,
    )


def _port(model, knobs, plan=None):
    return PagedServingEngine(
        InferenceEngine(TINY, model, **ENGINE_KW), GenerationConfig(max_new_tokens=4),
        PagedConfig(**knobs), injector=None if plan is None else FaultInjector(FaultPlan(**plan)),
    )


def _jax(jp, knobs, plan=None):
    return JaxPagedServingEngine(
        JaxInferenceEngine(JAX_TINY, jp, **ENGINE_KW), JaxGenerationConfig(max_new_tokens=4),
        JaxPagedConfig(**knobs), precompile=False,
        injector=None if plan is None else JaxFaultInjector(JaxFaultPlan(**plan)),
    )


def _churn(eng):
    """Seed the shared prefix, churn the pool past eviction, re-hit the
    prefix twice with different mid-block tails. Returns the streams."""
    shared, fillers = _churn_prompts()
    outs = {}
    eng.submit(shared + [1, 2])
    outs.update(eng.run_to_completion())
    for f in fillers:
        eng.submit(f)
    outs.update(eng.run_to_completion())
    eng.submit(shared + [3, 4])
    eng.submit(shared + [5, 6])
    outs.update(eng.run_to_completion())
    return outs


def _spy_payloads(eng):
    """Record every payload the engine reads back from its host tier (the
    restores' reads), in order: (sid, payload)."""
    seen = []
    get = eng.host_tier.get

    def spy(sid):
        p = get(sid)
        if p is not None:
            seen.append((sid, p))
        return p

    eng.host_tier.get = spy
    return seen


def _clean(eng):
    assert eng._pending is None and not eng._spill_pending
    assert eng.allocator.leak_check() == []
    assert audit_engine(eng) == []


def _bits(x) -> np.ndarray:
    """A payload's raw bytes: torch tensors and numpy arrays alike, so that
    fp32, int8, fp16 scales compare bit for bit."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().ravel()
    return np.ascontiguousarray(x).view(np.uint8).ravel()


_RESIDENT = {}


def _resident(weights, case):
    """The port's and the JAX engine's churn without the spill tier:
    (port streams, port engine, JAX engine), cached per configuration."""
    if case not in _RESIDENT:
        jp, model = weights
        knobs = _knobs(False, **CHURNS[case])
        port, jax_eng = _port(model, knobs), _jax(jp, knobs)
        outs = _churn(port)
        assert outs == _churn(jax_eng)
        _RESIDENT[case] = (outs, port, jax_eng)
    return _RESIDENT[case]


@pytest.mark.parametrize("case", sorted(CHURNS))
def test_churn_restores_like_jax(weights, case):
    """Spill on, every restore priced in: the streams equal the JAX
    engine's and the port's own run without spill; every spill-tier
    counter equals the JAX engine's, and the h2d uploads the tier adds."""
    jp, model = weights
    knobs = _knobs(True, **CHURNS[case])
    port, jax_eng = _port(model, knobs), _jax(jp, knobs)
    p_out, j_out = _churn(port), _churn(jax_eng)
    base, r_port, r_jax = _resident(weights, case)
    assert p_out == j_out == base
    pm, jm = port.metrics, jax_eng.metrics
    for c in COUNTERS:
        assert getattr(pm, c) == getattr(jm, c), c
    assert pm.restore_hits >= 1 and pm.blocks_restored >= 2 and pm.blocks_spilled >= 2
    assert pm.restore_uploads == pm.blocks_restored * (4 if case == "int8" else 2)
    assert (pm.h2d_uploads - r_port.metrics.h2d_uploads
            == jm.h2d_uploads - r_jax.metrics.h2d_uploads)
    assert port.allocator.cow_copies == jax_eng.allocator.cow_copies > 0
    assert port.allocator.evictions == jax_eng.allocator.evictions
    assert port.host_tier.stats() == jax_eng.host_tier.stats()
    snap = pm.snapshot(port.allocator, port.index)
    assert snap["restore_hit_rate"] == jm.snapshot(jax_eng.allocator, jax_eng.index)[
        "restore_hit_rate"] > 0
    _clean(port)


@pytest.mark.parametrize("kv_dtype", POOLS)
def test_restored_payload_bits_match_jax(weights, kv_dtype):
    """Each restored pool block holds its host payload's bits exactly, K,
    V and (int8) the scale tiles; and the payloads the port restores are
    the JAX engine's, payload for payload: an int8 payload bit for bit,
    the fp32 rows and the fp16 scales within 1e-5 (the two packages'
    fp32 projections differ in summation order, as in
    tests/test_torch_spec_serving.py's pool comparison)."""
    jp, model = weights
    port, jax_eng = _port(model, _knobs(True, kv_dtype)), _jax(jp, _knobs(True, kv_dtype))
    p_seen, j_seen = _spy_payloads(port), _spy_payloads(jax_eng)
    landed = []
    restore = port._restore_block

    def check_landed(sid, nb, payload):
        restore(sid, nb, payload)
        for x, t in zip(port._pool_tensors(), payload):
            landed.append(np.array_equal(_bits(x[:, nb]), _bits(t)))

    port._restore_block = check_landed
    _churn(port)
    _churn(jax_eng)
    assert landed and all(landed)
    assert [s for s, _ in p_seen] == [s for s, _ in j_seen] and p_seen
    for (_, p), (_, j) in zip(p_seen, j_seen):
        assert len(p) == len(j) == (2 if kv_dtype == "bf16" else 4)
        for i, (pt, jt) in enumerate(zip(p, j)):
            assert tuple(pt.shape) == jt.shape and pt.dtype.itemsize == jt.dtype.itemsize
            if kv_dtype == "int8" and i < 2:
                np.testing.assert_array_equal(_bits(pt), _bits(jt))
            else:
                np.testing.assert_allclose(
                    pt.float().numpy(), np.asarray(jt, np.float32), atol=1e-5)


def test_spilled_run_walks_and_heals(weights):
    """After the fillers the prefix's nodes are spilled (the sentinel, no
    pool id, payload in the host tier) and ``walk`` still sees them;
    after the re-hit they are resident again."""
    shared, fillers = _churn_prompts()
    port = _port(weights[1], _knobs(True))
    port.submit(shared + [1, 2])
    port.run_to_completion()
    for f in fillers:
        port.submit(f)
    port.run_to_completion()
    matched, chain = port.index.walk(shared)
    assert matched == len(shared)
    assert chain[0].block == SPILLED_BLOCK and port.host_tier.has(chain[0].sid)
    assert port.index.match(shared) == (0, [])
    _clean(port)
    port.submit(shared + [3, 4])
    port.run_to_completion()
    assert port.index.match(shared)[0] == len(shared)
    restores = [a for _, _, acts in port.action_trace for a in acts
                if a.type is ActionType.RESTORE]
    assert len(restores) == 1 and restores[0].meta["blocks"] == 3
    _clean(port)


def test_crossover_zero_declines_and_audit_spots_lost_payload(weights):
    """Crossover 0 prices every restore out: the port re-prefills the
    prefix (the insert heals the spilled chain) with the same streams and
    the same counters as the JAX engine; and invariant 9 spots a host
    payload lost behind the index's back."""
    jp, model = weights
    port, jax_eng = _port(model, _knobs(True, crossover=0.0)), _jax(jp, _knobs(True, crossover=0.0))
    assert _churn(port) == _churn(jax_eng) == _resident(weights, "bf16")[0]
    for c in COUNTERS:
        assert getattr(port.metrics, c) == getattr(jax_eng.metrics, c), c
    assert port.metrics.restore_hits == 0 and port.metrics.restore_declined > 0
    _clean(port)
    sid = next(s for s in port.index._spilled if port.host_tier.has(s))
    port.host_tier._entries.pop(sid)
    assert any("payload neither resident" in v for v in audit_engine(port))


def test_mid_crossover_prices_and_decides_like_jax(weights):
    """With the port's host-link rate and FLOP peak set to the JAX
    package's figures, a crossover between the price of restoring and of
    recomputing decides each spilled run as the JAX engine does: the same
    (restore_s, recompute_s) pairs, the same declines and restores."""
    from neuronx_distributed_llama3_2_tpu import flops as jax_flops
    from neuronx_distributed_llama3_2_tpu.serving.accounting import (
        HOST_LINK_BW_BYTES_PER_S as JAX_LINK,
    )

    jp, model = weights
    probe = _port(model, _knobs(True))
    prices = []
    probe.host_link_bw, probe.metrics.peak_flops_per_chip = JAX_LINK, jax_flops.PEAK_FLOPS_PER_CHIP
    price = probe._restore_price
    probe._restore_price = lambda n, g: prices.append(price(n, g)) or prices[-1]
    _churn(probe)
    (restore_s, recompute_s), = prices
    ratio = restore_s / recompute_s
    for xo, restored in ((0.5 * ratio, False), (2.0 * ratio, True)):
        port, jax_eng = _port(model, _knobs(True, crossover=xo)), _jax(jp, _knobs(True, crossover=xo))
        port.host_link_bw = JAX_LINK
        port.metrics.peak_flops_per_chip = jax_flops.PEAK_FLOPS_PER_CHIP
        got, want = [], []
        for eng, out in ((port, got), (jax_eng, want)):
            inner = eng._restore_price
            eng._restore_price = lambda n, g, inner=inner, out=out: out.append(inner(n, g)) or out[-1]
        assert _churn(port) == _churn(jax_eng)
        # a declined run is re-prefilled, which heals its full blocks; the
        # second re-hit then prices the partial block left spilled
        assert got and len(got) == len(want)
        np.testing.assert_allclose(got, want, rtol=1e-12)
        for c in COUNTERS:
            assert getattr(port.metrics, c) == getattr(jax_eng.metrics, c), c
        assert (port.metrics.restore_hits == 1) == restored
        assert (port.metrics.restore_declined == len(got)) == (not restored)
        _clean(port)


def test_h100_rates_price_the_run(weights):
    """The port prices a restore at its own host link and the H100's bf16
    peak, not at a TPU's figures."""
    from neuronx_distributed_llama3_2_tpu_torch import flops
    from neuronx_distributed_llama3_2_tpu_torch.serving.accounting import (
        HOST_LINK_BW_BYTES_PER_S,
        EngineDims,
        analytic_cost,
    )

    port = _port(weights[1], _knobs(True))
    assert port.host_link_bw == HOST_LINK_BW_BYTES_PER_S
    assert port.metrics.peak_flops_per_chip == flops.H100_BF16_FLOPS_PER_S
    restore_s, recompute_s = port._restore_price(4096, 20)
    assert restore_s == 4096 / HOST_LINK_BW_BYTES_PER_S
    flops_32 = analytic_cost(("pctx", 32), EngineDims.from_engine(port))[0]
    assert recompute_s == flops_32 / flops.H100_BF16_FLOPS_PER_S


def test_host_tier_fault_falls_back_fired_for_fired(weights):
    """A host-tier fault on every restore attempt: the spilled run is
    dropped and re-prefilled, the streams stay the resident run's, and the
    injector fires exactly where the JAX engine's does."""
    jp, model = weights
    plan = dict(seed=3, host_tier_rate=1.0)
    port, jax_eng = _port(model, _knobs(True), plan), _jax(jp, _knobs(True), plan)
    assert _churn(port) == _churn(jax_eng) == _resident(weights, "bf16")[0]
    assert list(port.injector.fired) == list(jax_eng.injector.fired)
    assert port.injector.counts["host_tier"] == jax_eng.injector.counts["host_tier"] >= 1
    for c in COUNTERS:
        assert getattr(port.metrics, c) == getattr(jax_eng.metrics, c), c
    assert port.metrics.restore_fallbacks >= 1 and port.metrics.restore_hits == 0
    _clean(port)


def test_planted_restore_fault_changes_the_streams(weights):
    """The test's teeth: a restore that writes V's payload into K serves
    other tokens than the resident run."""
    port = _port(weights[1], _knobs(True))
    restore = port._restore_block
    port._restore_block = lambda sid, nb, p: restore(sid, nb, (p[1], p[1]) + tuple(p[2:]))
    assert port.metrics.restore_hits == 0
    assert _churn(port) != _resident(weights, "bf16")[0]
    assert port.metrics.restore_hits == 1


def test_prewarmed_and_async_spill_serves(weights):
    """The spill tier under prewarm (on the CPU the records run eagerly
    through the same static buffers) and under the async loop: the same
    streams and spill counters as the JAX engine's async loop, nothing
    registered after the freeze."""
    jp, model = weights
    knobs = _knobs(True, async_loop=True)
    port = _port(model, dict(knobs, prewarm=True))
    jax_eng = _jax(jp, knobs)
    assert _churn(port) == _churn(jax_eng) == _resident(weights, "bf16")[0]
    for c in COUNTERS:
        assert getattr(port.metrics, c) == getattr(jax_eng.metrics, c), c
    assert port.metrics.restore_hits == 1
    assert port.metrics.steadystate_compiles == 0
    assert set(port.program_registry()) == {
        k for k in port.catalog.keys() if k[0] in GRAPH_KINDS
    }
    _clean(port)


@pytest.mark.parametrize("case", ["bf16", "int8", "fused-lane"])
def test_manifest_lines_match_jax_with_spill(weights, case):
    """With spill on the manifest gains ``block_save`` / ``block_restore``
    (quantized bit included) and the ``spill`` flag, line for line the
    JAX engine's; neither kind is captured as a CUDA graph."""
    jp, model = weights
    extra = dict(
        bf16={}, int8=dict(kv_cache_dtype="int8"),
        **{"fused-lane": dict(prefill_chunk_tokens=6, fused_step=True,
                              spec_draft_tokens=3, on_device_sampling=True)},
    )[case]
    knobs = dict(_knobs(True), **extra)
    jax_eng, port = _jax(jp, knobs), _port(model, knobs)
    manifest = CatalogManifest.from_engine(port)
    assert manifest.lines() == jax_eng.catalog.lines()
    assert [format_key(k) for k in manifest.prewarm_keys()] == [
        format_key(k) for k in jax_eng.catalog.prewarm_keys()
    ]
    quant = case == "int8"
    assert f"block_save[quantized={quant}]" in manifest.lines()
    assert f"block_restore[quantized={quant}]" in manifest.lines()
    assert manifest.describe().startswith(jax_eng.catalog.describe())
    assert "spill" in manifest.describe()
    assert not {k[0] for k in manifest.graph_keys()} & {"block_save", "block_restore"}
    # and spill off keeps both out
    assert not any(
        line.startswith("block_") for line in CatalogManifest.from_engine(
            _port(model, _knobs(False))).lines()
    )


@pytest.mark.parametrize("knobs,match", [
    (dict(spill_enabled=True), "host_tier_bytes"),
    (dict(spill_enabled=True, host_tier_bytes=1 << 20, enable_prefix_caching=False),
     "prefix"),
])
def test_spill_config_validation_matches_jax(weights, knobs, match):
    """The JAX engine's ValueErrors, message for message."""
    jp, model = weights
    pc = dict(block_size=8, num_blocks=12, **knobs)
    with pytest.raises(ValueError, match=match) as want:
        _jax(jp, pc)
    with pytest.raises(ValueError, match=match) as got:
        _port(model, pc)
    assert str(got.value) == str(want.value)


def test_no_spill_tier_without_the_knob(weights):
    """Without spill_enabled there is no host tier and no drain queue, and
    invariant 9 flags a spilled node."""
    port = _port(weights[1], _knobs(False))
    assert port.host_tier is None and port.allocator.spill_hook is None
    _churn(port)
    _clean(port)
    port.index._spilled[0] = next(iter(port.index._by_block.values()))
    assert any("without spill_enabled" in v for v in audit_engine(port))
