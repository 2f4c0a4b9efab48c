"""The port's paged engine over a tensor-parallel group against the JAX
package's tp = 2 engine, on the CPU, on the tiny config (8 q, 4 kv heads).

The port runs two ranks over gloo (``tests/torch_dist_workers.py``), the
JAX package a pure-tp mesh over two of its virtual CPU devices
(``tests/test_tp_serving.py``'s setup), from the same seeded weights with
the decoder layers scaled up (``tests/test_torch_async.py``'s
``LAYER_SCALE``: at the init scale every greedy stream repeats one
token). Greedy streams must agree token for token across a subset of
``test_tp_serving.py``'s matrix (speculation x sync / async x chunked /
whole prefill), both ranks' streams and step-action traces must be equal,
each rank's pool holds NKV/tp = 2 heads (``pool_bytes_per_rank`` half of
``pool_bytes_total``), and the kernel gate answers as JAX's does on a
tp = 2 mesh and on a dp-extended one.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from neuronx_distributed_llama3_2_tpu.inference import (
    GenerationConfig as JaxGenerationConfig,
    InferenceEngine as JaxInferenceEngine,
)
from neuronx_distributed_llama3_2_tpu.inference.model import LlamaDecode as JaxLlamaDecode
from neuronx_distributed_llama3_2_tpu.models.llama import (
    LLAMA_CONFIGS as JAX_CONFIGS,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_llama3_2_tpu.parallel import state as jstate
from neuronx_distributed_llama3_2_tpu.serving import (
    PagedConfig as JaxPagedConfig,
    PagedServingEngine as JaxPagedServingEngine,
)

from tests import torch_dist_workers as W

LAYER_SCALE = 10.0
CFG_KW = dict(use_paged_kernel=True)
ENGINE_KW = dict(max_batch=4, max_seq_len=64, buckets=[8, 16, 32])
MAX_NEW = 8
#: cell -> paged config: speculation x sync / async x chunked / whole
CELLS = {
    "chunked-async-spec": dict(block_size=8, num_blocks=64, prefill_chunk_tokens=6,
                               async_loop=True, spec_draft_tokens=3),
    "chunked-sync-plain": dict(block_size=8, num_blocks=64, prefill_chunk_tokens=6),
    "whole-async-plain": dict(block_size=8, num_blocks=64, async_loop=True),
    "whole-sync-spec": dict(block_size=8, num_blocks=64, spec_draft_tokens=3),
    # the SLO-aware policy and the degradation ladder under scheduled device
    # faults (tests/test_torch_ladder.py's plan): every objective missed, so
    # the burn gauges read alike on every clock
    "ladder-slo": dict(block_size=8, num_blocks=64, async_loop=True, degrade_after_faults=1,
                       degrade_window_steps=16, degrade_recover_steps=4, step_policy="slo",
                       slo_ttft_p99_ms=1e-6, slo_tpot_p99_ms=1e-6,
                       _fault_plan=dict(seed=17, schedule=((4, "device"), (7, "device")))),
}
#: cells whose rank-0 readings must win: rank 1 alone reads every SLO as met
#: (a clock reading of its own, planted), with the alerts feeding the ladder
SKEWED = {
    "slo-skew": dict(block_size=8, num_blocks=64, degrade_after_faults=1,
                     degrade_window_steps=16, degrade_recover_steps=4, step_policy="slo",
                     slo_ttft_p99_ms=1e-6, slo_tpot_p99_ms=1e-6, slo_degrade=True,
                     slo_eval_steps=2, slo_burn_window=1,
                     _rank1_paged=dict(slo_ttft_p99_ms=1e9, slo_tpot_p99_ms=1e9)),
}


def _scaled(path, x):
    name = jax.tree_util.keystr(path)
    return x * LAYER_SCALE if "layers" in name and "scale" not in name else x


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], **CFG_KW)
    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(
        _scaled, JaxLlama(jcfg).init(jax.random.key(0))))


def _prompts():
    rng = np.random.default_rng(7)
    # repetitive and free-text prompts, so that speculation accepts drafts
    pat = rng.integers(1, 256, size=3).tolist()
    return [(pat * 7)[:18]] + [rng.integers(0, 256, size=(n,)).tolist() for n in (5, 20, 9)]


@functools.lru_cache(maxsize=None)
def _jax_streams(cell):
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], **CFG_KW)
    jstate.destroy_model_parallel()
    jstate.initialize_model_parallel(tensor_model_parallel_size=2, devices=jax.devices()[:2])
    try:
        from neuronx_distributed_llama3_2_tpu.serving import FaultInjector, FaultPlan

        kw = dict(CELLS[cell])
        plan = kw.pop("_fault_plan", None)
        eng = JaxPagedServingEngine(
            JaxInferenceEngine(jcfg, _weights(), **ENGINE_KW),
            JaxGenerationConfig(max_new_tokens=MAX_NEW), JaxPagedConfig(**kw),
            precompile=False, injector=FaultInjector(FaultPlan(**plan)) if plan else None,
        )
        assert eng.model._paged_kernel_eligible(1, None)
        for p in _prompts():
            eng.submit(p)
        levels = []
        while eng.step():
            levels.append(eng._degrade_level)
        out = {rid: list(r.out) for rid, r in sorted(eng._finished.items())}
        m = eng.metrics
        return out, m.tp_size, m.pool_bytes_per_rank, (m.verify_steps, m.accepted_tokens), levels
    finally:
        jstate.destroy_model_parallel()


def _check_cell(cell, outs):
    want, jtp, jpool, jspec, jlevels = _jax_streams(cell)
    got = [o["cells"][cell] for o in outs]
    for g in got:
        assert g["streams"] == want
        assert g["levels"] == jlevels
        assert g["tp_size"] == jtp == 2
        assert g["pool_bytes_per_rank"] == jpool
        assert g["leaks"] == []
        # every decode-time call took the kernel, none the gather
        assert g["paths"].get("kernel", 0) > 0 and g["paths"].get("gather", 0) == 0
    # both ranks ran the same schedule, step for step
    assert got[0]["trace"] == got[1]["trace"]
    if CELLS[cell].get("spec_draft_tokens"):
        # the same verify steps and accepted drafts as JAX's (this cell's
        # drafter proposes in the sync loop's verify steps)
        assert (got[0]["verify_steps"], got[0]["accepted"]) == jspec
        assert cell != "whole-sync-spec" or jspec[0] > 0
    if CELLS[cell].get("async_loop") and not CELLS[cell].get("spec_draft_tokens"):
        assert got[0]["async_steps"] > 0
    if "_fault_plan" in CELLS[cell]:
        assert max(jlevels) > 0 and "failed" in got[0]["status"]


def test_rank0_readings_decide_for_every_rank(tmp_path):
    """Rank 1 alone reads every SLO as met (a clock of its own, planted);
    rank 0 reads every one as missed, and its alerts climb the ladder.
    The once-a-step broadcast makes rank 1 climb with it: both ranks run
    the same levels, the same schedule and the same streams."""
    outs = W.run(W.serve_worker, 2, tmp_path, 2, _weights(), CFG_KW, ENGINE_KW, SKEWED,
                 _prompts(), MAX_NEW)
    a, b = (o["cells"]["slo-skew"] for o in outs)
    assert max(a["levels"]) > 0
    assert a["levels"] == b["levels"] and a["trace"] == b["trace"]
    assert a["streams"] == b["streams"] and a["status"] == b["status"]


def _check_pool(outs):
    for o in outs:
        c = o["cells"]["chunked-sync-plain"]
        assert o["kv_heads"] == 2 and c["pool_shape"][3] == 2
        assert 2 * c["pool_bytes_per_rank"] == c["pool_bytes_total"]


def _jax_gate(tp, devices):
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], **CFG_KW)
    jstate.destroy_model_parallel()
    jstate.initialize_model_parallel(tensor_model_parallel_size=tp, devices=jax.devices()[:devices])
    try:
        dec = JaxLlamaDecode(jcfg)
        odd = JaxLlamaDecode(dataclasses.replace(jcfg, num_heads=6, num_kv_heads=3))
        return dict(
            t1=dec._paged_kernel_eligible(1, None),
            tmax=dec._paged_kernel_eligible(jcfg.paged_kernel_max_t, None),
            past=dec._paged_kernel_eligible(jcfg.paged_kernel_max_t + 1, None),
            tree=dec._paged_kernel_eligible(jcfg.paged_kernel_max_t, object()),
            odd=odd._paged_kernel_eligible(1, None),
        )
    finally:
        jstate.destroy_model_parallel()


def _check_gate(world, tp, outs):
    """Pure tp with divisible heads takes the kernel up to
    paged_kernel_max_t (trees too); heads tp does not divide, or a
    dp-extended mesh, take the gather."""
    want = _jax_gate(tp, world)
    for o in outs:
        assert o["gate"] == want
    assert want["t1"] == (world == tp)


def test_kernel_gate_on_a_dp_extended_mesh(tmp_path):
    outs = W.run(W.serve_worker, 4, tmp_path, 2, _weights(), CFG_KW, ENGINE_KW, {},
                 _prompts(), MAX_NEW)
    _check_gate(4, 2, outs)


def _check_dense(outs):
    """The dense engine over the tp group (JAX ``cache_specs``: kv heads
    split over tp) generates the JAX dense engine's greedy tokens on every
    rank."""
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], **CFG_KW)
    params = jax.tree.map(jax.numpy.asarray, _weights())
    want = JaxInferenceEngine(jcfg, params, **ENGINE_KW).generate(
        _prompts(), JaxGenerationConfig(max_new_tokens=MAX_NEW)).sequences
    for o in outs:
        d = o["dense"]
        assert [list(map(int, s)) for s in d["sequences"]] == [list(map(int, s)) for s in want]
        assert d["cache_heads"] == 2
        assert d["cache_specs"].k == (None, None, None, "tp", None)


def test_tp2_engines_match_jax(tmp_path):
    """One spawn of two ranks serves every cell, the dense engine and the
    kernel gate's cases; each is held to the JAX package at tp = 2."""
    outs = W.run(W.serve_worker, 2, tmp_path, 2, _weights(), CFG_KW, ENGINE_KW, CELLS,
                 _prompts(), MAX_NEW)
    for cell in CELLS:
        _check_cell(cell, outs)
    _check_pool(outs)
    _check_dense(outs)
    _check_gate(2, 2, outs)


@pytest.mark.parametrize("t", [None, 1, 4], ids=["3dim", "t1", "t4"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_tp_kernel_wrapper_on_rank_slices_equals_the_whole(t, quant):
    """paged_flash_decode_tp on each rank's head slice (tp = 2) is the
    whole call's output for those heads, bitwise (the same function per
    head: JAX's test_sharded_kernel_matches_single_chip), with the int8
    pool's scales sliced alike; sizes tp does not divide raise."""
    import torch

    from neuronx_distributed_llama3_2_tpu_torch.kernels.paged_attention import (
        paged_flash_decode,
        paged_flash_decode_tp,
    )
    from neuronx_distributed_llama3_2_tpu_torch.quantization.kv_cache import kv_quantize

    b, n, nkv, d, nb, bs, w, limit = 3, 8, 4, 16, 17, 8, 6, 40
    tt = 1 if t is None else t
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.normal(size=(b, n, d) if t is None else (b, t, n, d)), dtype=torch.float32)
    kp = torch.tensor(rng.normal(size=(nb, bs, nkv, d)), dtype=torch.float32)
    vp = torch.tensor(rng.normal(size=(nb, bs, nkv, d)), dtype=torch.float32)
    ks = vs = None
    if quant:
        kp, ks = kv_quantize(kp, torch.int8)
        vp, vs = kv_quantize(vp, torch.int8)
    nblk = -(-limit // bs)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, w), np.int32)
    for i in range(b):
        tables[i, :nblk] = perm[i * nblk:(i + 1) * nblk]
    tables = torch.tensor(tables)
    pos = torch.tensor(rng.integers(0, limit - tt + 1, size=(b,)), dtype=torch.int32)
    whole = paged_flash_decode(q, kp, vp, tables, pos, kv_limit=limit, k_scale=ks, v_scale=vs)
    for r in range(2):
        qs = q[..., r * 4:(r + 1) * 4, :]
        kvs = slice(r * 2, (r + 1) * 2)
        got = paged_flash_decode_tp(
            qs, kp[:, :, kvs], vp[:, :, kvs], tables, pos, num_heads=n, num_kv_heads=nkv,
            tp_size=2, kv_limit=limit, k_scale=None if ks is None else ks[:, :, kvs],
            v_scale=None if vs is None else vs[:, :, kvs])
        assert torch.equal(got, whole[..., r * 4:(r + 1) * 4, :])
    with pytest.raises(ValueError, match="divide tp"):
        paged_flash_decode_tp(q[..., :3, :], kp[:, :, :1], vp[:, :, :1], tables, pos,
                              num_heads=6, num_kv_heads=3, tp_size=2, kv_limit=limit)
    with pytest.raises(ValueError, match="rank slices"):
        paged_flash_decode_tp(q, kp, vp, tables, pos, num_heads=n, num_kv_heads=nkv,
                              tp_size=2, kv_limit=limit)
