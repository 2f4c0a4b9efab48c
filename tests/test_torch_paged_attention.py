"""The port's paged-decode wrapper and paged decode model against the JAX
package's, on the CPU.

On CPU tensors the wrapper runs its plain version (one masked softmax over
the gathered rows); the JAX side runs its Pallas kernel in interpret mode
(split-K online softmax). In fp32 the two differ only in summation order:
2e-5, the JAX package's own kernel-vs-reference tolerance. With bf16 q
(the quantized modes) the JAX kernel also rounds its softmax weights to
bf16 before p.V and the plain version does not, so the two agree within
2 bf16 ulps of the largest output, the tolerance chip_smoke.py holds the
CUDA kernel to. The CUDA kernel itself runs only on the card;
``chip_smoke.py`` holds it against the plain version there. Besides the
small head dim D = 32, cases at D = 96 (gpt-neox-20b's, which the three
CUDA sources take in instances of their own) run t = 1 and t > 1 on bf16,
int8 and fp8 pools in modes 3-6, and the route and launch checks take it
as they take 64 and 128.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.inference.model import (
    LlamaDecode as JaxLlamaDecode,
)
from neuronx_distributed_llama3_2_tpu.kernels.paged_attention_pallas import (
    paged_flash_decode as jax_paged_flash_decode,
)
from neuronx_distributed_llama3_2_tpu.models.llama import (
    LLAMA_CONFIGS as JAX_CONFIGS,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_llama3_2_tpu.quantization import kv_cache as jkv
from neuronx_distributed_llama3_2_tpu_torch.inference.model import (
    LlamaDecode,
    tree_bits_of,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.speculative import tree_topology
from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LLAMA_CONFIGS,
    LlamaForCausalLM,
    params_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.quantization import kv_cache as kv
from neuronx_distributed_llama3_2_tpu_torch.utils import device as device_mod

torch.set_num_threads(1)

B, N, NKV, D, BS, NB, W = 3, 8, 4, 32, 8, 40, 12  # GQA group G = 2
KV_LIMIT = 64  # below the table capacity W * BS = 96


def _case(t, seed, d=D):
    """Pool, tables and positions with garbage everywhere a read must not
    look: random pool contents (the null block included) and random block
    ids (0 among them) in every table entry past a lane's frontier."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, t, N, d)).astype(np.float32)
    kp = rng.standard_normal((NB, BS, NKV, d)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, NKV, d)).astype(np.float32)
    tables = rng.integers(0, NB, size=(B, W)).astype(np.int32)
    # ragged: the first row, mid-block, and the last rows under KV_LIMIT
    positions = np.asarray([0, 17, KV_LIMIT - t], np.int32)
    for i, p in enumerate(positions):
        live = (p + t - 1) // BS + 1
        tables[i, :live] = rng.choice(np.arange(1, NB), size=live, replace=False)
    return q, kp, vp, tables, positions


MATCH_CASES = [(t, splits, d) for d in (D, 96) for t in (1, 4) for splits in (1, 4)]


@pytest.mark.parametrize("t,splits,d", MATCH_CASES,
                         ids=[f"{t}-{s}" + ("" if d == D else f"-D{d}") for t, s, d in MATCH_CASES])
def test_matches_jax_kernel(t, splits, d):
    q, kp, vp, tables, positions = _case(t, seed=10 * t + splits, d=d)
    q_in = q[:, 0] if t == 1 else q  # t == 1 is the 3-dim token-gen form
    ref = jax_paged_flash_decode(
        jnp.asarray(q_in), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(positions),
        kv_limit=KV_LIMIT, num_splits=splits,
    )
    pa.launches.reset()
    out = pa.paged_flash_decode(
        torch.as_tensor(q_in), torch.as_tensor(kp), torch.as_tensor(vp),
        torch.as_tensor(tables), torch.as_tensor(positions),
        kv_limit=KV_LIMIT, num_splits=splits,
    )
    assert out.shape == q_in.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    assert pa.launches.count == 0  # the CPU path launches no kernel


def test_rows_past_the_frontier_are_never_read():
    q, kp, vp, tables, positions = _case(4, seed=3)
    args = [torch.as_tensor(x) for x in (q, kp, vp, tables, positions)]
    out = pa.paged_flash_decode(*args, kv_limit=KV_LIMIT)
    aliased = tables.copy()
    for i, p in enumerate(positions):
        aliased[i, (p + 3) // BS + 1:] = 0  # the null block
    args[3] = torch.as_tensor(aliased)
    out2 = pa.paged_flash_decode(*args, kv_limit=KV_LIMIT)
    torch.testing.assert_close(out2, out, atol=0, rtol=0)


def test_unported_modes_raise():
    q, kp, vp, tables, positions = (
        torch.as_tensor(x) for x in _case(1, seed=0)
    )
    # the quantized arguments now reach the plain version
    kq, ks = kv.kv_quantize(kp, torch.int8)
    vq, vs = kv.kv_quantize(vp, torch.int8)
    out = pa.paged_flash_decode(
        q, kq, vq, tables, positions, k_scale=ks, v_scale=vs, quant_mxu=True,
    )
    assert out.shape == q.shape and bool(torch.isfinite(out).all())


def test_quantized_arguments_are_validated():
    """As in the JAX kernel: scales come in pairs of shape (num_blocks, bs,
    NKV), and quant_mxu needs them."""
    q, kp, vp, tables, positions = (
        torch.as_tensor(x) for x in _case(1, seed=0)
    )
    kq, ks = kv.kv_quantize(kp, torch.int8)
    vq, vs = kv.kv_quantize(vp, torch.int8)
    for kw, match in (
        (dict(quant_mxu=True), "quant_mxu needs a quantized pool"),
        (dict(k_scale=ks), "passed together"),
        (dict(k_scale=ks[:, :4], v_scale=vs[:, :4]), "scale arrays must be"),
    ):
        for fn in (pa.paged_flash_decode, pa.paged_flash_decode_reference):
            with pytest.raises(ValueError, match=match):
                fn(q, kq, vq, tables, positions, **kw)


def test_no_silent_cpu_path(monkeypatch):
    # a tensor that is neither on the CPU nor on the card raises: the plain
    # version serves CPU tensors only
    q, kp, vp, tables, positions = (
        torch.as_tensor(x).to("meta") for x in _case(1, seed=0)
    )
    with pytest.raises(RuntimeError, match="cuda tensors"):
        pa.paged_flash_decode(q, kp, vp, tables, positions)
    # entry points default to the card, and raise where there is none
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_mod.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(LLAMA_CONFIGS["tiny"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaDecode(LLAMA_CONFIGS["tiny"]).init_paged_cache(4, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({}, LLAMA_CONFIGS["tiny"])


def test_kernel_launch_rejects_what_it_cannot_take():
    # the CUDA launch path validates before touching the library
    q, kp, vp, tables, positions = (
        torch.as_tensor(x) for x in _case(1, seed=0)
    )
    with pytest.raises(ValueError, match="bf16"):
        pa._launch(q, kp, vp, tables, positions, 8, 1, 8)
    with pytest.raises(ValueError, match="block_size 16"):
        pa._launch(
            q.bfloat16(), kp.bfloat16(), vp.bfloat16(), tables, positions, 8, 1, 8,
        )
    # row_live: int32, one entry per lane, contiguous, on q's device
    bf = (q.bfloat16(), kp.bfloat16(), vp.bfloat16(), tables, positions, 8, 1, 8)
    for live, match in (
        (positions.long(), "row_live must be int32"),
        (positions[:2], "one row per lane"),
        (torch.stack([positions, positions], 1)[:, 0], "row_live must be contiguous"),
        (positions.to("meta"), "row_live is on meta"),
    ):
        with pytest.raises(ValueError, match=match):
            pa._launch(*bf, row_live=live)
    # quantized: one payload dtype of the three, fp16 scales, bf16 q
    kq, ks = kv.kv_quantize(kp, torch.int8)
    vq, vs = kv.kv_quantize(vp, torch.float8_e4m3fn)
    qb = q.bfloat16()
    for args, kw, match in (
        ((qb, kq, vq), dict(k_scale=ks, v_scale=vs), "payloads"),
        ((qb, kq, kq), dict(k_scale=ks.float(), v_scale=ks.float()), "float16"),
        ((q, kq, kq), dict(k_scale=ks, v_scale=ks), "bf16 q"),
        ((qb, kp.bfloat16(), vp.bfloat16()), dict(k_scale=ks, v_scale=vs), "payloads"),
        ((qb, kq.float(), kq.float()), {}, "bf16 pools"),
    ):
        with pytest.raises(ValueError, match=match):
            pa._launch(*args, tables, positions, 8, 1, 8, **kw)


# -- row_live: the fused step's mixed-width tile (mode 4) ------------------------

LIVE_NB = 200


def _live_case(t, seed, d=D):
    """Lanes with every live count 0..t, plus a lane with none at row 0.
    Even lanes sit where their last live row is the first row of a pool
    block (a walk one row short would miss that block); odd lanes at
    random rows. The tables hold distinct real blocks for every row up to
    pos + t - 1 and random ids (0 among them) past it; the pool is random
    everywhere. Returns (q, k_pool, v_pool, tables, positions, row_live)
    as float32 / int32 numpy arrays."""
    rng = np.random.default_rng(seed)
    live = np.concatenate([np.arange(t + 1), [0]]).astype(np.int32)
    b = len(live)
    positions = np.empty(b, np.int32)
    for j, n in enumerate(live):
        if j % 2 == 0:
            positions[j] = BS * (2 + j % 3) + 1 - n  # row pos + n - 1 opens a block
        else:
            positions[j] = rng.integers(0, KV_LIMIT - t + 1)
    positions[-1] = 0
    q = rng.standard_normal((b, t, N, d)).astype(np.float32)
    kp = rng.standard_normal((LIVE_NB, BS, NKV, d)).astype(np.float32)
    vp = rng.standard_normal((LIVE_NB, BS, NKV, d)).astype(np.float32)
    tables = rng.integers(0, LIVE_NB, size=(b, W)).astype(np.int32)
    ids = rng.permutation(np.arange(1, LIVE_NB))
    for j, p in enumerate(positions):
        n = (p + t - 1) // BS + 1
        tables[j, :n], ids = ids[:n], ids[n:]
    return q, kp, vp, tables, positions, live


# the pools the row_live and tree_bits cases run on: float32, int8 in mode 3,
# fp8 e4m3 in mode 6
MASK_POOLS = ["float32", "int8", "fp8_e4m3-mode6"]


def _mask_pool(kp, vp, pool):
    """(k_pool, v_pool, the quantized-pool keywords) of a MASK_POOLS name."""
    if pool == "float32":
        return kp, vp, {}
    name, _, mode = pool.partition("-")
    kp, ks = kv.kv_quantize(kp, kv.KV_CACHE_DTYPES[name])
    vp, vs = kv.kv_quantize(vp, kv.KV_CACHE_DTYPES[name])
    return kp, vp, dict(k_scale=ks, v_scale=vs, quant_mxu=mode == "mode6")


def _jax_kw(kw: dict) -> dict:
    return {k: _jax(v) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}


def _live_run(t, seed, pool, splits, d=D):
    """(the port's output, JAX's interpret-mode kernel output, the case
    as torch tensors), fp32 q, a MASK_POOLS pool."""
    q, kp, vp, tables, positions, live = (
        torch.as_tensor(x) for x in _live_case(t, seed, d)
    )
    kp, vp, scales = _mask_pool(kp, vp, pool)
    kw = dict(kv_limit=KV_LIMIT, num_splits=splits)
    ref = jax_paged_flash_decode(
        *(_jax(x) for x in (q, kp, vp, tables, positions)), row_live=_jax(live),
        **kw, **_jax_kw(scales),
    )
    out = pa.paged_flash_decode(q, kp, vp, tables, positions, row_live=live, **kw, **scales)
    return out, np.asarray(ref), (q, kp, vp, tables, positions, live, scales)


LIVE_CASES = [(t, pool, splits, D) for t in (4, 8, 16) for pool in MASK_POOLS
              for splits in (1, 4)] + [(8, pool, 4, 96) for pool in MASK_POOLS]


@pytest.mark.parametrize("t,pool,splits,d", LIVE_CASES,
                         ids=[f"{t}-{p}-{s}" + ("" if d == D else f"-D{d}")
                              for t, p, s, d in LIVE_CASES])
def test_row_live_matches_jax_kernel(t, pool, splits, d):
    """Mode 4 against JAX's interpret-mode kernel on whole outputs, padding
    rows included, fp32 within 1e-5; a lane with no live row at row 0 sees
    nothing and gives 0 in both."""
    out, ref, _ = _live_run(t, 100 + t, pool, splits, d)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    assert not out[-1].any() and not ref[-1].any()


@pytest.mark.parametrize("t", [4, 16])
def test_row_live_bf16_matches_jax_kernel(t):
    """Mode 4 on a bf16 pool with bf16 q, the card's dtypes: whole outputs
    within 2 bf16 ulps of the largest (the JAX kernel rounds its softmax
    weights to bf16, the plain version does not)."""
    q, kp, vp, tables, positions, live = (
        torch.as_tensor(x) for x in _live_case(t, 200 + t)
    )
    q, kp, vp = (x.bfloat16() for x in (q, kp, vp))
    kw = dict(kv_limit=KV_LIMIT, num_splits=4)
    ref = jax_paged_flash_decode(
        *(_jax(x) for x in (q, kp, vp, tables, positions)), row_live=_jax(live), **kw,
    )
    out = pa.paged_flash_decode(q, kp, vp, tables, positions, row_live=live, **kw)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(out.float().numpy() - ref).max() <= _bf16_band(ref)


@pytest.mark.parametrize("t", [4, 16])
def test_row_live_rows_and_walk(t):
    """Live rows are bitwise what the call without row_live gives; padding
    rows differ somewhere (their walk was cut); and nothing past a lane's
    live frontier block is read: those blocks replaced by the null block
    leave the output bitwise unchanged."""
    q, kp, vp, tables, positions, live = (
        torch.as_tensor(x) for x in _live_case(t, 7 + t)
    )
    kw = dict(kv_limit=KV_LIMIT, num_splits=4)
    out = pa.paged_flash_decode(q, kp, vp, tables, positions, row_live=live, **kw)
    full = pa.paged_flash_decode(q, kp, vp, tables, positions, **kw)
    is_live = torch.arange(t)[None, :] < live[:, None]
    assert torch.equal(out[is_live], full[is_live])
    assert not torch.equal(out[~is_live], full[~is_live])
    cut = tables.clone()
    for j, (p, n) in enumerate(zip(positions.tolist(), live.tolist())):
        cut[j, max(p + n - 1, -1) // BS + 1:] = 0
    out2 = pa.paged_flash_decode(q, kp, vp, cut, positions, row_live=live, **kw)
    assert torch.equal(out2, out)
    # a walk one row short misses the block the even lanes' last live row
    # opens, which moves their last live row
    short = pa.paged_flash_decode(q, kp, vp, tables, positions, row_live=live - 1, **kw)
    lanes = [j for j in range(0, len(live) - 1, 2) if live[j] >= 1]
    for j in lanes:
        n = int(live[j])
        assert not torch.allclose(short[j, n - 1], out[j, n - 1], atol=1e-3)


def test_row_live_is_validated():
    q, kp, vp, tables, positions = (torch.as_tensor(x) for x in _case(4, seed=0))
    for fn in (pa.paged_flash_decode, pa.paged_flash_decode_reference):
        with pytest.raises(ValueError, match="row_live must be"):
            fn(q, kp, vp, tables, positions, row_live=positions[:2])


# -- the quantized pool: modes 3 and 6 ----------------------------------------

QDTYPES = ("int8", "fp8_e4m3", "fp8_e5m2")
JAX_FP8 = {torch.float8_e4m3fn: jnp.float8_e4m3fn, torch.float8_e5m2: jnp.float8_e5m2}


def _jax(x: torch.Tensor):
    """A torch tensor as a JAX array of the same dtype and bits."""
    if x.dtype in JAX_FP8:
        return jnp.asarray(x.view(torch.uint8).numpy().view(JAX_FP8[x.dtype]))
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _quantized_case(t, seed, name, q_dtype=torch.float32, d=D):
    """_case's garbage-filled tables with the pool quantized by the ported
    kv_quantize: (q, (k, v, k_scale, v_scale), tables, positions)."""
    q, kp, vp, tables, positions = _case(t, seed, d)
    qdt = kv.KV_CACHE_DTYPES[name]
    kq, ks = kv.kv_quantize(torch.as_tensor(kp), qdt)
    vq, vs = kv.kv_quantize(torch.as_tensor(vp), qdt)
    q = torch.as_tensor(q).to(q_dtype)
    return q, (kq, vq, ks, vs), torch.as_tensor(tables), torch.as_tensor(positions)


def _run_both(q, pool, tables, positions, splits, mxu):
    """(the port's output, JAX's interpret-mode kernel output), in fp32."""
    kq, vq, ks, vs = pool
    ref = jax_paged_flash_decode(
        _jax(q), _jax(kq), _jax(vq), _jax(tables), _jax(positions),
        kv_limit=KV_LIMIT, num_splits=splits, k_scale=_jax(ks), v_scale=_jax(vs),
        quant_mxu=mxu,
    )
    out = pa.paged_flash_decode(
        q, kq, vq, tables, positions, kv_limit=KV_LIMIT, num_splits=splits,
        k_scale=ks, v_scale=vs, quant_mxu=mxu,
    )
    assert out.shape == q.shape and out.dtype == q.dtype
    return out.float().numpy(), np.asarray(ref.astype(jnp.float32))


def _bf16_band(ref):
    """2 bf16 ulps (8 significant bits) of the largest |ref|."""
    top = float(np.abs(ref).max())
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("mxu", [False, True], ids=["mode3", "mode6"])
@pytest.mark.parametrize("name", QDTYPES)
def test_quantized_matches_jax_kernel(name, mxu, t, splits):
    """fp32 q: the plain version against JAX's kernel in modes 3 and 6 at
    the fp32 tolerance of the bf16 pool."""
    q, pool, tables, positions = _quantized_case(t, 10 * t + splits, name)
    if t == 1:
        q = q[:, 0]  # the 3-dim token-gen form
    out, ref = _run_both(q, pool, tables, positions, splits, mxu)
    np.testing.assert_allclose(out, ref, atol=2e-5)


QUANT_BF16_CASES = [(name, mxu, t, d) for name in QDTYPES for mxu in (False, True)
                    for t, d in ((4, D), (1, 96), (4, 96))]


@pytest.mark.parametrize(
    "name,mxu,t,d", QUANT_BF16_CASES,
    ids=[f"{n}-mode{6 if m else 3}" + ("" if d == D else f"-t{t}-D{d}")
         for n, m, t, d in QUANT_BF16_CASES])
def test_quantized_bf16_matches_jax_kernel(name, mxu, t, d):
    """bf16 q: dequantized K/V rounded to bf16 on both sides; within 2 bf16
    ulps of the largest output (the softmax weights are rounded on the
    JAX side only)."""
    q, pool, tables, positions = _quantized_case(t, 5, name, torch.bfloat16, d)
    if t == 1:
        q = q[:, 0]  # the 3-dim token-gen form
    out, ref = _run_both(q, pool, tables, positions, 4, mxu)
    assert np.abs(out - ref).max() <= _bf16_band(ref)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", QDTYPES)
def test_mode3_is_the_bf16_path_on_the_dequantized_pool(name, q_dtype):
    """Mode 3 reads exactly kv_dequantize(payload, scale, q.dtype): the
    same call on the dequantized pool without scales gives the same bits.
    A mode 3 that skipped the rounding to q's dtype fails this."""
    q, (kq, vq, ks, vs), tables, positions = _quantized_case(4, 9, name, q_dtype)
    out = pa.paged_flash_decode(
        q, kq, vq, tables, positions, kv_limit=KV_LIMIT, k_scale=ks, v_scale=vs,
    )
    deq = pa.paged_flash_decode(
        q, kv.kv_dequantize(kq, ks, q_dtype), kv.kv_dequantize(vq, vs, q_dtype),
        tables, positions, kv_limit=KV_LIMIT,
    )
    torch.testing.assert_close(out, deq, atol=0, rtol=0)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["fp8_e4m3", "fp8_e5m2"])
def test_fp8_query_cast_matches_jax(name, q_dtype):
    """The unsaturated cast of q to fp8, value for value against JAX's
    astype: e4m3fn is NaN past 464, e5m2 inf from 61440 (torch's own cast
    saturates e4m3fn)."""
    x = np.asarray(
        [0.0, 1e-3, -0.3, 447.0, 448.0, 455.0, 464.0, 465.0, 480.0, -1000.0,
         57344.0, 61439.0, 61440.0, -70000.0, np.inf, -np.inf, np.nan],
        np.float32,
    )
    dt = kv.KV_CACHE_DTYPES[name]
    want = np.asarray(
        jnp.asarray(x, getattr(jnp, q_dtype)).astype(JAX_FP8[dt]).astype(jnp.float32)
    )
    got = pa.fp8_query(torch.as_tensor(x).to(getattr(torch, q_dtype)), dt).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,big", [("fp8_e4m3", 1000.0), ("fp8_e5m2", 7e4)])
def test_fp8_mode6_overflow_is_nan_where_jax_is(name, big):
    """A query element past the fp8 range poisons its query row with NaN
    in JAX's kernel, and exactly that row in the plain version."""
    q, pool, tables, positions = _quantized_case(1, 4, name)
    q = q[:, 0].clone()
    q[1, 3, 5] = big
    q[2, 6, 0] = -big
    out, ref = _run_both(q, pool, tables, positions, 4, True)
    assert np.isnan(ref).any()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    live = ~np.isnan(ref)
    np.testing.assert_allclose(out[live], ref[live], atol=2e-5)


# -- the decode model around the kernel ---------------------------------------

JAX_TINY = dataclasses.replace(JAX_CONFIGS["tiny"], use_paged_kernel=True)
TINY = dataclasses.replace(LLAMA_CONFIGS["tiny"], use_paged_kernel=True)


@pytest.fixture(scope="module")
def weights():
    jp = JaxLlama(JAX_TINY).init(jax.random.key(1))
    model = LlamaForCausalLM(TINY, device="cpu")
    model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, jp), TINY, device="cpu")
    )
    return jp, model


def test_paged_decode_model_matches_jax(weights):
    """Prefill (context encode), a 4-token suffix through the kernel and a
    T=1 decode step over shared tables: logits and the written pool rows
    agree with the JAX package's LlamaDecode (fp32, 1e-5)."""
    jp, model = weights
    nb, bs, w = 16, 8, 8
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, TINY.vocab_size, size=(2, 16))
    tables = np.zeros((2, w), np.int32)
    tables[0, :3] = [3, 5, 7]
    tables[1, :3] = [2, 9, 4]
    jdec, tdec = JaxLlamaDecode(JAX_TINY), LlamaDecode(TINY)
    jcache = jdec.init_paged_cache(nb, bs)
    tcache = tdec.init_paged_cache(nb, bs, device="cpu")
    steps = [  # (tokens, positions, forward kwargs)
        (prompt, [0, 0], dict(context_encode=True)),
        (rng.integers(0, TINY.vocab_size, size=(2, 4)), [16, 16], {}),
        (rng.integers(0, TINY.vocab_size, size=(2, 1)), [20, 20], dict(kv_limit=32)),
    ]
    for toks, pos, kw in steps:
        jl, jcache = jdec.forward(
            jp, jcache, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
            block_tables=jnp.asarray(tables), **kw,
        )
        tl, tcache = tdec.forward(
            model, tcache, torch.as_tensor(toks), torch.as_tensor(pos, dtype=torch.int32),
            block_tables=torch.as_tensor(tables), **kw,
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    for blk in (2, 3, 4, 5, 7, 9):  # every block the two lanes wrote
        np.testing.assert_allclose(
            tcache.k[:, blk].numpy(), np.asarray(jcache.k[:, blk]), atol=1e-5
        )
    assert tdec.attention_paths == {
        "context": TINY.num_layers, "kernel": 2 * TINY.num_layers,
    }


def test_kernel_and_gather_paths_agree(weights):
    """The same suffix step through the kernel's wrapper and through the
    gather plus plain cache attention (use_paged_kernel off): fp32, 1e-5."""
    _, model = weights
    rng = np.random.default_rng(8)
    tables = torch.as_tensor([[1, 2, 3, 0], [4, 5, 6, 0]], dtype=torch.int32)
    prompt = torch.as_tensor(rng.integers(0, 256, size=(2, 12)))
    step = torch.as_tensor(rng.integers(0, 256, size=(2, 3)))
    outs = []
    for flag in (True, False):
        dec = LlamaDecode(dataclasses.replace(TINY, use_paged_kernel=flag))
        cache = dec.init_paged_cache(8, 8, device="cpu")
        dec.forward(model, cache, prompt, torch.zeros(2, dtype=torch.int32),
                    block_tables=tables, context_encode=True)
        logits, _ = dec.forward(model, cache, step, torch.full((2,), 12, dtype=torch.int32),
                                block_tables=tables, kv_limit=24)
        outs.append(logits)
        assert dec.attention_paths[dec.paged_dispatch_path(3)] == TINY.num_layers
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)


QUANT_MODEL_CASES = [
    (name, kernel, mxu)
    for name in QDTYPES
    for kernel, mxu in ((False, False), (True, False), (True, True))
]


@pytest.mark.parametrize(
    "name,kernel,mxu", QUANT_MODEL_CASES,
    ids=[f"{n}-{'kernel' if k else 'gather'}{'-mxu' if m else ''}" for n, k, m in QUANT_MODEL_CASES],
)
def test_quantized_decode_model_matches_jax(weights, name, kernel, mxu):
    """test_paged_decode_model_matches_jax on a quantized pool: prefill,
    a 4-token suffix and a T=1 decode step, through the kernel's wrapper
    (modes 3 and 6) or the gather; logits within 1e-5 of JAX's LlamaDecode,
    and the written payloads and scales the same but for rare rows."""
    jp, model = weights
    nb, bs, w = 16, 8, 8
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, TINY.vocab_size, size=(2, 16))
    tables = np.zeros((2, w), np.int32)
    tables[0, :3] = [3, 5, 7]
    tables[1, :3] = [2, 9, 4]
    cfg = dict(use_paged_kernel=kernel, quant_mxu=mxu)
    jdec = JaxLlamaDecode(dataclasses.replace(JAX_TINY, **cfg))
    tdec = LlamaDecode(dataclasses.replace(TINY, **cfg))
    jcache = jdec.init_paged_cache(nb, bs, kv_cache_dtype=name)
    tcache = tdec.init_paged_cache(nb, bs, kv_cache_dtype=name, device="cpu")
    assert tcache.quantized and tcache.k.dtype == kv.KV_CACHE_DTYPES[name]
    steps = [
        (prompt, [0, 0], dict(context_encode=True)),
        (rng.integers(0, TINY.vocab_size, size=(2, 4)), [16, 16], {}),
        (rng.integers(0, TINY.vocab_size, size=(2, 1)), [20, 20], dict(kv_limit=32)),
    ]
    for toks, pos, kw in steps:
        jl, jcache = jdec.forward(
            jp, jcache, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
            block_tables=jnp.asarray(tables), **kw,
        )
        tl, out_cache = tdec.forward(
            model, tcache, torch.as_tensor(toks), torch.as_tensor(pos, dtype=torch.int32),
            block_tables=torch.as_tensor(tables), **kw,
        )
        assert out_cache is tcache  # written in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    # every block the two lanes wrote: the fp32 projections differ from
    # JAX's in summation order, so a rare row's scale may land one fp16
    # ulp away and its payload one step away
    blocks = [2, 3, 4, 5, 7, 9]
    for pool, scale in (("k", "k_scale"), ("v", "v_scale")):
        st = getattr(tcache, scale)[:, blocks].float().numpy()
        sj = np.asarray(getattr(jcache, scale)[:, blocks]).astype(np.float32)
        np.testing.assert_allclose(st, sj, rtol=2.0 ** -10)
        dt = kv.kv_dequantize(getattr(tcache, pool)[:, blocks],
                              getattr(tcache, scale)[:, blocks], torch.float32).numpy()
        dj = np.asarray(jkv.kv_dequantize(getattr(jcache, pool)[:, blocks],
                                          getattr(jcache, scale)[:, blocks], jnp.float32))
        assert (dt == dj).mean() >= 0.99
    path = "kernel" if kernel else "gather"
    assert tdec.attention_paths == {"context": TINY.num_layers, path: 2 * TINY.num_layers}


def test_quantized_cache_outside_the_paged_path_raises(weights):
    _, model = weights
    dec = LlamaDecode(TINY)
    cache = dec.init_paged_cache(16, 8, kv_cache_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="quantized KV storage is paged-only"):
        dec.forward(model, cache, torch.zeros((1, 4), dtype=torch.long),
                    torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="mutually exclusive"):
        dec.init_paged_cache(16, 8, torch.float16, kv_cache_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="kv_cache_dtype must be one of"):
        dec.init_paged_cache(16, 8, kv_cache_dtype="int4", device="cpu")


# -- tree_bits: packed draft trees (mode 5) --------------------------------------


def _tree_bits(parents: np.ndarray) -> np.ndarray:
    """(b, t) int32 ancestor bitmasks of packed parents (b, t), through the
    port's tree_topology and the model's packing."""
    _, anc = tree_topology(torch.as_tensor(parents))
    return tree_bits_of(anc).numpy()


def _random_parents(rng, b, t):
    """Packed random trees, each node's parent among the three before it
    (deep and branching)."""
    parents = np.zeros((b, t), np.int32)
    for j in range(1, t):
        parents[:, j] = rng.integers(max(0, j - 3), j, size=b)
    return parents


def _chain_bits(b, t):
    return _tree_bits(np.broadcast_to(np.maximum(np.arange(t) - 1, 0), (b, t)).copy())


TREE_CASES = [(t, pool, live, D) for t in (5, 9) for pool in MASK_POOLS
              for live in (False, True)] + [(9, pool, True, 96) for pool in MASK_POOLS]


@pytest.mark.parametrize(
    "t,pool,live,d", TREE_CASES,
    ids=[f"{t}-{p}-{'row_live' if lv else 'all-rows'}" + ("" if d == D else f"-D{d}")
         for t, p, lv, d in TREE_CASES])
def test_tree_bits_matches_jax_kernel(t, pool, live, d):
    """Mode 5 against JAX's interpret-mode kernel on random branching trees
    over _live_case's lanes (row_live's padding rows included), fp32 q, a
    MASK_POOLS pool: whole outputs within 1e-5 (summation order)."""
    rng = np.random.default_rng(300 + t)
    q, kp, vp, tables, positions, row_live = (
        torch.as_tensor(x) for x in _live_case(t, 300 + t, d)
    )
    bits = torch.as_tensor(_tree_bits(_random_parents(rng, len(row_live), t)))
    kp, vp, scales = _mask_pool(kp, vp, pool)
    kw = dict(kv_limit=KV_LIMIT, num_splits=4)
    extra = dict(row_live=row_live) if live else {}
    ref = jax_paged_flash_decode(
        *(_jax(x) for x in (q, kp, vp, tables, positions)), tree_bits=_jax(bits),
        **kw, **_jax_kw(dict(scales, **extra)),
    )
    out = pa.paged_flash_decode(q, kp, vp, tables, positions, tree_bits=bits,
                                **kw, **scales, **extra)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    # the ancestor mask is not the block-causal one on these trees
    causal = pa.paged_flash_decode(q, kp, vp, tables, positions, **kw, **scales, **extra)
    assert not torch.allclose(causal, out, atol=1e-3)


@pytest.mark.parametrize("t", [17, 32])
def test_wide_tree_bf16_matches_jax_kernel(t):
    """A tree as wide as the kernel takes (t * G = 64 at t = 32 and G = 2)
    on a bf16 pool with bf16 q, with row_live: whole outputs within 2 bf16
    ulps of the largest (the JAX kernel rounds its softmax weights to bf16,
    the plain version does not)."""
    rng = np.random.default_rng(400 + t)
    q, kp, vp, tables, positions = (torch.as_tensor(x) for x in _case(t, 400 + t))
    q, kp, vp = (x.bfloat16() for x in (q, kp, vp))
    bits = torch.as_tensor(_tree_bits(_random_parents(rng, B, t)))
    live = torch.as_tensor([t, t // 2, 1], dtype=torch.int32)
    kw = dict(kv_limit=KV_LIMIT, num_splits=4)
    ref = jax_paged_flash_decode(
        *(_jax(x) for x in (q, kp, vp, tables, positions)), tree_bits=_jax(bits),
        row_live=_jax(live), **kw,
    )
    out = pa.paged_flash_decode(q, kp, vp, tables, positions, tree_bits=bits,
                                row_live=live, **kw)
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(out.float().numpy() - ref).max() <= _bf16_band(ref)


@pytest.mark.parametrize("pool", ["float32", "int8"])
def test_chain_tree_bits_are_the_block_causal_mask(pool):
    """A chain tree (bits[q] = (1 << (q + 1)) - 1) gives bitwise what the
    launch without tree_bits gives, with and without row_live; and rows
    past a lane's frontier block are never read under a tree either."""
    t = 8
    q, kp, vp, tables, positions, live = (torch.as_tensor(x) for x in _live_case(t, 5))
    scales = {}
    if pool == "int8":
        kp, ks = kv.kv_quantize(kp, torch.int8)
        vp, vs = kv.kv_quantize(vp, torch.int8)
        scales = dict(k_scale=ks, v_scale=vs)
    chain = torch.as_tensor(_chain_bits(len(live), t))
    assert chain[0].tolist() == [(1 << (j + 1)) - 1 for j in range(t)]
    kw = dict(kv_limit=KV_LIMIT, num_splits=4, **scales)
    for extra in ({}, dict(row_live=live)):
        out = pa.paged_flash_decode(q, kp, vp, tables, positions, tree_bits=chain, **kw, **extra)
        assert torch.equal(out, pa.paged_flash_decode(q, kp, vp, tables, positions, **kw, **extra))
    bits = torch.as_tensor(_tree_bits(_random_parents(np.random.default_rng(6), len(live), t)))
    out = pa.paged_flash_decode(q, kp, vp, tables, positions, tree_bits=bits, **kw)
    cut = tables.clone()
    for j, p in enumerate(positions.tolist()):
        cut[j, (p + t - 1) // BS + 1:] = 0
    assert torch.equal(pa.paged_flash_decode(q, kp, vp, cut, positions, tree_bits=bits, **kw), out)


def test_tree_bits_are_validated_as_jax_does():
    """t > 32 and a shape other than (b, t) raise in the wrapper, the plain
    version and the JAX kernel alike; on the card the launch also needs
    int32, contiguous, on q's device."""
    q, kp, vp, tables, positions = (torch.as_tensor(x) for x in _case(4, seed=0))
    wide = torch.as_tensor(np.random.default_rng(0).standard_normal((B, 33, N, D)),
                           dtype=torch.float32)
    for qq, bits, match in (
        (wide, torch.zeros((B, 33), dtype=torch.int32), "must be <= 32"),
        (q, torch.zeros((B, 3), dtype=torch.int32), "tree_bits must be"),
        (q, torch.zeros((2, 4), dtype=torch.int32), "tree_bits must be"),
    ):
        for fn in (pa.paged_flash_decode, pa.paged_flash_decode_reference):
            with pytest.raises(ValueError, match=match):
                fn(qq, kp, vp, tables, positions, tree_bits=bits)
        with pytest.raises(ValueError, match=match):
            jax_paged_flash_decode(
                _jax(qq), _jax(kp), _jax(vp), _jax(tables), _jax(positions),
                tree_bits=_jax(bits),
            )
    bf = (q.bfloat16(), kp.bfloat16(), vp.bfloat16(), tables, positions, 8, 1, 8)
    ok = torch.zeros((B, 4), dtype=torch.int32)
    for bits, match in (
        (ok.long(), "tree_bits must be int32"),
        (torch.zeros((4, B), dtype=torch.int32).t(), "tree_bits must be contiguous"),
        (ok.to("meta"), "tree_bits is on meta"),
    ):
        with pytest.raises(ValueError, match=match):
            pa._launch(*bf, tree_bits=bits)


def test_wide_tiles_reach_the_launch():
    """No t * G cap is left before the CUDA launch: a linear t = 32 block at
    G = 2 (64 rows) and a t = 40 block (80 rows, two row chunks on the
    card) pass every check the launcher makes of its arguments and stop
    only at its block-size check; on the CPU both run the plain version."""
    for t in (32, 40):
        q, kp, vp, tables, positions = (torch.as_tensor(x) for x in _case(t, seed=t))
        positions = torch.as_tensor([0, 17, 0], dtype=torch.int32)
        out = pa.paged_flash_decode(q, kp, vp, tables, positions, kv_limit=KV_LIMIT)
        assert out.shape == q.shape and bool(torch.isfinite(out).all())
        bf = (q.bfloat16(), kp.bfloat16(), vp.bfloat16(), tables, positions, 8, 1, 8)
        with pytest.raises(ValueError, match="block_size 16 and head_dim"):
            pa._launch(*bf)


# -- the route between csrc/paged_decode.cu, paged_decode_tile.cu, paged_decode_t1.cu

ROUTES = [
    # (pool dtype, t, G, head_dim, source)
    (torch.bfloat16, 2, 4, 64, "tile"),
    (torch.bfloat16, 8, 4, 64, "tile"),
    (torch.bfloat16, 32, 4, 64, "tile"),     # 128 rows, the widest tile
    (torch.bfloat16, 16, 3, 128, "tile"),    # the 3B geometry
    (torch.bfloat16, 1, 4, 64, "t1"),        # the t == 1 decode
    (torch.bfloat16, 1, 3, 128, "t1"),
    (torch.int8, 1, 4, 64, "t1"),            # every payload at t == 1
    (torch.int8, 1, 3, 128, "t1"),
    (torch.float8_e4m3fn, 1, 4, 64, "t1"),
    (torch.float8_e4m3fn, 1, 3, 128, "t1"),
    (torch.float8_e5m2, 1, 4, 64, "t1"),
    (torch.float8_e5m2, 1, 3, 128, "t1"),
    (torch.bfloat16, 1, 16, 64, "split"),    # G past T1_MAX_GROUP
    (torch.bfloat16, 1, 4, 32, "split"),     # a head_dim no source takes
    (torch.int8, 8, 4, 64, "tile"),          # every payload at t > 1
    (torch.float8_e4m3fn, 8, 4, 64, "tile"),
    (torch.float8_e5m2, 8, 4, 64, "tile"),
    (torch.int8, 16, 3, 128, "tile"),        # a quantized pool, the 3B geometry
    (torch.float8_e5m2, 16, 3, 128, "tile"),
    (torch.bfloat16, 40, 4, 64, "split"),    # 160 rows
    (torch.int8, 40, 4, 64, "split"),
    (torch.bfloat16, 8, 4, 32, "split"),     # a head_dim neither source takes
    (torch.int8, 8, 4, 32, "split"),
    (torch.float8_e4m3fn, 1, 4, 32, "split"),
    # head_dim 96 (gpt-neox-20b, G 1) routes as 64 and 128 do, every payload
    (torch.bfloat16, 1, 1, 96, "t1"),
    (torch.int8, 1, 1, 96, "t1"),
    (torch.float8_e4m3fn, 1, 1, 96, "t1"),
    (torch.float8_e5m2, 1, 8, 96, "t1"),
    (torch.bfloat16, 8, 1, 96, "tile"),
    (torch.int8, 8, 1, 96, "tile"),
    (torch.float8_e4m3fn, 128, 1, 96, "tile"),  # 128 rows, the widest tile
    (torch.bfloat16, 256, 1, 96, "split"),     # the chunked serve's 256-token chunks
    (torch.int8, 256, 1, 96, "split"),
    (torch.bfloat16, 1, 9, 96, "split"),       # G past T1_MAX_GROUP
]


@pytest.mark.parametrize("dtype,t,g,d,want", ROUTES,
                         ids=[f"{str(r[0])[6:]}-t{r[1]}-g{r[2]}-d{r[3]}" for r in ROUTES])
def test_kernel_route(dtype, t, g, d, want):
    assert pa.kernel_route(dtype, t, g, d) == want


def _launch_case(t, pool="bf16", b=2, n=8, nkv=2, d=64, nb=6, w=4):
    """CPU tensors that pass every check of the CUDA launch path: bf16 q,
    16-row blocks, head_dim d (64 unless asked), G = 4."""
    rng = np.random.default_rng(t)
    q = torch.as_tensor(rng.standard_normal((b, t, n, d))).bfloat16()
    kp = torch.as_tensor(rng.standard_normal((nb, 16, nkv, d))).bfloat16()
    vp = torch.as_tensor(rng.standard_normal((nb, 16, nkv, d))).bfloat16()
    scales = {}
    if pool != "bf16":
        kp, ks = kv.kv_quantize(kp, kv.kv_cache_torch_dtype(pool))
        vp, vs = kv.kv_quantize(vp, kv.kv_cache_torch_dtype(pool))
        scales = dict(k_scale=ks, v_scale=vs)
    tables = torch.as_tensor(rng.integers(1, nb, size=(b, w)), dtype=torch.int32)
    positions = torch.as_tensor([0, 9][:b], dtype=torch.int32)
    return (q, kp, vp, tables, positions), scales


# the ints of each C entry point, and where head_dim sits among them
ENTRY_INTS = {"split": (12, 4), "tile": (12, 4), "t1": (10, 3)}


@pytest.fixture
def fake_entries(monkeypatch):
    """The three C entry points replaced by recorders (no library is
    built): ``calls`` gets (source, ints, pointers) for each launch."""
    calls = []

    def entry(source, n_ptrs):
        n_ints, head_dim = ENTRY_INTS[source]

        def fn(*args):
            assert len(args) == n_ptrs + n_ints + 2
            ints = args[n_ptrs:-2]
            assert all(isinstance(x, int) for x in ints)
            assert args[-2] == pytest.approx(ints[head_dim] ** -0.5)
            calls.append((source, ints, args[:n_ptrs]))
            return 0
        return lambda: fn

    monkeypatch.setattr(pa, "_kernel", entry("split", 13))
    monkeypatch.setattr(pa, "_tile_kernel", entry("tile", 13))
    monkeypatch.setattr(pa, "_t1_kernel", entry("t1", 14))
    monkeypatch.setattr(pa, "_stream", lambda device: 0)
    for c in (pa.launches, pa.row_live_launches, pa.tree_launches, pa.tile_launches,
              pa.t1_launches):
        c.reset()
    return calls


LAUNCHES = [
    # (t, pool, row_live, tree_bits, kernel, source)
    (4, "bf16", False, False, "auto", "tile"),
    (4, "bf16", True, False, "auto", "tile"),
    (4, "bf16", False, True, "auto", "tile"),
    (4, "bf16", True, True, "auto", "tile"),
    (4, "bf16", False, False, "split", "split"),
    (4, "bf16", False, True, "split", "split"),
    (1, "bf16", False, False, "auto", "t1"),
    (1, "bf16", True, False, "auto", "t1"),
    (1, "bf16", False, True, "auto", "t1"),
    (1, "int8", False, False, "auto", "t1"),
    (1, "fp8_e4m3", False, False, "auto", "t1"),
    (1, "fp8_e5m2", False, False, "auto", "t1"),
    (1, "bf16", False, False, "t1", "t1"),
    (1, "bf16", False, False, "split", "split"),  # the same-call yardstick
    (1, "int8", False, False, "split", "split"),
    (4, "int8", False, False, "auto", "tile"),
    (4, "int8", True, False, "auto", "tile"),
    (4, "fp8_e4m3", False, True, "auto", "tile"),
    (4, "fp8_e5m2", True, True, "auto", "tile"),
    (4, "int8", False, False, "tile", "tile"),
    (4, "int8", True, False, "split", "split"),  # the same-call yardstick at t > 1
    (4, "fp8_e5m2", False, True, "split", "split"),
    (40, "bf16", False, False, "auto", "split"),
    (40, "int8", False, False, "auto", "split"),
]
# the same launches at head_dim 96, each source and payload
LAUNCHES = [c + (64,) for c in LAUNCHES] + [
    (1, "bf16", False, False, "auto", "t1", 96),
    (1, "fp8_e4m3", False, False, "auto", "t1", 96),
    (4, "int8", True, False, "auto", "tile", 96),
    (4, "fp8_e5m2", False, True, "auto", "tile", 96),
    (4, "bf16", False, False, "split", "split", 96),
    (40, "bf16", False, False, "auto", "split", 96),
    (40, "int8", False, False, "auto", "split", 96),
]


@pytest.mark.parametrize(
    "t,pool,live,tree,kernel,source,d", LAUNCHES,
    ids=[f"t{c[0]}-{c[1]}{'-live' if c[2] else ''}{'-tree' if c[3] else ''}-{c[4]}"
         + ("" if c[6] == 64 else f"-d{c[6]}") for c in LAUNCHES])
def test_launch_calls_the_routed_entry(fake_entries, t, pool, live, tree, kernel, source, d):
    """_launch hands the routed C entry point the geometry's ints, then the
    payload kind and quant_mxu (t1 takes no t and no blocks per split) and
    ticks tile_launches or t1_launches for its own source only; row_live and
    tree_bits launches are counted as before, whichever source takes
    them."""
    args, scales = _launch_case(t, pool, d=d)
    b = args[0].shape[0]
    kw = dict(scales)
    if live:
        kw["row_live"] = torch.full((b,), max(1, t - 1), dtype=torch.int32)
    if tree:
        kw["tree_bits"] = torch.as_tensor(_chain_bits(b, t))
    out = pa._launch(*args, 3, 2, 2, kernel=kernel, **kw)
    assert out.shape == args[0].shape and out.dtype == torch.bfloat16
    mode = (pa.KV_KINDS[args[1].dtype], 0)
    want = {
        "tile": (b, t, 8, 2, d, 16, 4, 3, 2, 2) + mode,
        "split": (b, t, 8, 2, d, 16, 4, 3, 2, 2) + mode,
        "t1": (b, 8, 2, d, 16, 4, 3, 2) + mode,
    }[source]
    assert [(s, i) for s, i, _ in fake_entries] == [(source, want)]
    assert pa.launches.count == 1
    assert pa.tile_launches.count == (source == "tile")
    assert pa.t1_launches.count == (source == "t1")
    assert pa.row_live_launches.count == live
    assert pa.tree_launches.count == tree


T1_POOLS = [("bf16", False)] + [(p, m) for p in QDTYPES for m in (False, True)]


@pytest.mark.parametrize("pool,mxu", T1_POOLS,
                         ids=[f"{p}{'-mxu' if m else ''}" for p, m in T1_POOLS])
def test_t1_launch_passes_its_pointers(fake_entries, pool, mxu):
    """csrc/paged_decode_t1.cu gets 14 pointers: q, the pools, the scales
    (null for a bf16 pool), tables, positions, row_live and tree_bits (null
    unless passed), the three scratch parts, the output, and the
    (lane, kv head) arrival counters, zero and one per (lane, kv head) at
    least; its last two ints are the payload kind and quant_mxu."""
    args, scales = _launch_case(1, pool)
    q, kp = args[0], args[1]
    out = pa._launch(*args, 3, 2, 2, quant_mxu=mxu, **scales)
    ((source, ints, ptrs),) = fake_entries
    assert source == "t1" and ints[-2:] == (pa.KV_KINDS[kp.dtype], int(mxu))
    assert ptrs[:3] == (q.data_ptr(), kp.data_ptr(), args[2].data_ptr())
    if scales:
        assert ptrs[3:5] == (scales["k_scale"].data_ptr(), scales["v_scale"].data_ptr())
    else:
        assert ptrs[3:5] == (None, None)
    assert ptrs[5:7] == (args[3].data_ptr(), args[4].data_ptr())
    assert ptrs[7:9] == (None, None)
    assert ptrs[12] == out.data_ptr()
    arrivals = pa._T1_ARRIVALS[q.device]
    assert ptrs[13] == arrivals.data_ptr()
    assert arrivals.dtype == torch.int32 and arrivals.numel() >= q.shape[0] * kp.shape[2]
    assert not arrivals.any()
    assert pa.t1_launches.count == 1


@pytest.mark.parametrize("t,pool", [(1, "bf16"), (1, "int8"), (40, "fp8_e4m3"),
                                    (40, "fp8_e5m2"), (40, "bf16")])
def test_tile_kernel_takes_only_its_calls(fake_entries, t, pool):
    """Forcing the tile source on a call it does not take (t == 1, or t * G
    past TILE_MAX_ROWS), whatever the payload, raises before any launch, as
    does a source name that does not exist."""
    args, scales = _launch_case(t, pool)
    with pytest.raises(ValueError, match="paged_decode_tile.cu takes"):
        pa._launch(*args, 3, 2, 2, kernel="tile", **scales)
    with pytest.raises(ValueError, match="kernel must be"):
        pa._launch(*args, 3, 2, 2, kernel="cutlass", **scales)
    assert fake_entries == [] and pa.launches.count == 0


@pytest.mark.parametrize("t,pool,n", [(4, "bf16", 8), (4, "int8", 8), (40, "bf16", 8),
                                      (1, "bf16", 18)])
def test_t1_kernel_takes_only_its_calls(fake_entries, t, pool, n):
    """Forcing csrc/paged_decode_t1.cu on a call it does not take (t > 1, or
    G = 9 past T1_MAX_GROUP) raises before any launch; at G = 9 and t == 1
    the route picks csrc/paged_decode.cu."""
    args, scales = _launch_case(t, pool, n=n)
    with pytest.raises(ValueError, match="paged_decode_t1.cu takes"):
        pa._launch(*args, 3, 2, 2, kernel="t1", **scales)
    assert fake_entries == [] and pa.launches.count == 0
    if t == 1:
        pa._launch(*args, 3, 2, 2, **scales)
        assert [s for s, _, _ in fake_entries] == ["split"] and pa.t1_launches.count == 0


def test_a_t1_launch_error_raises(monkeypatch):
    """A refused t1 launch raises; nothing retries on another source."""
    monkeypatch.setattr(pa, "_t1_kernel", lambda: lambda *a: 1)
    monkeypatch.setattr(pa, "_kernel", lambda: pytest.fail("retried on the split source"))
    monkeypatch.setattr(pa, "_tile_kernel", lambda: pytest.fail("retried on the tile source"))
    monkeypatch.setattr(pa, "_stream", lambda device: 0)
    pa.t1_launches.reset()
    args, _ = _launch_case(1)
    with pytest.raises(RuntimeError, match="paged_decode_t1 launch failed"):
        pa._launch(*args, 3, 2, 2)
    assert pa.t1_launches.count == 0


@pytest.mark.parametrize("live", [False, True], ids=["walk", "row_live"])
@pytest.mark.parametrize("pool,mxu", T1_POOLS,
                         ids=[f"{p}{'-mxu' if m else ''}" for p, m in T1_POOLS])
def test_tile_launch_passes_its_scales(fake_entries, pool, mxu, live):
    """csrc/paged_decode_tile.cu gets 13 pointers: q, the pools, the scales
    (null for a bf16 pool), tables, positions, row_live and tree_bits (null
    unless passed), the three scratch parts and the output; its last two
    ints are the payload kind and quant_mxu."""
    args, scales = _launch_case(8, pool)
    q, kp, vp, tables, positions = args
    kw = dict(row_live=torch.full((q.shape[0],), 5, dtype=torch.int32)) if live else {}
    out = pa._launch(*args, 3, 2, 2, quant_mxu=mxu, **scales, **kw)
    ((source, ints, ptrs),) = fake_entries
    assert source == "tile" and ints[-2:] == (pa.KV_KINDS[kp.dtype], int(mxu))
    assert ptrs[:3] == (q.data_ptr(), kp.data_ptr(), vp.data_ptr())
    if scales:
        assert ptrs[3:5] == (scales["k_scale"].data_ptr(), scales["v_scale"].data_ptr())
    else:
        assert ptrs[3:5] == (None, None)
    assert ptrs[5:7] == (tables.data_ptr(), positions.data_ptr())
    assert ptrs[7:9] == ((kw["row_live"].data_ptr() if live else None), None)
    assert ptrs[12] == out.data_ptr()
    assert pa.tile_launches.count == 1 and pa.launches.count == 1


def test_a_tile_launch_error_raises(monkeypatch):
    """A refused tile launch raises; nothing retries on the split source."""
    monkeypatch.setattr(pa, "_tile_kernel", lambda: lambda *a: 1)
    monkeypatch.setattr(pa, "_kernel", lambda: pytest.fail("retried on the split source"))
    monkeypatch.setattr(pa, "_stream", lambda device: 0)
    args, _ = _launch_case(4)
    with pytest.raises(RuntimeError, match="paged_decode_tile launch failed"):
        pa._launch(*args, 3, 2, 2)


# -- csrc/paged_decode_t1.cu's partition of each lane's walk -----------------------

T1_KV_LIMIT, T1_BS = 512, 16
T1_NBLK = T1_KV_LIMIT // T1_BS
# lane 0 at row 0, lanes whose row opens a pool block (16, 64, 256), lanes
# inside one, and the last row under kv_limit
T1_POSITIONS = [0, 15, 16, 17, 64, 100, 256, T1_KV_LIMIT - 1]


@pytest.mark.parametrize("live", [False, True], ids=["walk", "row_live"])
@pytest.mark.parametrize("splits", [1, 3, 4, 16, 64])
def test_t1_split_ranges_cover_the_walk(splits, live):
    """Each lane's ranges are disjoint and contiguous, at most ``splits`` of
    them, all of ceil(nb / splits) blocks but the last, and cover exactly
    the blocks the walk reads (walked_rows): from block 0 to the block
    holding the lane's row, none for a walk of no block. Splits beyond a
    lane's blocks (64 splits, or row 0's single block) take nothing."""
    positions = torch.as_tensor(T1_POSITIONS, dtype=torch.int32)
    # row_live 0 ends the walk at the block holding pos - 1 (none at row 0)
    row_live = torch.as_tensor([0, 1, 0, 0, 1, 0, 0, 1], dtype=torch.int32) if live else None
    ranges = pa.t1_split_ranges(positions, T1_NBLK, splits, row_live, bs=T1_BS)
    walked = (pa.walked_rows(positions, 1, T1_NBLK, T1_BS, row_live) // T1_BS).tolist()
    assert len(ranges) == len(T1_POSITIONS)
    for lane, (nb, r) in enumerate(zip(walked, ranges)):
        pos = T1_POSITIONS[lane]
        frontier = pos if row_live is None else pos + int(row_live[lane]) - 1
        assert nb == (0 if frontier < 0 else min(T1_NBLK, frontier // T1_BS + 1))
        if nb == 0:
            assert r == []
            continue
        c = -(-nb // splits)
        assert 1 <= len(r) <= splits
        assert r[0][0] == 0 and r[-1][1] == nb
        assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
        assert all(hi - lo == c for lo, hi in r[:-1]) and 0 < r[-1][1] - r[-1][0] <= c
    assert walked[0] == (0 if live else 1) and walked[-1] == T1_NBLK


def _split_merge(q, pool, tables, positions, splits, mxu):
    """The plain version's fp32 scores cut at each lane's
    t1_split_ranges, each range's (acc, m, l) taken alone and merged by
    log-sum-exp as csrc/paged_decode_t1.cu's last split merges them."""
    kp, vp, ks, vs = pool
    q4 = q[:, None]
    scores, mask, v_all = pa._masked_scores(
        q4, kp, vp, tables, positions, kv_limit=KV_LIMIT, k_scale=ks, v_scale=vs,
        quant_mxu=mxu, row_live=None, tree_bits=None,
    )
    nblk = KV_LIMIT // BS
    out = torch.zeros(q.shape, dtype=torch.float32)
    for i, lane in enumerate(pa.t1_split_ranges(positions, nblk, splits, bs=BS)):
        parts = []
        for lo, hi in lane:
            sc = scores[i, ..., 0, lo * BS:hi * BS]               # (NKV, G, rows)
            m = sc.amax(dim=-1)
            p = torch.where(sc == float("-inf"), 0.0, torch.exp(sc - m[..., None]))
            acc = torch.einsum("kgs,skd->kgd", p, v_all[i, lo * BS:hi * BS])
            parts.append((acc, m, p.sum(dim=-1)))
        m_star = torch.stack([m for _, m, _ in parts]).amax(dim=0)
        l_tot = torch.zeros_like(m_star)
        acc_tot = torch.zeros_like(parts[0][0])
        for acc, m, l in parts:
            wgt = torch.where(m == float("-inf"), 0.0, torch.exp(m - m_star))
            l_tot += wgt * l
            acc_tot += wgt[..., None] * acc
        out[i] = (acc_tot / torch.where(l_tot == 0, 1.0, l_tot)[..., None]).reshape(N, D)
    return out


T1_MERGE_CASES = [("float32", False)] + [(p, m) for p in ("int8", "fp8_e4m3")
                                         for m in (False, True)]


@pytest.mark.parametrize("splits", [3, 16])
@pytest.mark.parametrize("pool,mxu", T1_MERGE_CASES,
                         ids=[f"{p}{'-mode6' if m else '-mode3' if p != 'float32' else ''}"
                              for p, m in T1_MERGE_CASES])
def test_t1_split_merge_is_the_plain_version(pool, mxu, splits):
    """Attention over each range of t1_split_ranges alone, merged by
    log-sum-exp, is the plain version in fp32 (within 1e-6: summation
    order), on _case's garbage-filled tables at t == 1; and it matches
    JAX's interpret-mode kernel at test_matches_jax_kernel's 2e-5, on the
    float32 pool and on int8 / fp8 e4m3 pools in modes 3 and 6."""
    if pool == "float32":
        q, kp, vp, tables, positions = (torch.as_tensor(x) for x in _case(1, seed=40 + splits))
        quant = (kp, vp, None, None)
    else:
        q, quant, tables, positions = _quantized_case(1, 40 + splits, pool)
    q = q[:, 0]
    merged = _split_merge(q, quant, tables, positions, splits, mxu)
    kp, vp, ks, vs = quant
    kw = dict(kv_limit=KV_LIMIT, k_scale=ks, v_scale=vs, quant_mxu=mxu)
    ref = pa.paged_flash_decode_reference(q, kp, vp, tables, positions, **kw)
    torch.testing.assert_close(merged, ref, atol=1e-6, rtol=1e-5)
    jax_kw = {k: (_jax(v) if isinstance(v, torch.Tensor) else v) for k, v in kw.items()
              if v is not None}
    want = jax_paged_flash_decode(
        _jax(q), _jax(kp), _jax(vp), _jax(tables), _jax(positions), num_splits=4, **jax_kw)
    np.testing.assert_allclose(merged.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("b,nkv,nblk", [(8, 8, 64), (8, 8, 8), (1, 8, 128), (1, 8, 2),
                                        (64, 8, 64), (1, 1, 1), (3, 2, 1000), (8, 2, 128)])
def test_t1_num_splits_fills_the_card(b, nkv, nblk):
    """At least 1 and at most nblk splits; within that, the smallest power
    of two that gives T1_MIN_BLOCKS thread blocks."""
    s = pa.t1_num_splits(b, nkv, nblk)
    assert 1 <= s <= nblk
    if s < nblk:
        assert b * nkv * s >= pa.T1_MIN_BLOCKS and s & (s - 1) == 0
        assert s == 1 or b * nkv * (s // 2) < pa.T1_MIN_BLOCKS


def test_t1_split_count_of_a_call():
    """A t == 1 call without num_splits takes t1_num_splits, a num_splits
    the caller passes overrides it (capped at nblk), and a source forced to
    csrc/paged_decode.cu keeps DEFAULT_NUM_SPLITS, as the t > 1 calls do."""
    args, _ = _launch_case(1, b=2, nkv=2, w=64)
    q, kp, _, tables, _ = args
    nblk = 1024 // 16
    assert pa._geometry(q, kp, tables, 1024, None)[1] == pa.t1_num_splits(2, 2, nblk) == 64
    assert pa._geometry(q, kp, tables, 1024, 3)[1] == 3
    assert pa._geometry(q, kp, tables, 1024, 100)[1] == nblk
    assert pa._geometry(q, kp, tables, 1024, None, source="split")[1] == pa.DEFAULT_NUM_SPLITS
    q4, _ = _launch_case(4, b=2, nkv=2, w=64)
    assert pa._geometry(q4[0], q4[1], q4[3], 1024, None)[1] == pa.DEFAULT_NUM_SPLITS


# -- csrc/paged_decode_tile.cu's walk on the quantized pools ----------------------

TILE_BS = 16  # the kernel's pool block
TILE_KV_LIMIT = 160  # ten blocks: four splits of 3, 3, 3 and 1
TILE_NB = 48


def _tile_quant_case(t, seed, name):
    """fp32 q and a pool of 16-row blocks quantized to ``name``, over
    tables that hold distinct real blocks up to each lane's frontier and
    random ids (0 among them) past it; lanes at row 0, inside a block, at a
    row whose fresh block opens a pool block, further on, and at the last
    rows under TILE_KV_LIMIT. Random live counts (0 at row 0) and random
    branching trees. Returns (q, (k, v, k_scale, v_scale), tables,
    positions, row_live, tree_bits) as torch tensors."""
    rng = np.random.default_rng(seed)
    positions = np.asarray([0, 21, 48 - t + 1, 97, TILE_KV_LIMIT - t], np.int32)
    b = len(positions)
    q = rng.standard_normal((b, t, N, D)).astype(np.float32)
    kp = torch.as_tensor(rng.standard_normal((TILE_NB, TILE_BS, NKV, D)), dtype=torch.float32)
    vp = torch.as_tensor(rng.standard_normal((TILE_NB, TILE_BS, NKV, D)), dtype=torch.float32)
    w = TILE_KV_LIMIT // TILE_BS + 2
    tables = rng.integers(0, TILE_NB, size=(b, w)).astype(np.int32)
    ids = rng.permutation(np.arange(1, TILE_NB))
    for j, p in enumerate(positions):
        n = (p + t - 1) // TILE_BS + 1
        tables[j, :n], ids = ids[:n], ids[n:]
    live = rng.integers(1, t + 1, size=b).astype(np.int32)
    live[0] = 0
    bits = _tree_bits(_random_parents(rng, b, t))
    qdt = kv.KV_CACHE_DTYPES[name]
    kq, ks = kv.kv_quantize(kp, qdt)
    vq, vs = kv.kv_quantize(vp, qdt)
    return (torch.as_tensor(q), (kq, vq, ks, vs), torch.as_tensor(tables),
            torch.as_tensor(positions), torch.as_tensor(live), torch.as_tensor(bits))


def _tile_walk(q, pool, tables, positions, mxu, row_live, tree_bits):
    """csrc/paged_decode_tile.cu's arithmetic, block by block, in torch: for
    each (lane, split) of the tile source's geometry, the walk over the
    split's 16-row blocks up to the one holding pos + t - 1, broken at the
    live frontier under row_live; each block's scores (mode 3: q . K
    dequantized to q's dtype; mode 6 on int8: the int32 dot of q
    requantized per tile row with the payload, times q_scale, k_scale and
    sm_scale in that order; on fp8: q cast to the payload's type . the
    payload, times k_scale and sm_scale), masked as the kernel masks them;
    the online softmax with its m == -inf guards, p rounded to q's dtype
    for P.V; then the combine's log-sum-exp merge of the splits."""
    kp, vp, ks, vs = pool
    b, t, n, d = q.shape
    nkv = kp.shape[2]
    g = n // nkv
    tg = t * g
    sm_scale = d ** -0.5
    nblk, splits, bps = pa._geometry(q, kp, tables, TILE_KV_LIMIT, None, source="tile")
    # tile row r = ti * G + gi of kv head h holds q[:, ti, h * G + gi]
    qt = q.float().reshape(b, t, nkv, g, d).permute(0, 2, 1, 3, 4).reshape(b, nkv, tg, d)
    int8_mxu = mxu and kp.dtype == torch.int8
    if int8_mxu:
        q_scl = qt.abs().amax(dim=-1).clamp_min(1e-6) / 127.0                 # (b, nkv, tg)
        q_op = torch.clamp(torch.round(qt / q_scl[..., None]), -127.0, 127.0)
    elif mxu:
        q_op = pa.fp8_query(qt, kp.dtype)
    else:
        q_op = qt
    k_deq = kv.kv_dequantize(kp, ks, q.dtype).float()
    v_deq = kv.kv_dequantize(vp, vs, q.dtype).float()
    ti = torch.arange(tg) // g
    neg = float("-inf")
    out = torch.zeros(b, nkv, tg, d)
    for i in range(b):
        pos = int(positions[i])
        frontier = (pos + t - 1) // TILE_BS + 1
        live_all = frontier if row_live is None else min(
            frontier, (pos + int(row_live[i]) + TILE_BS - 1) // TILE_BS)
        parts = []
        for s in range(splits):
            lb_stop = min((s + 1) * bps, nblk, frontier)
            live_stop = min(lb_stop, live_all)
            m = torch.full((nkv, tg), neg)
            l = torch.zeros(nkv, tg)
            acc = torch.zeros(nkv, tg, d)
            for lb in range(s * bps, lb_stop):
                if lb >= live_stop:
                    break
                blk = int(tables[i, lb])
                if mxu:
                    dot = torch.einsum("krd,ckd->krc", q_op[i], kp[blk].float())
                    k_col = ks[blk].float().t()[:, None, :]                    # (nkv, 1, 16)
                    sc = (dot * q_scl[i][..., None] * k_col if int8_mxu else dot * k_col)
                    sc = sc * sm_scale
                else:
                    sc = torch.einsum("krd,ckd->krc", q_op[i], k_deq[blk]) * sm_scale
                u = lb * TILE_BS + torch.arange(TILE_BS) - pos
                if tree_bits is None:
                    ok = u[None, :] <= ti[:, None]
                else:
                    node = tree_bits[i].long()[ti][:, None]
                    ok = (u[None, :] < 0) | ((u[None, :] < t)
                                             & (((node >> u.clamp(0, 31)[None, :]) & 1) > 0))
                sc = torch.where(ok[None], sc, neg)
                m_new = torch.maximum(m, sc.amax(dim=-1))
                alpha = torch.where(m == neg, 0.0, torch.exp(m - m_new))
                p = torch.where(sc == neg, 0.0, torch.exp(sc - m_new[..., None]))
                l = l * alpha + p.sum(dim=-1)
                pv = torch.einsum("krc,ckd->krd", p.to(q.dtype).float(), v_deq[blk])
                acc = acc * alpha[..., None] + pv
                m = m_new
            parts.append((acc, m, l))
        m_star = torch.stack([pm for _, pm, _ in parts]).amax(dim=0)
        l_tot = torch.zeros(nkv, tg)
        acc_tot = torch.zeros(nkv, tg, d)
        for pacc, pm, pl in parts:
            wgt = torch.where(pm == neg, 0.0, torch.exp(pm - m_star))
            l_tot += wgt * pl
            acc_tot += wgt[..., None] * pacc
        out[i] = acc_tot / torch.where(l_tot == 0, 1.0, l_tot)[..., None]
    return out.reshape(b, nkv, t, g, d).permute(0, 2, 1, 3, 4).reshape(b, t, n, d)


TILE_MERGE_CASES = [(p, m, masks) for p in QDTYPES for m in (False, True)
                    for masks in ("walk", "row_live", "tree_bits", "row_live+tree_bits")]


@pytest.mark.parametrize(
    "pool,mxu,masks", TILE_MERGE_CASES,
    ids=[f"{p}-mode{6 if m else 3}-{k}" for p, m, k in TILE_MERGE_CASES])
def test_tile_quant_split_merge_is_the_plain_version(pool, mxu, masks):
    """The tile source's walk on a quantized pool, block by block and split
    by split (``_tile_walk``), merged by log-sum-exp, is the plain version in
    fp32 (within 1e-6: summation order) and matches JAX's interpret-mode
    kernel within 2e-5, in modes 3 and 6 on int8, fp8 e4m3 and e5m2 pools,
    with and without row_live and tree_bits."""
    t = 6
    q, quant, tables, positions, live, bits = _tile_quant_case(t, 60 + len(masks), pool)
    kp, vp, ks, vs = quant
    extra = {}
    if "row_live" in masks:
        extra["row_live"] = live
    if "tree_bits" in masks:
        extra["tree_bits"] = bits
    assert pa.kernel_route(kp.dtype, t, N // NKV, 64) == "tile"
    walked = _tile_walk(q, quant, tables, positions, mxu, extra.get("row_live"),
                        extra.get("tree_bits"))
    kw = dict(kv_limit=TILE_KV_LIMIT, k_scale=ks, v_scale=vs, quant_mxu=mxu, **extra)
    ref = pa.paged_flash_decode_reference(q, kp, vp, tables, positions, **kw)
    torch.testing.assert_close(walked, ref, atol=1e-6, rtol=1e-5)
    want = jax_paged_flash_decode(
        _jax(q), _jax(kp), _jax(vp), _jax(tables), _jax(positions), num_splits=4,
        **_jax_kw(kw))
    np.testing.assert_allclose(walked.numpy(), np.asarray(want), atol=2e-5)
