"""The port's paged-decode wrapper and paged decode model against the JAX
package's, on the CPU.

On CPU tensors the wrapper runs its plain version (one masked softmax over
the gathered rows); the JAX side runs its Pallas kernel in interpret mode
(split-K online softmax). In fp32 the two differ only in summation order:
2e-5, the JAX package's own kernel-vs-reference tolerance. The CUDA kernel
itself runs only on the card; ``chip_smoke.py`` holds it against the plain
version there.
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
from neuronx_distributed_llama3_2_tpu_torch.inference.model import LlamaDecode
from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LLAMA_CONFIGS,
    LlamaForCausalLM,
    params_from_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.utils import device as device_mod

torch.set_num_threads(1)

B, N, NKV, D, BS, NB, W = 3, 8, 4, 32, 8, 40, 12  # GQA group G = 2
KV_LIMIT = 64  # below the table capacity W * BS = 96


def _case(t, seed):
    """Pool, tables and positions with garbage everywhere a read must not
    look: random pool contents (the null block included) and random block
    ids (0 among them) in every table entry past a lane's frontier."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, t, N, D)).astype(np.float32)
    kp = rng.standard_normal((NB, BS, NKV, D)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, NKV, D)).astype(np.float32)
    tables = rng.integers(0, NB, size=(B, W)).astype(np.int32)
    # ragged: the first row, mid-block, and the last rows under KV_LIMIT
    positions = np.asarray([0, 17, KV_LIMIT - t], np.int32)
    for i, p in enumerate(positions):
        live = (p + t - 1) // BS + 1
        tables[i, :live] = rng.choice(np.arange(1, NB), size=live, replace=False)
    return q, kp, vp, tables, positions


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("t", [1, 4])
def test_matches_jax_kernel(t, splits):
    q, kp, vp, tables, positions = _case(t, seed=10 * t + splits)
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
    scale = torch.ones(NB, BS, NKV)
    for kw in (
        dict(k_scale=scale, v_scale=scale), dict(quant_mxu=True),
        dict(row_live=positions), dict(tree_bits=torch.zeros(B, 1, dtype=torch.int32)),
    ):
        with pytest.raises(NotImplementedError, match="sub-slice"):
            pa.paged_flash_decode(q, kp, vp, tables, positions, **kw)


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
