"""The PyTorch port's Llama model against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; the
weights cross through ``params_from_jax``. Everything runs in fp32, where
the two implementations differ only in summation order, so outputs agree
to ~1e-5 (tolerances stated per test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.models import llama as jllama
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

LLAMA3_SCALING = (32.0, 1.0, 4.0, 8192)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jllama.LlamaForCausalLM(cfg).init(jax.random.key(seed)))


def _port_model(np_params, cfg):
    model = tllama.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(tllama.params_from_jax(np_params, cfg, device="cpu"))
    return model


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("tied", [True, False])
def test_params_round_trip_is_exact(tied):
    jcfg = dataclasses.replace(jllama.LLAMA_CONFIGS["tiny"], tie_word_embeddings=tied)
    tcfg = dataclasses.replace(tllama.LLAMA_CONFIGS["tiny"], tie_word_embeddings=tied)
    np_params = _jax_params(jcfg)
    back = tllama.params_to_jax(
        _port_model(np_params, tcfg).state_dict(), tcfg
    )
    src, dst = dict(_leaves(np_params)), dict(_leaves(back))
    assert src.keys() == dst.keys()
    for path, a in src.items():
        np.testing.assert_array_equal(dst[path], a, err_msg=str(path))
    assert ("lm_head", "kernel") in src.keys() or tied


def test_bridge_keeps_norms_fp32_and_kernels_in_model_dtype():
    tcfg = dataclasses.replace(tllama.LLAMA_CONFIGS["tiny"], dtype=torch.bfloat16)
    np_params = _jax_params(jllama.LLAMA_CONFIGS["tiny"])
    sd = tllama.params_from_jax(np_params, tcfg, device="cpu")
    assert sd["layers.0.attn_norm.scale"].dtype == torch.float32
    assert sd["final_norm.scale"].dtype == torch.float32
    assert sd["layers.0.mlp.gate_up"].dtype == torch.bfloat16
    assert sd["layers.0.mlp.gate_up"].shape == (64, 2, 128)  # (H, 2, I)
    assert sd["embed.embedding"].dtype == torch.bfloat16


@pytest.mark.parametrize("rope_scaling", [None, LLAMA3_SCALING])
def test_logits_match_jax(rope_scaling):
    # fp32 on both sides; only the summation order differs: 1e-5
    jcfg = dataclasses.replace(jllama.LLAMA_CONFIGS["tiny"], rope_scaling=rope_scaling)
    tcfg = dataclasses.replace(tllama.LLAMA_CONFIGS["tiny"], rope_scaling=rope_scaling)
    np_params = _jax_params(jcfg, seed=1)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 24))
    ref = np.asarray(jllama.LlamaForCausalLM(jcfg)(np_params, jnp.asarray(ids)))
    out = _port_model(np_params, tcfg)(torch.as_tensor(ids))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    ref = jllama.RMSNorm(64, 1e-5, jnp.float32)({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    norm = tllama.RMSNorm(64, 1e-5, torch.float32)
    with torch.no_grad():
        norm.scale.copy_(torch.as_tensor(scale))
    np.testing.assert_allclose(norm(torch.as_tensor(x)).detach().numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("rope_scaling", [None, LLAMA3_SCALING])
def test_rope_tables_and_rotation_match_jax(rope_scaling):
    # the tables agree to fp32 rounding of t * inv_freq (t <= 1023, so a
    # one-ulp difference in inv_freq moves an angle by < 1e-4 rad)
    d, s, theta = 64, 1024, 500000.0
    jsin, jcos = jllama.precompute_rope(d, s, theta, rope_scaling)
    tsin, tcos = tllama.precompute_rope(d, s, theta, rope_scaling)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-4)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-4)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 4, d)).astype(np.float32)
    pos = rng.integers(0, s, size=(2, 6))
    ref = jllama.apply_rope(jnp.asarray(x), jsin, jcos, jnp.asarray(pos))
    out = tllama.apply_rope(torch.as_tensor(x), tsin, tcos, torch.as_tensor(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_core_attention_matches_jax():
    # GQA (8 q heads over 2 kv heads), causal, fp32: 1e-6
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 10, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    ref = jllama.core_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = tllama.core_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_flash_attention_belongs_to_the_training_slice():
    # use_flash_attention (the training slice's attention) on CPU tensors
    # runs the flash autograd function over the kernels' plain versions;
    # fp32 logits equal core_attention's up to summation order, and match
    # JAX's flash path: 1e-5
    ids = np.random.default_rng(0).integers(0, 256, size=(2, 24))
    jcfg = dataclasses.replace(
        jllama.LLAMA_CONFIGS["tiny"], use_flash_attention=True, flash_block_kv=8
    )
    tcfg = dataclasses.replace(
        tllama.LLAMA_CONFIGS["tiny"], use_flash_attention=True, flash_block_kv=8
    )
    np_params = _jax_params(jcfg, seed=2)
    flash = _port_model(np_params, tcfg)(torch.as_tensor(ids))
    plain = _port_model(np_params, tllama.LLAMA_CONFIGS["tiny"])(torch.as_tensor(ids))
    ref = np.asarray(jllama.LlamaForCausalLM(jcfg)(np_params, jnp.asarray(ids)))
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(flash.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_init_weights_is_seeded():
    cfg = tllama.LLAMA_CONFIGS["tiny"]
    a = tllama.LlamaForCausalLM(cfg, device="cpu").init_weights(7)
    b = tllama.LlamaForCausalLM(cfg, device="cpu").init_weights(7)
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), name
    assert a.layers[0].attn.qkv.q_kernel.std().item() == pytest.approx(0.02, rel=0.2)
