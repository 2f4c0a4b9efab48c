"""The port's loss (parallel/loss.py, LlamaForCausalLM.loss) against the
JAX package's, on the CPU, in fp32.

Values and gradients agree to 1e-5 relative: both sides compute the same
fp32 log-sum-exp and differ only in summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.models import llama as jllama
from neuronx_distributed_llama3_2_tpu.parallel import loss as jloss
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama
from neuronx_distributed_llama3_2_tpu_torch.parallel import loss as tloss

torch.set_num_threads(1)
V = 50


def _labels(shape, seed):
    """Labels with IGNORE_INDEX, -1 and out-of-vocab ids mixed in."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, V, size=shape)
    flat = labels.reshape(-1)
    flat[::7] = tloss.IGNORE_INDEX
    flat[3::11] = V + 3
    flat[5::13] = -1
    return labels


def test_ignore_index_and_valid_token_mask_match_jax():
    assert tloss.IGNORE_INDEX == jloss.IGNORE_INDEX
    labels = _labels((4, 9), 0)
    ref = np.asarray(jloss.valid_token_mask(jnp.asarray(labels), V))
    out = tloss.valid_token_mask(torch.as_tensor(labels), V).numpy()
    np.testing.assert_array_equal(out, ref)
    assert 0 < out.sum() < out.size


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_values_and_grads_match_jax(smoothing):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((3, 7, V))).astype(np.float32)
    labels = _labels((3, 7), 2)
    weights = rng.standard_normal((3, 7)).astype(np.float32)

    def jf(lg):
        per_tok = jloss.cross_entropy(lg, jnp.asarray(labels), smoothing)
        return jnp.sum(per_tok * jnp.asarray(weights)), per_tok

    (_, jper), jgrad = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(logits))
    tl = torch.tensor(logits, requires_grad=True)
    tper = tloss.cross_entropy(tl, torch.as_tensor(labels), smoothing)
    (tper * torch.as_tensor(weights)).sum().backward()
    np.testing.assert_allclose(tper.detach().numpy(), np.asarray(jper), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6)
    # parallel_cross_entropy at tp = 1 is the same function
    np.testing.assert_array_equal(
        tloss.parallel_cross_entropy(tl, torch.as_tensor(labels), smoothing).detach().numpy(),
        tper.detach().numpy(),
    )
    assert (tper.detach().numpy()[~tloss.valid_token_mask(torch.as_tensor(labels), V).numpy()] == 0).all()


@pytest.mark.parametrize("chunk", [4, 5])
def test_fused_linear_cross_entropy_matches_jax(chunk):
    """Chunked LM head + CE (chunk 5 does not divide T = 11): the sum, the
    count and the gradients wrt hidden states and head weight."""
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, 11, 16)).astype(np.float32)
    w = (0.3 * rng.standard_normal((16, V))).astype(np.float32)
    labels = _labels((2, 11), 4)

    def jf(h, w):
        s, n = jloss.fused_linear_cross_entropy(
            h, lambda hc: hc @ w, jnp.asarray(labels), chunk_size=chunk, label_smoothing=0.1
        )
        return s, n

    (js, jn), jvjp = jax.vjp(jf, jnp.asarray(hidden), jnp.asarray(w))
    jgh, jgw = jvjp((jnp.float32(1.0), jnp.float32(0.0)))
    th = torch.tensor(hidden, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ts, tn = tloss.fused_linear_cross_entropy(
        th, lambda hc: hc @ tw, torch.as_tensor(labels), chunk_size=chunk, label_smoothing=0.1
    )
    ts.backward()
    np.testing.assert_allclose(ts.item(), float(js), rtol=1e-5)
    assert tn.item() == float(jn)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk", [None, 8])
def test_model_loss_and_grads_match_jax(chunk):
    """LlamaForCausalLM.loss on tiny (labels with ignored positions): the
    loss and every parameter's gradient, compared through params_to_jax."""
    jcfg = dataclasses.replace(jllama.LLAMA_CONFIGS["tiny"], loss_chunk_size=chunk)
    tcfg = dataclasses.replace(tllama.LLAMA_CONFIGS["tiny"], loss_chunk_size=chunk)
    jmodel = jllama.LlamaForCausalLM(jcfg)
    jp = jmodel.init(jax.random.key(0))
    rng = np.random.default_rng(5)
    ids = rng.integers(0, jcfg.vocab_size, size=(2, 20))
    labels = ids.copy()
    labels[0, 3:6] = tloss.IGNORE_INDEX
    jl, jg = jax.value_and_grad(jmodel.loss)(jp, jnp.asarray(ids), jnp.asarray(labels))
    model = tllama.LlamaForCausalLM(tcfg, device="cpu")
    model.load_state_dict(tllama.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    tl = model.loss(torch.as_tensor(ids), torch.as_tensor(labels))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    tg = tllama.params_to_jax({k: p.grad for k, p in model.named_parameters()}, tcfg)
    for path, ref in jax.tree_util.tree_leaves_with_path(jg):
        keys = [k.key for k in path]
        out = tg
        for key in keys:
            out = out[key]
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-6, err_msg=str(keys))
