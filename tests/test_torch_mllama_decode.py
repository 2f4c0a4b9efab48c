"""The port's ``MllamaDecoder`` (inference/mllama_decode.py) and Mllama's
quantization against the JAX package's, on the CPU, mirroring
``tests/test_mllama_decode.py``.

Weights: ``tests/test_torch_mllama.py``'s (seeded, every gate non-zero),
the text layers' kernels scaled by LAYER_SCALE so that greedy streams do
not repeat one token. One request (the first image, one valid tile of
two, its text attending the image from position 4):

- ``generate`` equals JAX's ``MllamaDecoder.generate`` token for token;
- the decoder's prefill logits equal the model's forward (1e-5 abs +
  1e-4 rel);
- EOS stops after the token and a zero budget returns nothing;
- ``project_kv`` runs once a request per cross layer, not once a token;
- the text layers are bound once a request for the token loop;
- ``quantize_params`` covers the cross-attention q, the vision attention
  and ``fc1``, and the projector, with int8 payloads and scales equal to
  JAX's bit for bit (per channel and per tensor), and a quantized model
  serves the stream of its dequantized weights.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.inference.mllama_decode import MllamaDecoder as JDecoder
from neuronx_distributed_llama3_2_tpu.quantization import quantize as jq
from neuronx_distributed_llama3_2_tpu_torch.inference import MllamaDecoder
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama
from neuronx_distributed_llama3_2_tpu_torch.models import mllama as M
from neuronx_distributed_llama3_2_tpu_torch.quantization import quantize as tq

from tests.test_torch_mllama import JTINY, _j, _leaves, _t, inputs, jax_params, port_model

torch.set_num_threads(1)

LAYER_SCALE = 10.0
NEW = 10


@functools.lru_cache(maxsize=None)
def scaled_params():
    p = jax_params()

    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if path[0] == "layers" and "kernel" in path[-1]:
            return t * LAYER_SCALE
        return t

    return walk(p)


def request():
    pix, ids, ar_ids, ar_mask, xmask = inputs(b=2, s=12)
    return list(ids[0]), pix[:1], ar_ids[:1], ar_mask[:1], xmask[:1]


def port_decoder(params=None):
    cfg, model = port_model(params=scaled_params() if params is None else params)
    return model, MllamaDecoder(cfg, model, max_seq_len=64)


@functools.lru_cache(maxsize=None)
def jax_stream():
    prompt, *rest = request()
    return JDecoder(JTINY, scaled_params(), max_seq_len=64).generate(
        prompt, *_j(rest), max_new_tokens=NEW)


def test_generate_matches_jax():
    prompt, *rest = request()
    _, dec = port_decoder()
    got = dec.generate(prompt, *_t(rest), max_new_tokens=NEW)
    want = jax_stream()
    assert got == want and len(set(want)) > 1, (got, want)


def test_prefill_logits_match_full_forward():
    prompt, pix, ar_ids, ar_mask, xmask = request()
    model, dec = port_decoder()
    tpix, tar, tarm, txm = _t((pix, ar_ids, ar_mask, xmask))
    ids = torch.tensor([prompt])
    ref = model(ids, tpix, tar, tarm, txm)
    _, ck, cv = dec.precompute_cross_kv(tpix, tar, tarm)
    bias, full = M.prepare_cross_attention_mask(txm, JTINY.vision.num_patches)
    logits, _ = dec.forward(model, dec.init_cache(ck, cv), ids, torch.zeros(1, dtype=torch.int32),
                            bias, full)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


def test_eos_and_zero_budget():
    prompt, *rest = request()
    _, dec = port_decoder()
    args = (prompt, *_t(rest))
    assert dec.generate(*args, max_new_tokens=0) == []
    full = dec.generate(*args, max_new_tokens=6)
    assert dec.generate(*args, max_new_tokens=6, eos_token_id=full[0]) == full[:1]
    with pytest.raises(ValueError, match="max_seq_len"):
        dec.generate(*args, max_new_tokens=64)


def test_project_kv_once_a_request(monkeypatch):
    prompt, *rest = request()
    _, dec = port_decoder()
    calls = []
    orig = M.TextCrossAttention.project_kv

    def counted(self, vt):
        calls.append(vt.shape)
        return orig(self, vt)

    monkeypatch.setattr(M.TextCrossAttention, "project_kv", counted)
    out = dec.generate(prompt, *_t(rest), max_new_tokens=6)
    assert len(out) == 6
    assert len(calls) == len(JTINY.text.cross_attention_layers)


def test_layers_bound_once_a_request(monkeypatch):
    """The text layers are read from the stacks and bound twice a request
    (the cross K/V, the decoder's binding), not once a token."""
    prompt, *rest = request()
    _, dec = port_decoder()
    calls = []
    orig = M.MllamaForConditionalGeneration.text_layers

    def counted(self):
        calls.append(1)
        return orig(self)

    monkeypatch.setattr(M.MllamaForConditionalGeneration, "text_layers", counted)
    out = dec.generate(prompt, *_t(rest), max_new_tokens=6)
    assert len(out) == 6
    assert len(calls) == 2


@pytest.mark.parametrize("qtype", ["per_channel_symmetric", "per_tensor_symmetric"])
def test_quantize_params_match_jax(qtype):
    p = jax_params()
    cfg, model = port_model(params=p)
    jcfg = jq.QuantizationConfig(quantization_type=jq.QuantizationType(qtype))
    tcfg = tq.QuantizationConfig(quantization_type=tq.QuantizationType(qtype))
    jtree = jq.quantize_params(jax.tree.map(jnp.asarray, p), jcfg)
    with torch.no_grad():
        got = tq.quantize_params(dict(model.named_parameters()), tcfg, specs=model.param_specs())
    quantized = [k for k, v in got.items() if isinstance(v, tq.QuantizedTensor)]
    for want in ("layers.xattn.cross_attn.q.kernel", "vision_model.transformer.self_attn.q.kernel",
                 "vision_model.global_transformer.mlp.fc1.kernel", "multi_modal_projector.kernel",
                 "layers.plain.attn.qkv.q_kernel", "layers.xattn.mlp.gate_up"):
        assert want in quantized, want
    jpaths = []
    jq._walk(jtree, lambda path, leaf: jpaths.append(path)
             if isinstance(leaf, jq.QuantizedTensor) else leaf)
    assert sorted("/".join(tllama.jax_path(k)[0]) for k in quantized) == sorted(jpaths)
    for k in quantized:
        leaf = tllama._dig(jtree, tllama.jax_path(k)[0])
        np.testing.assert_array_equal(got[k].qvalue.numpy(), np.asarray(leaf.qvalue), err_msg=k)
        np.testing.assert_array_equal(got[k].scale.numpy(),
                                      np.asarray(leaf.scale).reshape(got[k].scale.shape),
                                      err_msg=k)


def test_quantized_model_serves_its_dequantized_stream():
    prompt, *rest = request()
    model, dec = port_decoder()
    with torch.no_grad():
        q = tq.quantize_params(dict(model.named_parameters()), specs=model.param_specs())
    deq = {k: v.dequantize(model.state_dict()[k].dtype) if isinstance(v, tq.QuantizedTensor)
           else v for k, v in q.items()}
    tq.quantize_model(model)
    assert any(n.endswith("_qvalue") for n, _ in model.named_buffers())
    got = dec.generate(prompt, *_t(rest), max_new_tokens=8)
    ref_model, ref_dec = port_decoder()
    ref_model.load_state_dict({k: v.detach() for k, v in deq.items()})
    assert got == ref_dec.generate(prompt, *_t(rest), max_new_tokens=8)
