"""The port's GPT-NeoX / CodeGen family (models/gptneox.py, inference/model.py
``GPTNeoXDecode``) against the JAX package's, on the CPU, in fp32, mirroring
``tests/test_gptneox.py``.

The same numpy weights (``params_from_jax``, the biases perturbed so that
they count) and token ids go through both:

- tiny-neox (parallel residual, rotate-half rotary on 25 % of the head),
  tiny-codegen (interleaved rotary on half, shared LayerNorm, gelu_new,
  the head's bias) and a sequential-residual tiny-neox: logits, loss and
  gradients, and the weight bridge both ways;
- three AdamW steps through the trainer against JAX's ``make_train_step``;
- ``decode_model_for`` gives ``GPTNeoXDecode``; prefill and incremental
  decode against the training forward (JAX's 2e-4) and JAX's
  ``GPTNeoXDecode`` (1e-5);
- the dense and the paged engines' greedy streams (the paged one with
  ``use_paged_kernel``, the kernel's plain version here) against the JAX
  engines', token for token; draft-model speculation equals greedy; an
  int8 model serves JAX's quantized tree's streams;
- head_dim 96 (gpt-neox-20b's), which K1-K4 take in D 96 instances: a
  D 96 config matches JAX's logits, loss and gradients, with flash
  attention on too, and serves the JAX engines' streams with the paged
  kernel on and off.

The tp = 2 and pp = 2 cases of this family, LoRA's and BERT's run in one
gloo spawn (``tests/torch_dist_workers.py`` ``family_worker``): this
file's :func:`test_tp2_and_pp2_match_jax`.

Tolerances: the same fp32 math in another order, so logits and loss 1e-5,
gradients 1e-5 of the leaf's largest element (a floor of 1e-8 for the k
bias, whose true gradient is 0: softmax does not see a shift of every
key), after AdamW as in ``tests/test_torch_trainer.py``; greedy streams
token for token.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu import trainer as jtrainer
from neuronx_distributed_llama3_2_tpu.inference import (
    GenerationConfig as JaxGen,
    InferenceEngine as JaxEngine,
)
from neuronx_distributed_llama3_2_tpu.inference.model import GPTNeoXDecode as JaxNeoXDecode
from neuronx_distributed_llama3_2_tpu.models import gptneox as jneox
from neuronx_distributed_llama3_2_tpu.parallel import state as jstate
from neuronx_distributed_llama3_2_tpu.quantization import quantize as jq
from neuronx_distributed_llama3_2_tpu.serving import (
    PagedConfig as JaxPagedConfig,
    PagedServingEngine as JaxPagedServingEngine,
)
from neuronx_distributed_llama3_2_tpu_torch import trainer as ttrainer
from neuronx_distributed_llama3_2_tpu_torch.inference import (
    GenerationConfig,
    GPTNeoXDecode,
    InferenceEngine,
    decode_model_for,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.speculative import SpeculativeDecoder
from neuronx_distributed_llama3_2_tpu_torch.models import gptneox as tneox
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama
from neuronx_distributed_llama3_2_tpu_torch.quantization import quantize as tq
from neuronx_distributed_llama3_2_tpu_torch.serving.engine import PagedConfig, PagedServingEngine

torch.set_num_threads(1)

LR = 1e-3
STEPS = 3
#: the decoder layers' kernels scaled up (tests/test_torch_async.py's
#: reason: the tiny models at their init scale repeat one token)
LAYER_SCALE = 10.0

#: name -> (JAX config, port config)
CASES = {
    "tiny-neox": (jneox.GPTNEOX_CONFIGS["tiny-neox"], tneox.GPTNEOX_CONFIGS["tiny-neox"]),
    "tiny-codegen": (jneox.GPTNEOX_CONFIGS["tiny-codegen"],
                     tneox.GPTNEOX_CONFIGS["tiny-codegen"]),
    "tiny-neox-sequential": (
        dataclasses.replace(jneox.GPTNEOX_CONFIGS["tiny-neox"], parallel_residual=False),
        dataclasses.replace(tneox.GPTNEOX_CONFIGS["tiny-neox"], parallel_residual=False)),
    # gpt-neox-20b's head_dim, at tiny width
    "tiny-neox-d96": (
        dataclasses.replace(jneox.GPTNEOX_CONFIGS["tiny-neox"], num_heads=2, num_kv_heads=2,
                            head_dim=96),
        dataclasses.replace(tneox.GPTNEOX_CONFIGS["tiny-neox"], num_heads=2, num_kv_heads=2,
                            head_dim=96)),
}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _batch():
    """(4, 16) ids; labels with ignored positions spread unevenly."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 256, size=(4, 16))
    labels = ids.copy()
    labels[1, 2:9] = -100
    labels[3, 5] = -100
    return ids, labels


@functools.lru_cache(maxsize=None)
def _jax_params(name, scale=False):
    """JAX init, every leaf nudged (so the zero-initialized biases count),
    the layers' kernels scaled by LAYER_SCALE for the serving tests."""
    rng = np.random.default_rng(2)
    p = jax.tree.map(np.asarray, jneox.GPTNeoXForCausalLM(CASES[name][0]).init(jax.random.key(3)))
    p = jax.tree.map(lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32), p)
    if scale:
        p = jax.tree_util.tree_map_with_path(
            lambda path, x: x * LAYER_SCALE if "layers" in jax.tree_util.keystr(path)
            and "kernel" in jax.tree_util.keystr(path) else x, p)
    return p


def _port(name, scale=False, **cfg_kw):
    cfg = dataclasses.replace(CASES[name][1], **cfg_kw)
    model = tneox.GPTNeoXForCausalLM(cfg, device="cpu")
    model.load_state_dict(tllama.params_from_jax(_jax_params(name, scale), cfg, device="cpu"))
    return cfg, model


def _jax(name, **cfg_kw):
    jcfg = dataclasses.replace(CASES[name][0], **cfg_kw)
    return jcfg, jneox.GPTNeoXForCausalLM(jcfg)


def _assert_grads(got, want):
    for path, w in _leaves(jax.tree.map(np.asarray, want)):
        scale = max(np.abs(w).max(), 1e-3)
        assert np.abs(got[path] - w).max() <= 1e-5 * scale, path


@pytest.mark.parametrize("name", list(CASES))
def test_logits_loss_grads_and_bridge_match_jax(name):
    _, jm = _jax(name)
    p = _jax_params(name)
    cfg, model = _port(name)
    ids, labels = _batch()
    jids, jlabels = jnp.asarray(ids, jnp.int32), jnp.asarray(labels, jnp.int32)
    tids, tlabels = torch.as_tensor(ids), torch.as_tensor(labels)
    np.testing.assert_allclose(model(tids).numpy(), np.asarray(jm(p, jids)), rtol=1e-5, atol=1e-5)
    jloss, jgrads = jax.value_and_grad(jm.loss)(p, jids, jlabels)
    params = dict(model.named_parameters())
    loss = model.loss(tids, tlabels)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _assert_grads(dict(_leaves(tllama.params_to_jax(dict(zip(params, grads)), cfg))), jgrads)
    # the bridge both ways: every leaf of the JAX tree, bit for bit
    back = dict(_leaves(tllama.params_to_jax(params, cfg)))
    want = dict(_leaves(p))
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k]) for k in want)
    c = CASES[name][1]
    assert ("mlp_norm" in {k[1] for k in want if k[0] == "layers"}) == (not c.shared_layernorm)
    assert (("lm_head", "bias") in want) == c.lm_head_bias


@functools.lru_cache(maxsize=None)
def _jax_run():
    """STEPS JAX train steps on tiny-neox from perturbed weights, traced into
    one call (as tests/test_torch_trainer.py does)."""
    tc = jtrainer.TrainingConfig(optimizer=jtrainer.OptimizerConfig(
        learning_rate=LR, warmup_steps=1, total_steps=10))
    jstate.destroy_model_parallel()
    tc.initialize(devices=jax.devices()[:1])
    try:
        model = jneox.GPTNeoXForCausalLM(CASES["tiny-neox"][0])
        state, _ = jtrainer.initialize_parallel_model(model, tc)
        p = jax.tree.map(jnp.asarray, _jax_params("tiny-neox"))
        state = state._replace(params=p, opt=jtrainer.init_optimizer_state(p, tc.optimizer))
        start = jax.tree.map(np.asarray, state)
        one = jtrainer.make_train_step(model, tc).__wrapped__
        ids, labels = _batch()
        batch = {"input_ids": jnp.asarray(ids, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}

        def steps(state):
            metrics = []
            for _ in range(STEPS):
                state, m = one(state, batch)
                metrics.append(m)
            return state, metrics

        state, metrics = jax.jit(steps)(state)
        return start, [{k: float(v) for k, v in m.items()} for m in metrics], \
            jax.tree.map(np.asarray, state)
    finally:
        jstate.destroy_model_parallel()


def test_train_steps_match_jax():
    start, jmetrics, jend = _jax_run()
    cfg, model = _port("tiny-neox")
    opt_cfg = ttrainer.OptimizerConfig(learning_rate=LR, warmup_steps=1, total_steps=10)
    tc = ttrainer.TrainingConfig(optimizer=opt_cfg)
    tc.initialize("cpu")
    params = dict(model.named_parameters())
    state = ttrainer.TrainState(
        params, ttrainer.opt_state_from_jax(start.opt, cfg, opt_cfg, device="cpu"))
    step = ttrainer.make_train_step(model, tc)
    ids, labels = _batch()
    batch = {"input_ids": torch.as_tensor(ids), "labels": torch.as_tensor(labels)}
    for jm in jmetrics:
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"], rtol=1e-4)
    got = dict(_leaves(tllama.params_to_jax(state.params, cfg)))
    for path, ref in _leaves(jend.params):
        diff = np.abs(got[path] - ref)
        # the k bias's true gradient is 0 (softmax does not see a shift of
        # every key): AdamW scales its rounding noise to whole steps in both
        # packages alike, so only the per-step bound holds there
        mean_ok = diff.mean() <= 1e-6 or path[-1] == "k_bias"
        assert diff.max() <= 2 * LR * STEPS and mean_ok, (path, diff.max())
    assert state.params["layers.0.attn_norm.bias"].dtype == torch.float32


def test_decode_dispatch():
    for name in ("tiny-neox", "tiny-codegen"):
        assert isinstance(decode_model_for(CASES[name][1]), GPTNeoXDecode)


@pytest.mark.parametrize("name", ["tiny-neox", "tiny-codegen", "tiny-neox-sequential"])
def test_incremental_decode_matches_forward_and_jax(name):
    """Prefill then four single-token steps over the dense cache: each
    step's logits against the training forward on the grown sequence (JAX's
    2e-4) and against JAX's GPTNeoXDecode on the same weights (1e-5)."""
    jcfg, _ = _jax(name)
    jp = _jax_params(name)
    cfg, model = _port(name)
    dec, jdec = GPTNeoXDecode(cfg), JaxNeoXDecode(jcfg)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(1, 10))
    cache = dec.init_cache(max_batch=1, max_len=32, device="cpu")
    jcache = jdec.init_cache(max_batch=1, max_len=32)
    logits, cache = dec.forward(model, cache, torch.as_tensor(prompt),
                                torch.zeros(1, dtype=torch.int32), context_encode=True)
    jlogits, jcache = jdec.forward(jp, jcache, jnp.asarray(prompt, jnp.int32),
                                   jnp.zeros((1,), jnp.int32), context_encode=True)
    full = model(torch.as_tensor(prompt))
    np.testing.assert_allclose(logits.numpy(), full.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5)
    seq = prompt[0].tolist()
    for _ in range(4):
        nxt = int(full[0, -1].argmax())
        seq.append(nxt)
        pos = torch.as_tensor([len(seq) - 1], dtype=torch.int32)
        step, cache = dec.forward(model, cache, torch.as_tensor([[nxt]]), pos)
        jstep, jcache = jdec.forward(jp, jcache, jnp.asarray([[nxt]], jnp.int32),
                                     jnp.asarray([len(seq) - 1], jnp.int32))
        full = model(torch.as_tensor([seq]))
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(), atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep), atol=1e-5, rtol=1e-5)


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).tolist() for n in lengths]


@pytest.mark.parametrize("name", ["tiny-neox", "tiny-codegen"])
def test_engines_greedy_match_jax(name):
    """The dense engine (two prompts) and the paged engine with the paged
    kernel (mixed lengths over 2 lanes, a shared prefix) give the JAX
    engines' greedy streams token for token."""
    jcfg, _ = _jax(name, max_seq_len=128, use_paged_kernel=True)
    jp = jax.tree.map(jnp.asarray, _jax_params(name, scale=True))
    cfg, model = _port(name, scale=True, use_paged_kernel=True)
    kw = dict(max_batch=2, max_seq_len=64, buckets=[8, 16, 32])
    prompts = _prompts(11, (6, 13))
    want = JaxEngine(jcfg, jp, **kw).generate(prompts, JaxGen(max_new_tokens=6)).sequences
    eng = InferenceEngine(cfg, model, **kw)
    assert isinstance(eng.model, GPTNeoXDecode)
    got = eng.generate(prompts, GenerationConfig(max_new_tokens=6)).sequences
    assert got == want
    assert len(set(got[0])) > 1  # the stream does not repeat one token
    shared = _prompts(2, (12,))[0]
    prompts = _prompts(3, (5, 20, 9)) + [shared + [7, 8], shared + [9]]
    outs = []
    jeng = JaxPagedServingEngine(JaxEngine(jcfg, jp, **kw), JaxGen(max_new_tokens=8),
                                 JaxPagedConfig(block_size=8, num_blocks=64), precompile=False)
    peng = PagedServingEngine(InferenceEngine(cfg, model, **kw), GenerationConfig(max_new_tokens=8),
                              PagedConfig(block_size=8, num_blocks=64))
    for e in (jeng, peng):
        for p in prompts:
            e.submit(p)
        outs.append(e.run_to_completion())
    assert outs[1] == outs[0]
    assert peng.model.attention_paths["kernel"] > 0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_paged_engine_over_quantized_pools_matches_jax(kv_dtype):
    """tiny-neox from an int8 or fp8 e4m3 KV pool, the paged kernel on
    (its plain version here), chunked prefill: the JAX paged engine's
    greedy streams token for token."""
    jcfg, _ = _jax("tiny-neox", max_seq_len=128, use_paged_kernel=True)
    jp = jax.tree.map(jnp.asarray, _jax_params("tiny-neox", scale=True))
    cfg, model = _port("tiny-neox", scale=True, use_paged_kernel=True)
    kw = dict(max_batch=2, max_seq_len=64, buckets=[8, 16, 32])
    prompts = _prompts(6, (5, 20, 9))
    knobs = dict(block_size=8, num_blocks=64, kv_cache_dtype=kv_dtype, prefill_chunk_tokens=8)
    outs = []
    for eng in (JaxPagedServingEngine(JaxEngine(jcfg, jp, **kw), JaxGen(max_new_tokens=8),
                                      JaxPagedConfig(**knobs), precompile=False),
                PagedServingEngine(InferenceEngine(cfg, model, **kw),
                                   GenerationConfig(max_new_tokens=8), PagedConfig(**knobs))):
        for p in prompts:
            eng.submit(p)
        outs.append(eng.run_to_completion())
    assert outs[1] == outs[0]
    assert eng.metrics.prefill_chunks > 0 and eng.model.attention_paths["kernel"] > 0


def test_speculative_and_int8_serving():
    """Draft-model speculation with the model as its own draft equals
    plain greedy (JAX's test); an int8 (per channel) tiny-neox serves the
    JAX engine's streams over JAX's quantized tree."""
    jcfg, _ = _jax("tiny-neox", max_seq_len=128)
    jp = jax.tree.map(jnp.asarray, _jax_params("tiny-neox", scale=True))
    cfg, model = _port("tiny-neox", scale=True)
    prompt = list(range(4, 12))
    kw = dict(max_batch=1, max_seq_len=64)
    ref = InferenceEngine(cfg, model, **kw).generate([prompt], GenerationConfig(
        max_new_tokens=10)).sequences[0]
    res = SpeculativeDecoder(InferenceEngine(cfg, model, **kw), InferenceEngine(cfg, model, **kw),
                             gamma=3).generate(prompt, max_new_tokens=10)
    assert res.tokens == ref
    assert res.mean_accepted > 2.5
    jc, tc = jq.QuantizationConfig(quantized_dtype="int8"), tq.QuantizationConfig(
        quantized_dtype="int8")
    before = tq.weight_bytes(model)
    tq.quantize_model(model, tc)
    assert tq.weight_bytes(model) < before
    want = JaxEngine(jcfg, jq.quantize_params(jp, jc), **kw).generate(
        [prompt], JaxGen(max_new_tokens=10)).sequences[0]
    got = InferenceEngine(cfg, model, **kw).generate([prompt], GenerationConfig(
        max_new_tokens=10)).sequences[0]
    assert got == want and len(set(got)) > 1


def test_head_dim_96_refused_under_the_kernels_and_served_plain():
    """gpt-neox-20b's head_dim 96, which flash attention (K1-K3) and the
    paged kernel (K4) take in D 96 instances of their own (the name records
    the refusal this test held before they existed): with flash attention
    on, the loss and gradients match the JAX model's with its flash path on;
    with the paged kernel on (its plain version here, JAX's Pallas kernel
    there), the paged engine's greedy streams equal the JAX paged engine's;
    and with both off the model decodes JAX's greedy streams."""
    ids, labels = _batch()
    _, jm = _jax("tiny-neox-d96", use_flash_attention=True)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        _jax_params("tiny-neox-d96"), jnp.asarray(ids, jnp.int32), jnp.asarray(labels, jnp.int32))
    cfg, flash = _port("tiny-neox-d96", use_flash_attention=True)
    params = dict(flash.named_parameters())
    loss = flash.loss(torch.as_tensor(ids), torch.as_tensor(labels))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _assert_grads(dict(_leaves(tllama.params_to_jax(dict(zip(params, grads)), cfg))), jgrads)

    jcfg, _ = _jax("tiny-neox-d96", max_seq_len=128, use_paged_kernel=True)
    jp = jax.tree.map(jnp.asarray, _jax_params("tiny-neox-d96", scale=True))
    cfg, model = _port("tiny-neox-d96", scale=True, use_paged_kernel=True)
    kw = dict(max_batch=2, max_seq_len=64, buckets=[8, 16, 32])
    shared = _prompts(2, (12,))[0]
    prompts = _prompts(3, (5, 20, 9)) + [shared + [7, 8], shared + [9]]
    outs = []
    jeng = JaxPagedServingEngine(JaxEngine(jcfg, jp, **kw), JaxGen(max_new_tokens=8),
                                 JaxPagedConfig(block_size=8, num_blocks=64), precompile=False)
    peng = PagedServingEngine(InferenceEngine(cfg, model, **kw), GenerationConfig(max_new_tokens=8),
                              PagedConfig(block_size=8, num_blocks=64))
    for e in (jeng, peng):
        for p in prompts:
            e.submit(p)
        outs.append(e.run_to_completion())
    assert outs[1] == outs[0]
    assert peng.model.attention_paths["kernel"] > 0

    jcfg, _ = _jax("tiny-neox-d96", max_seq_len=128)
    cfg, model = _port("tiny-neox-d96", scale=True)
    prompts = _prompts(4, (6, 11))
    kw = dict(max_batch=2, max_seq_len=64, buckets=[16, 32])
    want = JaxEngine(jcfg, jp, **kw).generate(prompts, JaxGen(max_new_tokens=6)).sequences
    got = InferenceEngine(cfg, model, **kw).generate(prompts, GenerationConfig(
        max_new_tokens=6)).sequences
    assert got == want


def test_tp2_and_pp2_match_jax(tmp_path):
    """One spawn of two gloo ranks (``torch_dist_workers.family_worker``):
    tiny-neox and tiny-codegen at tp = 2 (logits, loss, gradients gathered
    whole), tiny-bert at tp = 2 (MLM and NSP logits, the pretraining loss
    and its gradients), LoRA over tiny at tp = 2 (logits, loss, adapter
    gradients; the adapter tag saved at tp = 2 loads back bit for bit and
    JAX's tag of the adapters loads at tp = 2), LoRA's three AdamW steps at
    dp = 2 under ZeRO-1 (the adapters' state split over dp) and tiny-neox's
    pp = 2 gpipe and 1f1b loss and gradients, each against the JAX package
    on one device."""
    from neuronx_distributed_llama3_2_tpu.checkpoint import checkpoint as jckpt
    from neuronx_distributed_llama3_2_tpu.lora import LoraConfig as JLoraConfig
    from neuronx_distributed_llama3_2_tpu.lora import LoraModel as JLoraModel
    from neuronx_distributed_llama3_2_tpu.models import bert as jbert
    from neuronx_distributed_llama3_2_tpu.models import llama as jllama

    from tests import torch_dist_workers as W

    ids, labels = _batch()
    jids, jlabels = jnp.asarray(ids, jnp.int32), jnp.asarray(labels, jnp.int32)
    want, inputs = {}, {"ids": ids, "labels": labels}
    for name in ("tiny-neox", "tiny-codegen"):
        _, jm = _jax(name)
        p = _jax_params(name)
        loss, grads = jax.value_and_grad(jm.loss)(p, jids, jlabels)
        want[name] = dict(logits=np.asarray(jm(p, jids)), loss=float(loss), grads=grads)
        inputs[name] = p
    # BERT: a padded batch with token types and an NSP label
    rng = np.random.default_rng(9)
    bm = jbert.BertForPreTraining(jbert.BERT_CONFIGS["tiny-bert"])
    bp = jax.tree.map(lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape)).astype(
        np.float32), bm.init(jax.random.key(4)))
    mask = np.ones((4, 16), np.int32)
    mask[2, 11:] = 0
    bbatch = dict(input_ids=ids, labels=np.where(rng.random((4, 16)) < 0.3, ids, -100),
                  token_type_ids=(np.arange(16)[None] >= 8).astype(np.int32).repeat(4, 0),
                  attention_mask=mask, next_sentence_label=np.array([0, 1, 1, 0]))
    jb = {k: jnp.asarray(v) for k, v in bbatch.items()}
    mlm, nsp = bm(bp, jb["input_ids"], jb["token_type_ids"], jb["attention_mask"])
    bloss, bgrads = jax.value_and_grad(bm.pretraining_loss)(bp, jb)
    want["tiny-bert"] = dict(mlm=np.asarray(mlm), nsp=np.asarray(nsp), loss=float(bloss),
                             grads=bgrads)
    inputs["tiny-bert"] = (bp, bbatch)
    # LoRA over tiny, default targets, adapters nudged off B = 0
    lm = jllama.LlamaForCausalLM(jllama.LLAMA_CONFIGS["tiny"])
    lp = jax.tree.map(np.asarray, lm.init(jax.random.key(0)))
    lora = JLoraModel(lm, lp, JLoraConfig(r=4, alpha=8.0))
    ad = jax.tree.map(lambda a: np.asarray(a) + 0.02, lora.init(jax.random.key(1)))
    lloss, lgrads = jax.value_and_grad(lora.loss)(ad, jids, jlabels)
    want["lora"] = dict(logits=np.asarray(lora(ad, jids)), loss=float(lloss), grads=lgrads)
    jroot = str(tmp_path / "jax_adapters")
    jckpt.save_checkpoint(jroot, "adapters", model=ad)
    inputs["lora"] = (lp, ad, jroot, str(tmp_path / "port_adapters"))
    # the JAX trainer's LoRA steps (tests/test_torch_lora.py), held at dp = 2
    from tests import test_torch_lora as TL

    start, jsteps, jend = TL._jax_run()
    inputs["lora_dp2"] = (start, dict(warmup_steps=1, learning_rate=TL.LR), TL._batch(),
                          TL.STEPS)
    out = W.run(W.family_worker, 2, tmp_path, inputs)
    for rank in out:
        for name in ("tiny-neox", "tiny-codegen"):
            got, w = rank[f"{name} tp2"], want[name]
            np.testing.assert_allclose(got["logits"], w["logits"], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5)
            _assert_grads(dict(_leaves(got["grads"])), w["grads"])
        for sched in ("gpipe", "1f1b"):
            got, w = rank[f"tiny-neox pp2 {sched}"], want["tiny-neox"]
            np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5)
            _assert_grads(dict(_leaves(got["grads"])), w["grads"])
        got, w = rank["tiny-bert tp2"], want["tiny-bert"]
        np.testing.assert_allclose(got["mlm"], w["mlm"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["nsp"], w["nsp"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5)
        _assert_grads(dict(_leaves(got["grads"])), w["grads"])
        got, w = rank["lora tp2"], want["lora"]
        np.testing.assert_allclose(got["logits"], w["logits"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5)
        for path, ab in w["grads"].items():
            for x in "ab":
                ref = np.asarray(ab[x])
                assert np.abs(got["grads"][path][x] - ref).max() <= 1e-5 * np.abs(ref).max(), \
                    (path, x)
        assert got["jax_tag_loaded"] and got["own_tag_loaded"]
        got = rank["lora dp2 zero1"]
        assert got["dp"] == 2 and got["sharded"]
        for m, jm in zip(got["metrics"], jsteps):
            np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
            np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-4)
        for path, ab in jend.items():
            for x in "ab":
                assert np.abs(got["adapters"][path][x] - ab[x]).max() <= 2 * TL.LR * TL.STEPS


@pytest.mark.parametrize("model", ["tiny-moe", "tiny-neox"])
def test_generate_script_serves_any_family(tmp_path, model):
    """``scripts.generate --model tiny-moe|tiny-neox --ckpt-dir`` (the model
    resolved through ``models.resolve_model``) over a JAX tag of scaled
    weights gives the JAX InferenceEngine's greedy stream; BERT is refused
    by the engine and an Mllama name by the registry, as in JAX."""
    from neuronx_distributed_llama3_2_tpu.checkpoint import checkpoint as jckpt
    from neuronx_distributed_llama3_2_tpu.models import resolve_model as jresolve
    from neuronx_distributed_llama3_2_tpu_torch.scripts import generate

    entry = jresolve(model)
    jcfg = entry["config"]
    p = jax.tree_util.tree_map_with_path(
        lambda path, x: x * LAYER_SCALE if "layers" in jax.tree_util.keystr(path)
        and "kernel" in jax.tree_util.keystr(path) else x,
        entry["model_cls"](jcfg).init(jax.random.key(5)))
    jckpt.save_checkpoint(str(tmp_path / "ck"), "step_1", model=p)
    prompt = [5, 17, 3, 9, 200, 41]
    want = JaxEngine(jcfg, p, max_batch=1, max_seq_len=64).generate(
        [prompt], JaxGen(max_new_tokens=8)).sequences[0]
    common = ["--prompt-ids", ",".join(map(str, prompt)), "--greedy", "--device", "cpu",
              "--max-seq-len", "64", "--max-new-tokens", "8"]
    got = generate.main(["--model", model, "--ckpt-dir", str(tmp_path / "ck")] + common)
    assert got["sequences"][0] == want and len(set(want)) > 1
    with pytest.raises(NotImplementedError, match="no KV-cache decode"):
        generate.main(["--model", "tiny-bert", "--random-init"] + common)
    with pytest.raises(SystemExit, match="multimodal decode needs image inputs"):
        generate.main(["--model", "tiny-mllama", "--random-init"] + common)
