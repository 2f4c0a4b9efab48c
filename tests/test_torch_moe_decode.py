"""The port's MoE decode (inference/model.py ``MixtralDecode``,
``decode_model_for``) and its engines against the JAX package's, on the
CPU, in fp32, mirroring ``tests/test_moe_inference.py``.

- ``decode_model_for`` dispatch: MixtralDecode for Mixtral and DBRX,
  LlamaDecode for Llama, BERT refused, GPT-NeoX refused naming its slice;
- prefill and incremental decode against the full recompute of the
  training model (JAX's tolerances, 2e-4 / 3e-4) and against JAX's
  MixtralDecode logits on the same weights (1e-5); ``moe_paths`` counts the
  selective path for small blocks and all experts for larger ones;
- the dense and the paged engines' greedy streams on ``tiny-moe`` and
  ``tiny-dbrx`` against the JAX engines', token for token (the decoder
  layers scaled up so that the streams do not repeat one token);
- a capacity-factor config decodes with no drop: its logits are the
  no-capacity config's (1e-5);
- expert parallelism is refused in decode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.inference import (
    GenerationConfig as JaxGen,
    InferenceEngine as JaxEngine,
    MixtralDecode as JaxMixtralDecode,
)
from neuronx_distributed_llama3_2_tpu.models import dbrx as jdbrx
from neuronx_distributed_llama3_2_tpu.models import mixtral as jmix
from neuronx_distributed_llama3_2_tpu.serving import (
    PagedConfig as JaxPagedConfig,
    PagedServingEngine as JaxPagedServingEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.inference import (
    GenerationConfig,
    InferenceEngine,
    LlamaDecode,
    GPTNeoXDecode,
    MixtralDecode,
    decode_model_for,
)
from neuronx_distributed_llama3_2_tpu_torch.models import dbrx as tdbrx
from neuronx_distributed_llama3_2_tpu_torch.models.bert import BertConfig
from neuronx_distributed_llama3_2_tpu_torch.models.gptneox import GPTNeoXConfig
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama
from neuronx_distributed_llama3_2_tpu_torch.models import mixtral as tmix
from neuronx_distributed_llama3_2_tpu_torch.serving.engine import PagedConfig, PagedServingEngine

torch.set_num_threads(1)

#: the decoder layers' kernels scaled up (tests/test_torch_async.py's
#: reason: the tiny models at their init scale repeat one token)
LAYER_SCALE = 10.0

FAMILIES = {
    "tiny-moe": (jmix.MIXTRAL_CONFIGS["tiny-moe"], tmix.MIXTRAL_CONFIGS["tiny-moe"],
                 jmix.MixtralForCausalLM, tmix.MixtralForCausalLM),
    "tiny-dbrx": (jdbrx.DBRX_CONFIGS["tiny-dbrx"], tdbrx.DBRX_CONFIGS["tiny-dbrx"],
                  jdbrx.DbrxForCausalLM, tdbrx.DbrxForCausalLM),
}


def _scaled(path, x):
    name = jax.tree_util.keystr(path)
    return x * LAYER_SCALE if "layers" in name and "scale" not in name and "router" not in name \
        else x


def _weights(name, scale=False, **cfg_kw):
    jcfg, tcfg, jcls, tcls = FAMILIES[name]
    jcfg, tcfg = dataclasses.replace(jcfg, **cfg_kw), dataclasses.replace(tcfg, **cfg_kw)
    jp = jcls(jcfg).init(jax.random.key(0))
    if scale:
        jp = jax.tree_util.tree_map_with_path(_scaled, jp)
    model = tcls(tcfg, device="cpu")
    model.load_state_dict(tllama.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                                 device="cpu"))
    return jcfg, jp, tcfg, model


def test_decode_model_dispatch():
    assert isinstance(decode_model_for(tmix.MIXTRAL_CONFIGS["tiny-moe"]), MixtralDecode)
    assert isinstance(decode_model_for(tdbrx.DBRX_CONFIGS["tiny-dbrx"]), MixtralDecode)
    llama = decode_model_for(tllama.LLAMA_CONFIGS["tiny"])
    assert isinstance(llama, LlamaDecode) and not isinstance(llama, MixtralDecode)
    with pytest.raises(NotImplementedError, match="no KV-cache decode"):
        decode_model_for(BertConfig())
    # the GPT-NeoX family decodes through its own model (tests/test_torch_gptneox.py)
    neox = decode_model_for(GPTNeoXConfig(dtype=torch.float32))
    assert isinstance(neox, GPTNeoXDecode) and not isinstance(neox, MixtralDecode)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_incremental_decode_matches_recompute_and_jax(name):
    """Prefill then four single-token steps: each step's logits against the
    training model's forward on the grown sequence (JAX's 2e-4 / 3e-4) and
    against JAX's MixtralDecode on the same weights (1e-5). The prefill
    (T·k = 16 > E) runs every expert, the steps (T·k = 2 <= E) gather the
    chosen ones."""
    jcfg, jp, cfg, model = _weights(name)
    dec, jdec = MixtralDecode(cfg), JaxMixtralDecode(jcfg)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(1, 8))
    cache = dec.init_cache(max_batch=1, max_len=32, device="cpu")
    jcache = jdec.init_cache(max_batch=1, max_len=32)
    logits, cache = dec.forward(model, cache, torch.as_tensor(prompt), torch.zeros(1, dtype=torch.int32),
                                context_encode=True)
    jlogits, jcache = jdec.forward(jp, jcache, jnp.asarray(prompt, jnp.int32),
                                   jnp.zeros((1,), jnp.int32), context_encode=True)
    full = model(torch.as_tensor(prompt))
    np.testing.assert_allclose(logits.numpy(), full.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5)
    assert dec.moe_paths == {"all_experts": cfg.num_layers}
    seq = prompt[0].tolist()
    for _ in range(4):
        nxt = int(full[0, -1].argmax())
        seq.append(nxt)
        pos = torch.as_tensor([len(seq) - 1], dtype=torch.int32)
        step, cache = dec.forward(model, cache, torch.as_tensor([[nxt]]), pos)
        jstep, jcache = jdec.forward(jp, jcache, jnp.asarray([[nxt]], jnp.int32),
                                     jnp.asarray([len(seq) - 1], jnp.int32))
        full = model(torch.as_tensor([seq]))
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(), atol=3e-4, rtol=3e-4)
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep), atol=1e-5, rtol=1e-5)
    assert dec.moe_paths["selective"] == 4 * cfg.num_layers


def test_capacity_config_decodes_without_drops():
    """A cf 1.0 training config decodes through the no-drop paths: its
    logits equal the no-capacity config's."""
    _, _, cfg, model = _weights("tiny-moe", capacity_factor=1.0)
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)))
    a, _ = MixtralDecode(cfg).forward(model, MixtralDecode(cfg).init_cache(2, 16, device="cpu"),
                                      ids, torch.zeros(2, dtype=torch.int32), context_encode=True)
    ref_cfg = dataclasses.replace(cfg, capacity_factor=None)
    b, _ = MixtralDecode(ref_cfg).forward(model, MixtralDecode(ref_cfg).init_cache(2, 16, device="cpu"),
                                          ids, torch.zeros(2, dtype=torch.int32), context_encode=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).tolist() for n in lengths]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_dense_engine_greedy_matches_jax(name):
    jcfg, jp, cfg, model = _weights(name, scale=True, max_seq_len=128)
    kw = dict(max_batch=2, max_seq_len=64, buckets=[16, 32, 64])
    prompts = _prompts(11, (6, 13))
    want = JaxEngine(jcfg, jp, **kw).generate(prompts, JaxGen(max_new_tokens=6)).sequences
    eng = InferenceEngine(cfg, model, **kw)
    assert isinstance(eng.model, MixtralDecode)
    got = eng.generate(prompts, GenerationConfig(max_new_tokens=6)).sequences
    assert got == want
    assert len(set(got[0])) > 1  # the stream does not repeat one token


@pytest.mark.parametrize("name", list(FAMILIES))
def test_paged_engine_greedy_matches_jax(name):
    """Mixed prompt lengths over 2 lanes, with a shared prefix: the
    prefills (T·k > E = 4: every expert) and the decode steps (2 lanes x k 2
    = E: the selective path) give JAX's streams token for token."""
    jcfg, jp, cfg, model = _weights(name, scale=True, use_paged_kernel=True)
    kw = dict(max_batch=2, max_seq_len=64, buckets=[8, 16, 32])
    shared = _prompts(2, (12,))[0]
    prompts = _prompts(3, (5, 20, 9)) + [shared + [7, 8], shared + [9]]
    outs = []
    jeng = JaxPagedServingEngine(JaxEngine(jcfg, jp, **kw), JaxGen(max_new_tokens=8),
                                 JaxPagedConfig(block_size=8, num_blocks=64), precompile=False)
    peng = PagedServingEngine(InferenceEngine(cfg, model, **kw), GenerationConfig(max_new_tokens=8),
                              PagedConfig(block_size=8, num_blocks=64))
    for eng in (jeng, peng):
        for p in prompts:
            eng.submit(p)
        outs.append(eng.run_to_completion())
    assert outs[1] == outs[0]
    assert set(peng.model.moe_paths) == {"selective", "all_experts"}


def test_decode_refuses_expert_parallelism(monkeypatch):
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as tstate

    _, _, cfg, model = _weights("tiny-moe")
    monkeypatch.setattr(tstate, "expert_parallel_size_or", lambda default=1: 2)
    dec = MixtralDecode(cfg)
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        dec.forward(model, dec.init_cache(1, 16, device="cpu"), torch.zeros((1, 4), dtype=torch.long),
                    torch.zeros(1, dtype=torch.int32), context_encode=True)
