"""The port's weight quantization (quantization/quantize.py, layers.py)
against the JAX package's, on the CPU.

- ``quantize_array``'s payload and scale equal JAX's bit for bit: int8,
  fp8 e4m3 and e5m2, per tensor and per channel, round half to even
  included (inputs with exact .5 quotients);
- ``quantize_params`` over a model's parameters: every payload and scale
  equals JAX's ``quantize_params`` on the stacked tree bit for bit (per
  layer and per (layer, expert) scales; per tensor, one scale a leaf), the
  router and the norms left float;
- the quantized linears against JAX's (column- and row-parallel, at tp 1
  and, over two gloo ranks, at tp 2: a rank's payload is its slice of the
  whole weight's, its scales the whole weight's), and ``convert`` refusing
  a layer it has no mapping for;
- quantized ``tiny`` and ``tiny-moe`` models: logits equal JAX's quantized
  forward (1e-5), within JAX's band of the float model's (0.25, argmax
  agreement 0.95), and the model's weight bytes;
- the dense and the paged engines serving a quantized model give the JAX
  engines' streams on the quantized tree, token for token.
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
)
from neuronx_distributed_llama3_2_tpu.models import llama as jllama
from neuronx_distributed_llama3_2_tpu.models import mixtral as jmix
from neuronx_distributed_llama3_2_tpu.parallel import layers as jlayers
from neuronx_distributed_llama3_2_tpu.quantization import layers as jql
from neuronx_distributed_llama3_2_tpu.quantization import quantize as jq
from neuronx_distributed_llama3_2_tpu.serving import (
    PagedConfig as JaxPagedConfig,
    PagedServingEngine as JaxPagedServingEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.inference import GenerationConfig, InferenceEngine
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama
from neuronx_distributed_llama3_2_tpu_torch.models import mixtral as tmix
from neuronx_distributed_llama3_2_tpu_torch.parallel import layers as tlayers
from neuronx_distributed_llama3_2_tpu_torch.quantization import layers as tql
from neuronx_distributed_llama3_2_tpu_torch.quantization import quantize as tq
from neuronx_distributed_llama3_2_tpu_torch.serving.engine import PagedConfig, PagedServingEngine

from tests import torch_dist_workers as W

torch.set_num_threads(1)

DTYPES = ["int8", "fp8_e4m3", "fp8_e5m2"]
TYPES = ["per_tensor_symmetric", "per_channel_symmetric"]
LAYER_SCALE = 10.0


def _cfgs(qtype, qdtype, **kw):
    return (jq.QuantizationConfig(quantization_type=jq.QuantizationType(qtype),
                                  quantized_dtype=qdtype, **kw),
            tq.QuantizationConfig(quantization_type=tq.QuantizationType(qtype),
                                  quantized_dtype=qdtype, **kw))


def _same(qt, jqt):
    """Payload and scale bit for bit (the payloads compared as fp32, which
    holds every int8 and fp8 value exactly)."""
    a = np.asarray(jqt.qvalue.astype(jnp.float32))
    assert np.array_equal(qt.qvalue.float().numpy(), a)
    assert qt.qvalue.dtype == {"int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn,
                               "float8_e5m2": torch.float8_e5m2}[str(jqt.qvalue.dtype)]
    assert np.array_equal(qt.scale.numpy(), np.asarray(jqt.scale))


@pytest.mark.parametrize("qtype", TYPES)
@pytest.mark.parametrize("qdtype", DTYPES)
def test_quantize_array_bitwise(qdtype, qtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((4, 24, 40)) * 3).astype(np.float32)
    # exact halves: absmax 127 makes the scale 1 on channel 0 of layer 0
    w[0, :, 0] = np.linspace(-126.5, 127.0, 24, dtype=np.float32).round(1)
    w[0, :4, 0] = [0.5, 1.5, 2.5, -3.5]
    jc, tc = _cfgs(qtype, qdtype)
    _same(tq.quantize_array(torch.as_tensor(w), tc), jq.quantize_array(jnp.asarray(w), jc))
    err = tq.quantization_error(torch.as_tensor(w), tc)
    np.testing.assert_allclose(float(err), float(jq.quantization_error(jnp.asarray(w), jc)),
                               rtol=1e-6)


@pytest.mark.parametrize("qtype", TYPES)
@pytest.mark.parametrize("qdtype", ["int8", "fp8_e4m3"])
def test_quantize_params_bitwise_with_per_expert_scales(qdtype, qtype):
    """tiny-moe: each port layer tensor's payload and scale are its layer's
    (and expert's) slice of JAX's stacked leaf; per tensor, every layer of a
    leaf holds JAX's one scale."""
    jcfg = jmix.MIXTRAL_CONFIGS["tiny-moe"]
    p = jmix.MixtralForCausalLM(jcfg).init(jax.random.key(2))
    jc, tc = _cfgs(qtype, qdtype)
    jqp = jq.quantize_params(p, jc)
    cfg = tmix.MIXTRAL_CONFIGS["tiny-moe"]
    sd = tllama.params_from_jax(jax.tree.map(np.asarray, p), cfg, device="cpu")
    qp = tq.quantize_params(sd, tc)
    n_quantized = 0
    for name, v in qp.items():
        path, layer = tllama.jax_path(name)
        leaf = jqp
        for k in path:
            leaf = leaf[k]
        if isinstance(leaf, jq.QuantizedTensor):
            assert isinstance(v, tq.QuantizedTensor), name
            want = jq.QuantizedTensor(leaf.qvalue[layer], leaf.scale[min(layer, leaf.scale.shape[0] - 1)])
            _same(v, want)
            n_quantized += 1
        else:
            assert not isinstance(v, tq.QuantizedTensor), name
    assert n_quantized == cfg.num_layers * 6  # q, k, v, o, gate_up, down
    gu = qp["layers.0.moe.experts.gate_up"]
    if qtype == "per_channel_symmetric":
        assert tuple(gu.scale.shape) == (cfg.num_experts, 1, 2, cfg.intermediate_size)
    deq = tq.dequantize_params(qp, torch.float32)
    assert not any(isinstance(v, tq.QuantizedTensor) for v in deq.values())
    assert tq.live_params(qp, torch.float32).keys() == qp.keys()
    assert tq.live_params(sd) is sd


@pytest.mark.parametrize("kind", ["column", "row"])
def test_quantized_linear_matches_jax(kind):
    jcls = jlayers.ColumnParallelLinear if kind == "column" else jlayers.RowParallelLinear
    tcls = tlayers.ColumnParallelLinear if kind == "column" else tlayers.RowParallelLinear
    jmod = jcls(24, 16, dtype=jnp.float32)
    p = jmod.init(jax.random.key(1))
    jqmod = (jql.QuantizedColumnParallelLinear if kind == "column"
             else jql.QuantizedRowParallelLinear).from_float(jmod)
    qp = jqmod.quantize_params(p)
    x = np.random.default_rng(3).standard_normal((2, 5, 24)).astype(np.float32)
    mod = tcls(24, 16, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        mod.kernel.copy_(torch.as_tensor(np.asarray(p["kernel"])))
    qmod = tql.convert(mod)
    assert isinstance(qmod, tql.DEFAULT_QUANT_MODULE_MAPPINGS[tcls])
    assert "kernel" not in dict(qmod.named_parameters())
    _same(qmod.quantized("kernel"), qp["kernel"])
    np.testing.assert_allclose(qmod(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(jqmod(qp, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


TP_W = np.random.default_rng(4).standard_normal((32, 16)).astype(np.float32)
TP_X = np.random.default_rng(5).standard_normal((3, 32)).astype(np.float32)
TP_CASES = [(kind, qtype) for qtype in TYPES for kind in ("row", "column")]


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """The quantized linears of every case of TP_CASES on two gloo ranks,
    one spawn: their outputs by case and rank."""
    cases = [(kind, dict(quantization_type=tq.QuantizationType(qtype)))
             for kind, qtype in TP_CASES]
    outs = W.run(W.quant_linear_worker, 2, tmp_path_factory.mktemp("tp2"), cases, TP_W, TP_X)
    return {case: [o[i] for o in outs] for i, case in enumerate(TP_CASES)}


@pytest.mark.parametrize("qtype", TYPES)
def test_quantized_linears_at_tp2_match_jax(tp2, qtype):
    """Two gloo ranks: each rank's payload is its slice of JAX's payload of
    the whole kernel and its scale JAX's (the row-parallel kernel's input
    rows, split over tp, take the maximum over the ranks), and the output
    JAX's."""
    jc, _ = _cfgs(qtype, "int8")
    want = jq.quantize_array(jnp.asarray(TP_W), jc)
    pay, sc = np.asarray(want.qvalue, np.float32), np.asarray(want.scale)
    y = TP_X @ np.asarray(want.dequantize(jnp.float32))
    for kind, dim in (("row", 0), ("column", 1)):
        for r, o in enumerate(tp2[kind, qtype]):
            assert np.array_equal(o["qvalue"], np.split(pay, 2, dim)[r]), (kind, r)
            assert np.array_equal(o["scale"], sc if sc.shape[dim] == 1 else np.split(sc, 2, dim)[r])
            np.testing.assert_allclose(o["y"], y, rtol=1e-5, atol=1e-5)


def test_convert_rejects_an_unmapped_module():
    with pytest.raises(TypeError, match="no quantized mapping for Linear"):
        tql.convert(torch.nn.Linear(4, 4))
    with pytest.raises(TypeError, match="no quantized mapping"):
        jql.convert(object())


def _scaled(path, x):
    name = jax.tree_util.keystr(path)
    return x * LAYER_SCALE if "layers" in name and "scale" not in name and "router" not in name \
        else x


def _models(family, scale=False, **cfg_kw):
    if family == "tiny":
        jcfg, cfg = jllama.LLAMA_CONFIGS["tiny"], tllama.LLAMA_CONFIGS["tiny"]
        jcls, tcls = jllama.LlamaForCausalLM, tllama.LlamaForCausalLM
    else:
        jcfg, cfg = jmix.MIXTRAL_CONFIGS["tiny-moe"], tmix.MIXTRAL_CONFIGS["tiny-moe"]
        jcls, tcls = jmix.MixtralForCausalLM, tmix.MixtralForCausalLM
    jcfg, cfg = dataclasses.replace(jcfg, **cfg_kw), dataclasses.replace(cfg, **cfg_kw)
    p = jcls(jcfg).init(jax.random.key(11))
    if scale:
        p = jax.tree_util.tree_map_with_path(_scaled, p)
    model = tcls(cfg, device="cpu")
    model.load_state_dict(tllama.params_from_jax(jax.tree.map(np.asarray, p), cfg, device="cpu"))
    return jcfg, jcls(jcfg), p, cfg, model


@pytest.mark.parametrize("qtype", TYPES)
@pytest.mark.parametrize("family", ["tiny", "tiny-moe"])
def test_quantized_model_logits_match_jax(family, qtype):
    _, jm, p, cfg, model = _models(family)
    jc, tc = _cfgs(qtype, "int8")
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    ref = model(torch.as_tensor(ids)).numpy()
    before = tq.weight_bytes(model)
    tq.quantize_model(model, tc)
    out = model(torch.as_tensor(ids)).numpy()
    want = np.asarray(jm(jq.dequantize_params(jq.quantize_params(p, jc), jnp.float32),
                         jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    assert np.abs(out - ref).max() < 0.25
    assert (out.argmax(-1) == ref.argmax(-1)).mean() > 0.95
    assert tq.weight_bytes(model) < before
    assert not any(n.endswith(("q_kernel", "gate_up", "down")) for n, _ in model.named_parameters())


def test_engines_serve_a_quantized_model_as_jax():
    """int8 per channel, tiny-moe with its layers scaled: the dense engine's
    and the paged engine's greedy streams over the quantized model equal the
    JAX engines' over the quantized tree."""
    jcfg, _, p, cfg, model = _models("tiny-moe", scale=True, use_paged_kernel=True)
    jc, tc = _cfgs("per_channel_symmetric", "int8")
    jqp = jq.quantize_params(p, jc)
    tq.quantize_model(model, tc)
    prompts = [np.random.default_rng(s).integers(0, 256, size=(n,)).tolist()
               for s, n in ((1, 6), (2, 13), (3, 9))]
    kw = dict(max_batch=2, max_seq_len=64, buckets=[8, 16, 32])
    want = JaxEngine(jcfg, jqp, **kw).generate(prompts[:2], JaxGen(max_new_tokens=6)).sequences
    got = InferenceEngine(cfg, model, **kw).generate(prompts[:2],
                                                     GenerationConfig(max_new_tokens=6)).sequences
    assert got == want and len(set(got[0])) > 1
    outs = []
    for eng in (JaxPagedServingEngine(JaxEngine(jcfg, jqp, **kw), JaxGen(max_new_tokens=6),
                                      JaxPagedConfig(block_size=8, num_blocks=32),
                                      precompile=False),
                PagedServingEngine(InferenceEngine(cfg, model, **kw), GenerationConfig(max_new_tokens=6),
                                   PagedConfig(block_size=8, num_blocks=32))):
        for pr in prompts:
            eng.submit(pr)
        outs.append(eng.run_to_completion())
    assert outs[1] == outs[0]
