"""The port's LoRA (lora/model.py) against the JAX package's, on the CPU, in
fp32, mirroring ``tests/test_lora.py``.

The base is ``tiny`` with the JAX package's init (``params_from_jax``); the
adapters cross from JAX through ``adapters_from_jax``, nudged off B = 0 so
that they count:

- identity at B = 0 (the port's own init), the merge math against JAX's
  ``merge_lora`` and against base + scaling · A @ B, rsLoRA's scaling;
- logits, loss and adapter gradients for the default targets, a custom
  pair (``mlp/down/kernel``, ``mlp/gate_up``), the tied embedding and the
  fused gate_up;
- the trainer: three AdamW steps against JAX's ``make_train_step`` on the
  adapters, then eight falling steps; the base stays bit for bit, the
  optimizer state is adapter-sized;
- adapter-only tags cross both ways bit for bit;
- the refusals: no match, MoE expert weights (tiny-moe), a conv target
  that is not rank 4, a path under both pattern lists; the conv branch's
  merge math on a stand-in HWIO kernel (its parity on a real conv waits
  for Mllama, ROADMAP.md);
- merged adapters decode: B = 0 serves the base's stream, trained
  adapters JAX's merged stream, in the dense and the paged engines.

The tp = 2 case (logits, loss, adapter gradients, tags at tp = 2) runs in
``tests/test_torch_gptneox.py``'s one gloo spawn.

Tolerances: logits and loss 1e-5 (atol 1e-6 for the B = 0 identity, which
adds exact zeros), adapter gradients 1e-5 of the leaf's largest element,
merged weights 1e-6, after AdamW 2·lr a step per element; streams token for
token; tags and the base bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from neuronx_distributed_llama3_2_tpu import trainer as jtrainer
from neuronx_distributed_llama3_2_tpu.checkpoint import checkpoint as jckpt
from neuronx_distributed_llama3_2_tpu.inference import (
    GenerationConfig as JaxGen,
    InferenceEngine as JaxEngine,
)
from neuronx_distributed_llama3_2_tpu.lora import LoraConfig as JLoraConfig
from neuronx_distributed_llama3_2_tpu.lora import LoraModel as JLoraModel
from neuronx_distributed_llama3_2_tpu.lora import merge_lora as jmerge
from neuronx_distributed_llama3_2_tpu.models import llama as jllama
from neuronx_distributed_llama3_2_tpu.models import mixtral as jmix
from neuronx_distributed_llama3_2_tpu.parallel import state as jstate
from neuronx_distributed_llama3_2_tpu_torch import trainer as ttrainer
from neuronx_distributed_llama3_2_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from neuronx_distributed_llama3_2_tpu_torch.inference import GenerationConfig, InferenceEngine
from neuronx_distributed_llama3_2_tpu_torch.lora import (
    LoraConfig,
    LoraModel,
    adapters_from_jax,
    adapters_to_jax,
    merge_lora,
)
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama
from neuronx_distributed_llama3_2_tpu_torch.models import mixtral as tmix
from neuronx_distributed_llama3_2_tpu_torch.parallel.layout import LeafSpec
from neuronx_distributed_llama3_2_tpu_torch.serving.engine import PagedConfig, PagedServingEngine

torch.set_num_threads(1)

TINY = tllama.LLAMA_CONFIGS["tiny"]
JTINY = jllama.LLAMA_CONFIGS["tiny"]
LR = 5e-2
STEPS = 3

#: name -> target_modules (None: the default q/k/v/o)
TARGETS = {
    "default": None,
    "custom": (r"mlp/down/kernel$", r"mlp/gate_up$"),
    "embedding": (r"embed/embedding$",),
    "gate_up": (r"mlp/gate_up$",),
}


def _cfgs(targets=None, **kw):
    if targets is not None:
        kw["target_modules"] = targets
    return JLoraConfig(**kw), LoraConfig(**kw)


@functools.lru_cache(maxsize=None)
def _base_params(scale=1.0):
    p = jax.tree.map(np.asarray, jllama.LlamaForCausalLM(JTINY).init(jax.random.key(0)))
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * scale if "layers" in jax.tree_util.keystr(path)
        and "scale" not in jax.tree_util.keystr(path) else x, p)


def _base(scale=1.0):
    model = tllama.LlamaForCausalLM(TINY, device="cpu")
    model.load_state_dict(tllama.params_from_jax(_base_params(scale), TINY, device="cpu"))
    return model


def _batch():
    rng = np.random.default_rng(3)
    return rng.integers(0, TINY.vocab_size, (2, 16))


def _adapters(name, r=4, alpha=8.0, shift=0.01):
    """JAX's LoraModel over the tiny base and its adapters, each leaf + shift."""
    jc, _ = _cfgs(TARGETS[name], r=r, alpha=alpha)
    jl = JLoraModel(jllama.LlamaForCausalLM(JTINY), _base_params(), jc)
    return jl, jax.tree.map(lambda x: np.asarray(x) + shift, jl.init(jax.random.key(1)))


def _port(name, ad, r=4, alpha=8.0, base=None):
    _, tc = _cfgs(TARGETS[name], r=r, alpha=alpha)
    lora = LoraModel(base if base is not None else _base(), tc)
    lora.load_state_dict(adapters_from_jax(ad, lora))
    return lora


def test_zero_init_is_identity():
    """B = 0 at the port's own init: the adapted model is the base, and A is
    N(0, 1/fan_in)."""
    base = _base()
    ids = torch.as_tensor(_batch())
    ref = base(ids)
    lora = LoraModel(base, LoraConfig(r=4)).init_weights(1)
    np.testing.assert_allclose(lora(ids).numpy(), ref.numpy(), atol=1e-6)
    a = lora.adapter("layers.0.attn.qkv.q_kernel").a
    assert a.shape == (TINY.hidden_size, 4)
    assert abs(float(a.std()) * TINY.hidden_size ** 0.5 - 1.0) < 0.3
    assert all(not bool(lora.adapter(n).b.any()) for n in lora._plan)
    with torch.no_grad():
        lora.adapter("layers.0.attn.qkv.q_kernel").b.add_(0.1)
    assert not torch.allclose(lora(ids), ref, atol=1e-3)  # the base runs adapted
    with lora.disabled():
        torch.testing.assert_close(lora.base(ids), ref, rtol=0, atol=0)
    assert sorted({n.split(".", 2)[2] for n, _ in lora.named_parameters()}) == [
        "attn.o.kernel.a", "attn.o.kernel.b", "attn.qkv.k_kernel.a", "attn.qkv.k_kernel.b",
        "attn.qkv.q_kernel.a", "attn.qkv.q_kernel.b", "attn.qkv.v_kernel.a",
        "attn.qkv.v_kernel.b"]


def test_merge_math():
    """merged == JAX's merge_lora and base + (alpha/r)·A@B on the targets;
    every other weight is the base's own tensor."""
    jl, ad = _adapters("default")
    jc, tc = _cfgs(None, r=4, alpha=8.0)
    base = _base()
    lora = _port("default", ad, base=base)
    merged = merge_lora(base, lora.state_dict(), tc)
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jmerge(jllama.LlamaForCausalLM(JTINY), _base_params(), ad, jc))))
    got = tllama.params_to_jax(merged, TINY)
    for path, leaf in want.items():
        keys = [k.key for k in path]
        node = got
        for k in keys:
            node = node[k]
        np.testing.assert_allclose(node, leaf, rtol=1e-6, atol=1e-6, err_msg=str(keys))
    q = ad["layers/attn/qkv/q_kernel"]
    by_hand = _base_params()["layers"]["attn"]["qkv"]["q_kernel"] + tc.scaling * np.einsum(
        "lir,lro->lio", q["a"], q["b"])
    np.testing.assert_allclose(got["layers"]["attn"]["qkv"]["q_kernel"], by_hand,
                               rtol=1e-5, atol=1e-6)
    params = dict(base.named_parameters())
    assert merged["layers.0.mlp.gate_up"].data_ptr() == params["layers.0.mlp.gate_up"].data_ptr()
    assert not torch.equal(merged["layers.0.attn.o.kernel"], params["layers.0.attn.o.kernel"])


def test_rslora_scaling():
    for cls in (LoraConfig, JLoraConfig):
        assert cls(r=16, alpha=16.0).scaling == 1.0
        assert cls(r=16, alpha=16.0, use_rslora=True).scaling == 4.0
    with pytest.raises(ValueError, match="rank must be >= 1"):
        LoraConfig(r=0)


@pytest.mark.parametrize("name", list(TARGETS))
def test_forward_loss_and_adapter_grads_match_jax(name):
    jl, ad = _adapters(name)
    lora = _port(name, ad)
    ids = _batch()
    jids, tids = jnp.asarray(ids, jnp.int32), torch.as_tensor(ids)
    assert set(adapters_to_jax(dict(lora.named_parameters()), lora)) == set(ad)
    np.testing.assert_allclose(lora(tids).numpy(), np.asarray(jl(ad, jids)), rtol=1e-5, atol=1e-5)
    jloss, jgrads = jax.value_and_grad(jl.loss)(ad, jids, jids)
    params = dict(lora.named_parameters())
    loss = lora.loss(tids, tids)
    grads = adapters_to_jax(
        dict(zip(params, torch.autograd.grad(loss, list(params.values())))), lora)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for path, ab in jgrads.items():
        for x in "ab":
            ref = np.asarray(ab[x])
            assert np.abs(grads[path][x] - ref).max() <= 1e-5 * np.abs(ref).max(), (path, x)
    # the base's parameters are frozen and are not the model's
    assert all(not p.requires_grad for p in lora.base.parameters())
    assert all(n.endswith((".a", ".b")) for n in params)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """STEPS JAX train steps of the default adapters (zero_one off, as JAX's
    test), traced into one call. Returns (start adapters, metrics, end)."""
    jl, ad = _adapters("default", shift=0.0)
    tc = jtrainer.TrainingConfig(optimizer=jtrainer.OptimizerConfig(
        zero_one_enabled=False, warmup_steps=1, learning_rate=LR))
    jstate.destroy_model_parallel()
    tc.initialize(devices=jax.devices()[:1])
    try:
        state, _ = jtrainer.initialize_parallel_model(jl, tc)
        start = jax.tree.map(np.asarray, state.params)
        one = jtrainer.make_train_step(jl, tc).__wrapped__
        ids = jnp.asarray(_batch(), jnp.int32)
        batch = {"input_ids": ids, "labels": ids}

        def steps(state):
            metrics = []
            for _ in range(STEPS):
                state, m = one(state, batch)
                metrics.append(m)
            return state, metrics

        state, metrics = jax.jit(steps)(state)
        return start, [{k: float(v) for k, v in m.items()} for m in metrics], \
            jax.tree.map(np.asarray, state.params)
    finally:
        jstate.destroy_model_parallel()


def test_trainer_steps_match_jax_then_loss_falls():
    """initialize_parallel_model(lora) -> make_train_step: from JAX's start
    adapters, three steps give JAX's losses and adapters; eight steps
    lower the loss; the base is bit for bit the same; AdamW's state is below
    1/20 of the base's size."""
    start, jmetrics, jend = _jax_run()
    base = _base()
    before = {k: p.clone() for k, p in base.named_parameters()}
    lora = LoraModel(base, LoraConfig(r=4, alpha=8.0))
    tc = ttrainer.TrainingConfig(optimizer=ttrainer.OptimizerConfig(
        zero_one_enabled=False, warmup_steps=1, learning_rate=LR))
    tc.initialize("cpu")
    state, specs = ttrainer.initialize_parallel_model(lora, tc)
    with torch.no_grad():
        for k, v in adapters_from_jax(start, lora).items():
            state.params[k].copy_(v)
    state = ttrainer.TrainState(state.params, ttrainer.init_optimizer_state(
        state.params, tc.optimizer, specs.opt))
    n_opt = sum(v.numel() for v in state.opt.mu.values())
    assert n_opt < sum(p.numel() for p in base.parameters()) / 20
    step = ttrainer.make_train_step(lora, tc)
    ids = torch.as_tensor(_batch())
    batch = {"input_ids": ids, "labels": ids}
    losses = []
    for i in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i < STEPS:
            np.testing.assert_allclose(losses[-1], jmetrics[i]["loss"], rtol=1e-5)
            np.testing.assert_allclose(float(m["grad_norm"]), jmetrics[i]["grad_norm"], rtol=1e-4)
        if i == STEPS - 1:
            got = adapters_to_jax(state.params, lora)
            for path, ab in jend.items():
                for x in "ab":
                    assert np.abs(got[path][x] - ab[x]).max() <= 2 * LR * STEPS, (path, x)
    assert losses[-1] < losses[0]
    assert all(torch.equal(p, before[k]) for k, p in base.named_parameters())


def test_adapter_tags_cross_both_ways(tmp_path):
    """An adapter-only tag of the port loads in JAX bit for bit, under the
    JAX file names; JAX's loads in the port bit for bit."""
    jl, ad = _adapters("default")
    lora = _port("default", ad)
    root = str(tmp_path / "port")
    save_checkpoint(root, "adapters", model=dict(lora.named_parameters()))
    template = jax.eval_shape(lambda: jax.tree.map(jnp.asarray, ad))
    out = jckpt.load_checkpoint(root, "adapters", model=template)["model"]
    for path, ab in ad.items():
        for x in "ab":
            assert np.array_equal(np.asarray(out[path][x]), ab[x]), (path, x)
    jroot = str(tmp_path / "jax")
    moved = jax.tree.map(lambda x: x + 0.5, ad)
    jckpt.save_checkpoint(jroot, "adapters", model=jax.tree.map(jnp.asarray, moved))
    own = dict(lora.named_parameters())
    got = load_checkpoint(jroot, "adapters", model=own)["model"]
    back = adapters_to_jax(got, lora)
    for path, ab in moved.items():
        for x in "ab":
            assert np.array_equal(back[path][x], ab[x]), (path, x)
    files = sorted(p.name for p in (tmp_path / "port" / "adapters" / "model").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax" / "adapters" / "model").iterdir())


def test_custom_targets_and_shapes():
    lora = LoraModel(_base(), LoraConfig(r=2, target_modules=TARGETS["custom"])).init_weights(6)
    paths = set(adapters_to_jax(dict(lora.named_parameters()), lora))
    assert paths == {"layers/mlp/down/kernel", "layers/mlp/gate_up"}
    specs = lora.param_specs()
    L, H, I = TINY.num_layers, TINY.hidden_size, TINY.intermediate_size
    # fused gate_up (L, H, 2, I): B carries the (2, I) out dims
    assert specs["layers.0.mlp.gate_up.a"].shape == (L, H, 2)
    assert specs["layers.0.mlp.gate_up.b"].shape == (L, 2, 2, I)
    assert lora.adapter("layers.1.mlp.gate_up").b.shape == (2, 2, I)
    with pytest.raises(ValueError, match="no parameters match"):
        LoraModel(_base(), LoraConfig(target_modules=(r"nonexistent",)))


def test_embedding_and_fused_gate_up_train():
    """The tied embedding's adapter (V, r) / (r, H) gets a gradient and is
    the base at init; a gradient step on the fused gate_up's lowers the
    loss."""
    ids = torch.as_tensor(_batch())
    lora = LoraModel(_base(), LoraConfig(r=4, target_modules=TARGETS["embedding"]))
    lora.init_weights(1)
    ad = lora.adapter("embed.embedding")
    assert ad.a.shape == (TINY.vocab_size, 4) and ad.b.shape == (4, TINY.hidden_size)
    np.testing.assert_allclose(lora(ids).numpy(), lora.base(ids).numpy(), atol=1e-6)
    g = torch.autograd.grad(lora.loss(ids, ids), [ad.a, ad.b])
    assert float(g[0].abs().sum() + g[1].abs().sum()) > 0
    lora = LoraModel(_base(), LoraConfig(r=2, target_modules=TARGETS["gate_up"])).init_weights(2)
    params = list(lora.parameters())
    loss0 = lora.loss(ids, ids)
    grads = torch.autograd.grad(loss0, params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p -= 0.5 * g
    assert float(lora.loss(ids, ids)) < float(loss0)


def test_refusals():
    """Expert weights (tiny-moe), a conv target that is not rank 4, a path
    under both pattern lists: the port refuses as JAX does."""
    moe = tmix.MixtralForCausalLM(tmix.MIXTRAL_CONFIGS["tiny-moe"], device="cpu")
    jmoe = jmix.MixtralForCausalLM(jmix.MIXTRAL_CONFIGS["tiny-moe"])
    jp = jmoe.init(jax.random.key(3))
    for target in (r"experts/gate_up$", r"experts/down$"):
        with pytest.raises(ValueError, match="not LoRA-targetable"):
            LoraModel(moe, LoraConfig(r=2, target_modules=(target,)))
        with pytest.raises(ValueError, match="not LoRA-targetable"):
            JLoraModel(jmoe, jp, JLoraConfig(r=2, target_modules=(target,)))
    jm = jllama.LlamaForCausalLM(JTINY)
    for kw, match in ((dict(target_modules=(r"qkv/q_kernel$",),
                            conv_target_modules=(r"attn/o/kernel$",)), "rank-4"),
                      (dict(target_modules=(r"attn/o/kernel$",),
                            conv_target_modules=(r"attn/o/kernel$",)), "both")):
        with pytest.raises(ValueError, match=match):
            LoraModel(_base(), LoraConfig(**kw))
        with pytest.raises(ValueError, match=match):
            JLoraModel(jm, _base_params(), JLoraConfig(**kw))


class _ConvBase(nn.Module):
    """A stand-in base with one HWIO kernel (Mllama's patch conv layout)
    and one linear kernel."""

    def __init__(self):
        super().__init__()
        self.config = TINY
        self.patch = nn.Module()
        self.patch.kernel = nn.Parameter(torch.randn(3, 3, 2, 8))
        self.proj = nn.Module()
        self.proj.kernel = nn.Parameter(torch.randn(8, 6))

    @property
    def device(self):
        return torch.device("cpu")

    def param_specs(self):
        return {"patch.kernel": LeafSpec((3, 3, 2, 8), (None, None, None, "tp")),
                "proj.kernel": LeafSpec((8, 6), (None, "tp"))}


def test_conv_target_merge_math():
    """The conv branch: A (kh, kw, I, r) carries the spatial kernel, B (r,
    O) the 1x1 mix; B = 0 merges to the base exactly, a nonzero B to base +
    scaling · einsum(hwir,ro); A splits like I and B like O."""
    base = _ConvBase()
    cfg = LoraConfig(r=4, alpha=8.0, target_modules=(r"proj/kernel$",),
                     conv_target_modules=(r"patch/kernel$",))
    lora = LoraModel(base, cfg).init_weights(0)
    ad = lora.adapter("patch.kernel")
    assert ad.a.shape == (3, 3, 2, 4) and ad.b.shape == (4, 8)
    assert lora.param_specs()["patch.kernel.b"].spec == (None, "tp")
    assert torch.equal(lora.merged_params()["patch.kernel"], base.patch.kernel)
    with torch.no_grad():
        ad.b.normal_(0.0, 0.1)
    with lora.disabled():  # the base's own weight (attached, it reads adapted)
        w0 = base.patch.kernel.detach().numpy()
    want = w0 + cfg.scaling * np.einsum(
        "hwir,ro->hwio", ad.a.detach().numpy(), ad.b.detach().numpy())
    np.testing.assert_allclose(lora.merged_params()["patch.kernel"].detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(base.patch.kernel.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    lora.detach()
    assert type(base.patch) is nn.Module and np.array_equal(base.patch.kernel.detach().numpy(), w0)


def test_decode_with_merged_adapters():
    """B = 0 merged weights serve the base's greedy stream; JAX-drawn
    adapters (x 0.3) merged serve JAX's merged stream, not the base's, in
    the dense engine and in the paged engine with the paged kernel."""
    base = _base(scale=10.0)
    prompt = list(range(1, 9))
    kw = dict(max_batch=1, max_seq_len=64, buckets=[16, 32])
    gen = GenerationConfig(max_new_tokens=8)
    ref = InferenceEngine(TINY, base, **kw).generate([prompt], gen).sequences[0]
    tc = LoraConfig(r=4, alpha=8.0)
    lora = LoraModel(base, tc, attach=False).init_weights(3)
    served = tllama.LlamaForCausalLM(TINY, device="cpu")
    served.load_state_dict(merge_lora(base, lora.state_dict(), tc))
    assert InferenceEngine(TINY, served, **kw).generate([prompt], gen).sequences[0] == ref
    jc = JLoraConfig(r=4, alpha=8.0)
    jm = jllama.LlamaForCausalLM(JTINY)
    jl = JLoraModel(jm, _base_params(10.0), jc)
    ad = jax.tree.map(lambda x: np.asarray(jax.random.normal(jax.random.key(5), x.shape)) * 0.3,
                      jl.init(jax.random.key(3)))
    jmerged = jmerge(jm, jax.tree.map(jnp.asarray, _base_params(10.0)), ad, jc)
    want = JaxEngine(JTINY, jmerged, **kw).generate([prompt], JaxGen(max_new_tokens=8)).sequences[0]
    lora.load_state_dict(adapters_from_jax(ad, lora))
    cfg = dataclasses.replace(TINY, use_paged_kernel=True)
    served = tllama.LlamaForCausalLM(cfg, device="cpu")
    served.load_state_dict(merge_lora(base, lora.state_dict(), tc))
    assert InferenceEngine(cfg, served, **kw).generate([prompt], gen).sequences[0] == want
    assert want != ref
    eng = PagedServingEngine(InferenceEngine(cfg, served, **kw), gen,
                             PagedConfig(block_size=8, num_blocks=16))
    rid = eng.submit(prompt)
    assert eng.run_to_completion()[rid] == want
    assert eng.model.attention_paths["kernel"] > 0


@pytest.mark.parametrize("remat", ["full", "selective", "hybrid"])
def test_remat_recompute_reads_the_adapters(remat):
    """Under remat the backward recomputes each layer from the adapters (the
    base's modules read their targets adapted): the adapter gradients equal
    those without remat."""
    jl, ad = _adapters("default")
    ids = torch.as_tensor(_batch())
    grads = []
    for policy in ("none", remat):
        base = tllama.LlamaForCausalLM(dataclasses.replace(TINY, remat=policy), device="cpu")
        base.load_state_dict(tllama.params_from_jax(_base_params(), TINY, device="cpu"))
        lora = _port("default", ad, base=base)
        params = list(lora.parameters())
        grads.append(torch.autograd.grad(lora.loss(ids, ids), params))
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# Mllama: the conv target on the patch conv, the grouped plain stack
# ---------------------------------------------------------------------------

def _mllama(seed=0):
    """tiny-mllama in both packages: JAX's model and init weights, the
    port's model over them."""
    from neuronx_distributed_llama3_2_tpu.models import mllama as jml
    from neuronx_distributed_llama3_2_tpu_torch.models import mllama as tml

    jm = jml.MllamaForConditionalGeneration(jml.MLLAMA_CONFIGS["tiny-mllama"])
    p = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(seed)))
    cfg = tml.MLLAMA_CONFIGS["tiny-mllama"]
    base = tml.MllamaForConditionalGeneration(cfg, device="cpu")
    base.load_state_dict(tml.params_from_jax(p, cfg, device="cpu"))
    return jm, p, base


def test_conv_target_vision_lora_parity_mllama():
    """JAX ``test_conv_target_vision_lora_parity`` (tests/test_lora.py:239)
    on tiny-mllama: the patch conv's adapters (A (14, 14, 3, r), B (r,
    32)) and the grouped plain stack's q kernel (A (G, k - 1, 32, r)); B =
    0 merges to the base exactly; nudged adapters merge to JAX's
    ``merged_params``, and the adapted forward is the forward of the merged
    weights."""
    from neuronx_distributed_llama3_2_tpu_torch.models import mllama as tml

    jm, p, base = _mllama()
    kw = dict(r=4, alpha=8.0, target_modules=(r"layers/plain/attn/qkv/q_kernel$",),
              conv_target_modules=(r"vision_model/patch_embedding/kernel$",))
    jl = JLoraModel(jm, p, JLoraConfig(**kw))
    lora = LoraModel(base, LoraConfig(**kw))
    conv = lora.adapter("vision_model.patch_embedding.kernel")
    assert conv.a.shape == (14, 14, 3, 4) and conv.b.shape == (4, 32)
    assert lora.adapter("layers.plain.attn.qkv.q_kernel").a.shape == (1, 1, 32, 4)
    lora.init_weights(1)
    zero = tml.params_to_jax(dict(lora.merged_params()), base.config)
    np.testing.assert_array_equal(zero["vision_model"]["patch_embedding"]["kernel"],
                                  p["vision_model"]["patch_embedding"]["kernel"])
    ad = jax.tree.map(lambda x: np.asarray(x) + 0.05, jl.init(jax.random.key(1)))
    lora.load_state_dict(adapters_from_jax(ad, lora))
    want = jl.merged_params(jax.tree.map(jnp.asarray, ad))
    got = tml.params_to_jax({k: v.detach() for k, v in lora.merged_params().items()},
                            base.config)
    for path in (("vision_model", "patch_embedding", "kernel"),
                 ("layers", "plain", "attn", "qkv", "q_kernel")):
        w, g = want, got
        for k in path:
            w, g = w[k], g[k]
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)
        assert np.abs(np.asarray(w) - tllama._dig(p, path)).max() > 1e-3
    # the adapted base reads base + scaling · A @ B through the stacked holder
    from tests.test_torch_mllama import _t, inputs

    batch = _t(inputs(b=2, s=12, vocab=128))
    pix, ids, ar, arm, xm = batch
    adapted = base(ids, pix, ar, arm, xm)
    merged = tml.MllamaForConditionalGeneration(base.config, device="cpu")
    merged.load_state_dict({k: v.detach() for k, v in lora.merged_params().items()})
    np.testing.assert_allclose(adapted.numpy(), merged(ids, pix, ar, arm, xm).numpy(),
                               rtol=1e-5, atol=1e-6)
    lora.detach()


def test_conv_and_linear_pattern_overlap_refused_mllama():
    """JAX ``test_conv_and_linear_pattern_overlap_refused``
    (tests/test_lora.py:297): the patch conv under both pattern lists."""
    jm, p, base = _mllama()
    kw = dict(target_modules=(r"patch_embedding/kernel$",),
              conv_target_modules=(r"patch_embedding/kernel$",))
    with pytest.raises(ValueError, match="both"):
        LoraModel(base, LoraConfig(**kw))
    with pytest.raises(ValueError, match="both"):
        JLoraModel(jm, p, JLoraConfig(**kw))
