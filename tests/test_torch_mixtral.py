"""The port's MoE families (models/mixtral.py, models/dbrx.py) against the
JAX package's, on the CPU, in fp32.

The same numpy weights (``params_from_jax``) and token ids go through both:
the logits, the loss with its router aux term and the gradients of
``tiny-moe``, ``tiny-dbrx`` (LayerNorm, ``clip_qkv``), a Sinkhorn-routed
``tiny-moe`` and a capacity-factor ``tiny-moe`` that drops tokens; three
AdamW steps through the trainer against JAX's ``make_train_step`` (two
strided microbatches with uneven token counts); the weight bridge both
ways; checkpoint tags crossing both ways; and the pretrain script on
``tiny-moe``, preempted and resumed.

Tolerances: the same fp32 math in another order, so logits and loss 1e-5,
gradients 1e-5 of the leaf's largest element; after AdamW as in
``test_torch_trainer.py`` (2·lr a step per element, 1e-6 on the mean);
weights through the bridge and through tags bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu import trainer as jtrainer
from neuronx_distributed_llama3_2_tpu.checkpoint import checkpoint as jckpt
from neuronx_distributed_llama3_2_tpu.models import dbrx as jdbrx
from neuronx_distributed_llama3_2_tpu.models import mixtral as jmix
from neuronx_distributed_llama3_2_tpu.parallel import state as jstate
from neuronx_distributed_llama3_2_tpu_torch import trainer as ttrainer
from neuronx_distributed_llama3_2_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from neuronx_distributed_llama3_2_tpu_torch.models import dbrx as tdbrx
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama
from neuronx_distributed_llama3_2_tpu_torch.models import mixtral as tmix
from neuronx_distributed_llama3_2_tpu_torch.scripts import pretrain

from tests.test_torch_pretrain import _Preempted, _preempt_at, log  # noqa: F401

torch.set_num_threads(1)

LR = 1e-3
STEPS = 3

#: name -> (JAX config, port config, port model class)
CASES = {
    "tiny-moe": (jmix.MIXTRAL_CONFIGS["tiny-moe"], tmix.MIXTRAL_CONFIGS["tiny-moe"],
                 tmix.MixtralForCausalLM),
    "tiny-dbrx": (jdbrx.DBRX_CONFIGS["tiny-dbrx"], tdbrx.DBRX_CONFIGS["tiny-dbrx"],
                  tdbrx.DbrxForCausalLM),
    "tiny-moe-sinkhorn": (
        dataclasses.replace(jmix.MIXTRAL_CONFIGS["tiny-moe"], routing="sinkhorn"),
        dataclasses.replace(tmix.MIXTRAL_CONFIGS["tiny-moe"], routing="sinkhorn"),
        tmix.MixtralForCausalLM),
    "tiny-moe-cf1": (
        dataclasses.replace(jmix.MIXTRAL_CONFIGS["tiny-moe"], capacity_factor=1.0),
        dataclasses.replace(tmix.MIXTRAL_CONFIGS["tiny-moe"], capacity_factor=1.0),
        tmix.MixtralForCausalLM),
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


def _jax_model(jcfg):
    return (jdbrx.DbrxForCausalLM if isinstance(jcfg, jdbrx.DbrxConfig)
            else jmix.MixtralForCausalLM)(jcfg)


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    jcfg = CASES[name][0]
    return jax.tree.map(np.asarray, _jax_model(jcfg).init(jax.random.key(3)))


def _port(name, np_params, **cfg_kw):
    _, cfg, cls = CASES[name]
    cfg = dataclasses.replace(cfg, **cfg_kw)
    model = cls(cfg, device="cpu")
    model.load_state_dict(tllama.params_from_jax(np_params, cfg, device="cpu"))
    return cfg, model


@pytest.mark.parametrize("name", list(CASES))
def test_logits_loss_and_grads_match_jax(name):
    jcfg = CASES[name][0]
    jm, p = _jax_model(jcfg), _jax_params(name)
    ids, labels = _batch()
    jids, jlabels = jnp.asarray(ids, jnp.int32), jnp.asarray(labels, jnp.int32)
    cfg, model = _port(name, p)
    tids, tlabels = torch.as_tensor(ids), torch.as_tensor(labels)
    np.testing.assert_allclose(model(tids).numpy(), np.asarray(jm(p, jids)),
                               rtol=1e-5, atol=1e-5)
    jloss, jgrads = jax.value_and_grad(jm.loss)(p, jids, jlabels)
    params = dict(model.named_parameters())
    loss = model.loss(tids, tlabels)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = dict(_leaves(tllama.params_to_jax(dict(zip(params, grads)), cfg)))
    for path, want in _leaves(jax.tree.map(np.asarray, jgrads)):
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got[path] - want).max() <= 1e-5 * scale, path


def test_aux_term_is_in_the_loss():
    """The loss is CE + router_aux_loss_coef · the mean per-layer aux: at
    coef 0 it is the Llama CE of the same hidden states."""
    p = _jax_params("tiny-moe")
    ids, labels = _batch()
    _, model = _port("tiny-moe", p)
    _, model0 = _port("tiny-moe", p, router_aux_loss_coef=0.0)
    tids, tlabels = torch.as_tensor(ids), torch.as_tensor(labels)
    with torch.no_grad():
        full, ce = model.loss(tids, tlabels), model0.loss(tids, tlabels)
    aux = model.aux
    assert 0.5 < float(aux) < 4.0
    np.testing.assert_allclose(float(full), float(ce) + 0.02 * float(aux), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_run(n_micro):
    """STEPS JAX train steps on tiny-moe, traced into one call (as
    test_torch_trainer.py does). Returns (start state, metrics, end state)."""
    tc = jtrainer.TrainingConfig(num_microbatches=n_micro, optimizer=jtrainer.OptimizerConfig(
        learning_rate=LR, warmup_steps=1, total_steps=10))
    jstate.destroy_model_parallel()
    tc.initialize(devices=jax.devices()[:1])
    try:
        model = jmix.MixtralForCausalLM(jmix.MIXTRAL_CONFIGS["tiny-moe"])
        state, _ = jtrainer.initialize_parallel_model(model, tc)
        state = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), state)
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


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_match_jax(n_micro):
    start, jmetrics, jend = _jax_run(n_micro)
    cfg, model = _port("tiny-moe", start.params)
    opt_cfg = ttrainer.OptimizerConfig(learning_rate=LR, warmup_steps=1, total_steps=10)
    tc = ttrainer.TrainingConfig(num_microbatches=n_micro, optimizer=opt_cfg)
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
        assert diff.max() <= 2 * LR * STEPS and diff.mean() <= 1e-6, (path, diff.max())
    assert state.params["layers.0.moe.router.kernel"].dtype == torch.float32


@pytest.mark.parametrize("name,dtype", [("tiny-moe", "float32"), ("tiny-dbrx", "float32"),
                                        ("tiny-moe", "bfloat16")])
def test_params_round_trip(name, dtype):
    """params_to_jax(params_from_jax(tree)) is the tree; under bf16 the
    router and the norm scales stay fp32 and the kernels take bf16."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    p = _jax_params(name)
    if dtype == "bfloat16":
        p = {k: v for k, v in p.items()}
        p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32), p)
    cfg, model = _port(name, p, dtype=tdt)
    assert model.layers[0].moe.router.kernel.dtype == torch.float32
    assert model.layers[0].moe.experts.gate_up.dtype == tdt
    back = tllama.params_to_jax(dict(model.named_parameters()), cfg)
    want = dict(_leaves(p))
    for path, leaf in _leaves(back):
        exact = want[path] if dtype == "float32" or path[-1] in ("scale",) or "router" in path \
            else np.asarray(jnp.asarray(want[path], jnp.bfloat16), np.float32)
        assert np.array_equal(leaf, exact), path


def _opt_kw():
    return dict(learning_rate=LR, warmup_steps=1, total_steps=10)


def test_tags_cross_both_ways(tmp_path):
    """A JAX tag of tiny-moe (weights and AdamW state) loads in the port bit
    for bit; the port's tag of the same state loads in JAX bit for bit."""
    jcfg = jmix.MIXTRAL_CONFIGS["tiny-moe"]
    jtc = jtrainer.TrainingConfig(optimizer=jtrainer.OptimizerConfig(**_opt_kw()))
    jstate.destroy_model_parallel()
    jtc.initialize(devices=jax.devices()[:1])
    try:
        jstate_, _ = jtrainer.initialize_parallel_model(jmix.MixtralForCausalLM(jcfg), jtc)
    finally:
        jstate.destroy_model_parallel()
    jroot = str(tmp_path / "jax")
    jckpt.save_checkpoint(jroot, "step_1", model=jstate_.params, optimizer=jstate_.opt,
                          user_content={"step": 1})
    cfg = tmix.MIXTRAL_CONFIGS["tiny-moe"]
    opt_cfg = ttrainer.OptimizerConfig(**_opt_kw())
    model = tmix.MixtralForCausalLM(cfg, device="cpu")
    state, _ = ttrainer.initialize_parallel_model(model, ttrainer.TrainingConfig(optimizer=opt_cfg))
    loaded = load_checkpoint(jroot, "latest", model=state.params, optimizer=state.opt)
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(loaded["model"][k])
    state = ttrainer.TrainState(state.params, loaded["optimizer"])
    want = dict(_leaves(jax.tree.map(np.asarray, jstate_.params)))
    for path, leaf in _leaves(tllama.params_to_jax(state.params, cfg)):
        assert np.array_equal(leaf, want[path]), path
    jopt = ttrainer.opt_state_to_jax(state.opt, cfg)
    for name in ("master", "mu", "nu"):
        ref = dict(_leaves(jax.tree.map(np.asarray, getattr(jstate_.opt, name))))
        for path, leaf in _leaves(getattr(jopt, name)):
            assert np.array_equal(leaf, ref[path]), (name, path)
    # the port's tag of it, read back by JAX
    proot = str(tmp_path / "port")
    save_checkpoint(proot, "step_1", model=state.params, optimizer=state.opt,
                    user_content={"step": 1})
    params_t = jax.eval_shape(jmix.MixtralForCausalLM(jcfg).init, jax.random.key(0))
    opt_t = jax.eval_shape(lambda p: jtrainer.init_optimizer_state(p, jtc.optimizer), params_t)
    out = jckpt.load_checkpoint(proot, "latest", model=params_t, optimizer=opt_t)
    for path, leaf in _leaves(out["model"]):
        assert np.array_equal(np.asarray(leaf, np.float32), want[path]), path


def _argv(tmp_path, name, steps):
    return ["--model", "tiny-moe", "--global-batch", "4", "--seq-len", "32",
            "--synthetic", "20000", "--ckpt-dir", str(tmp_path / name), "--save-every", "2",
            "--lr", "1e-3", "--warmup-steps", "2", "--steps", str(steps), "--device", "cpu",
            "--capacity-factor", "2.0"]


def test_pretrain_tiny_moe_resumes_to_the_uninterrupted_run(tmp_path, log, monkeypatch):  # noqa: F811
    """``--model tiny-moe --capacity-factor 2.0``: a 6-step run preempted
    after its step-4 save resumes to the uninterrupted run's losses and
    weights bit for bit."""
    whole = pretrain.main(_argv(tmp_path, "whole", 6))
    with monkeypatch.context() as m:
        _preempt_at(m, 4)
        with pytest.raises(_Preempted):
            pretrain.main(_argv(tmp_path, "run", 6))
    b = pretrain.main(_argv(tmp_path, "run", 6))
    assert "resumed from step_4 at step 4" in log.read()
    assert b["start_step"] == 4 and sorted(b["losses"]) == [4, 5]
    for s in (4, 5):
        assert b["losses"][s] == whole["losses"][s]
    assert all(np.isfinite(list(whole["losses"].values())))
    for k, p in b["state"].params.items():
        assert torch.equal(p, whole["state"].params[k]), k
    assert isinstance(b["state"].params["layers.0.moe.experts.gate_up"], torch.nn.Parameter)
