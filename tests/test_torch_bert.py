"""The port's BERT (models/bert.py) against the JAX package's, on the CPU, in
fp32, mirroring ``tests/test_bert.py``.

The same numpy weights (``params_from_jax``, every leaf nudged so that the
zero-initialized biases count) and a padded batch with token types go
through both:

- the MLM and NSP logits with and without the padding mask;
- the MLM loss (the trainer's ``loss``) and the pretraining loss (MLM +
  NSP) with their gradients; the weight bridge both ways, the fp32 leaves
  (norms, ``mlm_bias``) staying fp32 under bf16;
- three AdamW steps through the trainer against JAX's ``make_train_step``
  on the MLM batch (the NSP head's gradient is zero there, as under
  ``jax.grad``), and remat "full" giving the same gradients as "none".

The tp = 2 case runs in ``tests/test_torch_gptneox.py``'s one gloo spawn.

Tolerances: logits and loss 1e-5, gradients 1e-5 of the leaf's largest
element (a floor of 1e-8: the k bias's true gradient is 0), after AdamW
2·lr a step per element and 1e-6 on the mean (the k bias excepted: AdamW
scales its rounding noise to whole steps in both packages alike); the
bridge bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu import trainer as jtrainer
from neuronx_distributed_llama3_2_tpu.models import bert as jbert
from neuronx_distributed_llama3_2_tpu.parallel import state as jstate
from neuronx_distributed_llama3_2_tpu_torch import trainer as ttrainer
from neuronx_distributed_llama3_2_tpu_torch.models import bert as tbert
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

JCFG, CFG = jbert.BERT_CONFIGS["tiny-bert"], tbert.BERT_CONFIGS["tiny-bert"]
LR = 1e-3
STEPS = 3


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@functools.lru_cache(maxsize=None)
def _jax_params():
    rng = np.random.default_rng(1)
    p = jax.tree.map(np.asarray, jbert.BertForPreTraining(JCFG).init(jax.random.key(0)))
    return jax.tree.map(lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32), p)


def _port(**cfg_kw):
    cfg = dataclasses.replace(CFG, **cfg_kw)
    model = tbert.BertForPreTraining(cfg, device="cpu")
    model.load_state_dict(tllama.params_from_jax(_jax_params(), cfg, device="cpu"))
    return cfg, model


def _batch():
    """(4, 16): MLM labels at ~30 % of the positions, two segments, the
    third row padded past position 11, NSP labels."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, CFG.vocab_size, (4, 16))
    mask = np.ones((4, 16), np.int32)
    mask[2, 11:] = 0
    return dict(input_ids=ids, labels=np.where(rng.random((4, 16)) < 0.3, ids, -100),
                token_type_ids=(np.arange(16)[None] >= 8).astype(np.int32).repeat(4, 0),
                attention_mask=mask, next_sentence_label=np.array([0, 1, 1, 0]))


def _assert_grads(got, want):
    for path, w in _leaves(jax.tree.map(np.asarray, want)):
        scale = max(np.abs(w).max(), 1e-3)
        assert np.abs(got[path] - w).max() <= 1e-5 * scale, path


@pytest.mark.parametrize("masked", [False, True])
def test_logits_match_jax(masked):
    jm, p = jbert.BertForPreTraining(JCFG), _jax_params()
    _, model = _port()
    b = _batch()
    mask = b["attention_mask"] if masked else None
    jmlm, jnsp = jm(p, jnp.asarray(b["input_ids"]), jnp.asarray(b["token_type_ids"]),
                    None if mask is None else jnp.asarray(mask))
    mlm, nsp = model(torch.as_tensor(b["input_ids"]), torch.as_tensor(b["token_type_ids"]),
                     None if mask is None else torch.as_tensor(mask))
    assert mlm.shape == (4, 16, CFG.vocab_size) and nsp.shape == (4, 2)
    np.testing.assert_allclose(mlm.numpy(), np.asarray(jmlm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nsp.numpy(), np.asarray(jnsp), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("objective", ["mlm", "pretraining"])
def test_losses_and_grads_match_jax(objective):
    jm, p = jbert.BertForPreTraining(JCFG), _jax_params()
    cfg, model = _port()
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    if objective == "mlm":
        jloss, jgrads = jax.value_and_grad(jm.loss)(p, jb["input_ids"], jb["labels"])
        loss = model.loss(tb["input_ids"], tb["labels"])
    else:
        jloss, jgrads = jax.value_and_grad(jm.pretraining_loss)(p, jb)
        loss = model.pretraining_loss(tb)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _assert_grads(dict(_leaves(tllama.params_to_jax(dict(zip(params, grads)), cfg))), jgrads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(dtype):
    """params_to_jax(params_from_jax(tree)) is the tree (bf16-rounded where
    the leaf takes bf16); the norms and ``mlm_bias`` stay fp32."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    cfg, model = _port(dtype=tdt)
    params = dict(model.named_parameters())
    fp32 = {k for k, v in params.items() if v.dtype == torch.float32}
    assert fp32 == set(params) if dtype == "float32" else fp32 == {
        k for k in params if k.endswith(("norm.scale", "norm.bias", "mlm_bias"))}
    back = dict(_leaves(tllama.params_to_jax(params, cfg)))
    want = dict(_leaves(_jax_params()))
    assert back.keys() == want.keys()
    for path, leaf in back.items():
        name = ".".join(path)
        exact = want[path]
        if dtype == "bfloat16" and not name.endswith(("norm.scale", "norm.bias", "mlm_bias")):
            exact = np.asarray(jnp.asarray(exact, jnp.bfloat16), np.float32)
        assert np.array_equal(leaf, exact), path


@functools.lru_cache(maxsize=None)
def _jax_run():
    """STEPS JAX train steps of tiny-bert's MLM loss, traced into one call."""
    tc = jtrainer.TrainingConfig(optimizer=jtrainer.OptimizerConfig(
        learning_rate=LR, warmup_steps=1, total_steps=10))
    jstate.destroy_model_parallel()
    tc.initialize(devices=jax.devices()[:1])
    try:
        model = jbert.BertForPreTraining(JCFG)
        p = jax.tree.map(jnp.asarray, _jax_params())
        state, _ = jtrainer.initialize_parallel_model(model, tc)
        state = state._replace(params=p, opt=jtrainer.init_optimizer_state(p, tc.optimizer))
        start = jax.tree.map(np.asarray, state)
        one = jtrainer.make_train_step(model, tc).__wrapped__
        b = _batch()
        batch = {"input_ids": jnp.asarray(b["input_ids"], jnp.int32),
                 "labels": jnp.asarray(b["labels"], jnp.int32)}

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
    cfg, model = _port()
    opt_cfg = ttrainer.OptimizerConfig(learning_rate=LR, warmup_steps=1, total_steps=10)
    tc = ttrainer.TrainingConfig(optimizer=opt_cfg)
    tc.initialize("cpu")
    params = dict(model.named_parameters())
    state = ttrainer.TrainState(
        params, ttrainer.opt_state_from_jax(start.opt, cfg, opt_cfg, device="cpu"))
    step = ttrainer.make_train_step(model, tc)
    b = _batch()
    batch = {"input_ids": torch.as_tensor(b["input_ids"]), "labels": torch.as_tensor(b["labels"])}
    for jm in jmetrics:
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"], rtol=1e-4)
    got = dict(_leaves(tllama.params_to_jax(state.params, cfg)))
    for path, ref in _leaves(jend.params):
        diff = np.abs(got[path] - ref)
        mean_ok = diff.mean() <= 1e-6 or path[-1] == "k_bias"
        assert diff.max() <= 2 * LR * STEPS and mean_ok, (path, diff.max())


def test_remat_full_matches_none():
    _, model = _port()
    _, remat = _port(remat="full")
    b = _batch()
    ids, labels = torch.as_tensor(b["input_ids"]), torch.as_tensor(b["labels"])
    out = []
    for m in (model, remat):
        params = [p for _, p in m.named_parameters()]
        loss = m.loss(ids, labels)
        out.append((loss.detach(), torch.autograd.grad(loss, params, allow_unused=True,
                                                       materialize_grads=True)))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for a, b_ in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b_, rtol=1e-6, atol=1e-7)
