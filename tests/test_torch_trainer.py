"""The port's trainer (trainer/, parallel/grads.py) against the JAX
package's, on the CPU, in fp32 on the tiny config.

Weights and optimizer state cross through ``params_from_jax`` /
``opt_state_from_jax``; inputs are drawn with numpy from a seed.

Tolerances. Loss and grad norm: the two sides run the same fp32 math in
another summation order, so 1e-5 and 1e-4 relative. Parameters after
AdamW: its first update is about lr·sign(g), so an element whose gradient
is near 0 (where the two sides' fp32 noise can take different signs) may
differ by up to 2·lr per step; after STEPS steps every element is held to
2·lr·STEPS, and the mean difference to 1e-6, which a wrong update would
exceed. bf16 optimizer state: within one bf16 rounding (2^-7 relative).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.models import llama as jllama
from neuronx_distributed_llama3_2_tpu.parallel import state as jstate
from neuronx_distributed_llama3_2_tpu import trainer as jtrainer
from neuronx_distributed_llama3_2_tpu.trainer.trainer import (
    default_weight_decay_mask as jax_default_weight_decay_mask,
)
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama
from neuronx_distributed_llama3_2_tpu_torch import trainer as ttrainer
from neuronx_distributed_llama3_2_tpu_torch.parallel import state as tstate
from neuronx_distributed_llama3_2_tpu_torch.parallel.grads import clip_grad_norm, global_norm

torch.set_num_threads(1)

LR = 1e-3
STEPS = 3


def _opt_kw():
    return dict(learning_rate=LR, warmup_steps=1, total_steps=10)


def _batch():
    """(4, 16) ids; labels with ignored positions spread unevenly, so the
    two strided microbatches carry different valid-token counts."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 256, size=(4, 16))
    labels = ids.copy()
    labels[1, 2:9] = -100
    labels[3, 5] = -100
    return ids, labels


@functools.lru_cache(maxsize=None)
def _jax_run(n_micro, flash):
    """STEPS JAX train steps on tiny with the loss chunked at 8, traced into
    one program and called once: on the CPU a jitted JAX train step called
    repeatedly in one process can fail from its second call on with an XLA
    buffer-count error, which a single call avoids. Returns (start state,
    per-step metrics, end state) as numpy."""
    cfg = dataclasses.replace(
        jllama.LLAMA_CONFIGS["tiny"], use_flash_attention=flash, loss_chunk_size=8
    )
    tc = jtrainer.TrainingConfig(
        num_microbatches=n_micro, optimizer=jtrainer.OptimizerConfig(**_opt_kw())
    )
    jstate.destroy_model_parallel()
    tc.initialize(devices=jax.devices()[:1])
    try:
        model = jllama.LlamaForCausalLM(cfg)
        state, _ = jtrainer.initialize_parallel_model(model, tc)
        # the step donates its input state: give it buffers of its own
        state = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), state)
        start = jax.tree.map(np.asarray, state)
        one_step = jtrainer.make_train_step(model, tc).__wrapped__

        def steps(state, batch):
            metrics = []
            for _ in range(STEPS):
                state, m = one_step(state, batch)
                metrics.append(m)
            return state, metrics

        ids, labels = _batch()
        batch = {"input_ids": jnp.asarray(ids, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
        state, metrics = jax.jit(steps)(state, batch)
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
        return start, metrics, jax.tree.map(np.asarray, state)
    finally:
        jstate.destroy_model_parallel()


def _port_model(cfg_kw, np_params):
    cfg = dataclasses.replace(tllama.LLAMA_CONFIGS["tiny"], **cfg_kw)
    model = tllama.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(tllama.params_from_jax(np_params, cfg, device="cpu"))
    return cfg, model


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("flash", [False, True], ids=["core", "flash"])
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_jax(n_micro, remat, flash):
    start, jmetrics, jend = _jax_run(n_micro, flash)
    cfg, model = _port_model(
        dict(remat=remat, use_flash_attention=flash, loss_chunk_size=8), start.params
    )
    opt_cfg = ttrainer.OptimizerConfig(**_opt_kw())
    tc = ttrainer.TrainingConfig(num_microbatches=n_micro, optimizer=opt_cfg)
    assert tc.initialize("cpu") == torch.device("cpu")
    params = dict(model.named_parameters())
    state = ttrainer.TrainState(
        params, ttrainer.opt_state_from_jax(start.opt, cfg, opt_cfg, device="cpu")
    )
    step = ttrainer.make_train_step(model, tc)
    ids, labels = _batch()
    batch = {"input_ids": torch.as_tensor(ids), "labels": torch.as_tensor(labels)}
    for jm in jmetrics:
        state, m = step(state, batch)
        assert m["step"] == int(jm["step"])
        np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(m["learning_rate"], jm["learning_rate"], rtol=1e-6)
    assert state.params is params  # updated in place
    got = dict(_leaves(tllama.params_to_jax(state.params, cfg)))
    for path, ref in _leaves(jend.params):
        diff = np.abs(got[path] - ref)
        assert diff.max() <= 2 * LR * STEPS, (path, diff.max())
        assert diff.mean() <= 1e-6, (path, diff.mean())
    jopt = ttrainer.opt_state_to_jax(state.opt, cfg)
    assert int(jopt.step) == int(jend.opt.step)
    got_master = dict(_leaves(jopt.master))
    for path, ref in _leaves(jend.opt.master):
        assert np.abs(got_master[path] - ref).mean() <= 1e-6, path


def _apply_case(master, state_dtype, clip):
    rng = np.random.default_rng(11)
    shapes = {"w": (4, 8), "v": (8,), "u": (3, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: (0.5 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    mask = {"w": True, "v": False, "u": True}
    kw = dict(
        learning_rate=1e-2, warmup_steps=1, total_steps=5, use_master_weights=master,
        state_dtype=state_dtype, grad_clipping=clip, max_grad_norm=0.5,
    )
    # bench's single-card setting keeps bf16 params beside bf16 state
    pdt = "bfloat16" if (state_dtype == "bfloat16" and not master) else "float32"
    return params, grads, mask, kw, pdt


@pytest.mark.parametrize("clip", [True, False], ids=["clip", "noclip"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("master", [True, False], ids=["master", "nomaster"])
def test_apply_gradients_matches_jax(master, state_dtype, clip):
    params, grads, mask, kw, pdt = _apply_case(master, state_dtype, clip)
    jcfg = jtrainer.OptimizerConfig(**kw)
    jp = {k: jnp.asarray(v, pdt) for k, v in params.items()}
    jg = {k: jnp.asarray(v, pdt) for k, v in grads.items()}
    jst = jtrainer.init_optimizer_state(jp, jcfg)
    tcfg = ttrainer.OptimizerConfig(**kw)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    tp = {k: torch.tensor(v).to(tdt[pdt]) for k, v in params.items()}
    tg = {k: torch.tensor(v).to(tdt[pdt]) for k, v in grads.items()}
    tst = ttrainer.init_optimizer_state(tp, tcfg)
    for _ in range(STEPS):
        jp, jst, jnorm = jtrainer.apply_gradients(jst, jg, jp, jcfg, weight_decay_mask=mask)
        tp, tst, tnorm = ttrainer.apply_gradients(tst, tg, tp, tcfg, weight_decay_mask=mask)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-5)
    assert tst.step == int(jst.step) == STEPS
    tol = dict(rtol=2.0 ** -7, atol=1e-6) if state_dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-6)
    for name, tree_t, tree_j in (("mu", tst.mu, jst.mu), ("nu", tst.nu, jst.nu)):
        for k in params:
            np.testing.assert_allclose(
                tree_t[k].float().numpy(), np.asarray(tree_j[k], np.float32), err_msg=f"{name}.{k}", **tol
            )
    assert (tst.master is None) == (not master)
    if master:
        for k in params:
            np.testing.assert_allclose(
                tst.master[k].float().numpy(), np.asarray(jst.master[k], np.float32), err_msg=k, **tol
            )
    ptol = dict(rtol=2.0 ** -7, atol=1e-6) if pdt == "bfloat16" else tol
    for k in params:
        assert tp[k].dtype == tdt[pdt]
        np.testing.assert_allclose(
            tp[k].float().numpy(), np.asarray(jp[k], np.float32), err_msg=k, **ptol
        )


def test_global_norm_and_clip_match_jax():
    from neuronx_distributed_llama3_2_tpu.parallel import grads as jgrads

    rng = np.random.default_rng(12)
    grads = {k: rng.standard_normal((5, 3)).astype(np.float32) for k in "abc"}
    jclipped, jnorm = jgrads.clip_grad_norm({k: jnp.asarray(v) for k, v in grads.items()}, 1.5)
    tclipped, tnorm = clip_grad_norm({k: torch.as_tensor(v) for k, v in grads.items()}, 1.5)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(tclipped)), 1.5, rtol=1e-5)
    for k in grads:
        np.testing.assert_allclose(tclipped[k].numpy(), np.asarray(jclipped[k]), rtol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_jax(schedule):
    kw = dict(learning_rate=0.5, warmup_steps=3, total_steps=12, min_lr_ratio=0.2, schedule=schedule)
    jcfg, tcfg = jtrainer.OptimizerConfig(**kw), ttrainer.OptimizerConfig(**kw)
    for step in range(16):
        np.testing.assert_allclose(tcfg.lr_at(step), float(jcfg.lr_at(step)), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("tied", [True, False])
def test_default_weight_decay_mask_matches_jax(tied):
    """Leaf by leaf: a port layer leaf decides as the JAX package's stacked
    (L, ...) leaf does, one dimension up."""
    jcfg = dataclasses.replace(jllama.LLAMA_CONFIGS["tiny"], tie_word_embeddings=tied)
    jp = jax.tree.map(np.asarray, jllama.LlamaForCausalLM(jcfg).init(jax.random.key(0)))
    jmask = dict(_leaves(jax_default_weight_decay_mask(jp)))
    cfg, model = _port_model(dict(tie_word_embeddings=tied), jp)
    tmask = ttrainer.default_weight_decay_mask(dict(model.named_parameters()))
    stacked = dict(_leaves(tllama.params_to_jax(
        {k: torch.tensor(float(v)) for k, v in tmask.items()}, cfg
    )))
    assert stacked.keys() == jmask.keys()
    for path, want in jmask.items():
        assert np.all(stacked[path] == float(want)), path
    assert any(jmask.values()) and not all(jmask.values())


def test_weight_decay_mask_counts_the_stacked_layer_axis():
    """A 1-D layer leaf that is no norm or bias decays in the JAX package,
    whose stacked (L, n) leaf has two dimensions; so it does in the port.
    A 1-D leaf outside the layers does not."""
    jmask = jax_default_weight_decay_mask(
        {"layers": {"gain": np.ones((4, 8))}, "head_gain": np.ones(8)}
    )
    tmask = ttrainer.default_weight_decay_mask(
        {"layers.0.gain": torch.ones(8), "head_gain": torch.ones(8)}
    )
    assert tmask == {"layers.0.gain": bool(jmask["layers"]["gain"]),
                     "head_gain": bool(jmask["head_gain"])}
    assert tmask == {"layers.0.gain": True, "head_gain": False}


def test_eval_step_and_evaluate_match_jax():
    start, _, _ = _jax_run(1, False)
    jcfg = dataclasses.replace(jllama.LLAMA_CONFIGS["tiny"], loss_chunk_size=8)
    jmodel = jllama.LlamaForCausalLM(jcfg)
    ids, labels = _batch()
    jstate.destroy_model_parallel()
    jtc = jtrainer.TrainingConfig()
    jtc.initialize(devices=jax.devices()[:1])
    try:
        jbatch = {"input_ids": jnp.asarray(ids, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
        want = float(jtrainer.make_eval_step(jmodel, jtc)(start.params, jbatch))
        want_mean = jtrainer.evaluate(jmodel, jtc, start.params, [jbatch, jbatch])
    finally:
        jstate.destroy_model_parallel()
    cfg, model = _port_model(dict(loss_chunk_size=8), start.params)
    tc = ttrainer.TrainingConfig()
    params = dict(model.named_parameters())
    batch = {"input_ids": torch.as_tensor(ids), "labels": torch.as_tensor(labels)}
    got = ttrainer.make_eval_step(model, tc)(params, batch)
    assert got.grad_fn is None and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    np.testing.assert_allclose(ttrainer.evaluate(model, tc, params, [batch, batch]), want_mean, rtol=1e-5)
    with pytest.raises(ValueError, match="empty"):
        ttrainer.evaluate(model, tc, params, [])
    with pytest.raises(ValueError, match="model's own parameters"):
        ttrainer.make_eval_step(model, tc)({k: v.detach().clone() for k, v in params.items()}, batch)


@pytest.mark.parametrize("knob,value", [
    ("pipeline_parallel_size", 2), ("pipeline_parallel_size", 4),
    ("expert_parallel_size", 2),
    ("pipeline_schedule", "1f1b"), ("num_model_chunks", 2),
])
def test_parallel_knobs_raise_naming_the_knob(knob, value):
    """Expert parallelism and the pipeline run (test_torch_ep_train.py,
    test_torch_pp_train.py): ep or pp on a world of one process is refused
    before a group starts, and the trainer refuses a config whose mesh is
    not live, naming the knob; the pipeline knobs on an unpipelined model
    are refused by the trainer, naming the knob (JAX
    ``_validate_pipeline_config``)."""
    tc = ttrainer.TrainingConfig(**{knob: value})
    model = tllama.LlamaForCausalLM(tllama.LLAMA_CONFIGS["tiny"], device="cpu")
    if knob == "expert_parallel_size":
        with pytest.raises(ValueError, match="not divisible by expert_parallel_size"):
            tc.initialize("cpu")
        with pytest.raises(ValueError, match=knob):
            ttrainer.make_train_step(model, tc)
    elif knob == "pipeline_parallel_size":
        with pytest.raises(ValueError, match="not divisible"):
            tc.initialize("cpu")
        with pytest.raises(ValueError, match=knob):
            ttrainer.make_train_step(model, tc)
    else:
        tc.initialize("cpu")
        with pytest.raises(ValueError, match=knob):
            ttrainer.make_train_step(model, tc)
        with pytest.raises(ValueError, match=knob):
            ttrainer.initialize_parallel_model(model, tc)


@pytest.mark.parametrize("cp", [2, 4])
def test_context_parallel_needs_a_world_it_divides(cp):
    """Context parallelism runs (test_torch_cp_train.py), over cp ranks of
    the process group: on a world of one process the mesh refuses it
    before it starts a group, and a train step refuses a config whose cp
    the live mesh does not have."""
    tc = ttrainer.TrainingConfig(context_parallel_size=cp)
    with pytest.raises(ValueError, match="not divisible"):
        tc.initialize("cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tstate.initialize_model_parallel(context_parallel_size=cp, device="cpu")
    assert not tstate.model_parallel_is_initialized()
    model = tllama.LlamaForCausalLM(tllama.LLAMA_CONFIGS["tiny"], device="cpu")
    with pytest.raises(ValueError, match=f"context_parallel_size={cp}.*cp = 1"):
        ttrainer.make_train_step(model, tc)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(remat, flash):
    """The JAX model's loss and gradients under ``remat`` (one jitted
    value_and_grad), from seed-0 weights, on ``_batch()``; as numpy."""
    cfg = dataclasses.replace(
        jllama.LLAMA_CONFIGS["tiny"], remat=remat, use_flash_attention=flash,
        loss_chunk_size=8,
    )
    jstate.destroy_model_parallel()
    jtrainer.TrainingConfig().initialize(devices=jax.devices()[:1])
    try:
        model = jllama.LlamaForCausalLM(cfg)
        params = model.init(jax.random.key(0))
        ids, labels = _batch()
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(
            params, jnp.asarray(ids, jnp.int32), jnp.asarray(labels, jnp.int32)
        )
        return (jax.tree.map(np.asarray, params), float(loss),
                jax.tree.map(np.asarray, grads))
    finally:
        jstate.destroy_model_parallel()


@pytest.mark.parametrize("flash", [False, True], ids=["core", "flash"])
@pytest.mark.parametrize("remat", ["selective", "hybrid", "kv", "dots"])
def test_remat_policy_matches_jax(remat, flash, monkeypatch):
    """Loss and gradients under each remat policy against the JAX model's
    under the same policy (loss 1e-5 relative, as the train step's; each
    gradient leaf 1e-4 relative in L2, the grad norm's tolerance). The
    serving forward keeps no remat: its logits equal the remat-free
    model's bit for bit. With flash on, the attention forward runs
    ``FLASH_FWD_PER_LAYER`` times a layer in one forward and backward."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import flash_attention as fa

    np_params, want_loss, want_grads = _jax_loss_and_grads(remat, flash)
    kw = dict(remat=remat, use_flash_attention=flash, loss_chunk_size=8)
    cfg, model = _port_model(kw, np_params)
    ids, labels = _batch()
    ids_t, labels_t = torch.as_tensor(ids), torch.as_tensor(labels)
    calls = []
    fwd = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd", lambda *a, **k: calls.append(1) or fwd(*a, **k))
    params = dict(model.named_parameters())
    loss = model.loss(ids_t, labels_t)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    got = dict(_leaves(tllama.params_to_jax(grads, cfg)))
    for path, ref in _leaves(want_grads):
        err = np.linalg.norm(got[path] - ref) / max(np.linalg.norm(ref), 1e-30)
        assert err <= 1e-4, (path, err)
    if flash:
        assert len(calls) == tllama.FLASH_FWD_PER_LAYER[remat] * cfg.num_layers
    _, plain = _port_model(dict(kw, remat="none"), np_params)
    assert torch.equal(model(ids_t), plain(ids_t))


def test_initialize_parallel_model_draws_seeded_weights():
    cfg = tllama.LLAMA_CONFIGS["tiny"]
    tc = ttrainer.TrainingConfig(seed=3, optimizer=ttrainer.OptimizerConfig(state_dtype="bfloat16"))
    a, _ = ttrainer.initialize_parallel_model(tllama.LlamaForCausalLM(cfg, device="cpu"), tc)
    b, _ = ttrainer.initialize_parallel_model(tllama.LlamaForCausalLM(cfg, device="cpu"), tc, key=3)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert a.params[k].requires_grad
        assert a.opt.mu[k].dtype == torch.bfloat16 and not a.opt.mu[k].any()
        assert torch.equal(a.opt.master[k], a.params[k].to(torch.bfloat16))
    assert a.opt.step == 0


def test_tensor_parallelism_needs_its_ranks():
    """tp = 2 in a single process: the mesh has no second rank to lay out,
    and initialize says so without starting a process group."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="world size 1 not divisible by tp"):
        ttrainer.TrainingConfig(tensor_parallel_size=2).initialize("cpu")
    assert not dist.is_initialized()
