"""The port's parallel training against the JAX package on the same mesh
shape, on the CPU, in fp32 on the tiny config.

Each case runs the port as one process per rank over gloo
(``tests/torch_dist_workers.py``) and the JAX package on as many of its
virtual CPU devices: (tp 2), (tp 2, SP), (dp 2, ZeRO-1) and (tp 2 x dp 2,
ZeRO-1), flash attention on and the loss chunked at 8, two microbatches.
Both start from the JAX package's seeded weights and take STEPS steps on
one numpy-drawn batch.

Tolerances (those of ``test_torch_trainer.py``, the same fp32 math in
another summation order): the first step's gradient, gathered over the
mesh, to 1e-5 of the largest element of its leaf; loss 1e-5 and grad norm
1e-4 relative; parameters and master weights after AdamW to 2·lr·STEPS per
element (an element whose gradient is near 0 may take the other sign of
lr·sign(g) each step) and 1e-6 on the mean; the moments to 1e-4 of their
largest element. The ZeRO-1 specs are compared with JAX's
``optimizer_state_specs`` leaf for leaf, and each rank's own part of mu
with JAX's mu cut by that spec at the rank's coordinates.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neuronx_distributed_llama3_2_tpu import trainer as jtrainer
from neuronx_distributed_llama3_2_tpu.models import llama as jllama
from neuronx_distributed_llama3_2_tpu.parallel import state as jstate

from tests import torch_dist_workers as W

LR = 1e-3
STEPS = 2
N_MICRO = 2
CFG_KW = dict(use_flash_attention=True, loss_chunk_size=8)
OPT_KW = dict(learning_rate=LR, warmup_steps=1, total_steps=10)

#: case id -> (tp, dp, sequence_parallel)
CASES = {
    "tp2": (2, 1, False),
    "tp2_sp": (2, 1, True),
    "dp2_zero1": (1, 2, False),
    "tp2_dp2_zero1": (2, 2, False),
}


def _batch():
    """(4, 16) ids; labels with ignored positions spread unevenly, so the
    microbatches and the dp ranks carry different valid-token counts."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 256, size=(4, 16))
    labels = ids.copy()
    labels[1, 2:9] = -100
    labels[3, 5] = -100
    return ids, labels


@functools.lru_cache(maxsize=None)
def _jax_run(tp, dp, sp):
    """Start weights, the first step's gradient, per-step metrics, the end
    state and the optimizer state's specs of the JAX trainer on a (dp, tp)
    mesh, as numpy (the steps traced into one call, as in
    test_torch_trainer.py)."""
    cfg = dataclasses.replace(jllama.LLAMA_CONFIGS["tiny"], **CFG_KW)
    tc = jtrainer.TrainingConfig(
        tensor_parallel_size=tp, sequence_parallel=sp, num_microbatches=N_MICRO,
        optimizer=jtrainer.OptimizerConfig(**OPT_KW),
    )
    jstate.destroy_model_parallel()
    tc.initialize(devices=jax.devices()[:tp * dp])
    try:
        model = jllama.LlamaForCausalLM(cfg)
        state, specs = jtrainer.initialize_parallel_model(model, tc)
        start = jax.tree.map(np.asarray, state.params)
        ids, labels = _batch()
        batch = {"input_ids": jnp.asarray(ids, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
        grads = jax.jit(jax.grad(model.loss))(state.params, batch["input_ids"], batch["labels"])
        one_step = jtrainer.make_train_step(model, tc).__wrapped__

        def steps(state, batch):
            metrics = []
            for _ in range(STEPS):
                state, m = one_step(state, batch)
                metrics.append(m)
            return state, metrics

        state = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), state)
        state, metrics = jax.jit(steps)(state, batch)
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
        return (start, jax.tree.map(np.asarray, grads), metrics,
                jax.tree.map(np.asarray, state), specs.opt.mu)
    finally:
        jstate.destroy_model_parallel()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _spec_of(p, ndim):
    """A JAX PartitionSpec as the port writes it: per dim "tp", "dp" (for
    ("dp", "ep")) or None."""
    parts = list(p) + [None] * (ndim - len(p))
    out = []
    for a in parts:
        if isinstance(a, tuple):
            a = "dp" if "dp" in a else a
        out.append(a)
    return tuple(out)


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _pairs(want_tree, got_tree):
    """(path, want, got) of two trees, matched by path."""
    got = dict(_leaves(got_tree))
    want = dict(_leaves(want_tree))
    assert got.keys() == want.keys()
    return [(k, want[k], got[k]) for k in want]


@pytest.mark.parametrize("case", list(CASES))
def test_parallel_train_matches_jax(case, tmp_path):
    tp, dp, sp = CASES[case]
    start, jgrads, jmetrics, jend, jspecs = _jax_run(tp, dp, sp)
    ids, labels = _batch()
    outs = W.run(W.train_worker, tp * dp, tmp_path, tp, sp, CFG_KW, OPT_KW, N_MICRO, STEPS,
                 start, ids, labels)
    port = outs[0]

    # every rank reaches the same loss and the same gathered state
    for o in outs[1:]:
        assert o["metrics"] == port["metrics"]
    for path, want, got in _pairs(jgrads, port["grads"]):
        _close(got, want, 1e-5 * np.abs(want).max())
    for jm, tm in zip(jmetrics, port["metrics"]):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)
        assert tm["step"] == jm["step"]
    for tree_j, tree_t in ((jend.params, port["params"]), (jend.opt.master, port["opt"].master)):
        for path, want, got in _pairs(tree_j, tree_t):
            _close(got, want, 2 * LR * STEPS)
            assert np.abs(got - want).mean() < 1e-6, path
    for tree_j, tree_t in ((jend.opt.mu, port["opt"].mu), (jend.opt.nu, port["opt"].nu)):
        for path, want, got in _pairs(tree_j, tree_t):
            _close(got, want, 1e-4 * np.abs(want).max() + 1e-12)
    assert int(port["opt"].step) == STEPS

    # ZeRO-1: the port's state specs are JAX's, leaf for leaf
    jflat = dict(_leaves(jspecs))
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import jax_path

    by_path = {}
    for name, (shape, spec) in port["specs"].items():
        by_path[jax_path(name)[0]] = (tuple(shape), tuple(spec))
    assert set(by_path) == set(jflat)
    mu_full = dict(_leaves(jend.opt.mu))
    for path, p in jflat.items():
        shape, spec = by_path[path]
        assert spec == _spec_of(p, len(shape)), path
        # each rank's own part of mu is JAX's mu cut by that spec
        for o in outs:
            d, t = o["coords"]
            index = tuple(
                slice(None) if a is None else slice(
                    (d if a == "dp" else t) * (n // (dp if a == "dp" else tp)),
                    ((d if a == "dp" else t) + 1) * (n // (dp if a == "dp" else tp)))
                for a, n in zip(spec, shape)
            )
            want = mu_full[path][index]
            held = sorted(
                (jax_path(k)[1], v) for k, v in o["mu_local"].items() if jax_path(k)[0] == path
            )
            got = np.stack([v for _, v in held]) if held[0][0] is not None else held[0][1]
            _close(got, want, 1e-4 * np.abs(mu_full[path]).max() + 1e-12)
    if dp > 1:
        # ZeRO-1 holds about half of the state on each of two dp ranks
        whole = sum(np.asarray(v).size * 4 * 3 for _, v in _leaves(jend.opt.mu))
        for o in outs:
            assert o["state_bytes"] < 0.6 * whole / tp
