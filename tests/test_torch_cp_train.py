"""The port's context-parallel model and trainer against the JAX package on
the same mesh shape, on the CPU, in fp32 on the tiny config.

Two spawns (``tests/torch_dist_workers.py``): four ranks for the tp = 2 x
cp = 2 eval forward and loss (JAX ``test_llama_forward_with_cp``'s set-up)
and the data loader's rows at dp = 2 x cp = 2; two ranks for the cp = 2
train step in both ring layouts, which starts from a tag the JAX package
saved (each cp rank reads the whole replicated state) and, after the
contiguous run, saves a tag of its own (written once, read by JAX).

Tolerances: the forward's logits ``atol=2e-4, rtol=1e-4`` and loss ``<
1e-4`` (JAX's test); the train step's those of ``test_torch_tp_train.py``
(the first step's gradient to 1e-5 of its leaf's largest element, loss
``rtol=1e-5``, grad norm ``rtol=1e-4``, parameters after AdamW to 2·lr per
element and 1e-6 on the mean); zigzag against contiguous JAX's
``test_model_level_zigzag_matches_contiguous`` tolerances (loss 1e-4, grad
norm 1e-3 relative).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neuronx_distributed_llama3_2_tpu import trainer as jtrainer
from neuronx_distributed_llama3_2_tpu.checkpoint import checkpoint as jckpt
from neuronx_distributed_llama3_2_tpu.models import llama as jllama
from neuronx_distributed_llama3_2_tpu.parallel import state as jstate
from neuronx_distributed_llama3_2_tpu.parallel.layers import shard_pytree
from neuronx_distributed_llama3_2_tpu_torch.data import (
    DistributedDataLoader,
    TokenDataset,
    write_token_file,
)
from neuronx_distributed_llama3_2_tpu_torch.models.llama import LLAMA_CONFIGS, param_specs
from neuronx_distributed_llama3_2_tpu_torch.parallel import layout as tlayout
from neuronx_distributed_llama3_2_tpu_torch.trainer import optimizer as toptim

from tests import torch_dist_workers as W

LR = 1e-3
STEPS = 1
N_MICRO = 2
CFG_KW = dict(use_flash_attention=True, loss_chunk_size=8)
#: the port's step recomputes each layer in the backward, under the layout
#: the backbone declared (remat is a memory policy: the same fp32 numbers as
#: JAX's tiny, which keeps its activations)
PORT_CFG_KW = dict(CFG_KW, remat="full")
OPT_KW = dict(learning_rate=LR, warmup_steps=1, total_steps=10)
LAYOUTS = ("contiguous", "zigzag")
GBS, SEQ = 4, 64


def _batch():
    """(4, 16) ids; labels with ignored positions spread unevenly (one of
    them the last position of a chunk at cp = 2), so the microbatches and
    the chunks carry different valid-token counts."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 256, size=(4, 16))
    labels = ids.copy()
    labels[1, 2:9] = -100
    labels[3, 8] = -100
    return ids, labels


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _pairs(want_tree, got_tree):
    got, want = dict(_leaves(got_tree)), dict(_leaves(want_tree))
    assert got.keys() == want.keys()
    return [(k, want[k], got[k]) for k in want]


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_forward():
    """JAX ``test_llama_forward_with_cp``'s set-up: the tiny model from key
    0 on a tp = 2 x cp = 2 mesh, its logits and loss on (2, 32) ids."""
    cfg = jllama.LLAMA_CONFIGS["tiny"]
    model = jllama.LlamaForCausalLM(cfg)
    params = model.init(jax.random.key(0))
    ids = jnp.asarray(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32)), jnp.int32)
    jstate.destroy_model_parallel()
    jstate.initialize_model_parallel(tensor_model_parallel_size=2, context_parallel_size=2)
    try:
        sharded = shard_pytree(params, model.specs())
        logits = jax.jit(model.__call__)(sharded, ids)
        loss = jax.jit(model.loss)(sharded, ids, ids)
        return (jax.tree.map(np.asarray, params), np.asarray(ids), np.asarray(logits),
                float(loss))
    finally:
        jstate.destroy_model_parallel()


@functools.lru_cache(maxsize=None)
def _jax_train(layout):
    """The JAX trainer's start state, the first step's gradient, the
    metrics and the end state of STEPS steps on a cp = 2 mesh, as numpy
    (the steps traced into one call, as in test_torch_tp_train.py)."""
    cfg = dataclasses.replace(jllama.LLAMA_CONFIGS["tiny"], cp_ring_layout=layout, **CFG_KW)
    tc = jtrainer.TrainingConfig(context_parallel_size=2, num_microbatches=N_MICRO,
                                 optimizer=jtrainer.OptimizerConfig(**OPT_KW))
    jstate.destroy_model_parallel()
    tc.initialize(devices=jax.devices()[:2])
    try:
        model = jllama.LlamaForCausalLM(cfg)
        state, _ = jtrainer.initialize_parallel_model(model, tc)
        start = jax.tree.map(np.asarray, state)
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
        return start, jax.tree.map(np.asarray, grads), metrics, jax.tree.map(np.asarray, state)
    finally:
        jstate.destroy_model_parallel()


# ---------------------------------------------------------------------------
# the port's spawns
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokens") / "tokens.npy")
    write_token_file(path, np.arange(10_000, dtype=np.int32) % 256)
    return path


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, token_file):
    params, ids, _, _ = _jax_forward()
    return W.run(W.cp_mesh_worker, 4, tmp_path_factory.mktemp("cp4"), params, ids, token_file,
                 GBS, SEQ)


@pytest.fixture(scope="module")
def cp_train(tmp_path_factory):
    """(the two ranks' results, the JAX tag's root, the port tag's root)."""
    d = tmp_path_factory.mktemp("cp2")
    jax_root, port_root = str(d / "jax"), str(d / "port")
    start = _jax_train("contiguous")[0]
    jckpt.save_checkpoint(jax_root, "step_0", model=start.params, optimizer=start.opt)
    ids, labels = _batch()
    outs = W.run(W.cp_train_worker, 2, d, LAYOUTS, PORT_CFG_KW, OPT_KW, N_MICRO, STEPS, jax_root,
                 port_root, ids, labels)
    return outs, jax_root, port_root


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_llama_forward_with_cp(four_ranks):
    """cp = 2 x tp = 2: every rank's eval logits (the final hidden states
    gathered over cp) and loss (the chunks' sums over cp) are JAX's."""
    _, _, logits, loss = _jax_forward()
    for o in four_ranks:
        np.testing.assert_allclose(o["logits"], logits, atol=2e-4, rtol=1e-4)
        assert abs(o["loss"] - loss) < 1e-4


def test_loader_gives_the_cp_ranks_of_a_dp_rank_the_same_rows(four_ranks, token_file):
    """dp = 2 x cp = 2: the two cp ranks of each dp rank read that dp
    rank's block of every global batch."""
    whole = DistributedDataLoader(TokenDataset(token_file, SEQ), GBS, seed=3)
    seen = set()
    for o in four_ranks:
        d, c = o["coords"]
        seen.add((d, c))
        for step, rows in enumerate(o["rows"]):
            np.testing.assert_array_equal(
                rows, whole.batch_at(step)[d * GBS // 2:(d + 1) * GBS // 2])
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_cp_train_step_matches_jax(cp_train, layout):
    outs, _, _ = cp_train
    _, jgrads, jmetrics, jend = _jax_train(layout)
    port = outs[0][layout]
    assert outs[1][layout]["metrics"] == port["metrics"]
    for _, want, got in _pairs(jgrads, port["grads"]):
        _close(got, want, 1e-5 * np.abs(want).max())
    # the eval step's loss on the start weights is the first step's
    np.testing.assert_allclose(port["eval_loss"], jmetrics[0]["loss"], rtol=1e-5)
    for jm, tm in zip(jmetrics, port["metrics"]):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)
        assert tm["step"] == jm["step"]
    for tree_j, tree_t in ((jend.params, port["params"]), (jend.opt.master, port["opt"].master)):
        for path, want, got in _pairs(tree_j, tree_t):
            _close(got, want, 2 * LR * STEPS)
            assert np.abs(got - want).mean() < 1e-6, path


def test_zigzag_matches_contiguous(cp_train):
    """The model permutes once outside the layer stack and declares the
    layout to its attention layers: the zigzag step's loss and grad norm
    are the contiguous step's."""
    outs, _, _ = cp_train
    ref, zz = (outs[0][layout]["metrics"][0] for layout in LAYOUTS)
    assert abs(zz["loss"] - ref["loss"]) / ref["loss"] < 1e-4
    assert abs(zz["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"] < 1e-3


def test_cp_checkpoint_written_once_and_crosses_to_jax(cp_train):
    """A save at cp = 2 writes each chunk once, all from cp rank 0; every
    rank reads the tag back whole; JAX loads it bit for bit. (The run
    itself started from a tag JAX saved.)"""
    outs, _, port_root = cp_train
    by_rank = {o["cp_rank"]: o["contiguous"]["written"] for o in outs}
    assert by_rank[1] == [] and by_rank[0]
    assert len(set(by_rank[0])) == len(by_rank[0])
    files = set()
    for kind in ("model", "optim"):
        manifest = json.loads(open(f"{port_root}/step_1/{kind}.manifest.json").read())
        for entry in manifest.values():
            files.update(c["file"] for c in entry["chunks"])
    assert {n.split("/", 1)[1] for n in by_rank[0]} == files
    assert all(o["contiguous"]["loaded_back"] for o in outs)
    saved = outs[0]["contiguous"]
    jcfg = dataclasses.replace(jllama.LLAMA_CONFIGS["tiny"], **CFG_KW)
    jtc = jtrainer.TrainingConfig(optimizer=jtrainer.OptimizerConfig(**OPT_KW))
    model = jllama.LlamaForCausalLM(jcfg)
    params_t = jax.eval_shape(model.init, jax.random.key(0))
    opt_t = jax.eval_shape(lambda p: jtrainer.init_optimizer_state(p, jtc.optimizer), params_t)
    out = jckpt.load_checkpoint(port_root, "latest", model=params_t, optimizer=opt_t)
    for tree_j, tree_t in ((out["model"], saved["params"]), (out["optimizer"].mu, saved["opt"].mu),
                           (out["optimizer"].master, saved["opt"].master)):
        for path, want, got in _pairs(jax.tree.map(np.asarray, tree_j), tree_t):
            assert np.array_equal(np.asarray(want, np.float32), got), path


# ---------------------------------------------------------------------------
# the helpers that know cp (no ranks needed)
# ---------------------------------------------------------------------------

def test_writers_and_the_norm_count_a_cp_replicated_leaf_once(monkeypatch):
    """Parameters and ZeRO-1's state are replicated over cp: cp rank 0
    writes each region and counts each leaf in the grad norm, cp rank 1
    neither."""
    assert tlayout.mesh_coords()["cp"] == (0, 1)
    specs = param_specs(LLAMA_CONFIGS["tiny"], tp=1)
    for cp_rank, want in ((0, True), (1, False)):
        coords = {"tp": (0, 1), "dp": (0, 1), "cp": (cp_rank, 2)}
        assert all(tlayout.is_writer(leaf, coords) is want for leaf in specs.values())
        monkeypatch.setattr(toptim, "mesh_coords", lambda c=coords: c)
        owned = toptim.norm_owned(specs, None, zero1=False)
        assert set(owned.values()) == {want}
