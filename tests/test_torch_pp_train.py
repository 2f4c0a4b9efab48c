"""The port's pipeline against the JAX package on the same mesh shape, on
the CPU, in fp32 on the tiny config.

Each step starts from a tag the JAX package saved (at pp = 1: the port
loads it at pp = 2, its blocks and stages read back bit for bit) and goes
through the trainer's entry points, over gloo ranks spawned by
``tests/torch_dist_workers.py``:

- two ranks, pp = 2: ``gpipe``, ``1f1b`` (with ``head_sequence_split`` on
  and off) and ``interleaved`` at V = 2, memory bounded and not, against
  JAX's ``PipelinedCausalLM`` of the same schedule on a pp = 2 mesh: loss
  ``rtol=1e-5``, grad norm ``rtol=1e-4``, the parameters and master
  weights after AdamW to 2·lr per element and 1e-6 on the mean (as in
  ``test_torch_cp_train.py``); the first step's gradient to 1e-5 of its
  leaf's largest element against the JAX model's (every schedule computes
  the gradient of the same mean loss); the eval loss (the forward-only
  schedule) and the logits; the most stage inputs held at once (at most
  ``min(pp - rank, M)`` under 1f1b, M under gpipe: what JAX's
  ``test_1f1b_activation_memory_below_gpipe`` measures); the
  point-to-point calls equal to the task list's sends and receives; a tag
  saved at pp = 2 (gpipe, and interleaved with its non-contiguous blocks)
  that JAX loads at pp = 1 bit for bit;
- four ranks: JAX's default-tier combinations, tp = 2 x SP x pp = 2 under
  1f1b (``test_combinatorial.py`` ``TP2_SP1_PP2_Z0_1F1B``, loss 2e-5 and
  grad norm 5e-4 relative), pp = 2 x dp = 2 with ZeRO-1 under gpipe, and
  pp = 2 x cp = 2 zigzag under gpipe (JAX ``test_gpipe_cp_zigzag_trains``).
  JAX's pipelined step under cp gives a grad norm of 1.4057 where its
  unpipelined cp = 2 step and every other mesh give 1.7133 (a fault of
  the JAX executor, ROADMAP.md section C): there the port's loss is held
  to JAX's pipelined forward, and its gradient, grad norm and end state to
  the JAX model's step; and pp = 4 under 1f1b (one layer a stage, the
  middle stages without the embedding, the first and last summing its
  gradient over their own group), held to the JAX model's step;
- the pretrain script at ``--pp 2`` on two ranks: a run preempted after
  its step-4 save resumes to the uninterrupted run's losses and weights
  bit for bit; its losses are the one-process run's (1e-5 relative).
"""

import dataclasses
import functools
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from filelock import FileLock

from neuronx_distributed_llama3_2_tpu import trainer as jtrainer
from neuronx_distributed_llama3_2_tpu.checkpoint import checkpoint as jckpt
from neuronx_distributed_llama3_2_tpu.models import llama as jllama
from neuronx_distributed_llama3_2_tpu.parallel import state as jstate
from neuronx_distributed_llama3_2_tpu.pipeline import PipelinedCausalLM as JPipelined
from neuronx_distributed_llama3_2_tpu_torch.scripts import pretrain

from tests import torch_dist_workers as W

LR = 1e-3
N_MICRO = 4
GBS, SEQ = 8, 16
#: the port's step recomputes each layer in the backward under remat
#: "full" and runs attention through the flash path (K1-K3's plain
#: versions on the CPU), as on the card; JAX's tiny keeps its activations
#: and its plain attention: the same fp32 function
PORT_CFG_KW = dict(use_flash_attention=True, loss_chunk_size=8, remat="full")
OPT_KW = dict(learning_rate=LR, warmup_steps=1, total_steps=10)
TWO = [
    dict(name="gpipe", schedule="gpipe", logits=True),
    dict(name="1f1b", schedule="1f1b"),
    dict(name="1f1b_unsplit_head", schedule="1f1b", head_split=False),
    dict(name="interleaved", schedule="interleaved", chunks=2, logits=True),
    dict(name="interleaved_gpipe", schedule="interleaved", chunks=2, memory_bounded=False),
]
FOUR = [
    dict(name="tp2_sp_1f1b", schedule="1f1b", tp=2, sp=True),
    dict(name="dp2_zero1_gpipe", schedule="gpipe", zero1=True),
    dict(name="cp2_zigzag_gpipe", schedule="gpipe", cp=2, layout="zigzag"),
    dict(name="pp4_1f1b", schedule="1f1b", pp=4),
]
#: the cases that save a tag at their end state, and their spawn
SAVED = {"gpipe": "pp2", "interleaved": "pp2", "dp2_zero1_gpipe": "pp4"}


def _batch():
    """(8, 16) ids; labels with ignored positions spread unevenly, so the
    microbatches, dp rows and cp chunks carry different token counts."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 256, size=(GBS, SEQ))
    labels = ids.copy()
    labels[1, 2:9] = -100
    labels[6, 11] = -100
    return ids, labels


def _jbatch():
    ids, labels = _batch()
    return {"input_ids": jnp.asarray(ids, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_tc(**kw):
    return jtrainer.TrainingConfig(optimizer=jtrainer.OptimizerConfig(**OPT_KW), **kw)


@functools.lru_cache(maxsize=None)
def _jax_model_step():
    """The JAX model on one device: its start state, the gradient of the
    batch's mean loss, one train step's metrics and end state, its logits
    (numpy)."""
    tc = _jax_tc()
    jstate.destroy_model_parallel()
    tc.initialize(devices=jax.devices()[:1])
    try:
        model = jllama.LlamaForCausalLM(jllama.LLAMA_CONFIGS["tiny"])
        state, _ = jtrainer.initialize_parallel_model(model, tc)
        start = _np(state)
        one = jtrainer.make_train_step(model, tc).__wrapped__

        def f(state, batch):
            grads = jax.grad(model.loss)(state.params, batch["input_ids"], batch["labels"])
            logits = model(state.params, batch["input_ids"])
            state, m = one(state, batch)
            return grads, logits, state, m

        grads, logits, end, m = jax.jit(f)(state, _jbatch())
        return start, _np(grads), np.asarray(logits), {k: float(v) for k, v in m.items()}, _np(end)
    finally:
        jstate.destroy_model_parallel()


@functools.lru_cache(maxsize=None)
def _jax_pipelined(schedule, chunks=1, memory_bounded=True, tp=1, sp=False, dp=1, cp=1,
                   zero1=False, layout="auto", forward_only=False):
    """JAX's ``PipelinedCausalLM`` at pp = 2 on the same mesh shape: one
    train step's metrics and end state in the canonical layout (or, with
    ``forward_only``, the loss alone), its start weights, and its
    ``to_pipeline`` of them."""
    cfg = dataclasses.replace(jllama.LLAMA_CONFIGS["tiny"], cp_ring_layout=layout)
    tc = _jax_tc(tensor_parallel_size=tp, sequence_parallel=sp, context_parallel_size=cp,
                 pipeline_parallel_size=2, pipeline_schedule=schedule, num_model_chunks=chunks)
    tc = dataclasses.replace(tc, optimizer=dataclasses.replace(tc.optimizer,
                                                               zero_one_enabled=zero1))
    jstate.destroy_model_parallel()
    tc.initialize(devices=jax.devices()[:2 * tp * dp * cp])
    try:
        pm = JPipelined(jllama.LlamaForCausalLM(cfg), num_microbatches=N_MICRO, schedule=schedule,
                        num_model_chunks=chunks, memory_bounded_backward=memory_bounded)
        state, _ = jtrainer.initialize_parallel_model(pm, tc)
        start = pm.from_pipeline(_np(state.params))
        piped = _np(pm.to_pipeline(start))
        batch = _jbatch()
        if forward_only:
            loss = jax.jit(pm.loss)(state.params, batch["input_ids"], batch["labels"])
            return dict(loss=float(loss), start=start)
        state, m = jtrainer.make_train_step(pm, tc)(state, batch)
        return dict(metrics={k: float(v) for k, v in m.items()}, start=start, piped=piped,
                    params=pm.from_pipeline(_np(state.params)),
                    master=pm.from_pipeline(_np(state.opt.master)))
    finally:
        jstate.destroy_model_parallel()


def _jax_case(case, forward_only=False):
    """``_jax_pipelined`` of a case of the port's spawns."""
    kw = {k: case[k] for k in ("chunks", "memory_bounded", "tp", "sp", "cp", "zero1", "layout")
          if k in case}
    if case["name"].startswith("dp2"):
        kw["dp"] = 2
    return _jax_pipelined(case["schedule"], forward_only=forward_only, **kw)


# ---------------------------------------------------------------------------
# the port's spawns
# ---------------------------------------------------------------------------

def _spawn(tmp_path_factory, name, world, cases):
    d = tmp_path_factory.mktemp(name)
    jax_root = str(d / "jax")
    start = _jax_model_step()[0]
    jckpt.save_checkpoint(jax_root, "step_0", model=start.params, optimizer=start.opt)
    cases = [dict(c, save=str(d / c["name"])) if c["name"] in SAVED else c for c in cases]
    ids, labels = _batch()
    outs = W.run(W.pp_train_worker, world, d, cases, PORT_CFG_KW, OPT_KW, N_MICRO, jax_root,
                 ids, labels)
    return outs, {c["name"]: c.get("save") for c in cases}


def _once(tmp_path_factory, name, world, cases):
    """``_spawn`` once per session: under pytest-xdist the first worker to
    ask runs the ranks and pickles their results into the session's shared
    temporary directory, and the others read them (pytest-xdist's recipe
    for a fixture shared between workers), so a mesh's ranks start once."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return _spawn(tmp_path_factory, name, world, cases)
    path = tmp_path_factory.getbasetemp().parent / f"{name}.pkl"
    with FileLock(f"{path}.lock"):
        if not path.exists():
            path.write_bytes(pickle.dumps(_spawn(tmp_path_factory, name, world, cases)))
        return pickle.loads(path.read_bytes())


@pytest.fixture(scope="module")
def pp2(tmp_path_factory):
    return _once(tmp_path_factory, "pp2", 2, TWO)


@pytest.fixture(scope="module")
def pp4(tmp_path_factory):
    return _once(tmp_path_factory, "pp4", 4, FOUR)


def _check_against_jax(outs, case, loss_rtol=1e-5, norm_rtol=1e-4):
    start, grads, _, model_m, model_end = _jax_model_step()
    name = case["name"]
    want_m, want_end = model_m, {"params": model_end.params, "master": model_end.opt.master}
    if case.get("cp", 1) > 1:
        # the JAX pipelined step's gradient is wrong under cp (module
        # docstring): its forward's loss, the JAX model's step
        jloss = _jax_case(case, forward_only=True)["loss"]
        np.testing.assert_allclose(jloss, model_m["loss"], rtol=1e-5)
    elif case.get("pp", 2) == 2:
        jp = _jax_case(case)
        want_m, want_end = jp["metrics"], {"params": jp["params"], "master": jp["master"]}
    port = outs[0][name]
    for o in outs:
        assert o[name]["metrics"] == port["metrics"], name
        for _, want, got in _pairs(start.params, o[name]["loaded"]):
            assert np.array_equal(got, want)
    for _, want, got in _pairs(grads, port["grads"]):
        _close(got, want, 1e-5 * np.abs(want).max())
    tm = port["metrics"][0]
    np.testing.assert_allclose(tm["loss"], want_m["loss"], rtol=loss_rtol)
    np.testing.assert_allclose(tm["grad_norm"], want_m["grad_norm"], rtol=norm_rtol)
    assert tm["step"] == want_m["step"] == 1
    np.testing.assert_allclose(port["eval_loss"], model_m["loss"], rtol=1e-5)
    for tree_j, tree_t in ((want_end["params"], port["params"]),
                           (want_end["master"], port["opt"].master)):
        for path, want, got in _pairs(tree_j, tree_t):
            _close(got, want, 2 * LR)
            assert np.abs(got - want).mean() < 1e-6, path
    return port


@pytest.mark.parametrize("name", [c["name"] for c in TWO])
def test_pp2_step_matches_jax(pp2, name):
    outs, _ = pp2
    case = next(c for c in TWO if c["name"] == name)
    _check_against_jax(outs, case)
    for rank, o in enumerate(outs):
        res = o[name]
        # the sends and receives issued are the task list's
        assert res["p2p"] == res["p2p_tasks"], (rank, res["p2p"], res["p2p_tasks"])
        assert res["coords"]["pp"] == rank


def test_stash_bounded_under_1f1b(pp2):
    """The most stage inputs held at once: pp - rank under 1f1b (rank 0
    warms up with pp - 1 forwards), M under gpipe (JAX's
    test_1f1b_activation_memory_below_gpipe)."""
    outs, _ = pp2
    for rank, o in enumerate(outs):
        assert o["1f1b"]["max_stashed"] == min(2 - rank, N_MICRO)
        assert o["gpipe"]["max_stashed"] == N_MICRO
        assert o["1f1b"]["max_stashed"] < o["gpipe"]["max_stashed"]


def test_head_sequence_split_changes_nothing(pp2):
    outs, _ = pp2
    for o in outs:
        assert o["1f1b"]["metrics"] == o["1f1b_unsplit_head"]["metrics"]


def test_pp2_logits_and_layouts_match_jax(pp2):
    """The forward-only schedule's logits on every rank are JAX's; each
    stage holds its layer blocks under their global names; to_pipeline
    gives JAX's pipelined layouts."""
    outs, _ = pp2
    logits = _jax_model_step()[2]
    for o in outs:
        for name in ("gpipe", "interleaved"):
            np.testing.assert_allclose(o[name]["logits"], logits, atol=2e-5, rtol=1e-5)
    layers = {r: sorted({int(k.split(".")[1]) for k in outs[r]["interleaved"]["holds"]
                         if k.startswith("layers.")}) for r in (0, 1)}
    assert layers == {0: [0, 2], 1: [1, 3]}
    assert "final_norm.scale" in outs[1]["gpipe"]["holds"]
    assert "final_norm.scale" not in outs[0]["gpipe"]["holds"]
    for name in ("gpipe", "interleaved"):
        want = _jax_case(next(c for c in TWO if c["name"] == name))["piped"]
        for _, w, g in _pairs(want, outs[0][name]["to_pipeline"]):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("name", sorted(SAVED))
def test_pp2_tag_loads_in_jax_at_pp1(request, name):
    """A tag saved at pp = 2 (interleaved: each stage's two blocks; dp = 2
    with ZeRO-1: the state split over dp too): each stage wrote its own
    layer blocks, the first stage the embedding, the last the final norm,
    every chunk once; every rank reads it back; JAX loads it at pp = 1 bit
    for bit."""
    outs, roots = request.getfixturevalue(SAVED[name])
    files = set()
    for kind in ("model", "optim"):
        manifest = json.loads(open(f"{roots[name]}/step_1/{kind}.manifest.json").read())
        for entry in manifest.values():
            files.update(c["file"] for c in entry["chunks"])
    written = [n.split("/", 1)[1] for o in outs for n in o[name]["written"]]
    assert sorted(written) == sorted(files)
    for o in outs:
        wrote_norm = any("model/final_norm" in n for n in o[name]["written"])
        assert wrote_norm == (o[name]["coords"] == {**o[name]["coords"], "pp": 1, "dp": 0})
    assert all(o[name]["loaded_back"] for o in outs)
    tc = _jax_tc()
    model = jllama.LlamaForCausalLM(jllama.LLAMA_CONFIGS["tiny"])
    params_t = jax.eval_shape(model.init, jax.random.key(0))
    opt_t = jax.eval_shape(lambda p: jtrainer.init_optimizer_state(p, tc.optimizer), params_t)
    out = jckpt.load_checkpoint(roots[name], "latest", model=params_t, optimizer=opt_t)
    saved = outs[0][name]
    for tree_j, tree_t in ((out["model"], saved["params"]), (out["optimizer"].mu, saved["opt"].mu),
                           (out["optimizer"].master, saved["opt"].master)):
        for path, want, got in _pairs(_np(tree_j), tree_t):
            assert np.array_equal(np.asarray(want, np.float32), got), path


@pytest.mark.parametrize("name", [c["name"] for c in FOUR])
def test_four_rank_meshes_match_jax(pp4, name):
    outs, _ = pp4
    case = next(c for c in FOUR if c["name"] == name)
    tol = dict(loss_rtol=2e-5, norm_rtol=5e-4) if case.get("tp", 1) > 1 else {}
    _check_against_jax(outs, case, **tol)
    coords = sorted((o[name]["coords"]["pp"], o[name]["coords"]["dp"], o[name]["coords"]["cp"],
                     o[name]["coords"]["tp"]) for o in outs)
    assert len(set(coords)) == 4
    for o in outs:
        assert o[name]["p2p"] == o[name]["p2p_tasks"]


# ---------------------------------------------------------------------------
# the pretrain script
# ---------------------------------------------------------------------------

def _argv(tmp_path, name, steps, **extra):
    argv = ["--model", "tiny", "--global-batch", "4", "--seq-len", "32",
            "--synthetic", "20000", "--ckpt-dir", str(tmp_path / name), "--save-every", "2",
            "--lr", "1e-3", "--warmup-steps", "2", "--steps", str(steps), "--device", "cpu"]
    for k, v in extra.items():
        argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return argv


def test_pp2_pretrain_resumes_bit_for_bit(tmp_path):
    """``--pp 2 --pp-schedule 1f1b`` on two ranks: a 6-step run preempted
    after its step-4 save, then run again, equals an uninterrupted 6-step
    run bit for bit (losses and every stage's final weights); the losses
    are the one-process run's."""
    pp = dict(pp=2, pp_schedule="1f1b", microbatches=2)
    runs = [(_argv(tmp_path, "whole", 6, **pp), None), (_argv(tmp_path, "run", 6, **pp), 4),
            (_argv(tmp_path, "run", 6, **pp), None)]
    outs = W.run(W.pp_pretrain_worker, 2, tmp_path, runs)
    whole, cut, resumed = outs[0]["records"]
    assert cut is None
    assert resumed["start_step"] == 4 and resumed["tag"] == "step_4"
    assert sorted(resumed["losses"]) == [4, 5] and sorted(whole["losses"]) == list(range(6))
    for s in (4, 5):
        assert resumed["losses"][s] == whole["losses"][s]
    for o in outs:
        a, b = o["params"][0], o["params"][2]
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert outs[0]["params"][0].keys() != outs[1]["params"][0].keys()
    one = pretrain.main(_argv(tmp_path, "one", 6, microbatches=2, save_every=0))
    for step, loss in one["losses"].items():
        np.testing.assert_allclose(whole["losses"][step], loss, rtol=1e-5)
