"""Expert parallelism and the pipelined Mixtral against the JAX package, on
the CPU, in fp32 on ``tiny-moe`` (capacity factor 1.0: C = T·k / E slots,
so that crowded experts drop tokens, rank-local in both packages).

One spawn per mesh (``tests/torch_dist_workers.py`` ``moe_train_worker``):

- two ranks: ep = 2 with ZeRO-1 (two microbatches, uneven token counts),
  and a pp = 2 step in gpipe and in 1f1b;
- four ranks: tp = 2 x ep = 2 with sequence parallelism and ZeRO-1.

Each starts from a tag the JAX package saved (tiny-moe's seeded state at
one device), which the port loads on its mesh (read back bit for bit).

The ep cases are held to the JAX package's step on the same mesh shape
(``TrainingConfig(expert_parallel_size=...)``): the gradient of the
batch's mean loss, gathered whole, to 1e-5 of its leaf's largest element;
loss 1e-5 and grad norm 1e-4 relative; parameters after AdamW to 2·lr per
element and 1e-6 on the mean, the moments to 1e-4 of their largest element
(the tolerances of ``test_torch_tp_train.py``). The ZeRO-1 state specs are
JAX's ``optimizer_state_specs`` leaf for leaf (a dense leaf's over ("dp",
"ep"), written "dp"; an expert leaf's over "dp" alone, written "edp"), and
each rank's own mu is JAX's mu cut at its coordinates. ep = 2's end state,
saved as a tag by the port, loads in the JAX package bit for bit. An MoE
block without a capacity factor is refused at ep > 1, as in JAX.

The pp cases are held to the JAX model's unpipelined step with as many
microbatches (JAX's pipelined executor is not the reference: ROADMAP.md
section C records its gradient fault under cp): loss, grad norm and end
state as above. Their batch has no ignored label: the pipeline adds each
microbatch's router aux term over M (as JAX's executors do), where the
unpipelined step weighs each microbatch by its token count, and the two
agree when every microbatch holds as many tokens.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neuronx_distributed_llama3_2_tpu import trainer as jtrainer
from neuronx_distributed_llama3_2_tpu.checkpoint import checkpoint as jckpt
from neuronx_distributed_llama3_2_tpu.models import mixtral as jmix
from neuronx_distributed_llama3_2_tpu.parallel import state as jstate

from tests import torch_dist_workers as W

LR = 1e-3
OPT_KW = dict(learning_rate=LR, warmup_steps=1, total_steps=10)
CFG_KW = dict(capacity_factor=1.0, use_flash_attention=True, loss_chunk_size=8)
JCFG = dataclasses.replace(jmix.MIXTRAL_CONFIGS["tiny-moe"], capacity_factor=1.0,
                           loss_chunk_size=8)


def _batches():
    """"uneven": (4, 16) ids whose labels ignore positions unevenly;
    "even": the same ids, every label valid."""
    ids = np.random.default_rng(7).integers(0, 256, size=(4, 16))
    labels = ids.copy()
    labels[1, 2:9] = -100
    labels[3, 5] = -100
    return {"uneven": (ids, labels), "even": (ids, ids.copy())}


TWO = [
    dict(name="ep2_zero1", ep=2, zero1=True, n_micro=2, batch="uneven", save=True),
    dict(name="pp2_gpipe", pp=2, schedule="gpipe", n_micro=2, batch="even"),
    dict(name="pp2_1f1b", pp=2, schedule="1f1b", n_micro=2, batch="even"),
]
FOUR = [dict(name="tp2_ep2_sp_zero1", tp=2, ep=2, sp=True, zero1=True, n_micro=2,
             batch="uneven")]
#: the JAX mesh (tp, ep, sp, n_micro) each case is held to
JAX_MESH = {"ep2_zero1": (1, 2, False, 2), "pp2_gpipe": (1, 1, False, 2),
            "pp2_1f1b": (1, 1, False, 2), "tp2_ep2_sp_zero1": (2, 2, True, 2)}


@functools.lru_cache(maxsize=None)
def _jax_start():
    """tiny-moe's seeded start state at one device (numpy)."""
    tc = jtrainer.TrainingConfig(optimizer=jtrainer.OptimizerConfig(**OPT_KW))
    jstate.destroy_model_parallel()
    tc.initialize(devices=jax.devices()[:1])
    try:
        state, _ = jtrainer.initialize_parallel_model(jmix.MixtralForCausalLM(JCFG), tc)
        return jax.tree.map(np.asarray, state)
    finally:
        jstate.destroy_model_parallel()


@functools.lru_cache(maxsize=None)
def _jax_run(tp, ep, sp, n_micro, batch):
    """The JAX step on a (ep, tp) mesh from the start state: the gradient of
    the batch's mean loss, the step's metrics, its end state and the
    optimizer state's specs."""
    start = _jax_start()
    tc = jtrainer.TrainingConfig(
        tensor_parallel_size=tp, expert_parallel_size=ep, sequence_parallel=sp,
        num_microbatches=n_micro, optimizer=jtrainer.OptimizerConfig(**OPT_KW))
    jstate.destroy_model_parallel()
    tc.initialize(devices=jax.devices()[:tp * ep])
    try:
        model = jmix.MixtralForCausalLM(JCFG)
        _, specs = jtrainer.initialize_parallel_model(model, tc)
        state = jax.tree.map(jnp.asarray, start)
        ids, labels = _batches()[batch]
        jb = {"input_ids": jnp.asarray(ids, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
        grads = jax.jit(jax.grad(model.loss))(state.params, jb["input_ids"], jb["labels"])
        state, m = jax.jit(jtrainer.make_train_step(model, tc).__wrapped__)(state, jb)
        return (jax.tree.map(np.asarray, grads), {k: float(v) for k, v in m.items()},
                jax.tree.map(np.asarray, state), specs.opt.mu)
    finally:
        jstate.destroy_model_parallel()


@pytest.fixture(scope="module")
def jax_tag(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_tag"))
    s = _jax_start()
    jckpt.save_checkpoint(root, "step_0", model=s.params, optimizer=s.opt)
    return root


@pytest.fixture(scope="module")
def runs(jax_tag, tmp_path_factory):
    """The port's cases on their meshes: case name -> results by rank."""
    out = {}
    for world, cases in ((2, TWO), (4, FOUR)):
        tmp = tmp_path_factory.mktemp(f"ranks{world}")
        cases = [dict(c, save=str(tmp / "tag")) if c.get("save") else c for c in cases]
        got = W.run(W.moe_train_worker, world, tmp, cases, CFG_KW, OPT_KW, jax_tag, _batches())
        for c in cases:
            out[c["name"]] = (c, [g[c["name"]] for g in got])
    return out


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


def _port_spec(p, ndim, expert):
    """A JAX PartitionSpec as the port writes it: ("dp", "ep") -> "dp",
    an expert leaf's "dp" -> "edp"."""
    out = []
    for a in list(p) + [None] * (ndim - len(p)):
        if isinstance(a, tuple):
            a = "dp" if "dp" in a else a
        elif a == "dp" and expert:
            a = "edp"
        out.append(a)
    return tuple(out)


@pytest.mark.parametrize("name", [c["name"] for c in TWO + FOUR])
def test_moe_mesh_step_matches_jax(runs, name):
    case, ranks = runs[name]
    port = ranks[0]
    jgrads, jm, jend, jspecs = _jax_run(*JAX_MESH[name], case["batch"])
    start = _jax_start()
    for path, want, got in _pairs(start.params, port["loaded"]):
        assert np.array_equal(got, want), path
    for r in ranks[1:]:
        assert r["metrics"] == port["metrics"]
    np.testing.assert_allclose(port["metrics"]["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(port["metrics"]["grad_norm"], jm["grad_norm"], rtol=1e-4)
    if case.get("pp", 1) == 1:
        for path, want, got in _pairs(jgrads, port["grads"]):
            _close(got, want, 1e-5 * np.abs(want).max())
    for path, want, got in _pairs(jend.params, port["params"]):
        _close(got, want, 2 * LR)
        assert np.abs(got - want).mean() < 1e-6, path
    for tj, tt in ((jend.opt.mu, port["opt"].mu), (jend.opt.nu, port["opt"].nu)):
        for path, want, got in _pairs(tj, tt):
            _close(got, want, 1e-4 * np.abs(want).max() + 1e-12)
    if case.get("ep", 1) > 1:
        assert "requires a capacity_factor" in port["refused"]


@pytest.mark.parametrize("name", [c["name"] for c in TWO + FOUR if c.get("zero1")])
def test_ep_zero1_specs_match_jax(runs, name):
    """The ZeRO-1 state specs leaf for leaf, each rank's own mu JAX's mu cut
    at its coordinates, and every rank holding less than the whole state."""
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import jax_path

    case, ranks = runs[name]
    _, _, jend, jspecs = _jax_run(*JAX_MESH[name], case["batch"])
    jflat = dict(_leaves(jspecs))
    by_path = {jax_path(k)[0]: (tuple(s), tuple(p)) for k, (s, p) in ranks[0]["specs"].items()}
    assert set(by_path) == set(jflat)
    mu_full = dict(_leaves(jend.opt.mu))
    tp, ep = case.get("tp", 1), case.get("ep", 1)
    for path, p in jflat.items():
        shape, spec = by_path[path]
        assert spec == _port_spec(p, len(shape), "experts" in path), path
        for r in ranks:
            c = r["coords"]
            at = {"tp": (c["tp"], tp), "ep": (c["ep"], ep), "dp": (c["dp"] * ep + c["ep"], ep),
                  "edp": (c["dp"], 1)}
            index = tuple(slice(None) if a is None else slice(
                at[a][0] * (n // at[a][1]), (at[a][0] + 1) * (n // at[a][1]))
                for a, n in zip(spec, shape))
            held = sorted((jax_path(k)[1], v) for k, v in r["mu_local"].items()
                          if jax_path(k)[0] == path)
            got = np.stack([v for _, v in held]) if held[0][0] is not None else held[0][1]
            _close(got, mu_full[path][index], 1e-4 * np.abs(mu_full[path]).max() + 1e-12)
    whole = sum(np.asarray(v).size * 4 * 3 for _, v in _leaves(jend.opt.mu))
    assert all(r["state_bytes"] < whole for r in ranks)


def test_ep2_tag_loads_in_jax_bitwise(runs):
    """The end state of the ep = 2 step, saved by the port over its two
    ranks (each rank its experts' chunks), loads in the JAX package at one
    device bit for bit."""
    case, ranks = runs["ep2_zero1"]
    tc = jtrainer.TrainingConfig(optimizer=jtrainer.OptimizerConfig(**OPT_KW))
    params_t = jax.eval_shape(jmix.MixtralForCausalLM(JCFG).init, jax.random.key(0))
    opt_t = jax.eval_shape(lambda p: jtrainer.init_optimizer_state(p, tc.optimizer), params_t)
    out = jckpt.load_checkpoint(case["save"], "latest", model=params_t, optimizer=opt_t)
    for path, want, got in _pairs(ranks[0]["params"], out["model"]):
        assert np.array_equal(np.asarray(got, np.float32), want), path
    for path, want, got in _pairs(ranks[0]["opt"].mu, out["optimizer"].mu):
        assert np.array_equal(np.asarray(got), want), path
