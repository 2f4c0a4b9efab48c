"""The port's checkpoint (checkpoint/) against the JAX package's, on the
CPU, on the tiny config.

The contract is the JAX package's on-disk format, byte for byte: a tag
written by either package loads in the other bitwise, and the manifests
are equal as JSON. After a cross-package load, one train step matches the
other package's step at ``tests/test_torch_trainer.py``'s tolerances
(loss 1e-5 relative, grad norm 1e-4 relative; parameters within 2·lr of
JAX's and 1e-6 on average). A resumed port run equals the uninterrupted
one bitwise (the same fp32 math in the same order).
"""

import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu import trainer as jtrainer
from neuronx_distributed_llama3_2_tpu.checkpoint import checkpoint as jckpt
from neuronx_distributed_llama3_2_tpu.models import llama as jllama
from neuronx_distributed_llama3_2_tpu.parallel import state as jstate
from neuronx_distributed_llama3_2_tpu_torch import trainer as ttrainer
from neuronx_distributed_llama3_2_tpu_torch.checkpoint import (
    CheckpointIOState,
    copy_checkpoint,
    create_checkpoint_storage,
    finalize_async_saves,
    load_checkpoint,
    save_checkpoint,
)
from neuronx_distributed_llama3_2_tpu_torch.checkpoint import checkpoint as tckpt
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

LR = 1e-3


def _opt_kw():
    return dict(learning_rate=LR, warmup_steps=1, total_steps=10)


def _batch(seed=7):
    ids = np.random.default_rng(seed).integers(0, 256, size=(4, 16))
    return ids, ids.copy()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _same_files(a, b):
    """Every file under tag dir ``a`` has a byte-identical twin in ``b``,
    meta.json (which holds a wall clock) aside."""
    names = []
    for root, _, files in os.walk(a):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), a)
            if rel != "meta.json":
                names.append(rel)
    assert names
    for rel in names:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel


# -- the JAX package's cases, on the port ------------------------------------

def test_roundtrip_and_markers(tmp_path):
    root = str(tmp_path / "ckpt")
    tree = {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": torch.ones(4, dtype=torch.bfloat16) * 1.5,
        "nested": {"s": torch.tensor(7, dtype=torch.int32)},
    }
    save_checkpoint(root, "step_10", model=tree, user_content={"step": 10})
    storage = create_checkpoint_storage(root)
    assert storage.is_done("step_10")
    assert storage.file_exists("step_10/checkpoint")
    out = load_checkpoint(root, "step_10", model=tree)
    for k in ("w", "b"):
        assert out["model"][k].dtype == tree[k].dtype
        assert torch.equal(out["model"][k], tree[k])
    assert torch.equal(out["model"]["nested"]["s"], tree["nested"]["s"])
    assert out["user_content"] == {"step": 10}
    manifest = storage.load_json("step_10/model.manifest.json")
    assert list(manifest) == ["b", "nested/s", "w"]  # JAX's flatten order
    assert manifest["b"] == {"file": "model/b.npy", "shape": [4], "dtype": "bfloat16"}
    assert np.load(tmp_path / "ckpt/step_10/model/b.npy").dtype == np.uint16


def test_incomplete_tag_garbage_collected(tmp_path):
    root = str(tmp_path / "ckpt")
    tree = {"w": torch.ones(2, 2)}
    save_checkpoint(root, "good", model=tree)
    storage = create_checkpoint_storage(root)
    storage.makedirs("bad")
    storage.mark_checkpoint("bad")
    storage.save_bytes(b"partial", "bad/model/w.npy")
    assert set(storage.list_tags(completed_only=False)) == {"good", "bad"}
    save_checkpoint(root, "good2", model=tree)
    assert "bad" not in storage.list_tags(completed_only=False)
    assert storage.list_tags() == ["good", "good2"]


def test_latest_and_retention(tmp_path):
    root = str(tmp_path / "ckpt")
    for i in range(4):
        save_checkpoint(root, f"step_{i}", model={"w": torch.full((2,), float(i))},
                        num_kept_ckpts=2)
    assert create_checkpoint_storage(root).list_tags() == ["step_2", "step_3"]
    out = load_checkpoint(root, "latest", model={"w": torch.zeros(2)})
    assert out["tag"] == "step_3"
    assert float(out["model"]["w"][0]) == 3.0
    with pytest.raises(ValueError, match="num_kept_ckpts"):
        save_checkpoint(root, "x", model={"w": torch.zeros(2)}, num_kept_ckpts=0)


def test_latest_if_exists_empty(tmp_path):
    assert load_checkpoint(str(tmp_path / "none"), "latest_if_exists") is None
    assert load_checkpoint(str(tmp_path / "none"), "step_3_if_exists") is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), "latest")


def test_async_save(tmp_path):
    root = str(tmp_path / "ckpt")
    w = torch.arange(1000, dtype=torch.float32)
    save_checkpoint(root, "t", model={"w": w}, async_save=True)
    w += 1  # the next step's in-place update must not reach the tag
    finalize_async_saves()
    assert create_checkpoint_storage(root).is_done("t")
    out = load_checkpoint(root, "t", model={"w": w})
    assert torch.equal(out["model"]["w"], torch.arange(1000, dtype=torch.float32))


def test_async_save_error_surfaces_on_wait(tmp_path, monkeypatch):
    root = str(tmp_path / "ckpt")

    def broken(storage, arr, name):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "_save_npy", broken)
    save_checkpoint(root, "t", model={"w": torch.zeros(3)}, async_save=True)
    with pytest.raises(RuntimeError, match="disk full"):
        finalize_async_saves()
    assert not create_checkpoint_storage(root).is_done("t")


def test_copy_checkpoint_and_corrupt_shape_refused(tmp_path):
    src, dst = str(tmp_path / "a"), str(tmp_path / "b")
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    save_checkpoint(src, "t", model=tree, user_content={"k": 1})
    assert copy_checkpoint(src, "latest", dst, "t2") == "t2"
    out = load_checkpoint(dst, "t2", model=tree)
    assert torch.equal(out["model"]["w"], tree["w"]) and out["user_content"] == {"k": 1}
    np.save(tmp_path / "a/t/model/w.npy", np.zeros((3, 2), np.float32))
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        copy_checkpoint(src, "t", dst, "t3")
    assert not create_checkpoint_storage(dst).is_done("t3")


def test_shape_mismatch_and_missing_key_raise(tmp_path):
    root = str(tmp_path / "ckpt")
    save_checkpoint(root, "t", model={"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(root, "t", model={"w": torch.zeros(3, 2)})
    with pytest.raises(KeyError, match="missing tensor"):
        load_checkpoint(root, "t", model={"v": torch.zeros(2, 3)})


def test_multi_process_save_raises(tmp_path, monkeypatch):
    """Over several processes a save needs the specs of its trees (which
    part of each leaf the rank holds); without them it raises."""
    monkeypatch.setattr(tckpt, "_multi_process", lambda: True)
    monkeypatch.setattr(tckpt, "_rank", lambda: 0)
    monkeypatch.setattr(tckpt, "_world", lambda: 2)
    with pytest.raises(ValueError, match="needs the specs"):
        save_checkpoint(str(tmp_path / "c"), "t", model={"w": torch.zeros(2)})


# -- across the packages ------------------------------------------------------

def _jax_states(cfg):
    """A JAX TrainState after one step and the metrics and state of the
    step after it, from one traced call (JAX's jitted step is called once
    per process in these tests, see test_torch_trainer.py)."""
    tc = jtrainer.TrainingConfig(optimizer=jtrainer.OptimizerConfig(**_opt_kw()))
    jstate.destroy_model_parallel()
    tc.initialize(devices=jax.devices()[:1])
    try:
        model = jllama.LlamaForCausalLM(cfg)
        state, _ = jtrainer.initialize_parallel_model(model, tc)
        state = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), state)
        one = jtrainer.make_train_step(model, tc).__wrapped__
        ids, labels = _batch()
        batch = {"input_ids": jnp.asarray(ids, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}

        def two(state):
            s1, _ = one(state, batch)
            s2, m2 = one(s1, batch)
            return s1, m2, s2

        s1, m2, s2 = jax.jit(two)(state)
        return s1, {k: float(v) for k, v in m2.items()}, s2
    finally:
        jstate.destroy_model_parallel()


def _port_state(cfg, opt_cfg):
    model = tllama.LlamaForCausalLM(cfg, device="cpu")
    tc = ttrainer.TrainingConfig(optimizer=opt_cfg)
    state, _ = ttrainer.initialize_parallel_model(model, tc)
    return model, tc, state


def test_jax_tag_loads_in_the_port_and_trains_on(tmp_path):
    jcfg = dataclasses.replace(jllama.LLAMA_CONFIGS["tiny"], loss_chunk_size=8)
    s1, m2, s2 = _jax_states(jcfg)
    root = str(tmp_path / "jax")
    jckpt.save_checkpoint(root, "step_1", model=s1.params, optimizer=s1.opt,
                          user_content={"step": 1})

    cfg = dataclasses.replace(tllama.LLAMA_CONFIGS["tiny"], loss_chunk_size=8)
    opt_cfg = ttrainer.OptimizerConfig(**_opt_kw())
    model, tc, state = _port_state(cfg, opt_cfg)
    loaded = load_checkpoint(root, "latest", model=state.params, optimizer=state.opt)
    assert loaded["tag"] == "step_1" and loaded["user_content"] == {"step": 1}
    assert loaded["optimizer"].step == 1
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(loaded["model"][k])
    state = ttrainer.TrainState(state.params, loaded["optimizer"])
    # bitwise: every leaf of both kinds
    got = dict(_leaves(tllama.params_to_jax(state.params, cfg)))
    for path, ref in _leaves(jax.tree.map(np.asarray, s1.params)):
        assert np.array_equal(got[path], ref), path
    jopt = ttrainer.opt_state_to_jax(state.opt, cfg)
    for name in ("master", "mu", "nu"):
        got = dict(_leaves(getattr(jopt, name)))
        for path, ref in _leaves(jax.tree.map(np.asarray, getattr(s1.opt, name))):
            assert np.array_equal(got[path], ref), (name, path)
    # one port step from it against JAX's step from the same state
    ids, labels = _batch()
    state, m = ttrainer.make_train_step(model, tc)(
        state, {"input_ids": torch.as_tensor(ids), "labels": torch.as_tensor(labels)})
    assert m["step"] == int(m2["step"]) == 2
    np.testing.assert_allclose(float(m["loss"]), m2["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), m2["grad_norm"], rtol=1e-4)
    got = dict(_leaves(tllama.params_to_jax(state.params, cfg)))
    for path, ref in _leaves(jax.tree.map(np.asarray, s2.params)):
        diff = np.abs(got[path] - ref)
        assert diff.max() <= 2 * LR and diff.mean() <= 1e-6, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_tag_loads_in_jax_bitwise(tmp_path, dtype):
    """The port's tag, after a port step: JAX's load_checkpoint gives the
    port's values bit for bit, and JAX saving them again writes the same
    files and manifests. bf16 is the 1B's layout: bf16 weights beside fp32
    master, mu and nu."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    cfg = dataclasses.replace(tllama.LLAMA_CONFIGS["tiny"], dtype=tdt, loss_chunk_size=8)
    opt_cfg = ttrainer.OptimizerConfig(**_opt_kw())
    model, tc, state = _port_state(cfg, opt_cfg)
    ids, labels = _batch()
    state, _ = ttrainer.make_train_step(model, tc)(
        state, {"input_ids": torch.as_tensor(ids), "labels": torch.as_tensor(labels)})
    root = str(tmp_path / "port")
    save_checkpoint(root, "step_1", model=state.params, optimizer=state.opt,
                    user_content={"step": 1})

    jcfg = dataclasses.replace(jllama.LLAMA_CONFIGS["tiny"], dtype=jnp.dtype(dtype))
    jtc = jtrainer.TrainingConfig(optimizer=jtrainer.OptimizerConfig(**_opt_kw()))
    params_t = jax.eval_shape(jllama.LlamaForCausalLM(jcfg).init, jax.random.key(0))
    opt_t = jax.eval_shape(lambda p: jtrainer.init_optimizer_state(p, jtc.optimizer), params_t)
    out = jckpt.load_checkpoint(root, "latest", model=params_t, optimizer=opt_t)
    assert out["user_content"] == {"step": 1}
    want = dict(_leaves(tllama.params_to_jax(state.params, cfg)))
    for path, leaf in _leaves(out["model"]):
        # kernels in the config's dtype, norm scales fp32 in both packages
        assert str(leaf.dtype) == ("float32" if path[-1] == "scale" else dtype), path
        assert np.array_equal(np.asarray(leaf, np.float32), want[path]), path
    jopt = ttrainer.opt_state_to_jax(state.opt, cfg)
    assert int(out["optimizer"].step) == 1
    for name in ("master", "mu", "nu"):
        want = dict(_leaves(getattr(jopt, name)))
        for path, leaf in _leaves(getattr(out["optimizer"], name)):
            assert np.array_equal(np.asarray(leaf), want[path]), (name, path)
    again = str(tmp_path / "jax")
    jckpt.save_checkpoint(again, "step_1", model=out["model"], optimizer=out["optimizer"],
                          user_content={"step": 1})
    for kind in ("model", "optim"):
        a = json.loads((tmp_path / f"port/step_1/{kind}.manifest.json").read_text())
        b = json.loads((tmp_path / f"jax/step_1/{kind}.manifest.json").read_text())
        assert a == b and list(a) == list(b), kind
    _same_files(str(tmp_path / "port/step_1"), str(tmp_path / "jax/step_1"))


def test_sharded_jax_entry_read_whole(tmp_path):
    """A JAX tag written by several hosts holds ``sharded`` entries (chunk
    files named by their global index); the port puts the chunks together
    into the whole array, and refuses chunks that leave a hole."""
    root = tmp_path / "ckpt"
    storage = create_checkpoint_storage(str(root))
    storage.makedirs("t")
    storage.mark_checkpoint("t")
    full = np.random.default_rng(0).standard_normal((8, 6)).astype(np.float32)
    chunks = []
    for r in range(2):
        for c in range(2):
            index = ((4 * r, 4 * r + 4), (3 * c, 3 * c + 3))
            fname = jckpt._chunk_file("model", "w", index)
            storage.save_bytes(jckpt._npy_bytes(full[4 * r:4 * r + 4, 3 * c:3 * c + 3]),
                               f"t/{fname}")
            chunks.append({"file": fname, "index": [list(p) for p in index]})
    entry = {"sharded": True, "chunks": chunks, "shape": [8, 6], "dtype": "float32"}
    storage.save_json({"w": entry}, "t/model.manifest.json")
    storage.save_json({"save_seq": 0, "saved_at": 0.0, "process_count": 4}, "t/meta.json")
    storage.mark_done("t")
    out = load_checkpoint(str(root), "t", model={"w": torch.zeros(8, 6)})
    assert torch.equal(out["model"]["w"], torch.from_numpy(full))
    for region in (((0, 4), (0, 3)), ((2, 6), (1, 5))):
        want = full[region[0][0]:region[0][1], region[1][0]:region[1][1]]
        assert np.array_equal(tckpt._read_region(storage, "t", entry, region, {}), want)
    with pytest.raises(ValueError, match="do not cover"):
        tckpt._read_region(storage, "t", {**entry, "chunks": chunks[:3]},
                           ((0, 8), (0, 6)), {})
    copy_checkpoint(str(root), "t", str(tmp_path / "copy"))
    assert torch.equal(
        load_checkpoint(str(tmp_path / "copy"), "t", model={"w": torch.zeros(8, 6)})["model"]["w"],
        torch.from_numpy(full))


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """Save at step 2 of 4, reload into a fresh model and optimizer, and
    steps 3-4 equal the uninterrupted run's bitwise (fp32)."""
    cfg = dataclasses.replace(tllama.LLAMA_CONFIGS["tiny"], loss_chunk_size=8)
    opt_cfg = ttrainer.OptimizerConfig(**_opt_kw())
    batches = []
    for s in range(4):
        ids, labels = _batch(seed=s)
        batches.append({"input_ids": torch.as_tensor(ids), "labels": torch.as_tensor(labels)})
    root = str(tmp_path / "ckpt")

    model, tc, state = _port_state(cfg, opt_cfg)
    step = ttrainer.make_train_step(model, tc)
    want = []
    for s, b in enumerate(batches):
        state, m = step(state, b)
        want.append(float(m["loss"]))
        if s == 1:
            save_checkpoint(root, "step_2", model=state.params, optimizer=state.opt,
                            user_content={"step": 2})
    final = {k: p.detach().clone() for k, p in state.params.items()}

    model2, tc2, state2 = _port_state(dataclasses.replace(cfg), opt_cfg)
    loaded = load_checkpoint(root, "latest", model=state2.params, optimizer=state2.opt)
    with torch.no_grad():
        for k, p in state2.params.items():
            p.copy_(loaded["model"][k])
    state2 = ttrainer.TrainState(state2.params, loaded["optimizer"])
    step2 = ttrainer.make_train_step(model2, tc2)
    got = []
    for b in batches[2:]:
        state2, m = step2(state2, b)
        got.append(float(m["loss"]))
    assert got == want[2:]
    for k, p in state2.params.items():
        assert torch.equal(p, final[k]), k
    assert state2.opt.step == state.opt.step == 4


def test_host_buffers_are_reused_and_refreshed(tmp_path):
    """A second save through the same root reuses the first save's host
    buffers and writes the tensors' new values."""
    root = str(tmp_path / "ckpt")
    w = torch.zeros(3, 4)
    layers = {f"layers.{i}.mlp.gate_up": torch.full((2, 2), float(i)) for i in range(3)}
    save_checkpoint(root, "a", model={"w": w, **layers})
    io = tckpt._IO_STATES[create_checkpoint_storage(root).dirname()]
    assert isinstance(io, CheckpointIOState)
    bufs = dict(io._host)
    assert set(k for _, k in bufs) == {"w", "layers/mlp/gate_up"}
    w += 2
    for t in layers.values():
        t += 10
    save_checkpoint(root, "b", model={"w": w, **layers})
    assert all(io._host[k] is bufs[k] for k in bufs)
    stacked = np.load(tmp_path / "ckpt/b/model/layers.mlp.gate_up.npy")
    assert stacked.shape == (3, 2, 2) and stacked[2, 0, 0] == 12.0
    assert load_checkpoint(root, "a", model={"w": w, **layers})["model"]["w"].sum() == 0


# -- over several processes ------------------------------------------------------

from tests import torch_dist_workers as W  # noqa: E402


def _jax_start_params():
    jcfg = dataclasses.replace(jllama.LLAMA_CONFIGS["tiny"], loss_chunk_size=8)
    return jax.tree.map(np.asarray, jllama.LlamaForCausalLM(jcfg).init(jax.random.key(0)))


def _jax_load(root, tp, dp=1):
    """JAX's load_checkpoint of ``root``'s latest tag, whole (tp = 1) or
    placed on a (dp, tp) mesh of virtual CPU devices by its specs."""
    jcfg = jllama.LLAMA_CONFIGS["tiny"]
    jtc = jtrainer.TrainingConfig(tensor_parallel_size=tp,
                                  optimizer=jtrainer.OptimizerConfig(**_opt_kw()))
    model = jllama.LlamaForCausalLM(jcfg)
    params_t = jax.eval_shape(model.init, jax.random.key(0))
    opt_t = jax.eval_shape(lambda p: jtrainer.init_optimizer_state(p, jtc.optimizer), params_t)
    if tp * dp == 1:
        return jckpt.load_checkpoint(root, "latest", model=params_t, optimizer=opt_t)
    jstate.destroy_model_parallel()
    st = jtc.initialize(devices=jax.devices()[:tp * dp])
    try:
        _, specs = jtrainer.initialize_parallel_model(model, jtc)
        out = jckpt.load_checkpoint(root, "latest", model=params_t, optimizer=opt_t,
                                    model_specs=specs.params, optimizer_specs=specs.opt,
                                    mesh=st.mesh)
        return jax.tree.map(np.asarray, out)
    finally:
        jstate.destroy_model_parallel()


def _assert_bitwise(got_tree, want_tree, what):
    got = dict(_leaves(jax.tree.map(np.asarray, got_tree)))
    for path, ref in _leaves(jax.tree.map(lambda x: np.asarray(x, np.float32), want_tree)):
        assert np.array_equal(np.asarray(got[path], np.float32), ref), (what, path)


@pytest.mark.parametrize("tp,dp", [(2, 1), (2, 2)], ids=["tp2", "tp2_dp2_zero1"])
def test_multi_process_port_tag_loads_in_jax_and_the_port(tmp_path, tp, dp):
    """Each rank writes its own chunks (ZeRO-1's parts too under dp 2):
    JAX loads the tag whole (tp 1) and on its own (dp, tp) mesh, and the
    port loads it in one process, each bit for bit equal to the state the
    ranks gathered."""
    root = str(tmp_path / "ck")
    ids, labels = _batch()
    outs = W.run(W.ckpt_worker, tp * dp, tmp_path, tp, "save", root, _jax_start_params(),
                 _opt_kw(), ids, labels)
    saved = outs[0]
    manifest = json.loads((tmp_path / "ck/step_1/optim.manifest.json").read_text())
    assert all(e.get("sharded") for e in manifest.values())
    assert len(manifest["mu/layers/attn/qkv/q_kernel"]["chunks"]) == tp * dp
    assert (tmp_path / "ck/step_1/done").exists()
    for jtp, jdp in ((1, 1), (tp, dp)):
        out = _jax_load(root, jtp, jdp)
        _assert_bitwise(out["model"], saved["params"], ("jax", jtp, jdp, "model"))
        for name in ("master", "mu", "nu"):
            _assert_bitwise(getattr(out["optimizer"], name), getattr(saved["opt"], name),
                            ("jax", jtp, jdp, name))
    cfg = dataclasses.replace(tllama.LLAMA_CONFIGS["tiny"], loss_chunk_size=8)
    model, tc, state = _port_state(cfg, ttrainer.OptimizerConfig(**_opt_kw()))
    out = load_checkpoint(root, "latest", model=state.params, optimizer=state.opt)
    _assert_bitwise(tllama.params_to_jax(out["model"], cfg), saved["params"], "port tp1")
    jopt = ttrainer.opt_state_to_jax(out["optimizer"], cfg)
    for name in ("master", "mu", "nu"):
        _assert_bitwise(getattr(jopt, name), getattr(saved["opt"], name), ("port tp1", name))


def test_jax_tp2_tag_loads_in_the_port_at_tp1_and_tp2(tmp_path):
    """A tag JAX saved from a tp = 2 mesh: the port's two tp ranks read
    their regions of it, and one process reads it whole, bit for bit."""
    jcfg = dataclasses.replace(jllama.LLAMA_CONFIGS["tiny"], loss_chunk_size=8)
    jtc = jtrainer.TrainingConfig(tensor_parallel_size=2,
                                  optimizer=jtrainer.OptimizerConfig(**_opt_kw()))
    jstate.destroy_model_parallel()
    jtc.initialize(devices=jax.devices()[:2])
    try:
        state, _ = jtrainer.initialize_parallel_model(jllama.LlamaForCausalLM(jcfg), jtc)
        root = str(tmp_path / "jax")
        jckpt.save_checkpoint(root, "step_0", model=state.params, optimizer=state.opt,
                              user_content={"step": 0})
        want = jax.tree.map(np.asarray, state)
    finally:
        jstate.destroy_model_parallel()
    outs = W.run(W.ckpt_worker, 2, tmp_path, 2, "load", root, None, _opt_kw(), None, None)
    for o in outs:
        assert o["user_content"] == {"step": 0}
        _assert_bitwise(o["params"], want.params, "port tp2")
        for name in ("master", "mu", "nu"):
            _assert_bitwise(getattr(o["opt"], name), getattr(want.opt, name), ("port tp2", name))
    cfg = dataclasses.replace(tllama.LLAMA_CONFIGS["tiny"], loss_chunk_size=8)
    model, tc, pstate = _port_state(cfg, ttrainer.OptimizerConfig(**_opt_kw()))
    out = load_checkpoint(root, "latest", model=pstate.params, optimizer=pstate.opt)
    _assert_bitwise(tllama.params_to_jax(out["model"], cfg), want.params, "port tp1")
