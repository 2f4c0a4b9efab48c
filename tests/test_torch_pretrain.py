"""The port's pretrain script (scripts/pretrain.py) in process on the CPU,
tiny config: 4 steps and a save, then a resume to 6, against an
uninterrupted 6-step run (the same losses bit for bit, the same metrics
file, the JAX script's log lines); the refusals by name; and
``scripts.generate --ckpt-dir`` over a tag it wrote. The GPT-NeoX / CodeGen
and BERT families: tiny-neox, tiny-codegen and tiny-bert run and resume,
their tags cross with the JAX package's both ways, and BERT's MLM masks are
the JAX script's recipe (``examples/pretrain_llama.py:144``)."""

import json
import logging

import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu_torch.checkpoint import save_checkpoint
from neuronx_distributed_llama3_2_tpu_torch.data import write_token_file
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama
from neuronx_distributed_llama3_2_tpu_torch.scripts import generate, pretrain
from neuronx_distributed_llama3_2_tpu_torch.trainer.tensorboard import read_scalars
from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger

torch.set_num_threads(1)


def _argv(tmp_path, name, steps, **extra):
    argv = ["--model", "tiny", "--global-batch", "4", "--seq-len", "32",
            "--synthetic", "20000", "--ckpt-dir", str(tmp_path / name),
            "--save-every", "2", "--metrics-file", str(tmp_path / f"{name}.jsonl"),
            "--lr", "1e-3", "--warmup-steps", "2", "--steps", str(steps), "--device", "cpu"]
    for k, v in extra.items():
        argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return argv


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def read(self) -> str:
        out, self.lines = "\n".join(self.lines), []
        return out


@pytest.fixture()
def log():
    """The script's log lines (the port's logger does not propagate)."""
    handler = _Lines()
    get_logger().addHandler(handler)
    yield handler
    get_logger().removeHandler(handler)


def _metrics(path):
    return [{k: v for k, v in json.loads(line).items() if k not in ("ts", "seqs_per_s")}
            for line in open(path)]


class _Preempted(Exception):
    pass


def _preempt_at(monkeypatch, n_steps):
    """Make the next script run stop before its ``n_steps``-th train step,
    as a preempted job does."""
    from neuronx_distributed_llama3_2_tpu_torch import trainer

    make = trainer.make_train_step

    def make_train_step(model, config, **kw):
        step, calls = make(model, config, **kw), []

        def stepped(state, batch):
            if len(calls) == n_steps:
                raise _Preempted
            calls.append(1)
            return step(state, batch)

        return stepped

    monkeypatch.setattr(trainer, "make_train_step", make_train_step)


def test_resume_equals_the_uninterrupted_run(tmp_path, log, monkeypatch):
    """A 6-step run preempted after its step-4 save, then run again: the
    losses, the final weights and the metrics file equal an uninterrupted
    6-step run's (the same math in the same order: bitwise)."""
    whole = pretrain.main(_argv(tmp_path, "whole", 6))
    with monkeypatch.context() as m:
        _preempt_at(m, 4)
        with pytest.raises(_Preempted):
            pretrain.main(_argv(tmp_path, "run", 6))
    b = pretrain.main(_argv(tmp_path, "run", 6))
    err = log.read()
    assert "resumed from step_4 at step 4" in err and "done: 6 steps" in err
    assert b["start_step"] == 4 and b["tag"] == "step_4" and sorted(b["losses"]) == [4, 5]
    for s in (4, 5):
        assert b["losses"][s] == whole["losses"][s]
    assert len(whole["losses"]) == 6 and all(np.isfinite(list(whole["losses"].values())))
    for k, p in b["state"].params.items():
        assert torch.equal(p, whole["state"].params[k]), k
    assert _metrics(tmp_path / "run.jsonl") == _metrics(tmp_path / "whole.jsonl")
    assert len(_metrics(tmp_path / "run.jsonl")) == 6


def test_four_steps_then_resume_to_six(tmp_path, log):
    """The JAX script's two invocations: train 4 steps and save, then the
    same command with --steps 6 resumes and finishes; a third run with
    nothing left to do trains nothing and leaves the final tag alone."""
    a = pretrain.main(_argv(tmp_path, "run", 4))
    assert "done: 4 steps" in log.read() and sorted(a["losses"]) == [0, 1, 2, 3]
    b = pretrain.main(_argv(tmp_path, "run", 6))
    err = log.read()
    assert "resumed from step_4 at step 4" in err and "done: 6 steps" in err
    assert sorted(b["losses"]) == [4, 5]
    assert len(_metrics(tmp_path / "run.jsonl")) == 6
    c = pretrain.main(_argv(tmp_path, "run", 6))
    assert "resumed from step_6 at step 6" in log.read()
    assert c["start_step"] == 6 and c["losses"] == {} and c["save_seconds"] == []


def test_native_loader_tensorboard_timeline_eval_profile(tmp_path):
    out = pretrain.main(_argv(
        tmp_path, "ck", 4, native_loader=True, tensorboard_dir=tmp_path / "tb",
        timeline=tmp_path / "tl.json", eval_every=2, eval_batches=1,
        profile_dir=tmp_path / "prof", async_save=True, keep_ckpts=1))
    assert out["dataset"] == "NativeTokenDataset"
    assert sorted(out["eval_losses"]) == [1, 3]
    (tb,) = (tmp_path / "tb").iterdir()
    scalars = read_scalars(str(tb))
    assert scalars["train/loss"] == {s: pytest.approx(v, rel=1e-6) for s, v in out["losses"].items()}
    assert sorted(scalars["eval/loss"]) == [1, 3]
    events = json.loads((tmp_path / "tl.json").read_text())
    names = [e["name"] for e in events]
    assert names.count("train_step") == 4 and names.count("save_checkpoint") == 1
    assert len(list((tmp_path / "prof").iterdir())) == 1
    tags = sorted(p.name for p in (tmp_path / "ck").iterdir() if p.is_dir())
    assert tags == ["step_4"]  # --keep-ckpts 1


@pytest.mark.parametrize("argv,match", [
    (["--model", "mixtral-8x7b", "--ep", "3"], "--ep 3: 3 ranks"),
    (["--model", "tiny-mllama"], "the vision family needs image inputs"),
    (["--model", "nope"], "unknown model"),
    (["--tp", "2"], "--tp 2"),
    (["--pp", "2"], "--pp 2"),
    (["--dp", "3"], "--dp 3"),
    (["--pp-schedule", "1f1b"], "--pp-schedule"),
    (["--model-chunks", "2"], "--model-chunks"),
    (["--capacity-factor", "1.25"], "not a MoE model"),
])
def test_unported_options_raise_by_name(tmp_path, argv, match):
    base = ["--ckpt-dir", str(tmp_path / "c"), "--synthetic", "1000", "--device", "cpu",
            "--model", "tiny"]
    with pytest.raises(SystemExit, match=match):
        pretrain.main(base + argv)


def test_data_file_and_missing_data(tmp_path):
    path = str(tmp_path / "tokens.npy")
    write_token_file(path, np.random.default_rng(1).integers(0, 256, 4096).astype(np.int32))
    out = pretrain.main(["--model", "tiny", "--data", path, "--ckpt-dir", str(tmp_path / "c"),
                         "--global-batch", "2", "--seq-len", "16", "--steps", "2",
                         "--device", "cpu", "--microbatches", "2"])
    assert sorted(out["losses"]) == [0, 1] and out["dataset"] == "TokenDataset"
    with pytest.raises(SystemExit, match="--data"):
        pretrain.main(["--model", "tiny", "--ckpt-dir", str(tmp_path / "d"), "--device", "cpu"])


def test_generate_from_a_checkpoint_equals_random_init(tmp_path):
    """A tag saved from the tiny model's seeded weights generates the
    stream --random-init generates with those weights."""
    seed = 3
    model = tllama.LlamaForCausalLM(tllama.LLAMA_CONFIGS["tiny"], device="cpu").init_weights(seed)
    save_checkpoint(str(tmp_path / "ck"), "step_9", model=dict(model.named_parameters()))
    common = ["--model", "tiny", "--prompt-ids", "5,17,3,9", "--greedy", "--device", "cpu",
              "--max-seq-len", "64", "--max-new-tokens", "8"]
    from_ckpt = generate.main(common + ["--ckpt-dir", str(tmp_path / "ck"), "--tag", "latest"])
    random = generate.main(common + ["--random-init", "--seed", str(seed)])
    other = generate.main(common + ["--random-init", "--seed", str(seed + 1)])
    assert from_ckpt["sequences"] == random["sequences"]
    assert len(from_ckpt["sequences"][0]) == 8
    assert other["sequences"] != random["sequences"]
    with pytest.raises(SystemExit, match="no checkpoint"):
        generate.main(common + ["--ckpt-dir", str(tmp_path / "ck"), "--tag", "step_1_if_exists"])


# -- several ranks (--cpu-devices / --nproc start them over gloo on the CPU) -----

@pytest.mark.parametrize("extra", [{"tp": 2, "sp": True}, {"dp": 2}],
                         ids=["tp2_sp", "dp2_zero1"])
def test_parallel_pretrain_matches_one_process(tmp_path, extra):
    """Two steps at tp = 2 with sequence parallelism, and at dp = 2 with
    ZeRO-1, on two CPU ranks: the losses of the one-process run (fp32 in
    another summation order, 1e-5 relative), and a final tag every rank
    wrote its chunks of."""
    one = pretrain.main(_argv(tmp_path, "one", 2, save_every=0))
    two = pretrain.main(_argv(tmp_path, "two", 2, save_every=0, cpu_devices=2, **extra))
    assert sorted(two["losses"]) == [0, 1]
    for step, loss in one["losses"].items():
        np.testing.assert_allclose(two["losses"][step], loss, rtol=1e-5)
    manifest = json.loads((tmp_path / "two/step_2/model.manifest.json").read_text())
    assert all(e.get("sharded") for e in manifest.values())
    assert (tmp_path / "two/step_2/done").exists()


def test_generate_at_tp2_equals_one_process(tmp_path, monkeypatch):
    """--tp 2 on two CPU ranks generates the tokens of one process, for
    random weights and for a tag saved by one process; from the command
    line too (the ranks parse the process's own arguments)."""
    common = ["--model", "tiny", "--prompt-ids", "5,17,3,9", "--greedy", "--device", "cpu",
              "--max-seq-len", "64", "--max-new-tokens", "8"]
    model = tllama.LlamaForCausalLM(tllama.LLAMA_CONFIGS["tiny"], device="cpu").init_weights(4)
    save_checkpoint(str(tmp_path / "ck"), "step_1", model=dict(model.named_parameters()))
    for src in (["--random-init", "--seed", "3"], ["--ckpt-dir", str(tmp_path / "ck")]):
        one = generate.main(common + src)
        two = generate.main(common + src + ["--tp", "2", "--nproc"])
        assert two["sequences"] == one["sequences"] and len(one["sequences"][0]) == 8
    with pytest.raises(SystemExit, match="--tp 2"):
        generate.main(common + ["--random-init", "--tp", "2"])
    import sys

    argv = common + ["--random-init", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["generate"] + argv + ["--tp", "2", "--nproc"])
    assert generate.main()["sequences"] == generate.main(argv)["sequences"]


# -- the GPT-NeoX / CodeGen and BERT families -------------------------------------

def _family_argv(tmp_path, model, name, steps):
    return ["--model", model, "--global-batch", "4", "--seq-len", "32", "--synthetic", "20000",
            "--ckpt-dir", str(tmp_path / name), "--save-every", "2", "--lr", "1e-3",
            "--warmup-steps", "2", "--steps", str(steps), "--device", "cpu"]


@pytest.mark.parametrize("model", ["tiny-neox", "tiny-codegen", "tiny-bert"])
def test_family_resumes_to_the_uninterrupted_run(tmp_path, log, monkeypatch, model):
    """A 6-step run preempted after its step-4 save resumes to the
    uninterrupted run's losses and weights bit for bit (BERT's masks drawn
    from the step, so a resume masks what the whole run masked)."""
    whole = pretrain.main(_family_argv(tmp_path, model, "whole", 6))
    with monkeypatch.context() as m:
        _preempt_at(m, 4)
        with pytest.raises(_Preempted):
            pretrain.main(_family_argv(tmp_path, model, "run", 6))
    b = pretrain.main(_family_argv(tmp_path, model, "run", 6))
    assert "resumed from step_4 at step 4" in log.read()
    assert b["start_step"] == 4 and sorted(b["losses"]) == [4, 5]
    for s in (4, 5):
        assert b["losses"][s] == whole["losses"][s]
    assert all(np.isfinite(list(whole["losses"].values())))
    for k, p in b["state"].params.items():
        assert torch.equal(p, whole["state"].params[k]), k


def _jax_mask_mlm(tokens, rng, vocab_size):
    """The JAX script's recipe (examples/pretrain_llama.py:144-152)."""
    masked = np.array(tokens)
    labels = np.full_like(masked, -100)
    pick = rng.random(masked.shape) < 0.15
    labels[pick] = masked[pick]
    masked[pick] = vocab_size - 1
    return masked, labels


def test_mask_mlm_is_the_jax_recipe():
    """The same seed masks the same positions, and a dp rank's rows of the
    global batch get the rows of the global mask."""
    tokens = np.random.default_rng(0).integers(0, 256, (8, 32))
    for seed in (42 * 100003 + 3, 42 * 7919 + 1):
        want = _jax_mask_mlm(tokens, np.random.default_rng(seed), 256)
        got = pretrain.mask_mlm(tokens, np.random.default_rng(seed), 256)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert 0.05 < (got[1] != -100).mean() < 0.3
        rows = slice(4, 8)
        part = pretrain.mask_mlm(tokens[rows], np.random.default_rng(seed), 256, 8, rows)
        assert all(np.array_equal(a, b[rows]) for a, b in zip(part, want))


def test_bert_seq_len_is_bounded_by_its_position_table(tmp_path):
    with pytest.raises(SystemExit, match="learned position table"):
        pretrain.main(["--model", "tiny-bert", "--seq-len", "256", "--synthetic", "1000",
                       "--ckpt-dir", str(tmp_path / "c"), "--device", "cpu"])


@pytest.mark.parametrize("model", ["tiny-neox", "tiny-bert"])
def test_family_tags_cross_with_jax(tmp_path, model):
    """The port's final tag loads in the JAX package (weights and AdamW
    state) bit for bit; a JAX tag of step 2 resumes here at step 2 with the
    JAX state bit for bit."""
    import jax

    from neuronx_distributed_llama3_2_tpu import trainer as jtrainer
    from neuronx_distributed_llama3_2_tpu.checkpoint import checkpoint as jckpt
    from neuronx_distributed_llama3_2_tpu.models import resolve_model as jresolve
    from neuronx_distributed_llama3_2_tpu_torch import trainer as ttrainer

    run = pretrain.main(_family_argv(tmp_path, model, "port", 2))
    entry = jresolve(model)
    jm = entry["model_cls"](entry["config"])
    opt = jtrainer.OptimizerConfig()
    params_t = jax.eval_shape(jm.init, jax.random.key(0))
    opt_t = jax.eval_shape(lambda p: jtrainer.init_optimizer_state(p, opt), params_t)
    out = jckpt.load_checkpoint(str(tmp_path / "port"), "latest", model=params_t, optimizer=opt_t)
    pcfg = pretrain.model_families()[model][0]
    want = tllama.params_to_jax(run["state"].params, pcfg)

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield prefix, tree

    got = dict(leaves(jax.tree.map(np.asarray, out["model"])))
    for path, leaf in leaves(want):
        assert np.array_equal(np.asarray(got[path], np.float32), leaf), path
    jopt = ttrainer.opt_state_to_jax(run["state"].opt, pcfg)
    assert int(out["optimizer"].step) == int(jopt.step) == 2
    ref = dict(leaves(jax.tree.map(np.asarray, out["optimizer"].mu)))
    for path, leaf in leaves(jopt.mu):
        assert np.array_equal(np.asarray(ref[path], np.float32), leaf), path
    # JAX's tag of step 2 (moved weights), resumed by the port at step 2
    moved = jax.tree.map(lambda x: x + 0.25, out["model"])
    root = tmp_path / "jax"
    jckpt.save_checkpoint(str(root), "step_2", model=moved, optimizer=out["optimizer"],
                          user_content={"step": 2})
    write_token_file(str(root / "synthetic_tokens.npy"),
                     np.random.default_rng(0).integers(0, 256, 20000, dtype=np.int32))
    argv = _family_argv(tmp_path, model, "jax", 2)
    resumed = pretrain.main(argv)
    assert resumed["tag"] == "step_2" and resumed["losses"] == {}
    got = tllama.params_to_jax(resumed["state"].params, pcfg)
    want = dict(leaves(jax.tree.map(np.asarray, moved)))
    for path, leaf in leaves(got):
        assert np.array_equal(leaf, np.asarray(want[path], np.float32)), path
