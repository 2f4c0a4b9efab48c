"""The port's pipeline schedules, stage layout and pipelined model without
ranks, on the CPU.

- The port keeps its own copy of the JAX package's ``pipeline/scheduler.py``:
  its task lists and lock-step plans equal JAX's over the parameter grids of
  JAX ``tests/test_pipeline.py``.
- The port runs the task lists per rank and matches the messages of a pair
  of ranks by order (NCCL has no tags): for every schedule and grid point,
  walking every rank's list with sends that never block, each receive finds
  the message its sender sent, kind, microbatch and chunk alike, and no rank
  waits for ever.
- The stage layout (``pipeline_stage``, ``param_specs`` at pp > 1, the
  regions, writers and gradient-norm owners of a pipeline's leaves), the
  pipelined model's checks, and the trainer's refusals of a config that
  disagrees with the model (JAX ``test_pipeline_config_mismatch_fails_loudly``).
- At pp = 1 the pipelined model's loss and gradients are the model's.

The multi-rank runs are in ``test_torch_pp_train.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.pipeline import scheduler as jsched
from neuronx_distributed_llama3_2_tpu_torch.models import llama as tllama
from neuronx_distributed_llama3_2_tpu_torch.parallel import layout as tlayout
from neuronx_distributed_llama3_2_tpu_torch.pipeline import PipelinedCausalLM
from neuronx_distributed_llama3_2_tpu_torch.pipeline import model as tpmodel
from neuronx_distributed_llama3_2_tpu_torch.pipeline import scheduler as tsched
from neuronx_distributed_llama3_2_tpu_torch.scripts import pretrain
from neuronx_distributed_llama3_2_tpu_torch.trainer import optimizer as toptim
from neuronx_distributed_llama3_2_tpu_torch.trainer import trainer as ttrainer

TINY = tllama.LLAMA_CONFIGS["tiny"]
#: JAX tests/test_pipeline.py's grids: gpipe / 1f1b (pp, M) :46-47; the
#: interleaved schedule (pp, chunks, M) :280 with the warmup cases
#: :306-312; the rotation plan (pp, chunks, M) :742; the memory-bounded
#: plan (M, chunks, pp) :774
PP_M = [(pp, m) for pp in (2, 4, 8, 16) for m in (1, 2, 8, 32)]
INTERLEAVED = [(2, 2, 4), (4, 2, 8), (4, 3, 8), (4, 2, 4)]
ROTATION = [(2, 2, 4), (4, 2, 16), (4, 4, 8), (3, 2, 6), (2, 3, 5), (2, 1, 4), (4, 1, 16),
            (8, 1, 32)]
ONE_F_ONE_B_PLAN = [(4, 2, 2), (8, 2, 4), (8, 3, 2), (16, 2, 8)]


def _steps(sched):
    return [[(type(t).__name__, t.mb, t.chunk) for t in step] for step in sched.steps()]


# ---------------------------------------------------------------------------
# the port's copy of the schedules against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pp,m", PP_M)
def test_task_lists_equal_jax(pp, m):
    for rank in range(pp):
        for name in ("TrainGPipeSchedule", "Train1F1BSchedule", "InferenceSchedule"):
            got = getattr(tsched, name)(m, pp, rank)
            want = getattr(jsched, name)(m, pp, rank)
            assert _steps(got) == _steps(want), (name, rank)
        assert (tsched.Train1F1BSchedule(m, pp, rank).num_warmup
                == jsched.Train1F1BSchedule(m, pp, rank).num_warmup)


@pytest.mark.parametrize("pp,chunks,m", INTERLEAVED)
def test_interleaved_task_lists_equal_jax(pp, chunks, m):
    for rank in range(pp):
        got = tsched.TrainInterleavedSchedule(m, chunks, pp, rank)
        want = jsched.TrainInterleavedSchedule(m, chunks, pp, rank)
        assert _steps(got) == _steps(want)
        assert got.num_warmup == want.num_warmup
        assert [got.model_chunk_id(t, f) for t in range(2 * got.total_steps) for f in (0, 1)] \
            == [want.model_chunk_id(t, f) for t in range(2 * got.total_steps) for f in (0, 1)]
    with pytest.raises(ValueError):
        tsched.TrainInterleavedSchedule(6, 2, 4, 0)
    with pytest.raises(ValueError):
        tsched.PipeSchedule(4, 2, 2)


@pytest.mark.parametrize("pp,chunks,m", ROTATION)
def test_rotation_plan_equals_jax(pp, chunks, m):
    got, want = tsched.InterleavedRotationPlan(m, chunks, pp), jsched.InterleavedRotationPlan(
        m, chunks, pp)
    assert [dataclasses.asdict(s) for s in got.steps_] == [dataclasses.asdict(s) for s in want.steps_]
    assert (got.num_rotations, got.idle_lane_rotations, got.cost_model(8)) == (
        want.num_rotations, want.idle_lane_rotations, want.cost_model(8))


@pytest.mark.parametrize("m,chunks,pp", ONE_F_ONE_B_PLAN)
def test_memory_bounded_plan_equals_jax(m, chunks, pp):
    got, want = tsched.Interleaved1F1BPlan(m, chunks, pp), jsched.Interleaved1F1BPlan(m, chunks, pp)
    assert [dataclasses.asdict(s) for s in got.steps_] == [dataclasses.asdict(s) for s in want.steps_]
    assert (got.stash_depth, got.num_rotations, got.idle_lane_rotations) == (
        want.stash_depth, want.num_rotations, want.idle_lane_rotations)


# ---------------------------------------------------------------------------
# messages matched by order
# ---------------------------------------------------------------------------

def _lists(kind, m, pp, chunks):
    def one(rank):
        if kind == "gpipe":
            return tsched.TrainGPipeSchedule(m, pp, rank)
        if kind == "1f1b":
            return tsched.Train1F1BSchedule(m, pp, rank)
        if kind == "inference":
            return tsched.InferenceSchedule(m, pp, rank)
        if kind == "interleaved":
            return tsched.TrainInterleavedSchedule(m, chunks, pp, rank)
        if kind == "interleaved_gpipe":
            return tpmodel.InterleavedGPipeSchedule(m, chunks, pp, rank)
        return tpmodel._ForwardOnly(tpmodel.InterleavedGPipeSchedule(m, chunks, pp, rank))

    return [one(r).flat_tasks() for r in range(pp)]


def _walk(lists, pp, chunks):
    """Run every rank's task list: a send never blocks and appends to the
    (sender, receiver) channel, a receive waits for the channel's oldest
    message and must find the one it expects (a forward received by virtual
    stage u = chunk * pp + rank comes from u - 1, a gradient from u + 1).
    Returns the messages delivered; raises on a mismatch, a deadlock or a
    message never received."""
    chans, pos, delivered = {}, [0] * pp, 0
    fwd = (tsched.SendForwardTask, tsched.RecvForwardTask)
    while any(pos[r] < len(lists[r]) for r in range(pp)):
        moved = False
        for r in range(pp):
            while pos[r] < len(lists[r]):
                t = lists[r][pos[r]]
                u = t.chunk * pp + r
                if isinstance(t, (tsched.SendForwardTask, tsched.SendBackwardTask)):
                    dst_u = u + 1 if isinstance(t, fwd) else u - 1
                    chans.setdefault((r, dst_u % pp), []).append(
                        (isinstance(t, fwd), t.mb, dst_u))
                elif isinstance(t, (tsched.RecvForwardTask, tsched.RecvBackwardTask)):
                    src = (r - 1) % pp if isinstance(t, fwd) else (r + 1) % pp
                    queue = chans.get((src, r), [])
                    if not queue:
                        break
                    got = queue.pop(0)
                    assert got == (isinstance(t, fwd), t.mb, u), (r, t, got)
                    delivered += 1
                pos[r] += 1
                moved = True
        assert moved, f"deadlock at {pos}"
    assert not any(chans.values()), chans
    return delivered


@pytest.mark.parametrize("pp,m", PP_M)
def test_messages_match_by_order(pp, m):
    for kind in ("gpipe", "1f1b", "inference"):
        n = _walk(_lists(kind, m, pp, 1), pp, 1)
        assert n == (pp - 1) * m * (1 if kind == "inference" else 2)


@pytest.mark.parametrize("pp,chunks,m", INTERLEAVED + [(2, 2, 2), (8, 2, 16), (2, 3, 6),
                                                      (1, 2, 4)])
def test_interleaved_messages_match_by_order(pp, chunks, m):
    for kind in ("interleaved", "interleaved_gpipe", "interleaved_forward"):
        n = _walk(_lists(kind, m, pp, chunks), pp, chunks)
        assert n == (pp * chunks - 1) * m * (1 if kind == "interleaved_forward" else 2)


# ---------------------------------------------------------------------------
# the stage layout
# ---------------------------------------------------------------------------

def test_pipeline_stage_layers():
    assert tllama.pipeline_stage(16, 2, 1).chunk_layers == (tuple(range(8, 16)),)
    st = tllama.pipeline_stage(16, 2, 0, chunks=2)
    # chunk v of lane s is the block of virtual stage v * pp + s (JAX to_pipeline)
    assert st.chunk_layers == ((0, 1, 2, 3), (8, 9, 10, 11)) and st.first and not st.last
    assert tllama.pipeline_stage(8, 4, 3, chunks=2).layers == (3, 7)
    with pytest.raises(ValueError, match="not divisible"):
        tllama.pipeline_stage(16, 3, 0)


def test_layer_stack_keeps_global_names():
    stack = tllama.LayerStack({8: torch.nn.Linear(2, 2), 9: torch.nn.Linear(2, 2)})
    assert [k for k, _ in stack.named_parameters()][:2] == ["8.weight", "8.bias"]
    assert stack[1] is stack.by_index()[9] and len(stack) == 2


@pytest.mark.parametrize("chunks", [1, 2])
def test_specs_regions_writers_and_norm_owners_at_pp2(monkeypatch, chunks):
    """pp = 2, tied: each stage holds its layer blocks and writes them, the
    embedding lives on both stages (written and counted in the norm by the
    first), the final norm on the last; every layer block is one chunk of
    the tag."""
    cfg = dataclasses.replace(TINY, num_layers=8)
    specs = tllama.param_specs(cfg, tp=1, pp=2, chunks=chunks)
    layer, embed, norm = (specs["layers.0.mlp.gate_up"], specs["embed.embedding"],
                          specs["final_norm.scale"])
    assert layer.spec[0] == "pp" and layer.chunks == chunks
    assert embed.stages == (0, 1) and norm.stages == (1,)
    blocks = {r: tllama.pipeline_stage(8, 2, r, chunks).layers for r in (0, 1)}
    sizes = {"tp": 1, "dp": 1, "pp": 2}
    assert [reg[0] for reg in tlayout.all_regions(layer, sizes)] == (
        [(0, 4), (4, 8)] if chunks == 1 else [(0, 2), (2, 4), (4, 6), (6, 8)])
    for r in (0, 1):
        coords = {"tp": (0, 1), "dp": (0, 1), "cp": (0, 1), "pp": (r, 2)}
        held = {i for i in range(8) if tlayout.holds(layer, coords, i)}
        assert held == set(blocks[r])
        assert tlayout.holds(embed, coords) and tlayout.holds(norm, coords) == (r == 1)
        assert tlayout.is_writer(layer, coords)
        assert tlayout.is_writer(embed, coords) == (r == 0)
        assert tlayout.is_writer(norm, coords) == (r == 1)
        monkeypatch.setattr(toptim, "mesh_coords", lambda c=coords: c)
        owned = toptim.norm_owned(specs, None, zero1=False)
        assert owned["embed.embedding"] == (r == 0) and owned["final_norm.scale"] == (r == 1)
        assert all(owned[f"layers.{i}.mlp.gate_up"] for i in blocks[r])
    # ZeRO-1 at dp = 2 splits a layer's state on a free dim, not the pp one
    assert layer.with_dp_shard(2).spec[:2] == ("pp", "dp")
    untied = tllama.param_specs(dataclasses.replace(cfg, tie_word_embeddings=False), 1, 2)
    assert untied["embed.embedding"].stages == (0,) and untied["lm_head.kernel"].stages == (1,)


# ---------------------------------------------------------------------------
# the pipelined model's checks, the trainer's refusals
# ---------------------------------------------------------------------------

def test_pipelined_model_checks():
    model = tllama.LlamaForCausalLM(TINY, device="cpu")
    with pytest.raises(ValueError, match="schedule must be"):
        PipelinedCausalLM(model, num_microbatches=2, schedule="zb")
    with pytest.raises(ValueError, match="requires schedule='interleaved'"):
        PipelinedCausalLM(model, num_microbatches=2, num_model_chunks=2)
    with pytest.raises(ValueError, match="num_model_chunks must be"):
        PipelinedCausalLM(model, num_microbatches=2, num_model_chunks=0)
    with pytest.raises(TypeError, match="LlamaForCausalLM"):
        PipelinedCausalLM(torch.nn.Linear(2, 2), num_microbatches=2)
    with pytest.raises(ValueError, match="needs a pipeline"):
        tllama.LlamaForCausalLM(TINY, device="cpu", num_model_chunks=2)
    for schedule in ("gpipe", "1f1b", "interleaved"):
        assert PipelinedCausalLM(model, num_microbatches=2, schedule=schedule).uses_manual_vjp


def test_mixtral_pipeline_and_ep_wait_for_item_4(tmp_path):
    """Since the MoE slice (item 4) the port's Mixtral pipelines
    (test_torch_ep_train.py) and the script takes --ep: only a model that is
    not the port's is refused, and a one-process run asks for its ranks."""
    from neuronx_distributed_llama3_2_tpu.models.mixtral import MIXTRAL_CONFIGS, MixtralForCausalLM
    from neuronx_distributed_llama3_2_tpu_torch.models import mixtral as tmix

    with pytest.raises(TypeError, match="got MixtralForCausalLM"):
        PipelinedCausalLM(MixtralForCausalLM(MIXTRAL_CONFIGS["tiny-moe"]), num_microbatches=2)
    port = tmix.MixtralForCausalLM(tmix.MIXTRAL_CONFIGS["tiny-moe"], device="cpu")
    assert PipelinedCausalLM(port, num_microbatches=2).uses_manual_vjp
    base = ["--ckpt-dir", str(tmp_path / "c"), "--synthetic", "1000", "--device", "cpu"]
    with pytest.raises(SystemExit, match="--ep 2: tiny is not a MoE model"):
        pretrain.main(base + ["--ep", "2"])
    for argv, match in ((["--model", "tiny-moe", "--ep", "2"], "--dp 0 --ep 2: 2 ranks"),
                        (["--model", "tiny-moe", "--pp", "2"], "--pp 2 --dp 0: 2 ranks"),
                        (["--pp", "2"], "--pp 2 --dp 0: 2 ranks")):
        with pytest.raises(SystemExit, match=match):
            pretrain.main(base + argv)


def test_pipeline_config_mismatch_fails_loudly():
    """JAX ``test_pipeline_config_mismatch_fails_loudly``: the config's
    pipeline knobs must agree with the model's."""
    model = tllama.LlamaForCausalLM(TINY, device="cpu")
    tc = ttrainer.TrainingConfig(pipeline_schedule="interleaved", num_model_chunks=2)
    with pytest.raises(ValueError, match="not pipelined"):
        ttrainer.make_train_step(model, tc)
    with pytest.raises(ValueError, match="schedule"):
        ttrainer.make_train_step(PipelinedCausalLM(model, num_microbatches=4), tc)
    il = PipelinedCausalLM(model, num_microbatches=4, schedule="interleaved")
    with pytest.raises(ValueError, match="num_model_chunks"):
        ttrainer.make_train_step(il, tc)
    with pytest.raises(ValueError, match="num_model_chunks"):
        ttrainer.initialize_parallel_model(il, tc)


@pytest.mark.parametrize("schedule,chunks", [("gpipe", 1), ("1f1b", 1), ("interleaved", 1),
                                             ("interleaved", 2)])
def test_one_stage_pipeline_is_the_model(schedule, chunks):
    """At pp = 1 every schedule runs the whole model on one rank (the
    interleaved chunks passing their messages to the stage itself): its
    loss and gradients are the model's, its eval loss and logits too, and
    it trains through the trainer."""
    cfg = dataclasses.replace(TINY, use_flash_attention=True, loss_chunk_size=8, remat="full")
    model = tllama.LlamaForCausalLM(cfg, device="cpu").init_weights(3)
    ids = torch.as_tensor(np.random.default_rng(5).integers(0, 256, (4, 16)))
    labels = ids.clone()
    labels[0, 3:7] = -100
    loss = model.loss(ids, labels)
    want = torch.autograd.grad(loss, list(model.parameters()))
    pm = PipelinedCausalLM(model, num_microbatches=4, schedule=schedule, num_model_chunks=chunks)
    got_loss, grads = pm.loss_and_grad(ids, labels)
    assert len(pm.stats["tasks"]) == (9 if chunks == 1 else 33)
    torch.testing.assert_close(got_loss, loss.detach(), rtol=1e-6, atol=0)
    for (k, _), w in zip(model.named_parameters(), want):
        torch.testing.assert_close(grads[k], w, rtol=0, atol=1e-6 * float(w.abs().max()))
    torch.testing.assert_close(pm.loss(ids, labels), loss.detach(), rtol=1e-6, atol=0)
    torch.testing.assert_close(pm(ids), model(ids).float(), rtol=0, atol=1e-5)
    tc = ttrainer.TrainingConfig(pipeline_schedule=schedule, num_model_chunks=chunks)
    state, _ = ttrainer.initialize_parallel_model(pm, tc)
    _, m = ttrainer.make_train_step(pm, tc)(state, {"input_ids": ids, "labels": labels})
    assert np.isfinite(float(m["loss"])) and m["step"] == 1
