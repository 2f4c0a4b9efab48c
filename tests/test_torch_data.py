"""The port's data pipeline (data/dataset.py) against the JAX package's,
batch for batch: the same token file, seeds, epochs, ``sample_range``
holdout and resume step give equal batches (exact integers). And
``batch_to_device`` on the CPU."""

import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu import data as jdata
from neuronx_distributed_llama3_2_tpu_torch.data import (
    DistributedDataLoader,
    LoaderState,
    TokenDataset,
    batch_to_device,
    write_token_file,
)


@pytest.fixture()
def token_file(tmp_path):
    path = str(tmp_path / "tokens.npy")
    write_token_file(path, np.arange(10_000, dtype=np.int32) % 256)
    return path


def test_token_dataset(token_file):
    ds = TokenDataset(token_file, seq_len=64)
    assert len(ds) == 10_000 // 64
    s0 = ds[0]
    assert s0.shape == (64,) and s0.dtype == np.int32
    np.testing.assert_array_equal(s0, np.arange(64) % 256)
    np.testing.assert_array_equal(ds[17], jdata.TokenDataset(token_file, 64)[17])


def test_write_token_file_matches_jax(tmp_path):
    toks = np.random.default_rng(0).integers(0, 128256, 999).astype(np.int32)
    write_token_file(str(tmp_path / "a.npy"), toks)
    jdata.write_token_file(str(tmp_path / "b.npy"), toks)
    assert (tmp_path / "a.npy").read_bytes() == (tmp_path / "b.npy").read_bytes()


@pytest.mark.parametrize("seed", [0, 7])
def test_loader_matches_jax_batch_for_batch(token_file, seed):
    """Two epochs and a bit, shuffled: every batch equal to JAX's."""
    ours = DistributedDataLoader(TokenDataset(token_file, 64), 4, seed=seed)
    theirs = jdata.DistributedDataLoader(jdata.TokenDataset(token_file, 64), 4, seed=seed)
    assert ours.steps_per_epoch == theirs.steps_per_epoch
    for step in range(2 * ours.steps_per_epoch + 3):
        np.testing.assert_array_equal(ours.batch_at(step), theirs.batch_at(step))


def test_loader_deterministic_and_resumable(token_file):
    ds = TokenDataset(token_file, seq_len=64)
    it = iter(DistributedDataLoader(ds, global_batch_size=4, seed=7))
    batches = [next(it) for _ in range(10)]
    b = DistributedDataLoader(ds, global_batch_size=4, seed=7, state=LoaderState(step=6))
    jb = jdata.DistributedDataLoader(jdata.TokenDataset(token_file, 64), 4, seed=7,
                                     state=jdata.LoaderState(step=6))
    for i, batch, jbatch in zip(range(6, 10), iter(b), iter(jb)):
        np.testing.assert_array_equal(batch, batches[i])
        np.testing.assert_array_equal(batch, jbatch)
    assert b.state.step == 10 and b.state.to_json() == {"step": 10}
    assert LoaderState.from_json({"step": 3}) == LoaderState(step=3)
    assert LoaderState.from_json({}) == LoaderState(step=0)


def test_loader_epoch_reshuffle(token_file):
    dl = DistributedDataLoader(TokenDataset(token_file, seq_len=64), global_batch_size=4, seed=1)
    assert not np.array_equal(dl.batch_at(0), dl.batch_at(dl.steps_per_epoch))


def test_sample_range_holdout_matches_jax(tmp_path):
    path = str(tmp_path / "t.npy")
    write_token_file(path, np.arange(64 * 40, dtype=np.int32))
    ds = TokenDataset(path, 64)  # 40 samples
    train = DistributedDataLoader(ds, 4, seed=0, sample_range=(0, 32))
    ev = DistributedDataLoader(ds, 4, shuffle=False, sample_range=(32, 40))
    jds = jdata.TokenDataset(path, 64)
    jtrain = jdata.DistributedDataLoader(jds, 4, seed=0, sample_range=(0, 32))
    jev = jdata.DistributedDataLoader(jds, 4, shuffle=False, sample_range=(32, 40))
    seen_train, seen_eval = set(), set()
    for step in range(16):  # 2 epochs
        np.testing.assert_array_equal(train.batch_at(step), jtrain.batch_at(step))
        seen_train |= {int(r[0]) // 64 for r in train.batch_at(step)}
    for step in range(2):
        np.testing.assert_array_equal(ev.batch_at(step), jev.batch_at(step))
        seen_eval |= {int(r[0]) // 64 for r in ev.batch_at(step)}
    assert seen_train == set(range(32)) and seen_eval == set(range(32, 40))
    with pytest.raises(ValueError, match="sample_range"):
        DistributedDataLoader(ds, 4, sample_range=(30, 80))
    with pytest.raises(ValueError, match="samples < global batch"):
        DistributedDataLoader(ds, 16, sample_range=(32, 40))


def test_batch_to_device_on_the_cpu():
    batch = np.arange(12, dtype=np.int32).reshape(3, 4)
    t = batch_to_device(batch, "cpu")
    assert t.dtype == torch.int64 and t.device == torch.device("cpu")
    assert torch.equal(t, torch.arange(12).reshape(3, 4))
    batch[0, 0] = 99  # the device batch is a copy
    assert int(t[0, 0]) == 0


def test_batch_to_device_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch_to_device(np.zeros((1, 2), np.int32))


def test_loader_refuses_several_processes(token_file, monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    # several processes read the rows of their dp rank, which needs the mesh
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        next(iter(DistributedDataLoader(TokenDataset(token_file, 64), 4)))


def test_two_dp_ranks_read_jax_process_rows_and_resume(token_file, tmp_path, monkeypatch):
    """Two processes at dp = 2: each reads its block of every global batch,
    the rows JAX's loader gives ``jax.process_index()`` of two processes;
    the blocks are disjoint and make up the batch, and each rank's loader
    resumed at a step yields its own rows from there on."""
    import jax

    from tests import torch_dist_workers as W

    gbs, steps, resume_at = 4, 5, 3
    outs = W.run(W.loader_worker, 2, tmp_path, token_file, gbs, 64, steps, resume_at)
    whole = DistributedDataLoader(TokenDataset(token_file, 64), gbs, seed=3)
    for o in outs:
        r = o["dp_rank"]
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        jit = iter(jdata.DistributedDataLoader(jdata.TokenDataset(token_file, 64), gbs, seed=3))
        for step in range(steps):
            np.testing.assert_array_equal(o["first"][step], next(jit))
            np.testing.assert_array_equal(
                o["first"][step], whole.batch_at(step)[r * gbs // 2:(r + 1) * gbs // 2])
        for k, batch in enumerate(o["resumed"]):
            np.testing.assert_array_equal(batch, o["first"][resume_at + k])
    for step in range(steps):
        np.testing.assert_array_equal(
            np.concatenate([outs[0]["first"][step], outs[1]["first"][step]]), whole.batch_at(step))
