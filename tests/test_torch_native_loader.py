"""The port's native token loader (data/native_loader.py, over
``native/token_loader.cc``) against the numpy path and the JAX package's
loader: byte-exact samples at every token width, batch gather, prefetch,
and the loader's prefetch path batch for batch, across a resume. Skips,
with its reason, only where no g++ is on the machine."""

import shutil

import numpy as np
import pytest

from neuronx_distributed_llama3_2_tpu import data as jdata
from neuronx_distributed_llama3_2_tpu_torch.data import native_loader
from neuronx_distributed_llama3_2_tpu_torch.data.dataset import (
    DistributedDataLoader,
    LoaderState,
    TokenDataset,
    write_token_file,
)


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine to build native/token_loader.cc")


@pytest.fixture()
def token_file(tmp_path):
    path = str(tmp_path / "tokens.npy")
    write_token_file(path, np.random.default_rng(0).integers(0, 50000, 4096).astype(np.int32))
    return path


def test_builds_into_the_ports_build_directory():
    assert native_loader.native_available()
    path = native_loader.build()
    assert path == native_loader.library_path() and path.exists()
    assert path.parent.name == "build" and path.parent.parent.name == "kernels"


def test_matches_numpy_dataset(token_file):
    py = TokenDataset(token_file, seq_len=64)
    nat = native_loader.NativeTokenDataset(token_file, seq_len=64)
    assert len(py) == len(nat) == 64
    for i in [0, 1, 17, 63]:
        np.testing.assert_array_equal(nat[i], py[i])
    nat.close()


def test_batch_gather_and_prefetch(token_file):
    py = TokenDataset(token_file, seq_len=32)
    nat = native_loader.NativeTokenDataset(token_file, seq_len=32)
    idx = np.asarray([5, 0, 99, 42], np.int64)
    want = np.stack([py[int(i)] for i in idx])
    np.testing.assert_array_equal(nat.gather(idx), want)
    nat.prefetch(idx)
    np.testing.assert_array_equal(nat.wait(), want)
    nat.prefetch(idx[::-1].copy())
    np.testing.assert_array_equal(nat.wait(), want[::-1])
    with pytest.raises(RuntimeError, match="prefetch"):
        nat.wait()
    with pytest.raises(IndexError):
        nat.gather(np.asarray([len(nat)], np.int64))
    nat.close()


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16])
def test_token_widths(tmp_path, dtype):
    path = str(tmp_path / "t.npy")
    lo = 0 if np.dtype(dtype).kind == "u" else -7
    toks = np.arange(lo, 250 + lo, dtype=dtype)
    if np.dtype(dtype) == np.uint16:
        toks = toks + 40000  # beyond int16 range: catches sign-extension bugs
    write_token_file(path, toks)
    nat = native_loader.NativeTokenDataset(path, seq_len=10)
    np.testing.assert_array_equal(nat[0], toks[:10].astype(np.int32))
    np.testing.assert_array_equal(nat[24], toks[240:250].astype(np.int32))
    nat.close()


def test_rejects_2d(tmp_path):
    path = str(tmp_path / "bad.npy")
    np.save(path, np.zeros((4, 4), np.int32))
    with pytest.raises(ValueError):
        native_loader.NativeTokenDataset(path, seq_len=2)


def test_npy_layout_matches_jax(token_file):
    from neuronx_distributed_llama3_2_tpu.data import native_loader as jnative

    assert native_loader._npy_layout(token_file) == jnative._npy_layout(token_file)


def test_distributed_loader_native_prefetch_parity(token_file):
    """The loader over the native dataset (prefetch path) yields the JAX
    numpy loader's batches, across a resume."""
    ref = jdata.DistributedDataLoader(jdata.TokenDataset(token_file, 32), 8, seed=3)
    nat_ds = native_loader.NativeTokenDataset(token_file, 32)
    it_nat, it_ref = iter(DistributedDataLoader(nat_ds, 8, seed=3)), iter(ref)
    for _ in range(20):  # past the first epoch (16 steps of 8 of 128 samples)
        np.testing.assert_array_equal(next(it_nat), next(it_ref))
    nat2 = DistributedDataLoader(native_loader.NativeTokenDataset(token_file, 32), 8, seed=3,
                                 state=LoaderState(step=3))
    np.testing.assert_array_equal(next(iter(nat2)), ref.batch_at(3))
    nat_ds.close()
