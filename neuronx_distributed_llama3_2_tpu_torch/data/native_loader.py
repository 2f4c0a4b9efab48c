"""ctypes binding for the native (C++) token loader.

Counterpart of ``neuronx_distributed_llama3_2_tpu/data/native_loader.py``,
over the same source, ``native/token_loader.cc`` at the repository root
(reused, not copied): an mmap'd token file, int-width conversion, and a
worker thread that gathers the next batch while the current step runs.
Policy (epoch shuffle, resume) stays in :mod:`.dataset`.

The library is built at first use with ``g++ -O2 -std=c++17 -fPIC -shared
-pthread`` into the port's ``kernels/build/`` (git-ignored), named by a
hash of the source and the flags, so an edited source is rebuilt. As in
the JAX package, :func:`native_available` is False when no compiler or
source is found, and callers fall back to the numpy path; a build that
starts and fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger

logger = get_logger()

SOURCE = Path(__file__).resolve().parents[2] / "native" / "token_loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "kernels" / "build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")

_LIB: Optional[ctypes.CDLL] = None
_UNAVAILABLE: Optional[str] = None  # why there is no library, once known


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtoken_loader-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/token_loader.cc`` unless it is built already;
    returns the library's path. Raises with the compiler's output if g++
    fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def _load_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _UNAVAILABLE
    if _LIB is not None:
        return _LIB
    if _UNAVAILABLE is not None:
        return None
    if not SOURCE.is_file() or shutil.which("g++") is None:
        _UNAVAILABLE = f"no {SOURCE.name} or no g++"
        logger.info("native token loader unavailable (%s); using numpy", _UNAVAILABLE)
        return None
    lib = ctypes.CDLL(str(build()))
    lib.tl_open.restype = ctypes.c_void_p
    lib.tl_open.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.tl_close.restype = None
    lib.tl_close.argtypes = [ctypes.c_void_p]
    lib.tl_num_tokens.restype = ctypes.c_longlong
    lib.tl_num_tokens.argtypes = [ctypes.c_void_p]
    lib.tl_gather.restype = None
    lib.tl_gather.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.tl_prefetch.restype = None
    lib.tl_prefetch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.c_int,
    ]
    lib.tl_wait.restype = ctypes.c_longlong
    lib.tl_wait.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
    ]
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def _npy_layout(path: str):
    """(data_offset, n_tokens, token_bytes, is_signed) of a 1-D
    little-endian int .npy."""
    arr = np.load(path, mmap_mode="r")
    if arr.ndim != 1:
        raise ValueError(f"token file must be 1-D, got {arr.shape}")
    if arr.dtype.byteorder == ">":
        raise ValueError("big-endian token files are not supported natively")
    if arr.dtype.kind not in ("i", "u") or arr.dtype.itemsize not in (1, 2, 4, 8):
        raise ValueError(f"unsupported token dtype {arr.dtype}")
    return (int(arr.offset), int(arr.shape[0]), int(arr.dtype.itemsize),
            arr.dtype.kind == "i")


def _check_indices(indices: np.ndarray, n_samples: int) -> np.ndarray:
    idx = np.ascontiguousarray(indices, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"sample indices must be 1-D, got shape {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= n_samples):
        raise IndexError(f"sample index out of range [0, {n_samples})")
    return idx


class NativeTokenDataset:
    """Drop-in for :class:`.dataset.TokenDataset` backed by the C++ loader,
    with the batch-gather and prefetch entry points the loader uses."""

    def __init__(self, path: str, seq_len: int):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native token loader not available")
        self._lib = lib
        off, n, width, signed = _npy_layout(path)
        self._h = lib.tl_open(str(path).encode(), off, n, width, int(signed))
        if not self._h:
            raise RuntimeError(f"tl_open failed for {path}")
        self.seq_len = seq_len
        self._n_tokens = n
        self._pending_shape = None

    def __len__(self) -> int:
        return self._n_tokens // self.seq_len

    def __getitem__(self, i: int) -> np.ndarray:
        return self.gather(np.asarray([i], np.int64))[0]

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """(count, seq_len) int32 batch for explicit sample indices."""
        idx = _check_indices(indices, len(self))
        out = np.empty((len(idx), self.seq_len), np.int32)
        self._lib.tl_gather(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(idx), self.seq_len, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out

    def prefetch(self, indices: np.ndarray) -> None:
        """Post the next batch's indices to the background worker."""
        idx = _check_indices(indices, len(self))
        self._pending_shape = (len(idx), self.seq_len)
        self._lib.tl_prefetch(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(idx), self.seq_len,
        )

    def wait(self) -> np.ndarray:
        """Block for (and return) the prefetched batch."""
        if self._pending_shape is None:
            raise RuntimeError("wait() without a prefetch() before it")
        count, seq = self._pending_shape
        out = np.empty((count, seq), np.int32)
        n = self._lib.tl_wait(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size,
        )
        if n != out.size:
            raise RuntimeError(f"tl_wait returned {n}, expected {out.size}")
        self._pending_shape = None
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tl_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
