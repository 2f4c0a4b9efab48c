"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/<name>-<hash>.so`` next to this file (the directory is in
``.gitignore``), for ``sm_90a``, at first use. The hash covers the sources
and the flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing here runs at import time: this module imports on machines
without CUDA, where only the build itself fails.

    python -m neuronx_distributed_llama3_2_tpu_torch.kernels._build

builds every source (one ``nvcc`` per source, all started together) and
prints what ``ptxas`` reports for each kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# loaded libraries, one per source, for the life of the process
_LIBS: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float       # 0.0 when the library was already built
    ptxas: str           # nvcc's stderr: registers, shared memory, spills


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (checked $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the port's CUDA kernels build only on a machine with the CUDA toolkit"
    )


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _library_path(src: Path) -> Path:
    h = hashlib.sha256()
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, BuildResult]:
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together. Raises with the
    compiler's output if any build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    results: Dict[str, BuildResult] = {}
    running = []
    for name in names:
        if name not in srcs:
            raise KeyError(f"no CUDA source csrc/{name}.cu")
        out = _library_path(srcs[name])
        if out.exists():
            results[name] = BuildResult(name, out, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        running.append((name, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, proc, t0 in running:
        stdout, stderr = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- csrc/{name}.cu ---\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        results[name] = BuildResult(name, out, secs, stdout + stderr)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _LIBS[name] = lib
    return lib


if __name__ == "__main__":
    for res in build().values():
        print(f"{res.name}: {res.path.name} built in {res.seconds:.1f} s")
        print(res.ptxas)
