#!/usr/bin/env python3
"""Where csrc/paged_decode_t1.cu's time goes, on one CUDA card.

    python3 chip_trials/paged_decode_t1_trial.py [variant,...]   # from the repository root

Builds the source as it is ("base") and variants made by editing its text,
each into its own library (one nvcc per variant, all started together, in
a temporary directory), then at the bf16 serve's median t = 1 call of
Llama-3.2 1B (8 lanes, kv_limit 1024, at the positions of that call in
chip_smoke.py's serve) on a bf16 and an int8 (mode 3) pool, at 8 and 16 splits:

- times every variant in turns (a, b, ..., b, a) with chip_smoke.device_ms
  and prints chip_smoke.decode_agreement against the plain version;
- runs "stamps", the source with each block writing %globaltimer at its
  phase boundaries, and prints per-phase percentiles over the blocks and
  the latest block's path.

Variants: "sep" merges the splits in a second launch (the same
merge_splits, one block per (kv head, lane)) instead of in the last block
to arrive; "splitfast" hands the blocks out with the split index varying
fastest (the grid order before the split became the slowest dimension);
"nomerge" leaves the merge out (a lower bound: its output is
wrong wherever a lane has more than one split, though a buffer that the
allocator hands back may still hold a right one); "minblocksN" asks ptxas
for N blocks an SM on the D = 64, G <= 4 instances. Prints ptxas's
register and spill lines for each.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from neuronx_distributed_llama3_2_tpu_torch.kernels import _build  # noqa: E402
from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa  # noqa: E402
from neuronx_distributed_llama3_2_tpu_torch.quantization import kv_cache as kv  # noqa: E402

SOURCE = (_build.CSRC / "paged_decode_t1.cu").read_text()
SERVED = (38, 715, 145, 276, 279, 526, 79, 348)

# the merge as a launch of its own, after the main kernel
SEPARATE_MERGE = r'''
template <int D, int kG>
__global__ void __launch_bounds__(kThreads) t1_merge_kernel(
    const float* o_parts, const float* m_parts, const float* l_parts, __nv_bfloat16* out,
    const int* positions, int n_heads, int nkv, int group, int nblk, int splits) {
  __shared__ float scratch[2 * 128 * kG];
  const int h = blockIdx.x, i = blockIdx.y;
  const int nb = max(min(nblk, positions[i] / kBlockRows + 1), 0);
  const int per_split = (nb + splits - 1) / splits;
  const int n_live = nb > 0 ? (nb + per_split - 1) / per_split : 0;
  if (n_live <= 1) return;
  merge_splits<D, kG>(o_parts, m_parts, l_parts,
                      (static_cast<size_t>(i) * nkv + h) * splits * group, n_live, group,
                      scratch, out + (static_cast<size_t>(i) * n_heads + h * group) * D,
                      threadIdx.x);
}

'''

STAMPS = '''__device__ unsigned long long t1_stamps[8192][8];
__device__ __forceinline__ unsigned long long stamp() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
'''


def edit(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"the source no longer holds exactly one {old!r}")
    return text.replace(old, new)


def variant(name: str) -> str:
    s = SOURCE
    if name in ("nomerge", "sep"):
        s = edit(s, "  // the last split of this (lane, kv head) to arrive merges them all\n",
                 "  return;\n  // the last split of this (lane, kv head) to arrive merges them all\n")
    if name == "sep":
        s = edit(s, "struct Args {", SEPARATE_MERGE + "struct Args {")
        s = edit(s, "a.splits, a.sm_scale, mxu, e5m2);\n  return cudaGetLastError();",
                 "a.splits, a.sm_scale, mxu, e5m2);\n"
                 "  { cudaError_t err = cudaGetLastError(); if (err != cudaSuccess) return err; }\n"
                 "  t1_merge_kernel<D, kG><<<dim3(a.nkv, a.b), kThreads, 0, a.stream>>>("
                 "static_cast<const float*>(a.o_parts), static_cast<const float*>(a.m_parts), "
                 "static_cast<const float*>(a.l_parts), static_cast<__nv_bfloat16*>(a.out), "
                 "static_cast<const int*>(a.positions), a.n_heads, a.nkv, a.n_heads / a.nkv, "
                 "a.nblk, a.splits);\n  return cudaGetLastError();")
    if name == "splitfast":
        s = edit(s, "  const int h = blockIdx.x;\n  const int i = blockIdx.y;\n  const int s = blockIdx.z;",
                 "  const int s = blockIdx.x;\n  const int h = blockIdx.y;\n  const int i = blockIdx.z;")
        s = edit(s, "kernel<<<dim3(a.nkv, a.b, a.splits),", "kernel<<<dim3(a.splits, a.nkv, a.b),")
    if name.startswith("minblocks"):
        s = edit(s, "D == 64 && kG == 4 ? 6 : 1;", f"D == 64 && kG == 4 ? {name[9:]} : 1;")
    if name == "stamps":
        s = edit(s, "constexpr int kThreads = 128;", STAMPS + "constexpr int kThreads = 128;")
        s = edit(s, "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n\n"
                    "  // the group's query rows",
                 "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
                 "  unsigned long long* st_ = t1_stamps[s + splits * (h + nkv * i)];\n"
                 "  if (tid == 0) { st_[0] = stamp(); for (int z = 1; z < 8; ++z) st_[z] = 0; }\n\n"
                 "  // the group's query rows")
        s = edit(s, "  __syncthreads();  // q_s is ready\n",
                 "  __syncthreads();  // q_s is ready\n"
                 "  if (tid == 0) { st_[1] = stamp(); st_[6] = n_walk; }\n")
        s = edit(s, "  __syncthreads();     // every warp is done with the ring: the merges reuse it\n",
                 "  __syncthreads();     // every warp is done with the ring: the merges reuse it\n"
                 "  if (tid == 0) st_[2] = stamp();\n")
        s = edit(s, "  if (n_live == 1) return;\n", "  if (tid == 0) st_[3] = stamp();\n"
                                                   "  if (n_live == 1) return;\n")
        s = edit(s, "  merge_splits<D, kG>(o_parts, m_parts",
                 "  if (tid == 0) st_[4] = stamp();\n  merge_splits<D, kG>(o_parts, m_parts")
        s = edit(s, "reinterpret_cast<float*>(ring), o, tid);\n}",
                 "reinterpret_cast<float*>(ring), o, tid);\n  __syncthreads();\n"
                 "  if (tid == 0) st_[5] = stamp();\n}")
        s += ('\nextern "C" int t1_read_stamps(void* dst, int n) {\n'
              '  return static_cast<int>(cudaMemcpyFromSymbol(dst, t1_stamps, 64ull * n));\n}\n')
    return s


def build(names, workdir: Path) -> dict:
    """{name: ctypes library}, ptxas's register and spill lines printed."""
    procs = []
    for n in names:
        src = workdir / f"{n}.cu"
        src.write_text(variant(n))
        so = workdir / f"{n}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(so), str(src)]
        procs.append((n, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE, text=True)))
    libs = {}
    for n, so, p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {n}:\n{err[-3000:]}")
        rows, inst = [], None
        for line in err.splitlines():
            m = re.search(r"kernelILi(\d+)ELi(\d)ELi(\d)E", line)
            if m:
                inst = "D %s layout %s G %s" % m.groups()
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and inst:
                rows.append(f"{inst}: spill {m.group(1)}")
            m = re.search(r"Used (\d+) registers", line)
            if m and inst and rows:
                rows[-1] += f", {m.group(1)} registers"
        print(f"{n}: " + " | ".join(rows), flush=True)
        lib = ctypes.CDLL(str(so))
        lib.paged_decode_t1.restype = ctypes.c_int
        lib.paged_decode_t1.argtypes = (
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
        libs[n] = lib
    return libs


def served_case():
    """q, the bf16 and int8 pools of 16 layers, tables and positions."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    c = cs.DecodeCase("served", 32, 8, 64, 1, 1024, None, np.asarray(SERVED), table_width=256)
    q, kp, vp, tables, pos = cs.build_case(c, gen)
    kq, ks = kv.kv_quantize(kp, torch.int8)
    vq, vs = kv.kv_quantize(vp, torch.int8)
    return q, {"bf16": (kp, vp, None, None), "int8": (kq, vq, ks, vs)}, tables, pos


def launcher(lib, q, pool, tables, pos, splits):
    """fn(i): the wrapper's launch of ``lib`` at layer i % 16."""
    kp, vp, ks, vs = pool
    nblk, sp, bps = pa._geometry(q, kp[0], tables, 1024, splits)

    def fn(i):
        j = i % kp.shape[0]
        inner = pa._t1_kernel
        pa._t1_kernel = lambda: lib.paged_decode_t1
        try:
            return pa._launch(q, kp[j], vp[j], tables, pos, nblk, sp, bps,
                              k_scale=None if ks is None else ks[j],
                              v_scale=None if vs is None else vs[j], kernel="t1")
        finally:
            pa._t1_kernel = inner
    return fn, sp


def time_variants(libs, q, pools, tables, pos, card):
    for pool_name, pool in pools.items():
        kp, vp, ks, vs = pool
        ref = pa.paged_flash_decode_reference(
            q, kp[0], vp[0], tables, pos, kv_limit=1024,
            k_scale=None if ks is None else ks[0], v_scale=None if vs is None else vs[0])
        for splits in (8, 16):
            fns = {n: launcher(lib, q, pool, tables, pos, splits)[0] for n, lib in libs.items()}
            times = {n: [] for n in fns}
            order = list(fns) + list(reversed(fns))
            for n in order:
                times[n].append(cs.device_ms(fns[n])[0][0])
            parts = []
            for n, fn in fns.items():
                elem, rel = cs.decode_agreement(fn(0), ref)
                parts.append(f"{n} {' / '.join(f'{t:.6f}' for t in times[n])} ms "
                             f"(agreement {elem:.4f} x, {rel:.6f})")
            print(f"{pool_name} {splits} splits: " + "; ".join(parts) + f" | {card}", flush=True)


def timeline(lib, q, pools, tables, pos, card):
    lib.t1_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for pool_name, pool in pools.items():
        for splits in (8, 16):
            fn, sp = launcher(lib, q, pool, tables, pos, splits)
            for i in range(20):
                fn(i)
            torch.cuda.synchronize()
            n = sp * 8 * 8
            buf = np.zeros((n, 8), np.uint64)
            fn(20)
            torch.cuda.synchronize()
            if lib.t1_read_stamps(buf.ctypes.data, n) != 0:
                raise RuntimeError("reading the stamps failed")
            st = buf.astype(np.int64)
            t0 = st[:, 0].min()
            live, merged = st[:, 1] > 0, st[:, 5] > 0
            end = np.maximum.reduce([st[:, 0], st[:, 3], st[:, 5]])

            def pct(x):
                return f"p50 {np.percentile(x, 50):.0f} p90 {np.percentile(x, 90):.0f} max {x.max()}"

            print(f"{pool_name} {splits} splits, ns: {n} blocks, {live.sum()} walk, "
                  f"{merged.sum()} merge; span {end.max() - t0}; start {pct(st[:, 0] - t0)}; "
                  f"prologue {pct(st[live, 1] - st[live, 0])}; walk {pct(st[live, 2] - st[live, 1])}; "
                  f"split's merge and writes {pct(st[live, 3] - st[live, 2])}; arrival "
                  f"{pct(st[merged, 4] - st[merged, 3])}; merge {pct(st[merged, 5] - st[merged, 4])} "
                  f"| {card}", flush=True)
            k = int(np.argmax(end))
            print(f"  latest block (split {k % sp}, kv head {(k // sp) % 8}, lane {k // (sp * 8)}, "
                  f"{st[k, 6]} pool blocks): start {st[k, 0] - t0}, q ready {st[k, 1] - t0}, walked "
                  f"{st[k, 2] - t0}, split merged {st[k, 3] - t0}, arrived {st[k, 4] - t0}, end "
                  f"{st[k, 5] - t0}", flush=True)
            for nw in sorted(set(st[live, 6].tolist())):
                sel = live & (st[:, 6] == nw)
                print(f"  {nw} pool blocks: {sel.sum()} splits, walk {pct(st[sel, 2] - st[sel, 1])}",
                      flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_decode_t1_trial: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else ["base", "sep", "nomerge"]
    card = cs.card_label()
    print(card, flush=True)
    q, pools, tables, pos = served_case()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(names + ["stamps"], Path(tmp))
        stamps = libs.pop("stamps")
        time_variants(libs, q, pools, tables, pos, card)
        timeline(stamps, q, pools, tables, pos, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
