#!/usr/bin/env python3
"""What csrc/paged_decode_tile.cu's quantized instances spend, on one CUDA card.

    python3 chip_trials/paged_decode_tile_trial.py [variant,...] [--parent FILE]   # from the repository root

Builds the source as it is ("base") and variants made by editing its text,
each into its own library (one nvcc per variant, all started together, in
a temporary directory), then, at the calls below, times every variant in
turns (a, b, ..., b, a) with chip_smoke.device_ms (the whole call, and its
main kernel alone) and prints chip_smoke.decode_agreement against the plain
version:

- Q1's and Q2's served suffix prefill (Llama-3.2 1B, 1 lane, t = 8,
  kv_limit 512, the lane at row 256, 16 layers) on an int8 pool in mode 3,
  an fp8 e4m3 pool in mode 6, an int8 pool in mode 6, and the bf16 pool;
- F's median mixed call (8 lanes, t = 16 with row_live, kv_limit 512) on
  an int8 pool in mode 3.

Then every variant on chip_smoke.probe_case at t = 8 in fp8 e4m3 and e5m2
mode 6, the inputs that expose an inexact q.k sum. With ``--parent FILE``
(a copy of the source before it took the quantized pools, whose C entry
takes no scales), that source is built too and timed in turns with "base"
at the bf16 calls (parent, base, base, parent).

Variants: "fewwarps" launches the quantized instances with one warp per
16 tile rows, as the bf16 ones (the source launches 8 warps, the warps
past the tile's rows staging and dequantizing only; the served calls have
2 and 4 computing warps);
"nosync" leaves out the barrier that publishes the dequantized
working stage (a race: a lower bound on what that barrier costs);
"nodequant" dequantizes nothing and leaves out that barrier (its output is
wrong: a lower bound on the whole dequantization step); "fp8steps" starts
each 32-deep k step of the fp8 products from a zeroed accumulator and
adds the steps in fp32, where the source sums them in one accumulator;
"dequantloop" dequantizes as the first version did: a tensor at a time, a
chunk a loop step, each conversion waiting on its own loads, the fp8
flavour a run-time argument.
Prints ptxas's register and spill lines for each.
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

SOURCE = (_build.CSRC / "paged_decode_tile.cu").read_text()
# F's median mixed call (chip_smoke's F grid case)
F_POSITIONS = (43, 352, 154, 266, 352, 84, 334, 268)
F_LIVE = (1, 16, 2, 1, 16, 1, 1, 1)


# the dequantization as first written: one tensor at a time, a chunk a loop
# step, each conversion waiting on its own loads, the fp8 flavour a run-time
# argument
FIRST_DEQUANT = r'''template <int D, int L>
__device__ __forceinline__ void dequant_block(bf16* dst, const unsigned char* src,
                                              const __half* scale, int nkv, int h, bool e5m2,
                                              int tid, int nthreads) {
  using P = Payload<L>;
  constexpr int kVecs = D / 8;
  constexpr int SP = D + kPayloadPad;
  constexpr int LD = D + kPad;
  for (int e = tid; e < kBlockRows * kVecs; e += nthreads) {
    const int r = e / kVecs, c = e % kVecs;
    const uint2 raw = *reinterpret_cast<const uint2*>(src + r * SP + c * 8);
    const typename P::T* x = reinterpret_cast<const typename P::T*>(&raw);
    const __half s = scale[r * nkv + h];
    uint4 o;
    uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ow[k] = pack_float(dequant(P::widen(x[2 * k], e5m2), s),
                         dequant(P::widen(x[2 * k + 1], e5m2), s));
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = o;
  }
}

'''


def edit(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"the source no longer holds exactly one {old!r}")
    return text.replace(old, new)


def variant(name: str) -> str:
    s = SOURCE
    barrier = "      __syncthreads();  // the working stage is ready\n"
    if name in ("nosync", "nodequant"):
        s = edit(s, barrier, "")
    if name == "nodequant":
        s = edit(s, "      if (L == kLayoutFp8 && e5m2) {\n", "      if (false) {\n")
        s = edit(s, "        dequant_stage<D, L, kTensors, false>(kv_s[0][0], kq_s, ks_s, nkv, h, tid);\n",
                 "")
    if name == "fp8steps":
        s = edit(s, "            mma_fp8(sc[nt], qf[kk], b, e5m2);\n",
                 "            float part[4] = {};\n            mma_fp8(part, qf[kk], b, e5m2);\n"
                 "#pragma unroll\n            for (int c = 0; c < 4; ++c) sc[nt][c] += part[c];\n")
    if name == "fewwarps":
        s = edit(s, "  const int warps = L == kLayoutBf16 ? (a.t * group + 15) / 16 : kMaxWarps;",
                 "  const int warps = (a.t * group + 15) / 16;")
        # right for any launch of 2 or more warps (chunks past the first 64
        # threads' are converted twice, to the same values)
        s = edit(s, "  constexpr int kThreads = kMaxWarps * 32;\n  constexpr int kVecs = D / 8;",
                 "  constexpr int kThreads = 64;\n  constexpr int kVecs = D / 8;")
    if name == "dequantloop":
        s = edit(s, "// x cast to fp8 without saturation", FIRST_DEQUANT + "// x cast to fp8 without saturation")
        s = edit(s, "      if (L == kLayoutFp8 && e5m2) {\n"
                    "        dequant_stage<D, L, kTensors, true>(kv_s[0][0], kq_s, ks_s, nkv, h, tid);\n"
                    "      } else {\n"
                    "        dequant_stage<D, L, kTensors, false>(kv_s[0][0], kq_s, ks_s, nkv, h, tid);\n"
                    "      }\n",
                 "      if constexpr (!kMxu) {\n"
                 "        dequant_block<D, L>(kv_s[0][0], kq_s, ks_s, nkv, h, e5m2, tid, nthreads);\n"
                 "      }\n"
                 "      dequant_block<D, L>(kv_s[0][1], kq_s + kPayload, ks_s + kBlockRows * nkv, nkv, h,\n"
                 "                          e5m2, tid, nthreads);\n")
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
            m = re.search(r"tile_kernelILi(\d+)ELi(\d)ELb(\d)E", line)
            if m:
                inst = "D %s layout %s mxu %s" % m.groups()
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and inst:
                rows.append(f"{inst}: spill {m.group(1)}")
            m = re.search(r"Used (\d+) registers", line)
            if m and inst and rows and "registers" not in rows[-1]:
                rows[-1] += f", {m.group(1)} registers"
        print(f"{n}: " + " | ".join(rows), flush=True)
        lib = ctypes.CDLL(str(so))
        lib.paged_decode_tile.restype = ctypes.c_int
        lib.paged_decode_tile.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p])
        libs[n] = lib
    return libs


def cases():
    """[(label, q, (k, v, k_scale, v_scale) of 16 layers, tables, positions,
    kv_limit, quant_mxu, row_live)]"""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = []
    c = cs.DecodeCase("served", 32, 8, 64, 8, 512, None, np.asarray([256]), table_width=256)
    q, kp, vp, tables, pos = cs.build_case(c, gen)
    out.append(("Q served t8 bf16", q, (kp, vp, None, None), tables, pos, 512, False, None))
    for kv_dtype, mxu in (("int8", False), ("fp8_e4m3", True), ("int8", True)):
        kq, ks = kv.kv_quantize(kp, kv.kv_cache_torch_dtype(kv_dtype))
        vq, vs = kv.kv_quantize(vp, kv.kv_cache_torch_dtype(kv_dtype))
        out.append((f"Q served t8 {cs.mode_label(kv_dtype, mxu)}", q, (kq, vq, ks, vs), tables,
                    pos, 512, mxu, None))
    c = cs.DecodeCase("F", 32, 8, 64, 16, 512, None, np.asarray(F_POSITIONS), table_width=32)
    q, kp, vp, tables, pos = cs.build_case(c, gen)
    kq, ks = kv.kv_quantize(kp, torch.int8)
    vq, vs = kv.kv_quantize(vp, torch.int8)
    live = torch.as_tensor(F_LIVE, dtype=torch.int32, device="cuda")
    out.append(("F mixed t16 int8 mode 3", q, (kq, vq, ks, vs), tables, pos, 512, False, live))
    return out


def launcher(lib, q, pool, tables, pos, kv_limit, mxu, live):
    """fn(i): the wrapper's launch of ``lib`` at layer i % 16."""
    kp, vp, ks, vs = pool
    nblk, sp, bps = pa._geometry(q, kp[0], tables, kv_limit, None, source="tile")

    def fn(i):
        j = i % kp.shape[0]
        inner = pa._tile_kernel
        pa._tile_kernel = lambda: lib.paged_decode_tile
        try:
            return pa._launch(q, kp[j], vp[j], tables, pos, nblk, sp, bps,
                              k_scale=None if ks is None else ks[j],
                              v_scale=None if vs is None else vs[j], quant_mxu=mxu,
                              row_live=live, kernel="tile")
        finally:
            pa._tile_kernel = inner
    return fn


def time_variants(libs, card):
    for label, q, pool, tables, pos, kv_limit, mxu, live in cases():
        kp, vp, ks, vs = pool
        ref = pa.paged_flash_decode_reference(
            q, kp[0], vp[0], tables, pos, kv_limit=kv_limit,
            k_scale=None if ks is None else ks[0], v_scale=None if vs is None else vs[0],
            quant_mxu=mxu, row_live=live)
        fns = {n: launcher(lib, q, pool, tables, pos, kv_limit, mxu, live)
               for n, lib in libs.items()}
        times = {n: [] for n in fns}
        for n in list(fns) + list(reversed(fns)):
            dev, _ = cs.device_ms(fns[n], matches=(None, "paged_decode_tile_kernel"))
            times[n].append(dev)
        parts = []
        for n, fn in fns.items():
            elem, rel = cs.decode_agreement(fn(0), ref)
            parts.append(f"{n} {' / '.join(f'{a:.6f}' for a, _ in times[n])} ms (main kernel "
                         f"{' / '.join(f'{b:.6f}' for _, b in times[n])}; agreement "
                         f"{elem:.4f} x, {rel:.6f})")
        print(f"{label}: " + "; ".join(parts) + f" | {card}", flush=True)


def probe(libs, card):
    """Each variant on probe_case at t = 8, fp8 mode 6 (e4m3, e5m2)."""
    for kv_dtype in ("fp8_e4m3", "fp8_e5m2"):
        q, kp, vp, ks, vs, tables, pos = cs.probe_case(kv_dtype, "cuda", cs.PROBE_TILE_T)
        kw = dict(kv_limit=cs.PROBE_KV_LIMIT, k_scale=ks, v_scale=vs, quant_mxu=True)
        ref = pa.paged_flash_decode_reference(q, kp, vp, tables, pos, **kw)
        parts = []
        for n, lib in libs.items():
            fn = launcher(lib, q, (kp[None], vp[None], ks[None], vs[None]), tables, pos,
                          cs.PROBE_KV_LIMIT, True, None)
            elem, rel = cs.decode_agreement(fn(0), ref)
            parts.append(f"{n} {elem:.6g} x, {rel:.6g}")
        print(f"probe t={cs.PROBE_TILE_T} {kv_dtype} mode 6 (limits 1, {cs.LANE_REL_L2}): "
              + "; ".join(parts) + f" | {card}", flush=True)


def parent_launcher(lib, q, pool, tables, pos, kv_limit, live):
    """fn(i): the parent source's C entry (11 pointers, 10 ints: a bf16 pool,
    no scales) at layer i % 16, with the wrapper's geometry and scratch."""
    kp, vp, _, _ = pool
    nblk, sp, bps = pa._geometry(q, kp[0], tables, kv_limit, None, source="tile")
    b, t, n, d = q.shape
    nkv = kp.shape[3]
    tg = t * (n // nkv)

    def fn(i):
        j = i % kp.shape[0]
        parts = torch.empty(b * nkv * sp * tg * (d + 2), dtype=torch.float32, device="cuda")
        o, m, l = parts.split((b * nkv * sp * tg * d, b * nkv * sp * tg, b * nkv * sp * tg))
        out = torch.empty_like(q)
        err = lib.paged_decode_tile(
            q.data_ptr(), kp[j].data_ptr(), vp[j].data_ptr(), tables.data_ptr(), pos.data_ptr(),
            None if live is None else live.data_ptr(), None, o.data_ptr(), m.data_ptr(),
            l.data_ptr(), out.data_ptr(), b, t, n, nkv, d, 16, tables.shape[1], nblk, sp, bps,
            d ** -0.5, pa._stream(q.device))
        if err:
            raise RuntimeError(f"the parent's launch failed: cudaError_t {err}")
        return out
    return fn


def time_parent(base, parent, card):
    """The bf16 calls of ``cases`` on the parent source and on "base", in turns."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for label, t, pos, w, live in (("Q served t8 bf16", 8, [256], 256, None),
                                   ("F mixed t16 bf16", 16, list(F_POSITIONS), 32, F_LIVE)):
        c = cs.DecodeCase(label, 32, 8, 64, t, 512, None, np.asarray(pos), table_width=w)
        q, kp, vp, tables, positions = cs.build_case(c, gen)
        live = None if live is None else torch.as_tensor(live, dtype=torch.int32, device="cuda")
        pool = (kp, vp, None, None)
        fns = {"parent": parent_launcher(parent, q, pool, tables, positions, 512, live),
               "base": launcher(base, q, pool, tables, positions, 512, False, live)}
        ref = pa.paged_flash_decode_reference(q, kp[0], vp[0], tables, positions, kv_limit=512,
                                              row_live=live)
        times = {n: [] for n in fns}
        for n in ("parent", "base", "base", "parent"):
            times[n].append(cs.device_ms(fns[n], matches=(None, "paged_decode_tile_kernel"))[0])
        same = torch.equal(fns["parent"](0), fns["base"](0))
        parts = []
        for n, fn in fns.items():
            elem, rel = cs.decode_agreement(fn(0), ref)
            parts.append(f"{n} {' / '.join(f'{a:.6f}' for a, _ in times[n])} ms (main kernel "
                         f"{' / '.join(f'{b:.6f}' for _, b in times[n])}; agreement "
                         f"{elem:.4f} x, {rel:.6f})")
        print(f"{label}, parent source against this one: " + "; ".join(parts)
              + f"; outputs bitwise equal: {same} | {card}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_decode_tile_trial: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    parent = None
    if "--parent" in args:
        k = args.index("--parent")
        parent = Path(args[k + 1])
        del args[k:k + 2]
    names = args[0].split(",") if args else [
        "base", "fewwarps", "dequantloop", "nosync", "nodequant", "fp8steps"]
    card = cs.card_label()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(names, Path(tmp))
        probe(libs, card)
        time_variants(libs, card)
        if parent is not None:
            so = Path(tmp) / "parent.so"
            subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
                            str(so), str(parent)], check=True, capture_output=True)
            lib = ctypes.CDLL(str(so))
            lib.paged_decode_tile.restype = ctypes.c_int
            lib.paged_decode_tile.argtypes = (
                [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
            time_parent(libs["base"], lib, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
