#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card, end to end.

    python3 chip_smoke.py            # from the repository root

1. Device: prints the card's name and power limit (nvidia-smi).
2. Build: compiles every CUDA source of the port with nvcc for sm_90a.
3. Serve: Llama-3.2 1B at full width (seeded random bf16 weights) behind
   the paged serving engine with the paged-decode kernel on; the kernel
   launch counters are zeroed just before and read just after, and every
   distinct geometry the model gives the kernel is recorded.
4. End to end: teacher-forced check of the served tokens against the plain
   full-sequence forward on the card, which must also reject a serve
   through a planted kernel fault.
5. Kernels: runs each kernel on the card at a grid of shapes and at every
   geometry the serve launched, against its plain PyTorch version, with
   the tolerance stated, and times the kernel, the plain version and one
   PyTorch library call computing the same function (a yardstick the port
   never calls), beside the bound the card could reach.

Every failure exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the per-kernel
JSON record. Without a CUDA card, or outside the repository, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

SEED = 0
# H100 SXM published peaks (NVIDIA data sheet), for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# kernel vs plain version: both read bf16 operands and accumulate in fp32
# but sum in another order, the kernel rounds the softmax weights to bf16
# before p.V, and both round the output to bf16 on their own; so they may
# differ by KERNEL_ULPS bf16 ulps of the largest output
KERNEL_ULPS = 2
# end-to-end: an engine token must be the plain forward's argmax or within
# this many logits of it. Both paths run bf16 through 16 layers with
# different shapes (bucket-padded prefill, the paged kernel, T=1 decode vs
# one full-sequence pass), so their bf16 roundings differ. On an H100 the
# sound serve reads a worst gap of 2^-5 (one bf16 ulp at a logit of 4) and
# the planted fault of run_e2e_phase reads 1.3; the margin is twice the
# sound reading, and run_e2e_phase fails unless the fault lands above it
LOGIT_MARGIN = 0.0625


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*parts) -> None:
    print(*parts, flush=True)


# -- 1. device ------------------------------------------------------------------

def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi reported no card")
    return out[0].strip()


# -- 5. kernels -------------------------------------------------------------------

def bf16_tolerance(ref: torch.Tensor) -> float:
    """KERNEL_ULPS bf16 ulps (8 significant bits) at the largest |ref|."""
    top = ref.float().abs().max().item()
    return KERNEL_ULPS * 2.0 ** (np.floor(np.log2(max(top, 2.0 ** -126))) - 7)


def device_ms(fn, iters: int = 50, windows: int = 3):
    """(device ms, wall ms) per call of ``fn(i)``, each the median over
    ``windows`` runs of ``iters`` calls after three warm-up calls. Device
    time is the summed duration of every CUDA kernel the calls launched
    (torch.profiler, CUPTI); a window whose trace holds fewer kernels than
    the fullest one lost records and is left out. Wall time is CUDA events
    around the run, which includes the host's launch overhead whenever the
    host is the slower side."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    runs = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            start.record()
            for i in range(iters):
                fn(i)
            end.record()
            torch.cuda.synchronize()
        events = prof.key_averages()
        runs.append((
            sum(e.count for e in events if e.self_device_time_total > 0),
            sum(e.self_device_time_total for e in events) / 1e3 / iters,
            start.elapsed_time(end) / iters,
        ))
    full = max(r[0] for r in runs)
    check(full > 0, "the profiler recorded no device time")
    dev = [r[1] for r in runs if r[0] == full]
    return float(np.median(dev)), float(np.median([r[2] for r in runs]))


@dataclasses.dataclass
class DecodeCase:
    name: str
    n: int
    nkv: int
    d: int
    t: int
    kv_limit: int
    splits: Optional[int]  # None: the wrapper's default, as the model calls it
    positions: np.ndarray  # (b,) first fresh row per lane
    bs: int = 16
    layers: int = 16  # pool depth; timed calls walk the layers, as decode does
    table_width: Optional[int] = None  # W; None = kv_limit // bs
    serve_launches: int = 0  # launches at this geometry in the counted serve


# -- the serve's launch geometries -------------------------------------------

@contextlib.contextmanager
def model_kernel_call(wrap):
    """Route the model's paged-decode calls through ``wrap(inner, *args,
    **kwargs)`` while the block runs (the model looks the wrapper up in its
    module at each call). The kernel's own launch counter is untouched."""
    import neuronx_distributed_llama3_2_tpu_torch.inference.model as im

    inner = im.paged_flash_decode
    im.paged_flash_decode = functools.partial(wrap, inner)
    try:
        yield
    finally:
        im.paged_flash_decode = inner


def recording(geometries: dict, keep_positions: bool):
    """A ``model_kernel_call`` wrapper that counts the calls at each
    distinct (b, t, kv_limit, num_splits, W) and, if asked, keeps the
    positions of the last call at each (a host sync per call)."""
    def wrap(inner, q, k_pool, v_pool, tables, positions, **kw):
        key = (
            q.shape[0], 1 if q.dim() == 3 else q.shape[1], kw.get("kv_limit"),
            kw.get("num_splits"), tables.shape[1],
        )
        entry = geometries.setdefault(key, {"calls": 0, "positions": None})
        entry["calls"] += 1
        if keep_positions:
            entry["positions"] = positions.tolist()
        return inner(q, k_pool, v_pool, tables, positions, **kw)
    return wrap


def paged_cases(cfg, served: dict):
    """The fixed grid of shapes, then one case for each geometry the
    counted serve gave the kernel, at the positions of its last call."""
    rng = np.random.default_rng(SEED)
    cases = []
    for kv_limit in (512, 2048):
        for t in (1, 4):
            pos = rng.integers(0, kv_limit - t + 1, size=8)
            pos[0], pos[-1] = 0, kv_limit - t  # first row, last row
            for splits in (1, 4):
                cases.append(DecodeCase(
                    f"1b kv{kv_limit} t{t} s{splits}", 32, 8, 64, t, kv_limit,
                    splits, pos,
                ))
    cases.append(DecodeCase(
        "3b kv2048 t4 s4", 24, 8, 128, 4, 2048, 4,
        rng.integers(0, 2048 - 4 + 1, size=8),
    ))
    for (b, t, kv_limit, splits, w), entry in sorted(served.items()):
        cases.append(DecodeCase(
            f"serve b{b} t{t} kv{kv_limit}", cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, t, kv_limit, splits, np.asarray(entry["positions"]),
            table_width=w, serve_launches=entry["calls"],
        ))
    return cases


def build_case(c: DecodeCase, gen: torch.Generator):
    """q, a shuffled block table with null-block (id 0) entries past each
    lane's frontier, and an L-layer bf16 pool on the card."""
    b = len(c.positions)
    w = c.table_width or c.kv_limit // c.bs
    nb = b * w + 1
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tables = perm[: b * w].reshape(b, w).to(torch.int32)
    for i, p in enumerate(c.positions):
        tables[i, (int(p) + c.t - 1) // c.bs + 1:] = 0
    shape = (c.layers, nb, c.bs, c.nkv, c.d)
    kp = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    q = torch.randn((b, c.t, c.n, c.d), generator=gen, device="cuda", dtype=torch.bfloat16)
    pos = torch.as_tensor(c.positions, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables.contiguous(), pos


def paged_bound(c: DecodeCase):
    """Least time for this call's work: each input byte read once (q, the
    K/V rows 0 .. pos + t - 1 of every lane, the table entries of the
    blocks holding them, positions), each output byte written once;
    operations are the q.k and p.V products over the rows each lane's
    queries can see."""
    b = len(c.positions)
    rows = [min(int(p) + c.t, c.kv_limit) for p in c.positions]
    kv_bytes = 2 * sum(rows) * c.nkv * c.d * 2
    blocks = [-(-r // c.bs) for r in rows]
    io_bytes = 2 * (b * c.t * c.n * c.d * 2) + 4 * sum(blocks) + 4 * b
    seen = sum(int(p) + ti + 1 for p in c.positions for ti in range(c.t))
    flops = 4 * seen * c.n * c.d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), kv_bytes


def run_paged_kernel_phase(cfg, served: dict, card: str) -> dict:
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst, record, record_launches = 0.0, None, -1
    for c in paged_cases(cfg, served):
        q, kp, vp, tables, pos = build_case(c, gen)
        L = c.layers

        def kernel(i):
            return pa.paged_flash_decode(
                q, kp[i % L], vp[i % L], tables, pos, kv_limit=c.kv_limit,
                num_splits=c.splits,
            )

        def plain(i):
            return pa.paged_flash_decode_reference(
                q, kp[i % L], vp[i % L], tables, pos, kv_limit=c.kv_limit,
            )

        out, ref = kernel(0), plain(0)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = bf16_tolerance(ref)
        check(bool(torch.isfinite(out).all()), f"{c.name}: non-finite kernel output")
        check(err <= tol, f"{c.name}: max_abs_err {err} > {tol}")
        worst = max(worst, err)

        # the yardstick: one library call over K/V gathered beforehand
        # (gather excluded from its time), same mask
        b, nblk = len(c.positions), c.kv_limit // c.bs
        blocks = tables[:, :nblk].long()
        k_all = kp[:, blocks].reshape(L, b, c.kv_limit, c.nkv, c.d).transpose(2, 3).contiguous()
        v_all = vp[:, blocks].reshape(L, b, c.kv_limit, c.nkv, c.d).transpose(2, 3).contiguous()
        rows = torch.arange(c.kv_limit, device="cuda")
        last = pos.long()[:, None] + torch.arange(c.t, device="cuda")[None, :]
        mask = (rows[None, None, :] <= last[:, :, None])[:, None]  # (b, 1, t, S)
        qh = q.transpose(1, 2).contiguous()

        def library(i):
            return torch.nn.functional.scaled_dot_product_attention(
                qh, k_all[i % L], v_all[i % L], attn_mask=mask, enable_gqa=True,
            )

        lib_err = (library(0).transpose(1, 2).float() - ref.float()).abs().max().item()
        check(lib_err <= tol, f"{c.name}: library yardstick disagrees ({lib_err})")
        ms, wall_ms = device_ms(kernel)
        plain_ms, plain_wall_ms = device_ms(plain)
        library_ms, library_wall_ms = device_ms(library)
        bound_ms, bound_by, kv_bytes = paged_bound(c)
        splits = min(c.splits or pa.DEFAULT_NUM_SPLITS, nblk)
        served_by = f", {c.serve_launches} serve launches" if c.serve_launches else ""
        log(
            f"kernel paged_decode [{c.name}] b={b} N={c.n} NKV={c.nkv} D={c.d} "
            f"t={c.t} kv_limit={c.kv_limit} splits={splits} positions="
            f"{list(map(int, c.positions))}{served_by}: max_abs_err={err:.6g} "
            f"(tol {tol:.6g}) kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} "
            f"library_ms={library_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}; "
            f"K+V bytes read {kv_bytes} / 3.35 TB/s); wall per call {wall_ms:.6f} / "
            f"{plain_wall_ms:.6f} / {library_wall_ms:.6f} ms | {card}"
        )
        # the JSON record times the geometry the serve launched most
        if c.serve_launches > record_launches:
            record_launches = c.serve_launches
            record = dict(
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
            )
        del q, kp, vp, k_all, v_all
    torch.cuda.empty_cache()
    log(
        f"paged_decode: every case within {KERNEL_ULPS} bf16 ulps of its largest "
        f"output of the plain version (worst abs err {worst:.6g}); tolerance: "
        "bf16 operands and outputs, fp32 accumulation in another order, "
        "bf16-rounded softmax weights"
    )
    record["max_abs_err"] = worst
    return record


# -- 3. serve -------------------------------------------------------------------

def serve_prompts():
    """Eight greedy prompts, 20 to 700 tokens; two share a 256-token prefix
    and differ by suffixes of 5 and 8 tokens."""
    rng = np.random.default_rng(SEED + 1)
    vocab = 128256
    shared = rng.integers(0, vocab, size=256).tolist()
    lengths = (23, 700, 130, None, None, 511, 64, 333)
    prompts = []
    for i, n in enumerate(lengths):
        if n is None:
            prompts.append(shared + rng.integers(0, vocab, size=5 if i == 3 else 8).tolist())
        else:
            prompts.append(rng.integers(0, vocab, size=n).tolist())
    return prompts


MAX_NEW = 32


def load_model():
    """Llama-3.2 1B at full width, bf16, seeded random weights, on the card."""
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
        LLAMA_CONFIGS,
        LlamaForCausalLM,
    )

    cfg = dataclasses.replace(LLAMA_CONFIGS["llama3.2-1b"], use_paged_kernel=True)
    check(cfg.dtype == torch.bfloat16 and cfg.hidden_size == 2048, "not the 1B config")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda").init_weights(SEED)
    torch.cuda.synchronize()
    log(f"serve: llama3.2-1b, {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"vocab {cfg.vocab_size}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
        f"head_dim {cfg.head_dim}, rope_scaling {cfg.rope_scaling}, bf16, "
        f"seeded random weights ({time.perf_counter() - t0:.3f} s to init)")
    return cfg, model


def make_server(cfg, model):
    """The paged engine as served here: 8 lanes, 2048-token sequences, a
    2049-block pool of 16-row blocks (block 0 the null block)."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
        GenerationConfig,
        InferenceEngine,
    )
    from neuronx_distributed_llama3_2_tpu_torch.serving.engine import (
        PagedConfig,
        PagedServingEngine,
    )

    engine = InferenceEngine(cfg, model, max_batch=8, max_seq_len=2048)
    paged = PagedConfig(
        block_size=16, num_blocks=2049,
        # small rungs let a short suffix prefill ride the kernel (t <= 8)
        prefill_buckets=(8, 16, 32, 64, 128, 256, 512, 1024, 2048),
    )
    return PagedServingEngine(engine, GenerationConfig(max_new_tokens=MAX_NEW), paged)


def run_serve_phase(cfg, model, card: str):
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    prompts = serve_prompts()
    # warm-up: the same requests on a server of their own, so that library
    # handles, matmul algorithm choices for every prefill rung and the
    # allocator's pools are set up outside the timed and counted run, and
    # the timed server starts with an empty prefix cache. The warm-up also
    # keeps the positions of each kernel geometry's last call: it is the
    # same serve, and reading positions back costs a sync per call that
    # the timed run should not pay
    warm_geoms: dict = {}
    with model_kernel_call(recording(warm_geoms, keep_positions=True)):
        warm = make_server(cfg, model)
        for p in prompts:
            warm.submit(p)
        warm.run_to_completion()
    del warm

    server = make_server(cfg, model)
    geoms: dict = {}
    with model_kernel_call(recording(geoms, keep_positions=False)):
        pa.launches.reset()
        server.model.attention_paths.clear()
        steps0 = server.metrics.decode_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [server.submit(p) for p in prompts]
        outs = server.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pa.launches.count
    paths = dict(server.model.attention_paths)
    decode_steps = server.metrics.decode_steps - steps0

    infos = [server.request_info(r) for r in rids]
    for r, info in zip(rids, infos):
        check(info["status"] == "finished", f"request {r} is {info['status']}")
        check(len(outs[r]) == MAX_NEW, f"request {r} produced {len(outs[r])} tokens")
    check(infos[4]["cached_tokens"] >= 256, f"prefix pair not shared: {infos[4]}")
    check(launches >= decode_steps * cfg.num_layers,
          f"{launches} kernel launches for {decode_steps} decode steps")
    check(paths.get("kernel", 0) == launches and not paths.get("gather"),
          f"attention paths {paths} vs {launches} kernel launches")
    check(sum(e["calls"] for e in geoms.values()) == launches,
          f"kernel geometries {geoms} vs {launches} launches")
    check({k: e["calls"] for k, e in geoms.items()}
          == {k: e["calls"] for k, e in warm_geoms.items()},
          f"the warm-up's kernel geometries {warm_geoms} differ from the serve's {geoms}")
    served = {k: dict(calls=e["calls"], positions=warm_geoms[k]["positions"])
              for k, e in geoms.items()}
    generated = sum(len(outs[r]) for r in rids)
    ttft = np.median([i["ttft_ms"] for i in infos])
    tpot = np.median([i["tpot_ms"] for i in infos])
    log(f"serve: {len(rids)} requests, {generated} tokens in {wall:.6f} s = "
        f"{generated / wall:.6f} tokens/s; TTFT p50 {ttft:.6f} ms, TPOT p50 "
        f"{tpot:.6f} ms; cached_tokens {[i['cached_tokens'] for i in infos]}; "
        f"{decode_steps} decode steps | {card}")
    log(f"serve: paged_decode kernel launches {launches}; attention calls by "
        f"path {paths} (context = whole-prompt prefill in plain torch, kernel = "
        f"paged-decode kernel, gather = block-table gather + plain torch) | {card}")
    for (b, t, kv_limit, splits, w), e in sorted(served.items()):
        log(f"serve: kernel geometry b={b} t={t} kv_limit={kv_limit} "
            f"num_splits={splits} W={w}: {e['calls']} launches")
    return prompts, outs, rids, launches, served


def run_profile_phase(cfg, model, prompts, card: str) -> None:
    """The same requests once more on a fresh pool, under torch.profiler:
    the share of the wall time the card was busy, and the kernels that
    took it."""
    server = make_server(cfg, model)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in prompts:
            server.submit(p)
        server.run_to_completion()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = sorted(
        prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True,
    )
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    paged_ms = sum(
        e.self_device_time_total for e in events if "paged_decode" in e.key
    ) / 1e3
    log(f"profile: serve wall {wall_ms:.6f} ms (profiler on), device busy "
        f"{busy_ms:.6f} ms = {100 * busy_ms / wall_ms:.6f}% of it; paged_decode "
        f"kernels {paged_ms:.6f} ms = {100 * paged_ms / busy_ms:.6f}% of device "
        f"time; {server.metrics.decode_steps} decode steps | {card}")
    for e in events[:12]:
        log(f"  device {e.self_device_time_total / 1e3:.6f} ms, {e.count} calls: "
            f"{e.key[:100]}")


# -- 4. end to end --------------------------------------------------------------

E2E_PICKS = (0, 4)  # the shortest prompt, and the suffix after the prefix hit


def e2e_gaps(model, prompts, outs, rids):
    """Teacher-forced over the E2E_PICKS requests: the plain full-sequence
    forward on prompt + served tokens. Returns the largest gap between the
    argmax logit and the served token's logit, and how many of the served
    tokens were the argmax, of how many."""
    worst_gap, exact, total = 0.0, 0, 0
    for j in E2E_PICKS:
        prompt, gen = prompts[j], outs[rids[j]]
        ids = torch.as_tensor([prompt + gen[:-1]], device="cuda")
        logits = model(ids)[0, len(prompt) - 1:].float()  # predicts gen[0..]
        check(bool(torch.isfinite(logits).all()), "non-finite plain logits")
        tokens = torch.as_tensor(gen, device="cuda")
        chosen = logits[torch.arange(len(gen), device="cuda"), tokens]
        worst_gap = max(worst_gap, (logits.max(dim=-1).values - chosen).max().item())
        exact += int((logits.argmax(dim=-1) == tokens).sum())
        total += len(gen)
    return worst_gap, exact, total


def run_e2e_phase(cfg, model, prompts, outs, rids) -> None:
    """The served tokens must be the plain forward's argmax or within
    LOGIT_MARGIN of it; and the same check must reject a serve through a
    planted kernel fault (the newest visible row of every query masked
    off: at decode, the token's own K/V), or it could not tell a wrong
    kernel from a right one."""
    gap, exact, total = e2e_gaps(model, prompts, outs, rids)
    check(gap <= LOGIT_MARGIN, f"a served token is {gap} below the argmax logit")
    log(f"e2e: {exact}/{total} served tokens are the plain forward's argmax; "
        f"worst logit gap {gap:.6g} (margin {LOGIT_MARGIN})")

    def newest_row_dropped(inner, q, k_pool, v_pool, tables, positions, **kw):
        return inner(q, k_pool, v_pool, tables, (positions - 1).clamp_min(0), **kw)

    with model_kernel_call(newest_row_dropped):
        server = make_server(cfg, model)
        bad_rids = [server.submit(p) for p in prompts]
        bad_outs = server.run_to_completion()
    bad_gap, bad_exact, _ = e2e_gaps(model, prompts, bad_outs, bad_rids)
    log(f"e2e planted fault (newest row masked off in every kernel call): "
        f"{bad_exact}/{total} served tokens are the plain forward's argmax; "
        f"worst logit gap {bad_gap:.6g} (margin {LOGIT_MARGIN})")
    check(bad_gap > LOGIT_MARGIN,
          f"the e2e check passes a planted kernel fault (gap {bad_gap})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    from neuronx_distributed_llama3_2_tpu_torch.kernels import _build

    torch.manual_seed(SEED)
    card = card_label()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {len(built)} CUDA sources in {time.perf_counter() - t0:.3f} s "
        f"({', '.join(f'{r.name} {r.seconds:.3f} s' for r in built.values())})")
    for r in built.values():
        for line in r.ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {r.name}: {line.strip()}")

    cfg, model = load_model()
    prompts, outs, rids, launches, served = run_serve_phase(cfg, model, card)
    run_e2e_phase(cfg, model, prompts, outs, rids)
    run_profile_phase(cfg, model, prompts, card)
    del model
    torch.cuda.empty_cache()
    paged = run_paged_kernel_phase(cfg, served, card)

    kernels = [dict(
        name="paged_decode", route="cuda",
        source="neuronx_distributed_llama3_2_tpu_torch/kernels/csrc/paged_decode.cu",
        replaces="neuronx_distributed_llama3_2_tpu/kernels/paged_attention_pallas.py:419",
        launches=launches, max_abs_err=paged["max_abs_err"], ms=paged["ms"],
        plain_ms=paged["plain_ms"], bound_ms=paged["bound_ms"],
        bound_by=paged["bound_by"], library_ms=paged["library_ms"],
    )]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
