#!/usr/bin/env python3
"""The LoRA, GPT-NeoX / CodeGen, BERT and Mllama phases of chip_smoke.py
alone, and K1-K4's head-dim-96 instances.

    python3 chip_trials/families_trial.py [lora] [neox] [bert] [mllama] [neox20b] [d96]
    # from the repository root

Runs the named phase groups (the first three by default):
``run_lora_train_phase`` and ``run_lora_serve_phase``,
``run_neox_train_phase`` and ``run_neox_serve_phase``,
``run_bert_train_phase``, ``run_mllama_serve_phase`` and
``run_mllama_train_phase``; ``neox20b``: the gpt-neox-20b train and serve
phases (``run_neox_train_phase`` on it, ``run_neox20b_serve_phase``) and
the packed D 96 flash case; ``d96``: :func:`d96_kernels`, K4's D 96
instances at the GQA groups the 20b serve does not reach. The kernels are
built, and ptxas's register and spill lines printed, when a group other
than ``mllama`` is asked for (the Mllama path runs none), and Llama-3.2 1B
is served eagerly once on Serve's prompts for ``lora`` (the streams the
B = 0 LoRA merge must serve). A failed check is printed and counted instead
of ending the run, so one call reads every phase's numbers; the last line
counts the failures. About 90 s of command time on one H100 for the first
three groups, the build included, and about 60 s for ``mllama``.
"""

from __future__ import annotations

import itertools
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

FAILS: list = []


def check(cond: bool, msg: str) -> None:
    if not cond:
        FAILS.append(msg)
        print("CHECK FAILED:", msg, flush=True)


#: (q heads, kv heads) of the D 96 kernel check: G 1 (gpt-neox-20b's, t1's
#: group padded to 4 rows), G 4 and G 8 (t1's two group instances)
D96_HEADS = ((64, 64), (32, 8), (64, 8))
#: pools and modes: bf16; int8, fp8 e4m3 and e5m2 in modes 3 and 6
D96_POOLS = (("bf16", False),) + tuple(
    itertools.product(("int8", "fp8_e4m3", "fp8_e5m2"), (False, True)))


def d96_kernels(card: str) -> None:
    """K4 at head dim 96 against its plain version (``decode_agreement``,
    the kernel phases' limits) at every D96_HEADS group and D96_POOLS pool,
    on 4 lanes over a 512-row table: t = 1 (paged_decode_t1.cu), t = 8
    (paged_decode_tile.cu, alone and with row_live and chain tree_bits:
    modes 4 and 5) and t = 40 (paged_decode.cu at G 4 and 8; the tile source
    at G 1), each on the source the route picks, which must have launched."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa
    from neuronx_distributed_llama3_2_tpu_torch.quantization import kv_cache as kv

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    worst = (0.0, 0.0)
    n_cases = 0
    for (n, nkv), (pool, mxu), t in itertools.product(D96_HEADS, D96_POOLS, (1, 8, 40)):
        c = cs.DecodeCase(f"d96 n{n}/{nkv} t{t}", n, nkv, 96, t, 512, None,
                          np.asarray([0, 17, 200, 512 - t]), layers=1)
        q, kp, vp, tables, pos = cs.build_case(c, gen)
        kw = dict(kv_limit=512, quant_mxu=mxu)
        if pool != "bf16":
            qdt = kv.kv_cache_torch_dtype(pool)
            kp, ks = kv.kv_quantize(kp, qdt)
            vp, vs = kv.kv_quantize(vp, qdt)
            kw.update(k_scale=ks[0], v_scale=vs[0])
        extras = [{}]
        if t == 8:
            live = torch.as_tensor([8, 3, 1, 5], dtype=torch.int32, device="cuda")
            chain = torch.as_tensor([[(1 << (j + 1)) - 1 for j in range(t)]] * 4,
                                    dtype=torch.int32, device="cuda")
            extras += [dict(row_live=live), dict(tree_bits=chain),
                       dict(row_live=live, tree_bits=chain)]
        src = cs.k4_source(pool, t, n, nkv, 96)
        for extra in extras:
            before = cs.k4_counts()[src]
            out = pa.paged_flash_decode(q, kp[0], vp[0], tables, pos, **kw, **extra)
            check(cs.k4_counts()[src] == before + 1, f"{c.name} {pool}: not on {src}")
            ref = pa.paged_flash_decode_reference(q, kp[0], vp[0], tables, pos, **kw, **extra)
            torch.cuda.synchronize()
            elem, rel = cs.decode_agreement(out, ref)
            n_cases += 1
            worst = (max(worst[0], elem), max(worst[1], rel))
            ok = bool(torch.isfinite(out).all()) and elem <= 1.0 and rel <= cs.LANE_REL_L2
            check(ok, f"{c.name} {cs.mode_label(pool, mxu)} {sorted(extra)} on {src}: "
                      f"{elem:.6g} x the element limit, lane relative L2 {rel:.6g}")
    cs.log(f"d96 kernels: {n_cases} K4 calls at D 96 against the plain version, worst "
           f"{worst[0]:.6g} x the element limit, lane relative L2 {worst[1]:.6g} (limits 1, "
           f"{cs.LANE_REL_L2}) | {card}")


def main() -> int:
    from neuronx_distributed_llama3_2_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("families_trial: no CUDA device", file=sys.stderr)
        return 2
    cs.check = check
    t_start = time.perf_counter()
    card = cs.card_label()
    cs.log(card)
    groups = sys.argv[1:] or ["lora", "neox", "bert"]
    if set(groups) - {"mllama"}:
        t0 = time.perf_counter()
        built = _build.build()
        cs.log(f"build {time.perf_counter() - t0:.3f} s "
               f"({', '.join(f'{r.name} {r.seconds:.3f} s' for r in built.values())})")
        for r in built.values():
            for line in r.ptxas.splitlines():
                if "registers" in line or "spill" in line or "C7520" in line:
                    cs.log(f"  {r.name}: {line.strip()}")
    if "lora" in groups:
        cfg, model = cs.load_model()
        prompts = cs.serve_prompts()
        server = cs.make_server(cfg, model)
        rids = [server.submit(p) for p in prompts]
        outs = server.run_to_completion()
        del server, model
        torch.cuda.empty_cache()
    for name in groups:
        try:
            if name == "lora":
                lora = cs.timed("lora train", cs.run_lora_train_phase, card)
                cs.timed("lora serve", cs.run_lora_serve_phase, lora,
                         [outs[r] for r in rids], card)
                lora["lora"].detach()
                del lora
            elif name == "neox":
                cs.timed("neox train", cs.run_neox_train_phase, card)
                cs.timed("neox serve", cs.run_neox_serve_phase, card)
            elif name == "bert":
                cs.timed("bert train", cs.run_bert_train_phase, card)
            elif name == "mllama":
                cs.timed("mllama serve", cs.run_mllama_serve_phase, card)
                cs.timed("mllama train", cs.run_mllama_train_phase, card)
            elif name == "neox20b":
                cs.timed("neox20b train", cs.run_neox_train_phase, card, "gpt-neox-20b",
                         cs.NEOX20B_FLASH_CASES, "neox20b train")
                cs.timed("neox20b serve", cs.run_neox20b_serve_phase, card)
                cs.timed("flash kernels packed D 96", cs.run_flash_kernel_phase, card,
                         packed=True, cases=cs.PACKED_CASES[-1:])
            elif name == "d96":
                cs.timed("d96 kernels", d96_kernels, card)
            else:
                raise ValueError(f"unknown phase group {name!r}")
        except Exception:
            traceback.print_exc()
            FAILS.append(f"{name}: exception")
        torch.cuda.empty_cache()
    cs.log(f"families_trial: {time.perf_counter() - t_start:.3f} s, {len(FAILS)} failed checks: "
           f"{FAILS}")
    return 1 if FAILS else 0


if __name__ == "__main__":
    sys.exit(main())
