#!/usr/bin/env python3
"""The LoRA, GPT-NeoX / CodeGen, BERT and Mllama phases of chip_smoke.py
alone.

    python3 chip_trials/families_trial.py [lora] [neox] [bert] [mllama]   # from the repository root

Runs the named phase groups (the first three by default):
``run_lora_train_phase`` and ``run_lora_serve_phase``,
``run_neox_train_phase`` and ``run_neox_serve_phase``,
``run_bert_train_phase``, ``run_mllama_serve_phase`` and
``run_mllama_train_phase``. The kernels are built when a group other than
``mllama`` is asked for (the Mllama path runs none), and Llama-3.2 1B is
served eagerly once on Serve's prompts for ``lora`` (the streams the B = 0
LoRA merge must serve). A failed check is printed and counted instead of
ending the run, so one call reads every phase's numbers; the last line
counts the failures. About 90 s of command time on one H100 for the first
three groups, the build included, and about 60 s for ``mllama``.
"""

from __future__ import annotations

import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

FAILS: list = []


def check(cond: bool, msg: str) -> None:
    if not cond:
        FAILS.append(msg)
        print("CHECK FAILED:", msg, flush=True)


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
        _build.build()
        cs.log(f"build {time.perf_counter() - t0:.3f} s")
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
