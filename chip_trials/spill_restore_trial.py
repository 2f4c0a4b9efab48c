#!/usr/bin/env python3
"""What a restore from the host tier costs against re-prefilling, on one CUDA card.

    python3 chip_trials/spill_restore_trial.py [--tree DIR] [--reps N] [--tag T]   # from the repository root

Serves chip_smoke.py's spill churn (``spill_prompts``: a 256-token prefix
served once, six fillers that evict it, two re-hits) on Llama-3.2 1B at
full width, ``--reps`` times in each of four configurations, each on a
fresh server: eager with spill on (every restore taken), eager with spill
off (the re-hits re-prefill), and the prewarmed async twin of each. The
spill serves run without chip_smoke's bit-check spy and without the
tracer; ``chip_smoke.restore_breakdown`` clocks each restore's parts on
the host (the drain, the snapshots of the blocks the restore's own
allocations evict with the pinned buffers they take, the uploads).

With ``--tree DIR`` the package is imported from DIR (a ``git archive``
of another commit, whose kernels are built into DIR) and chip_smoke.py
from this checkout; a tree without the pinned-buffer pool still runs
(its pinned-buffer counts read 0). Compare two trees in one call, in
turns (parent, change, change, parent).

Prints each serve's chip_smoke line, then per configuration the first
re-hit's TTFT (ms) over the repetitions and, for the spill serves, the
restore path's effective rate: the restored bytes over the admission's
host-clock ms, its median and range. Writes the rows as JSON to
``chiprun_out/spill_restore_<tag>.json``.
"""
import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO, help="the package's checkout (default: this one)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tag", default="trial")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)

    import torch
    import neuronx_distributed_llama3_2_tpu_torch as pkg
    from neuronx_distributed_llama3_2_tpu_torch.kernels import _build
    from neuronx_distributed_llama3_2_tpu_torch.serving.engine import PagedServingEngine

    if not torch.cuda.is_available():
        print("spill_restore_trial: no CUDA device", file=sys.stderr)
        return 2
    cs.check(pkg.__file__.startswith(tree), f"the package came from {pkg.__file__}")
    if not hasattr(PagedServingEngine, "_pinned_take"):
        # a tree before the pinned-buffer pool: the breakdown's counter
        # wraps this stand-in, which that engine never calls
        PagedServingEngine._pinned_take = lambda self, like: None
        PagedServingEngine._pinned_free = {}
    t0 = time.perf_counter()
    card = cs.card_label()
    cs.log(f"[{args.tag}] package from {tree} | {card}")
    _build.build([n for n in _build.sources() if n.startswith("paged_decode")])
    cfg, model = cs.load_model()
    twin = dict(cs.SPILL_KNOBS, prewarm=True, async_loop=True)
    configs = (
        ("eager", True, cs.SPILL_KNOBS),
        ("eager re-prefill", False, dict(num_blocks=cs.SPILL_BLOCKS)),
        ("twin", True, twin),
        ("twin re-prefill", False,
         dict(twin, spill_enabled=False, host_tier_bytes=0, restore_crossover=1.0)),
    )
    rows = []
    for rep in range(args.reps):
        for label, spill, knobs in configs:
            r = cs.churn_serve(cfg, model, f"[{args.tag}] {label} #{rep}", spy=False,
                               breakdown=spill, **knobs)
            if spill:
                cs.check_restored(r)
            rows.append(dict(tag=args.tag, label=label, rep=rep, ttft_ms=r["rehit_ttft"],
                             restore_bytes=r["restore_bytes"], parts=r["parts"],
                             wall_s=r["wall"], card=card))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"spill_restore_{args.tag}.json"), "w") as f:
        json.dump(rows, f, indent=1)
    for label, spill, _ in configs:
        mine = [r for r in rows if r["label"] == label]
        line = (f"[{args.tag}] {label}: the first re-hit's TTFT ms "
                f"{sorted(r['ttft_ms'] for r in mine)}")
        if spill:
            rates = sorted(r["restore_bytes"] / r["parts"]["total_ms"] / 1e6 for r in mine)
            line += (f"; the restore path's effective GB/s median "
                     f"{statistics.median(rates):.6f}, range {rates[0]:.6f}-{rates[-1]:.6f}")
        cs.log(f"{line} | {card}")
    cs.log(f"[{args.tag}] done in {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
