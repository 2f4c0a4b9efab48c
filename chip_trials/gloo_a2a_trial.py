#!/usr/bin/env python3
"""Whether gloo's all-to-all carries CUDA tensors, on one card, and how fast.

    python3 chip_trials/gloo_a2a_trial.py   # from the repository root

Two ranks on the card over gloo (``parallel/multihost.spawn_gloo_ranks``,
as chip_smoke.py's two-rank phases run) each send half of an expert
dispatch buffer to the other rank, the expert-parallel all-to-all of the
MoE layer (``parallel/mappings.py`` ``all_to_all_ep``), by each transport:

- ``a2a``: ``dist.all_to_all_single`` on the tensor where it lies;
- ``host_a2a``: the CUDA tensor copied to a host buffer, the host buffers
  exchanged by ``dist.all_to_all_single``, the result copied back (what
  ``ep_transport`` "host_all_to_all" does).

Each (transport, device, dtype, size) runs in a process of its own under a
time limit, so that a transport that faults or hangs ends only that
process. A transport passes when every block received equals what its
sender put there, bit for bit; its median ms over 5 exchanges is printed
beside it (the host's clock around a synchronised exchange).

The sizes: an (E, C, H) bf16 dispatch buffer of Mixtral 8x7B (E 8, H 4096)
at C 128, 512 and 2048 slots an expert: 8, 32 and 134 MB.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, H = 8, 4096
CASES = (("a2a", "cuda", "bfloat16", 128), ("a2a", "cuda", "float32", 128),
         ("a2a", "cpu", "bfloat16", 128), ("host_a2a", "cuda", "bfloat16", 128),
         ("host_a2a", "cuda", "bfloat16", 512), ("host_a2a", "cuda", "bfloat16", 2048),
         ("a2a", "cuda", "bfloat16", 2048))


def exchange(rank: int, nproc: int, transport: str, device: str, dtype_name: str, cap: int):
    import torch
    import torch.distributed as dist

    dtype = getattr(torch, dtype_name)

    def block(src: int) -> torch.Tensor:
        g = torch.Generator().manual_seed(src)
        return torch.randn((E, cap, H), generator=g).to(dtype)

    x = block(rank).to(device)
    # rank r receives the e-th half of every rank's buffer, in rank order
    want = torch.cat([block(src).chunk(nproc)[rank] for src in range(nproc)])

    def once():
        if transport == "host_a2a":
            host = x.to("cpu")
            out = torch.empty_like(host)
            dist.all_to_all_single(out, host)
            return out.to(device)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out

    ms = []
    for _ in range(6):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = once()
        if device == "cuda":
            torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    same = bool(torch.equal(y.cpu(), want))
    return dict(same=same, ms=sorted(ms[1:])[2], mb=x.numel() * x.element_size() / 1e6)


def one_case(transport: str, device: str, dtype_name: str, cap: str) -> int:
    sys.path.insert(0, REPO)
    from neuronx_distributed_llama3_2_tpu_torch.parallel.multihost import spawn_gloo_ranks

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    outs = spawn_gloo_ranks(exchange, 2, transport, device, dtype_name, int(cap), device=device,
                            tmp_dir=os.path.join(REPO, "chiprun_out"))
    print(json.dumps(outs))
    return 0


def main() -> int:
    if len(sys.argv) == 5:
        return one_case(*sys.argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("gloo_a2a_trial: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for transport, device, dtype_name, cap in CASES:
        t0 = time.perf_counter()
        try:
            p = subprocess.run([sys.executable, __file__, transport, device, dtype_name,
                                str(cap)], capture_output=True, text=True, timeout=180)
            rc, out, err = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = "timeout", e.stdout or "", e.stderr or ""
        lines = [ln for ln in str(out).splitlines() if ln.startswith("[")]
        ranks = json.loads(lines[-1]) if rc == 0 and lines else None
        ok = bool(ranks) and all(r["same"] for r in ranks)
        print(json.dumps(dict(transport=transport, device=device, dtype=dtype_name, slots=cap,
                              mb=ranks[0]["mb"] if ranks else None, rc=rc, ok=ok,
                              ms=[r["ms"] for r in ranks] if ranks else None,
                              seconds=round(time.perf_counter() - t0, 3),
                              error=None if ok else str(err).strip().splitlines()[-3:])),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
