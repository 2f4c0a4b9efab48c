#!/usr/bin/env python3
"""Which transports gloo gives a ring rotation of CUDA tensors, on one card.

    python3 chip_trials/gloo_p2p_trial.py   # from the repository root

Two ranks on the card over gloo (``parallel/multihost.spawn_gloo_ranks``,
as chip_smoke.py's two-rank phases run) each rotate a K/V-chunk-sized
tensor of the context-parallel ring one hop (rank i sends to rank i + 1 and
receives from rank i - 1) by each transport in turn:

- ``send_recv``: ``dist.isend`` / ``dist.irecv`` pairs;
- ``batch_p2p``: ``dist.batch_isend_irecv`` over the same pair;
- ``all_gather``: ``dist.all_gather_into_tensor`` over the two ranks, the
  chunk of rank i - 1 taken from the gathered tensor;

on CUDA tensors (bf16 and fp32) and, for the point-to-point pair, on CPU
tensors. Each (transport, tensor) runs in a process of its own under a
time limit, so that a transport that faults or hangs ends only that
process. A transport passes when the tensor received equals the sender's,
bit for bit; its median ms over 5 rotations is printed beside it (the
host's clock around a synchronised rotation).

The tensor: one of K, V of the Llama-3.2 1B train step at batch 2 over a
contiguous cp = 2 chunk, (2, 8, 1024, 64) (B, Nkv, S / cp, D).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 8, 1024, 64)
CASES = (("send_recv", "cuda", "bfloat16"), ("send_recv", "cuda", "float32"),
         ("batch_p2p", "cuda", "bfloat16"), ("all_gather", "cuda", "bfloat16"),
         ("all_gather", "cuda", "float32"), ("send_recv", "cpu", "bfloat16"),
         ("batch_p2p", "cpu", "float32"), ("all_gather", "cpu", "bfloat16"))


def rotate(rank: int, nproc: int, transport: str, device: str, dtype_name: str):
    import torch
    import torch.distributed as dist

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator().manual_seed(rank)
    x = torch.randn(SHAPE, generator=gen).to(dtype=dtype, device=device)
    want = torch.randn(SHAPE, generator=torch.Generator().manual_seed((rank - 1) % nproc))
    want = want.to(dtype=dtype)
    nxt, prev = (rank + 1) % nproc, (rank - 1) % nproc

    def once():
        if transport == "all_gather":
            out = torch.empty((nproc,) + SHAPE, dtype=dtype, device=device)
            dist.all_gather_into_tensor(out, x.unsqueeze(0))
            return out[prev]
        y = torch.empty_like(x)
        if transport == "batch_p2p":
            ops = [dist.P2POp(dist.isend, x, nxt), dist.P2POp(dist.irecv, y, prev)]
            reqs = dist.batch_isend_irecv(ops)
        else:
            reqs = [dist.isend(x, nxt), dist.irecv(y, prev)]
        for r in reqs:
            r.wait()
        return y

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
    return dict(same=same, ms=sorted(ms[1:])[2])


def one_case(transport: str, device: str, dtype_name: str) -> int:
    sys.path.insert(0, REPO)
    from neuronx_distributed_llama3_2_tpu_torch.parallel.multihost import spawn_gloo_ranks

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    outs = spawn_gloo_ranks(rotate, 2, transport, device, dtype_name, device=device,
                            tmp_dir=os.path.join(REPO, "chiprun_out"))
    print(json.dumps(outs))
    return 0


def main() -> int:
    if len(sys.argv) == 4:
        return one_case(*sys.argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("gloo_p2p_trial: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    rows = []
    for transport, device, dtype_name in CASES:
        t0 = time.perf_counter()
        try:
            p = subprocess.run([sys.executable, __file__, transport, device, dtype_name],
                               capture_output=True, text=True, timeout=120)
            rc, out, err = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = "timeout", e.stdout or "", e.stderr or ""
        lines = [ln for ln in str(out).splitlines() if ln.startswith("[")]
        ranks = json.loads(lines[-1]) if rc == 0 and lines else None
        ok = bool(ranks) and all(r["same"] for r in ranks)
        rows.append(dict(transport=transport, device=device, dtype=dtype_name, rc=rc, ok=ok,
                         ms=[r["ms"] for r in ranks] if ranks else None,
                         seconds=round(time.perf_counter() - t0, 3),
                         error=None if ok else str(err).strip().splitlines()[-3:]))
        print(json.dumps(rows[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
