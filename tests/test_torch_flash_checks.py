"""``chip_smoke.py``'s checks of the flash kernels, on the CPU.

The card runs K1-K3 against their plain versions with ``flash_bound`` and
``flash_agreement``. Here, on plain versions only: the bounds at the train
shape are the ones ``PERF.md`` records; the agreement check passes the
plain forward, and the plain backward's dq, dk and dv, against themselves
at another kv chunking (the kernels' tiles differ from the plain
versions' chunks in the same way); and it rejects both planted faults, one
kv tile left out and the causal diagonal masked with col < row, in o and
in each of dq, dk and dv, at a small causal shape (B 1, N 4, Nkv 2,
S 192, D 64).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from neuronx_distributed_llama3_2_tpu_torch.kernels import flash_attention as fa  # noqa: E402

B, N, NKV, S, D = 1, 4, 2, 192, 64
SCALE = D ** -0.5


@pytest.mark.parametrize("kernel, ms", [(1, 0.208553), (2, 0.312830), (3, 0.417106)])
def test_flash_bound_at_train_shape(kernel, ms):
    bound, by = cs.flash_bound(12, 32, 8, 2048, 64, True, kernel)
    assert round(bound, 6) == ms
    assert by == "operations"


def _inputs():
    rng = np.random.default_rng(0)

    def draw(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(torch.bfloat16)

    return draw(B, N, S, D), draw(B, NKV, S, D), draw(B, NKV, S, D), draw(B, N, S, D)


def _forward(q, k, v, block_kv):
    return fa.flash_fwd_reference(q, k, v, None, True, SCALE, block_kv=block_kv)


def test_agreement_passes_the_plain_forward_at_another_chunking():
    q, k, v, _ = _inputs()
    out, lse = _forward(q, k, v, 64)
    ref, lse_ref = _forward(q, k, v, 1024)
    elem, rel = cs.flash_agreement(out, ref)
    assert elem <= 1.0 and rel <= cs.TILE_REL_L2
    assert (lse - lse_ref).abs().max().item() <= cs.LSE_TOL


@pytest.mark.parametrize("fault", ["tile left out", "diagonal masked"])
def test_agreement_rejects_planted_fault(fault):
    q, k, v, _ = _inputs()
    out = _forward(q, k, v, 64)[0]
    ref = _forward(q, k, v, 1024)[0]
    inner = fa._mask
    planted = (cs.plain_skips_tile((128, 192), (64, 128)) if fault == "tile left out"
               else cs.plain_misses_diagonal())
    with planted:
        bad = _forward(q, k, v, 1024)[0]
    assert fa._mask is inner
    faulty = (out.float() + bad.float() - ref.float()).to(out.dtype)
    elem, rel = cs.flash_agreement(faulty, ref)
    assert elem > 1.0 or rel > cs.TILE_REL_L2


GRADS = ("dq", "dk", "dv")


def _backward(q, k, v, do, block_kv):
    """(dq, dk, dv) of the plain backward, from the plain forward's o and
    lse (the kernels' backward reads the kernel forward's the same way)."""
    o, lse = _forward(q, k, v, 1024)
    return dict(zip(GRADS, fa.flash_bwd_reference(
        q, k, v, o, lse, do, None, True, SCALE, block_kv=block_kv)))


@pytest.mark.parametrize("grad", GRADS)
def test_agreement_passes_the_plain_backward_at_another_chunking(grad):
    q, k, v, do = _inputs()
    out = _backward(q, k, v, do, 64)[grad]
    ref = _backward(q, k, v, do, 1024)[grad]
    elem, rel = cs.flash_agreement(out, ref)
    assert elem <= 1.0 and rel <= cs.TILE_REL_L2


@pytest.mark.parametrize("fault", ["tile left out", "diagonal masked"])
@pytest.mark.parametrize("grad", GRADS)
def test_agreement_rejects_planted_fault_in_the_backward(grad, fault):
    q, k, v, do = _inputs()
    out = _backward(q, k, v, do, 64)[grad]
    ref = _backward(q, k, v, do, 1024)[grad]
    inner = fa._mask
    planted = (cs.plain_skips_tile((128, 192), (64, 128)) if fault == "tile left out"
               else cs.plain_misses_diagonal())
    o, lse = _forward(q, k, v, 1024)
    with planted:
        bad = dict(zip(GRADS, fa.flash_bwd_reference(
            q, k, v, o, lse, do, None, True, SCALE, block_kv=1024)))[grad]
    assert fa._mask is inner
    faulty = (out.float() + bad.float() - ref.float()).to(out.dtype)
    elem, rel = cs.flash_agreement(faulty, ref)
    assert elem > 1.0 or rel > cs.TILE_REL_L2
