"""``chip_smoke.py``'s checks of the flash kernels, on the CPU.

The card runs K1-K3 against their plain versions with ``flash_bound`` and
``flash_agreement``. Here, on plain versions only: the bounds at the train
shape are the ones ``PERF.md`` records; the agreement check passes the
plain forward, and the plain backward's dq, dk and dv, against themselves
at another kv chunking (the kernels' tiles differ from the plain
versions' chunks in the same way); and it rejects both planted faults, one
kv tile left out and the causal diagonal masked with col < row, in o and
in each of dq, dk and dv, at a small causal shape (B 1, N 4, Nkv 2,
S 192, D 64), and at D 96 the check rejects K1's scores without columns
64-95. The packed-document mode (segment ids) the same way: the
ids ``packed_segments`` makes have the boundaries, lengths and repeated
ids the card's cases need, the bound counts only the attended pairs, and
both planted segment faults (a boundary moved by one row; the segment
compare only on the tiles the causal or edge mask crosses) read above the
limits in o, dq, dk and dv.
"""

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from neuronx_distributed_llama3_2_tpu_torch import flops as cs_flops  # noqa: E402
from neuronx_distributed_llama3_2_tpu_torch.kernels import flash_attention as fa  # noqa: E402

B, N, NKV, S, D = 1, 4, 2, 192, 64
SCALE = D ** -0.5


@pytest.mark.parametrize("kernel, ms", [(1, 0.208553), (2, 0.312830), (3, 0.417106)])
def test_flash_bound_at_train_shape(kernel, ms):
    bound, by = cs.flash_bound(12, 32, 8, 2048, 64, True, kernel)
    assert round(bound, 6) == ms
    assert by == "operations"


@pytest.mark.parametrize("kernel, ms", [(1, 0.104277), (2, 0.156415), (3, 0.208553)])
def test_flash_bound_at_the_neox20b_train_shape(kernel, ms):
    """gpt-neox-20b's step: B 2, 64 / 64 heads, S 2048, D 96, causal."""
    bound, by = cs.flash_bound(2, 64, 64, 2048, 96, True, kernel)
    assert round(bound, 6) == ms
    assert by == "operations"


def _inputs(d=D):
    rng = np.random.default_rng(0)

    def draw(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(torch.bfloat16)

    return draw(B, N, S, d), draw(B, NKV, S, d), draw(B, NKV, S, d), draw(B, N, S, d)


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


def test_agreement_rejects_scores_without_columns_64_to_95():
    """The D 96 checks' planted fault: K1's scores from K's first 64 columns
    alone (``columns_left_out``), at D 96; the sound forward at another
    chunking passes."""
    q, k, v, _ = _inputs(96)
    scale = 96 ** -0.5
    out = fa.flash_fwd_reference(q, k, v, None, True, scale, block_kv=64)[0]
    ref = fa.flash_fwd_reference(q, k, v, None, True, scale, block_kv=1024)[0]
    elem, rel = cs.flash_agreement(out, ref)
    assert elem <= 1.0 and rel <= cs.TILE_REL_L2
    cut = cs.columns_left_out(k)
    assert torch.equal(cut[..., :64], k[..., :64]) and not cut[..., 64:].any()
    bad = fa.flash_fwd_reference(q, cut, v, None, True, scale, block_kv=1024)[0]
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


# -- packed documents (segment_ids) ------------------------------------------


def test_packed_segments_have_the_cases_boundaries():
    seg = cs.packed_segments(12, 2048).numpy()
    assert seg.shape == (12, 2048) and seg.dtype == np.int32
    assert np.array_equal(seg, cs.packed_segments(12, 2048).numpy())  # seeded
    row = seg[0]
    starts = [0] + [i for i in range(1, 2048) if row[i] != row[i - 1]]
    lengths = np.diff(starts + [2048])
    assert {64, 127, 128, 158} <= set(starts)      # tile first row, last row, mid-tile
    assert 1 in lengths and lengths.max() > 1024   # one row; longer than 1024
    for r in range(1, 12):
        cuts = [i for i in range(1, 2048) if seg[r, i] != seg[r, i - 1]]
        lengths = np.diff([0] + cuts + [2048])
        assert 1 <= lengths.min() and lengths[:-1].max() <= 1024
    # row 1 takes an id again after another one
    ids = [seg[1, 0]] + [seg[1, i] for i in range(1, 2048) if seg[1, i] != seg[1, i - 1]]
    assert len(ids) >= 3 and ids[0] == ids[2] != ids[1]
    # the unaligned case's rows fit too
    assert cs.packed_segments(2, 1000).shape == (2, 1000)


def test_segmented_flash_bound_counts_attended_pairs():
    ids = torch.tensor([[0, 0, 1, 0], [5, 5, 5, 5]], dtype=torch.int32)
    # id 0 thrice (non-contiguous) and id 1 once; then one id four times
    assert cs.attended_pairs(ids, causal=True) == (6 + 1) + 10
    assert cs.attended_pairs(ids, causal=False) == (9 + 1) + 16
    seg = cs.packed_segments(12, 2048)
    for kernel in (1, 2, 3):
        full, _ = cs.flash_bound(12, 32, 8, 2048, 64, True, kernel)
        packed, by = cs.flash_bound(12, 32, 8, 2048, 64, True, kernel, segment_ids=seg)
        flops = (2 + 2 * kernel) * 64 * 32 * cs.attended_pairs(seg, True)
        t_ops = flops / cs_flops.H100_BF16_FLOPS_PER_S * 1e3
        # few pairs a row attends: the bytes may bound it now
        assert packed == pytest.approx(t_ops) if by == "operations" else packed > t_ops
        assert packed < full


def _packed(block_kv, seg, planted=None):
    """o and (dq, dk, dv) of the plain versions with ``seg``, causal."""
    q, k, v, do = _inputs()
    with planted if planted is not None else contextlib.nullcontext():
        o, lse = fa.flash_fwd_reference(q, k, v, seg, True, SCALE, block_kv=block_kv)
        grads = fa.flash_bwd_reference(q, k, v, o, lse, do, seg, True, SCALE, block_kv=block_kv)
    return dict(zip(("o",) + GRADS, (o,) + tuple(grads)))


@pytest.mark.parametrize("out", ("o",) + GRADS)
def test_agreement_passes_packed_plain_versions_at_another_chunking(out):
    seg = cs.packed_segments(B, S)
    elem, rel = cs.flash_agreement(_packed(64, seg)[out], _packed(1024, seg)[out])
    assert elem <= 1.0 and rel <= cs.TILE_REL_L2


@pytest.mark.parametrize("fault", ["boundary moved", "crossing tiles only"])
@pytest.mark.parametrize("out", ("o",) + GRADS)
def test_agreement_rejects_planted_segment_fault(out, fault):
    seg = cs.packed_segments(B, S)
    got = _packed(64, seg)[out]
    ref = _packed(1024, seg)[out]
    inner = fa._mask
    if fault == "boundary moved":
        bad = _packed(1024, cs.plain_moves_boundary(seg))[out]
    else:
        bad = _packed(1024, seg, cs.plain_segments_on_crossing_tiles_only())[out]
    assert fa._mask is inner
    faulty = (got.float() + bad.float() - ref.float()).to(got.dtype)
    elem, rel = cs.flash_agreement(faulty, ref)
    assert elem > 1.0 or rel > cs.TILE_REL_L2
