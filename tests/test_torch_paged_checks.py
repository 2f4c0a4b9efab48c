"""``chip_smoke.py``'s probe of the quantized paged-decode kernels, on the CPU.

The card holds K4 against its plain version on ``probe_case``'s inputs at
t = 1 (``paged_decode_t1.cu``) and at ``PROBE_TILE_T`` (``paged_decode_tile.cu``),
and the check must reject each planted fault there. Here, on the plain
version only: the route sends each probe to the source it is meant for,
the probe's fresh rows end at ``PROBE_POSITIONS`` under the kv limit, and
``decode_agreement`` rejects both faults (the dequantized values left
unrounded; under quant_mxu, mode 3's arithmetic passed off as mode 6) in
all six quantized combinations at both t.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa  # noqa: E402

CASES = [(kv_dtype, mxu, t) for kv_dtype in ("int8", "fp8_e4m3", "fp8_e5m2")
         for mxu in (False, True) for t in (1, cs.PROBE_TILE_T)]


@pytest.mark.parametrize("kv_dtype,mxu,t", CASES,
                         ids=[f"{d}-mode{6 if m else 3}-t{t}" for d, m, t in CASES])
def test_paged_probe_rejects_its_planted_faults(kv_dtype, mxu, t):
    q, kp, vp, ks, vs, tables, pos = cs.probe_case(kv_dtype, "cpu", t)
    assert q.shape[1] == t
    assert (pos + t - 1).tolist() == list(cs.PROBE_POSITIONS)
    assert max(cs.PROBE_POSITIONS) < cs.PROBE_KV_LIMIT
    want = "t1" if t == 1 else "tile"
    assert pa.kernel_route(kp.dtype, t, q.shape[2] // kp.shape[2], q.shape[3]) == want
    kw = dict(kv_limit=cs.PROBE_KV_LIMIT, k_scale=ks, v_scale=vs)
    ref = pa.paged_flash_decode_reference(q, kp, vp, tables, pos, quant_mxu=mxu, **kw)
    assert bool(torch.isfinite(ref).all())
    assert cs.decode_agreement(ref, ref) == (0.0, 0.0)
    with cs.plain_dequant_unrounded():
        faults = [pa.paged_flash_decode_reference(q, kp, vp, tables, pos, quant_mxu=mxu, **kw)]
    if mxu:
        faults.append(pa.paged_flash_decode_reference(q, kp, vp, tables, pos, **kw))
    for bad in faults:
        elem, rel = cs.decode_agreement(bad, ref)
        assert elem > 1.0 or rel > cs.LANE_REL_L2
