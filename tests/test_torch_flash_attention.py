"""The port's flash attention (kernels/flash_attention.py) against the JAX
package's, on the CPU.

On CPU tensors the port runs the plain versions of its CUDA kernels; the
JAX side runs its Pallas kernels in interpret mode, as tests/test_kernels.py
does. Inputs are drawn with numpy from a seed and handed to both. Shapes
are small: S = 200 (not a multiple of the 128 block), D = 64, GQA groups
of 2 and 4, causal and full; and D = 96 (gpt-neox-20b's head dim, which
K1-K3 take in instances of their own on the card) with G 1 and 2, causal
and full, and under segment ids.

Tolerances. fp32: both sides compute the same blockwise algorithm with the
same kv blocks and differ only in summation order, so o and lse agree to
2e-5 and the gradients to 5e-5 (the bounds tests/test_kernels.py holds the
Pallas kernels to). bf16: both round P and dS to bf16 at the same points
and accumulate in fp32; a sum that lands on the other side of a bf16
rounding boundary moves an output by one bf16 ulp, so each bf16 output is
held within 2 bf16 ulps of its largest magnitude, and lse (fp32) to 1e-5.
Such flips are rare: at most 1 % of the bf16 outputs may differ from
JAX's at all (measured: under 0.5 %; a plain version that skips the bf16
rounding of P or dS differs in about 40 %, within 2 ulps all the same).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.kernels import pallas_flash_attention as jpfa
from neuronx_distributed_llama3_2_tpu.kernels.flash_attention import (
    blockwise_attention_stats as jax_blockwise_attention_stats,
    flash_attention_reference as jax_flash_attention_reference,
)
from neuronx_distributed_llama3_2_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)

S, D, BLOCK = 200, 64, 128
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CASES = [(causal, dt, g, D) for causal in (True, False) for dt in DTYPES for g in (2, 4)] + [
    (causal, dt, g, 96) for causal in (True, False) for dt in DTYPES for g in (1, 2)]
CASE_IDS = [f"{'causal' if c else 'full'}-{dt}-G{g}" + ("" if d == D else f"-D{d}")
            for c, dt, g, d in CASES]


def _inputs(g, seed=0, b=1, nkv=2, s=S, d=D):
    """(B, N, S, d) q / do and (B, Nkv, S, d) k / v as fp32 numpy."""
    rng = np.random.default_rng(seed)
    n = nkv * g
    q = rng.standard_normal((b, n, s, d)).astype(np.float32)
    k = rng.standard_normal((b, nkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, nkv, s, d)).astype(np.float32)
    do = rng.standard_normal((b, n, s, d)).astype(np.float32)
    return q, k, v, do


def _j(x, dt):
    return jnp.asarray(x, DTYPES[dt][0])


def _t(x, dt):
    return torch.tensor(np.asarray(x, np.float32)).to(DTYPES[dt][1])


def _close(out, ref, dt, what, fp32_atol):
    out = np.asarray(out.float() if isinstance(out, torch.Tensor) else out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, what
    if dt == "fp32":
        np.testing.assert_allclose(out, ref, atol=fp32_atol, rtol=0, err_msg=what)
    else:
        top = float(np.abs(ref).max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        np.testing.assert_allclose(out, ref, atol=2 * ulp, rtol=0, err_msg=what)
        assert (out != ref).mean() <= 0.01, (what, (out != ref).mean())


@functools.lru_cache(maxsize=None)
def _jax_fwd(causal, dt, g, d):
    q, k, v, _ = _inputs(g, d=d)
    o, lse = jpfa._flash_fwd(
        _j(q, dt), _j(k, dt), _j(v, dt), None, causal, d ** -0.5, BLOCK, BLOCK
    )
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse)


@pytest.mark.parametrize("causal,dt,g,d", CASES, ids=CASE_IDS)
def test_fwd_reference_matches_pallas(causal, dt, g, d):
    q, k, v, _ = _inputs(g, d=d)
    o_ref, lse_ref = _jax_fwd(causal, dt, g, d)
    o, lse = tfa.flash_fwd(
        _t(q, dt), _t(k, dt), _t(v, dt), None, causal, d ** -0.5, BLOCK, BLOCK
    )
    assert o.dtype == DTYPES[dt][1] and lse.dtype == torch.float32
    _close(o, o_ref, dt, "o", 2e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5, rtol=0, err_msg="lse")


@pytest.mark.parametrize("causal,dt,g,d", CASES, ids=CASE_IDS)
def test_bwd_reference_matches_pallas(causal, dt, g, d):
    q, k, v, do = _inputs(g, d=d)
    o_ref, lse_ref = _jax_fwd(causal, dt, g, d)
    # both sides differentiate the same forward: JAX's o, in the input dtype
    o_np = np.asarray(_j(o_ref, dt).astype(jnp.float32))
    refs = jpfa._flash_bwd(
        _j(q, dt), _j(k, dt), _j(v, dt), _j(o_np, dt), jnp.asarray(lse_ref),
        _j(do, dt), None, causal, d ** -0.5, BLOCK, BLOCK,
    )
    outs = tfa.flash_bwd(
        _t(q, dt), _t(k, dt), _t(v, dt), _t(o_np, dt), torch.tensor(lse_ref),
        _t(do, dt), None, causal, d ** -0.5, BLOCK, BLOCK,
    )
    for name, out, ref in zip(("dq", "dk", "dv"), outs, refs):
        assert out.dtype == DTYPES[dt][1], name
        _close(out, np.asarray(ref.astype(jnp.float32)), dt, name, 5e-5)


@pytest.mark.parametrize("causal,d", [(True, D), (False, D), (True, 96)],
                         ids=["causal", "full", "causal-D96"])
def test_autograd_function_matches_jax_grad(causal, d):
    """The port's (B, S, N, D) entry point through its autograd Function
    against jax.grad of the JAX package's pallas_flash_attention (fp32)."""
    q, k, v, do = (x.transpose(0, 2, 1, 3) for x in _inputs(2, seed=1, d=d))

    def jloss(q, k, v):
        o = jpfa.pallas_flash_attention(q, k, v, causal=causal, block_q=BLOCK, block_kv=BLOCK)
        return jnp.sum(o * jnp.asarray(do))

    jo = jpfa.pallas_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=BLOCK, block_kv=BLOCK,
    )
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    to = tfa.pallas_flash_attention(tq, tk, tv, causal=causal, block_q=BLOCK, block_kv=BLOCK)
    (to * torch.as_tensor(do)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=2e-5)
    for name, t, j in zip(("dq", "dk", "dv"), (tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=5e-5, err_msg=name)


SEGMENTS = np.repeat([0, 1, 2], [70, 60, 70])[None, :].astype(np.int32)


@pytest.mark.parametrize("causal,d", [(True, D), (False, D), (True, 96), (False, 96)],
                         ids=["causal", "full", "causal-D96", "full-D96"])
def test_segment_ids_reference_matches_pallas(causal, d):
    """Packed-document masking: the plain versions against JAX's kernels
    with segment_ids (fp32; unaligned document boundaries). The rows of the
    third document (from 130) see no key in the first 128-row kv block, so
    the m == -inf guards carry them through it."""
    q, k, v, do = _inputs(2, seed=2, d=d)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    seg = jnp.asarray(SEGMENTS)
    jo, jlse = jpfa._flash_fwd(jq, jk, jv, seg, causal, d ** -0.5, BLOCK, BLOCK)
    jgrads = jpfa._flash_bwd(jq, jk, jv, jo, jlse, jdo, seg, causal, d ** -0.5, BLOCK, BLOCK)
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    tseg = torch.as_tensor(SEGMENTS)
    to, tlse = tfa.flash_fwd(tq, tk, tv, tseg, causal, d ** -0.5, BLOCK, BLOCK)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=1e-5)
    tgrads = tfa.flash_bwd(
        tq, tk, tv, torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jlse)),
        tdo, tseg, causal, d ** -0.5, BLOCK, BLOCK,
    )
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=5e-5, err_msg=name)


# two batch rows whose ids are not contiguous: an id comes back after
# another (0, 1, 0 ...; 3, 7, 3), with a document of one row
REPEATED = np.stack([
    np.repeat([0, 1, 0, 2, 1], [50, 30, 40, 1, 79]),
    np.repeat([3, 7, 3], [100, 64, 36]),
]).astype(np.int32)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_repeated_segment_ids_match_pallas(causal):
    """flash_fwd / flash_bwd with ids that repeat after another id: the
    wrappers compare ids (as the kernels do), never assume a document is
    contiguous; held to JAX's interpret-mode kernels (fp32, B 2)."""
    q, k, v, do = _inputs(2, seed=7, b=2)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    seg = jnp.asarray(REPEATED)
    jo, jlse = jpfa._flash_fwd(jq, jk, jv, seg, causal, D ** -0.5, BLOCK, BLOCK)
    jgrads = jpfa._flash_bwd(jq, jk, jv, jo, jlse, jdo, seg, causal, D ** -0.5, BLOCK, BLOCK)
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    tseg = torch.as_tensor(REPEATED)
    to, tlse = tfa.flash_fwd(tq, tk, tv, tseg, causal, D ** -0.5, BLOCK, BLOCK)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=1e-5)
    tgrads = tfa.flash_bwd(tq, tk, tv, to, tlse, tdo, tseg, causal, D ** -0.5, BLOCK, BLOCK)
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=5e-5, err_msg=name)


@pytest.mark.parametrize("fn", ["flash_fwd", "flash_bwd"])
def test_segment_ids_shape_is_checked(fn):
    """segment_ids must be one (B, S) array with Sq == Skv: anything else
    raises ValueError before any kernel or plain version runs."""
    q, k, v, do = (torch.as_tensor(x) for x in _inputs(2, seed=8, b=2, s=32))
    good = torch.zeros((2, 32), dtype=torch.int32)

    def call(q, k, v, seg):
        if fn == "flash_fwd":
            return tfa.flash_fwd(q, k, v, seg, True, D ** -0.5)
        return tfa.flash_bwd(q, k, v, q, q[..., 0], q, seg, True, D ** -0.5)

    call(q, k, v, good)
    for bad in (good[:1], good[:, :31], good[None], good.float()):
        with pytest.raises(ValueError, match="segment_ids"):
            call(q, k, v, bad)
    with pytest.raises(ValueError, match="Sq == Skv"):
        call(q[:, :, :16], k, v, good[:, :16])


@pytest.mark.parametrize("segmented", [False, True], ids=["plain", "segments"])
def test_blockwise_reference_and_grads_match_jax(segmented):
    """The plain blockwise flash_attention_reference and its autograd
    gradients against JAX's (fp32, block 64); and the dispatching
    flash_attention, which on the CPU runs the autograd Function over the
    kernels' plain versions, against the same JAX numbers."""
    q, k, v, do = (x.transpose(0, 2, 1, 3) for x in _inputs(4, seed=3))
    seg = SEGMENTS if segmented else None

    def jloss(q, k, v):
        o = jax_flash_attention_reference(
            q, k, v, causal=True, segment_ids=None if seg is None else jnp.asarray(seg),
            block_kv=64,
        )
        return jnp.sum(o * jnp.asarray(do)), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    tseg = None if seg is None else torch.as_tensor(seg)
    for fn in (tfa.flash_attention_reference, tfa.flash_attention):
        tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        to = fn(tq, tk, tv, causal=True, segment_ids=tseg, block_kv=64)
        if fn is tfa.flash_attention:
            assert "_FlashAttention" in type(to.grad_fn.next_functions[0][0]).__name__
        (to * torch.as_tensor(do)).sum().backward()
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=2e-5)
        for name, t, j in zip(("dq", "dk", "dv"), (tq, tk, tv), jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=5e-5, err_msg=name)


def test_blockwise_stats_with_offsets_match_jax():
    """The combinable (acc, m, l) triple with global offsets and a kv
    length cut, as the ring-attention slice will call it."""
    q, k, v, _ = (x.transpose(0, 2, 1, 3) for x in _inputs(2, seed=4, s=96))
    kw = dict(causal=True, q_off=64, kv_off=16, kv_len=90, block_kv=32)
    jacc, jm, jl = jax_blockwise_attention_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    tacc, tm, tl = tfa.blockwise_attention_stats(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), **kw
    )
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)


def test_cpu_path_launches_no_kernel_and_other_devices_raise():
    q, k, v, do = (torch.as_tensor(x) for x in _inputs(2, seed=6, s=16))
    before = (tfa.fwd_launches.count, tfa.bwd_dq_launches.count, tfa.bwd_dkv_launches.count)
    o, lse = tfa.flash_fwd(q, k, v, None, True, D ** -0.5)
    tfa.flash_bwd(q, k, v, o, lse, do, None, True, D ** -0.5)
    after = (tfa.fwd_launches.count, tfa.bwd_dq_launches.count, tfa.bwd_dkv_launches.count)
    assert after == before
    meta = q.to("meta")
    with pytest.raises(RuntimeError, match="cuda tensors"):
        tfa.flash_fwd(meta, k.to("meta"), v.to("meta"), None, True, D ** -0.5)
    with pytest.raises(RuntimeError, match="cuda tensors"):
        tfa.flash_attention(meta, k.to("meta"), v.to("meta"))


@pytest.mark.parametrize("d", [64, 96, 128, 80])
def test_launch_path_takes_the_kernel_head_dims(d):
    """The CUDA launch path's checks take head dims 64, 96 and 128 (bf16,
    16-byte aligned) and raise on any other before a kernel is built."""
    q, k, v = (torch.zeros(shape, dtype=torch.bfloat16) for shape in
               ((1, 4, 16, d), (1, 2, 16, d), (1, 2, 16, d)))
    if d in tfa.KERNEL_HEAD_DIMS:
        assert set(tfa._checked(q, k, v)) == {"q", "k", "v"}
    else:
        with pytest.raises(ValueError, match="head_dim in"):
            tfa._checked(q, k, v)
