"""The port's context-parallel rings against the JAX package's, case for
case with ``tests/test_ring_attention.py`` (its ``test_gpipe_cp_zigzag_trains``
waits for the pipeline; the model and trainer cases are in
``test_torch_cp_train.py``).

The port runs one process per cp rank over gloo: one spawn of four ranks
(``torch_dist_workers.ring_worker``) computes every case, on a cp = 4 mesh,
then tp = 2 x cp = 2, then dp = 2 x cp = 2, and returns numpy. The JAX
package computes the same numpy inputs (drawn from a seed) on its virtual
CPU mesh of the same shape: ``ring_attention_sharded`` with the same
``impl`` (its Pallas rings in interpret mode) and the dense
``core_attention``. JAX's tolerances: fp32 forward ``atol=2e-5``, gradients
``atol=5e-5`` (the gradients are held to the dense attention's, as JAX's
own test holds its rings').
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.kernels.ring_attention import (
    ring_attention_sharded as jring,
)
from neuronx_distributed_llama3_2_tpu.kernels.ring_attention_pallas import (
    zigzag_permutation as jzigzag,
)
from neuronx_distributed_llama3_2_tpu.models.llama import core_attention as jdense
from neuronx_distributed_llama3_2_tpu.parallel import state as jstate
from neuronx_distributed_llama3_2_tpu_torch.kernels import ring_attention as tring
from neuronx_distributed_llama3_2_tpu_torch.kernels.ring_attention_pallas import (
    zigzag_permutation,
)

from tests import torch_dist_workers as W

FWD_ATOL = 2e-5
GRAD_ATOL = 5e-5


def _qkv(s=128, n=4, nkv=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, s, h, d)).astype(np.float32) for h in (n, nkv, nkv))


#: the inputs of every case, by name (JAX's shapes)
INPUTS = {
    "s128": _qkv(),
    "s64": _qkv(s=64),
    "s256": _qkv(s=256),
    "s80": _qkv(s=80),  # 40 a chunk at cp = 2; block_kv 16 -> 3 blocks, the last 8
    "gqa": _qkv(s=128, n=8, nkv=2, seed=3),
}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every rank's results, from one spawn of four ranks."""
    return W.run(W.ring_worker, 4, tmp_path_factory.mktemp("ring"), INPUTS)


def _dense(case, causal):
    return np.asarray(jdense(*map(jnp.asarray, INPUTS[case]), causal=causal))


def _dense_grads(case, causal=True):
    def loss(q, k, v):
        return (jdense(q, k, v, causal=causal) ** 2).sum()

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                                            INPUTS[case]))]


@functools.lru_cache(maxsize=None)
def _jax(case, causal, impl, cp=4, tp=1, block_kv=None):
    """JAX's ``ring_attention_sharded`` on its (tp, cp) mesh, as numpy."""
    jstate.destroy_model_parallel()
    st = jstate.initialize_model_parallel(tensor_model_parallel_size=tp, context_parallel_size=cp)
    try:
        kw = {} if block_kv is None else {"block_kv": block_kv}
        out = jax.jit(lambda q, k, v: jring(q, k, v, st.mesh, jstate.CP_AXIS, causal=causal,
                                            impl=impl, **kw))(*map(jnp.asarray, INPUTS[case]))
        return np.asarray(out)
    finally:
        jstate.destroy_model_parallel()


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_dense(port, causal):
    got = port[0]["dense", causal]["out"]
    _close(got, _jax("s128", causal, "auto"), FWD_ATOL, "against JAX's ring")
    _close(got, _dense("s128", causal), FWD_ATOL, "against dense attention")
    for o in port[1:]:
        np.testing.assert_array_equal(o["dense", causal]["out"], got)


def test_ring_gradients_match(port):
    """The plain ring's gradients (autograd through the rotation); the
    kernel rings' are held in test_pallas_ring_gradients_match."""
    for got, want, name in zip(port[0]["grads"]["grads"], _dense_grads("s64"), "qkv"):
        _close(got, want, GRAD_ATOL, f"d{name}")


def test_ring_local_chunks_stay_local(port):
    """Each rank holds only its chunk (JAX's sequence-sharded inputs): the
    plain and the kernel ring on the rank's (B, S/cp) chunk give the
    rank's chunk of the dense output."""
    want = _dense("s256", True)
    for r, o in enumerate(port):
        for name in ("plain", "kernel"):
            _close(o["local"][name], want[:, r * 64:(r + 1) * 64], FWD_ATOL, name)


def test_ring_with_tp_combined(port):
    """tp = 2 x cp = 2: each tp rank runs the ring over cp on its heads."""
    got = port[0]["tp"]
    _close(got, _jax("s64", True, "auto", cp=2, tp=2), FWD_ATOL, "against JAX's ring")
    _close(got, _dense("s64", True), FWD_ATOL, "against dense attention")


@pytest.mark.parametrize("causal", [True, False])
def test_ring_multiblock_and_padded_tail(port, causal):
    """block_kv smaller than (and not dividing) the chunk: several blocks
    and a short tail, at cp = 2."""
    got = port[0]["multiblock", causal]["out"]
    _close(got, _jax("s80", causal, "auto", cp=2, block_kv=16), FWD_ATOL, "against JAX's ring")
    _close(got, _dense("s80", causal), FWD_ATOL, "against dense attention")


def test_ring_multiblock_grads(port):
    for got, want, name in zip(port[0]["multiblock grads"]["grads"], _dense_grads("s80"), "qkv"):
        _close(got, want, GRAD_ATOL, f"d{name}")


@pytest.mark.parametrize("impl", ["pallas", "zigzag"])
@pytest.mark.parametrize("causal", [True, False])
def test_pallas_ring_matches_dense(port, impl, causal):
    """The kernel rings (contiguous and zigzag) against JAX's Pallas rings
    in interpret mode and the dense attention. JAX skips zigzag with full
    attention; the port refuses it."""
    got = port[0][impl, causal]
    if impl == "zigzag" and not causal:
        assert got == "zigzag balancing only applies to causal attention"
        return
    _close(got["out"], _jax("s128", causal, impl), FWD_ATOL, f"{impl} against JAX's")
    _close(got["out"], _dense("s128", causal), FWD_ATOL, f"{impl} against dense attention")


@pytest.mark.parametrize("impl", ["pallas", "zigzag"])
def test_pallas_ring_gradients_match(port, impl):
    """The kernel rings' backward (per-pair K2 / K3 from the global lse, dk
    / dv travelling home) against the dense attention's gradients."""
    for got, want, name in zip(port[0]["grads", impl]["grads"], _dense_grads("s64"), "qkv"):
        _close(got, want, GRAD_ATOL, f"d{name} ({impl})")


def test_pallas_ring_gqa_matches_jnp_ring(port):
    """GQA (8 q heads over 2 kv heads) through the kernel rings against the
    plain ring, and each against JAX's."""
    ref = port[0]["gqa", "jnp"]["out"]
    _close(ref, _jax("gqa", True, "jnp"), FWD_ATOL, "jnp against JAX's")
    for impl in ("pallas", "zigzag"):
        _close(port[0]["gqa", impl]["out"], ref, FWD_ATOL, impl)
        _close(port[0]["gqa", impl]["out"], _jax("gqa", True, impl), FWD_ATOL,
               f"{impl} against JAX's")


def test_zigzag_permutation_roundtrip():
    perm, inv = zigzag_permutation(32, 4)
    x = torch.arange(32)
    assert torch.equal(x[perm][inv], x)
    # rank 0 holds half-chunks (0, 7) of the 8-way split
    assert x[perm][:8].tolist() == list(range(0, 4)) + list(range(28, 32))
    jperm, jinv = jzigzag(32, 4)
    assert perm.tolist() == np.asarray(jperm).tolist()
    assert inv.tolist() == np.asarray(jinv).tolist()
    with pytest.raises(ValueError, match="not divisible"):
        zigzag_permutation(30, 4)


def test_ring_shift_rotates_and_its_gradient_rotates_back(port):
    """Rank i receives rank i - 1's tensor through the all-gather (gloo's
    transport, the one the card's gloo ranks take), counted once; the
    gradient of rank i's input is what rank i + 1 multiplied it by."""
    for r, o in enumerate(port):
        transport, y, grad, count = o["shift"]
        assert transport == "all_gather"
        assert y.tolist() == [float((r - 1) % 4)] * 3
        assert grad.tolist() == [float((r + 1) % 4 + 1)] * 3
        assert count == 2  # the forward's rotation and the backward's


def test_ring_shift_send_recv_matches_all_gather(port):
    """NCCL's transport (``batch_isend_irecv`` pairs, here over gloo's CPU
    send / recv) against gloo's all-gather, bit for bit at cp = 4: the
    rotation one hop forward and one back, and the kernel rings' outputs
    and gradients (the backward's dk / dv travel and their hop home)."""
    for r, o in enumerate(port):
        (fwd, back), rings = o["transports"]["send_recv"]
        (ag_fwd, ag_back), ag_rings = o["transports"]["all_gather"]
        base = np.arange(6.0).reshape(2, 3)
        np.testing.assert_array_equal(fwd, base + 10 * ((r - 1) % 4))
        np.testing.assert_array_equal(back, base + 10 * ((r + 1) % 4))
        np.testing.assert_array_equal(fwd, ag_fwd)
        np.testing.assert_array_equal(back, ag_back)
        for impl in ("pallas", "zigzag"):
            np.testing.assert_array_equal(rings[impl]["out"], ag_rings[impl]["out"])
            for got, want in zip(rings[impl]["grads"], ag_rings[impl]["grads"]):
                np.testing.assert_array_equal(got, want)


def test_resolve_cp_layout():
    """"auto" chooses zigzag on a CUDA device for causal attention when
    the sequence splits into 2·cp halves, contiguous on the CPU (JAX's
    rule off a TPU); a forced layout wins."""
    assert tring.resolve_cp_layout(64, 2, device="cpu") == "contiguous"
    assert tring.resolve_cp_layout(64, 2, device="cuda") == "zigzag"
    assert tring.resolve_cp_layout(64, 2, causal=False, device="cuda") == "contiguous"
    assert tring.resolve_cp_layout(60, 4, device="cuda") == "contiguous"
    assert tring.resolve_cp_layout(64, 2, force="zigzag", device="cpu") == "zigzag"
    assert tring.resolve_cp_layout(64, 2, force="contiguous", device="cuda") == "contiguous"
    with pytest.raises(ValueError, match="auto|contiguous|zigzag"):
        tring.resolve_cp_layout(64, 2, force="ring")
    with tring.cp_layout("zigzag"):
        assert tring.active_cp_layout() == "zigzag"
        with tring.cp_layout_from_inv(None):
            assert tring.active_cp_layout() == "contiguous"
    assert tring.active_cp_layout() == "contiguous"
