"""The port's channel-parallel convolutions (parallel/conv.py) against the
JAX package's layers on the same HWIO weights and NHWC inputs, on the CPU,
in fp32, mirroring ``tests/test_conv.py``'s four cases at tp = 1: the
output-channel layer with its output gathered, the output -> input
channel pair, the pair's gradients, and a strided rectangular kernel. The
same cases at tp = 2 run in the Mllama gloo spawn
(``tests/test_torch_mllama_tp.py``, ``torch_dist_workers.mllama_worker``).
Tolerance 1e-5 absolute (JAX's), gradients 1e-4 (JAX's)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from neuronx_distributed_llama3_2_tpu.parallel import conv as jconv
from neuronx_distributed_llama3_2_tpu_torch.parallel import conv as tconv

torch.set_num_threads(1)


def x_of(b=2, h=8, w=8, c=16, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, h, w, c)).astype(np.float32)


def port_layer(cls, jlayer, params, **kw):
    """The port's layer of a JAX one, its weights JAX's, bias nudged off 0."""
    layer = cls(jlayer.in_channels, jlayer.out_channels, jlayer.kernel_size,
                stride=jlayer.stride, padding=jlayer.padding, use_bias=jlayer.use_bias,
                device="cpu", **kw)
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}
    layer.load_state_dict(sd)
    return layer


def nudged(params, seed):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v) + (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            if k == "bias" else np.asarray(v) for k, v in params.items()}


def test_output_parallel_matches_jax():
    jl = jconv.OutputChannelParallelConv2d(16, 32, kernel_size=3, padding=1, gather_output=True)
    p = nudged(jl.init(jax.random.key(0)), 0)
    x = x_of()
    tl = port_layer(tconv.OutputChannelParallelConv2d, jl, p, gather_output=True)
    got = tl(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jl(p, jnp.asarray(x))), atol=1e-5)
    # NCHW in and out: the same product
    nchw = tl.forward_nchw(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(nchw.detach().numpy(), got, atol=1e-6)


def _pair(seed1=1, seed2=2):
    c1 = jconv.OutputChannelParallelConv2d(16, 32, kernel_size=3, padding=1)
    c2 = jconv.InputChannelParallelConv2d(32, 8, kernel_size=1)
    p1 = nudged(c1.init(jax.random.key(seed1)), seed1)
    p2 = nudged(c2.init(jax.random.key(seed2)), seed2)
    return c1, c2, p1, p2


def test_conv_pair_output_then_input_channels():
    c1, c2, p1, p2 = _pair()
    x = x_of()
    want = np.asarray(c2(p2, c1(p1, jnp.asarray(x))))
    t1 = port_layer(tconv.OutputChannelParallelConv2d, c1, p1)
    t2 = port_layer(tconv.InputChannelParallelConv2d, c2, p2)
    got = t2(t1(torch.as_tensor(x))).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert t1.specs()["kernel"].spec == (None, None, None, "tp")
    assert t2.specs()["kernel"].spec == (None, None, "tp", None)
    assert t2.specs()["bias"].spec == (None,)


def test_conv_pair_gradients_match_jax():
    c1 = jconv.OutputChannelParallelConv2d(8, 16, kernel_size=3, padding=1)
    c2 = jconv.InputChannelParallelConv2d(16, 4, kernel_size=1)
    p1 = nudged(c1.init(jax.random.key(3)), 3)
    p2 = nudged(c2.init(jax.random.key(4)), 4)
    x = x_of(b=4, c=8, seed=5)

    def loss(p1, p2, x):
        return jnp.sum(c2(p2, c1(p1, x)) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(p1, p2, jnp.asarray(x))
    t1 = port_layer(tconv.OutputChannelParallelConv2d, c1, p1)
    t2 = port_layer(tconv.InputChannelParallelConv2d, c2, p2)
    tx = torch.as_tensor(x).requires_grad_(True)
    (t2(t1(tx)) ** 2).sum().backward()
    for t, w in ((t1, want[0]), (t2, want[1])):
        for k in ("kernel", "bias"):
            np.testing.assert_allclose(getattr(t, k).grad.numpy(), np.asarray(w[k]), atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[2]), atol=1e-4)


def test_stride_and_rect_kernel():
    jl = jconv.OutputChannelParallelConv2d(4, 8, kernel_size=(3, 1), stride=(2, 1),
                                           padding=(1, 0), gather_output=True)
    p = nudged(jl.init(jax.random.key(6)), 6)
    x = x_of(c=4)
    tl = port_layer(tconv.OutputChannelParallelConv2d, jl, p, gather_output=True)
    got = tl(torch.as_tensor(x)).detach().numpy()
    assert got.shape == (2, 4, 8, 8)
    np.testing.assert_allclose(got, np.asarray(jl(p, jnp.asarray(x))), atol=1e-5)
