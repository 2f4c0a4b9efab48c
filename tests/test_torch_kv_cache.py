"""The port's KV-pool scale math against the JAX package's, bit for bit.

``kv_quantize`` must give the JAX package's payload bits and fp16 scales
exactly: the quantized serving engines of the two packages can only agree
token for token if every stored row is the same. Rows cover the random
case, all-zero rows (the KV_SCALE_MIN clamp) and rows whose absmax passes
the KV_SCALE_MAX clamp, in fp32 and bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_llama3_2_tpu.quantization import kv_cache as jkv
from neuronx_distributed_llama3_2_tpu_torch.quantization import kv_cache as kv

DTYPES = ("int8", "fp8_e4m3", "fp8_e5m2")


def _rows(seed):
    """(64, 4, 32) K/V rows over many magnitudes, with an all-zero row, a
    row of 1e-9 (both clamp to KV_SCALE_MIN) and rows past KV_SCALE_MAX
    at every qmax (absmax / 57344 exceeds 3e4 from 1.72e9 on)."""
    rng = np.random.default_rng(seed)
    mag = rng.choice([1e-3, 1.0, 30.0, 1e4], size=(64, 4, 1))
    x = (rng.standard_normal((64, 4, 32)) * mag).astype(np.float32)
    x[0] = 0.0
    x[1] = 1e-9
    x[2, :, 0] = 3e9
    x[3, :, 5] = -2e9
    return x


def _bits(a):
    """The raw bits of a JAX or torch array, as numpy unsigned ints."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint8 if a.element_size() == 1 else torch.int16).numpy()
    else:
        a = np.asarray(a)
    return a.view(np.uint8 if a.itemsize == 1 else np.uint16)


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DTYPES)
def test_kv_quantize_is_bitwise_jax(name, src):
    x = _rows(DTYPES.index(name))
    xj = jnp.asarray(x, getattr(jnp, src))
    xt = torch.as_tensor(x).to(getattr(torch, src))
    qj, sj = jkv.kv_quantize(xj, jkv.KV_CACHE_DTYPES[name])
    qt, st = kv.kv_quantize(xt, kv.KV_CACHE_DTYPES[name])
    assert qt.dtype == kv.KV_CACHE_DTYPES[name] and st.dtype == kv.KV_SCALE_DTYPE
    np.testing.assert_array_equal(_bits(qt), _bits(qj))
    np.testing.assert_array_equal(_bits(st), _bits(sj))
    # the clamps bound: zero rows at KV_SCALE_MIN, outliers at KV_SCALE_MAX
    s = st.float()
    assert torch.all(s[0] == torch.tensor(kv.KV_SCALE_MIN, dtype=torch.float16).float())
    assert torch.all(s[2:4] == torch.tensor(kv.KV_SCALE_MAX, dtype=torch.float16).float())
    # dequantize: the same fp32 widen, multiply and cast
    dj = jkv.kv_dequantize(qj, sj, jnp.bfloat16)
    dt = kv.kv_dequantize(qt, st, torch.bfloat16)
    np.testing.assert_array_equal(_bits(dt), _bits(dj))


@pytest.mark.parametrize("name", DTYPES)
def test_requantizing_a_dequantized_row_is_a_fixed_point(name):
    """The stored pair round-trips: quantizing what kv_dequantize returns
    (in fp32) gives the same payload and scale back."""
    x = torch.as_tensor(_rows(7)[4:])
    q, s = kv.kv_quantize(x, kv.KV_CACHE_DTYPES[name])
    q2, s2 = kv.kv_quantize(kv.kv_dequantize(q, s, torch.float32), kv.KV_CACHE_DTYPES[name])
    np.testing.assert_array_equal(_bits(q2), _bits(q))
    np.testing.assert_array_equal(_bits(s2), _bits(s))


def test_knob_validator_and_scale_itemsize():
    assert set(kv.KV_CACHE_DTYPES) == set(jkv.KV_CACHE_DTYPES)
    for name in kv.KV_CACHE_DTYPES:
        assert kv.kv_scale_itemsize(name) == jkv.kv_scale_itemsize(name)
        assert kv.kv_cache_torch_dtype(name).itemsize == jnp.dtype(
            jkv.kv_cache_jax_dtype(name)
        ).itemsize
    assert kv.kv_scale_itemsize("bf16") == 0 and kv.kv_scale_itemsize("int8") == 2
    with pytest.raises(ValueError, match="kv_cache_dtype must be one of"):
        kv.kv_cache_torch_dtype("int4")
    with pytest.raises(ValueError, match="kv_cache_dtype must be one of"):
        kv.kv_scale_itemsize("fp8")
    assert kv._qmax(torch.int8) == 127.0
    assert kv._qmax(torch.float8_e4m3fn) == 448.0
    assert kv._qmax(torch.float8_e5m2) == 57344.0
