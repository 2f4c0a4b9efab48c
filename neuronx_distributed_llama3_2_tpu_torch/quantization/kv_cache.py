"""Scale math of the quantized paged KV pool.

Counterpart of ``neuronx_distributed_llama3_2_tpu/quantization/kv_cache.py``
(with its own copy of ``QUANTIZED_DTYPES`` and ``_qmax`` from the JAX
package's ``quantization/quantize.py``). ``PagedConfig.kv_cache_dtype``
int8 / fp8 stores each written K/V row as a low-bit payload beside one
fp16 absmax scale per (token row, kv head):

- scale = clip(absmax over head_dim / qmax, KV_SCALE_MIN, KV_SCALE_MAX),
  rounded to fp16 *before* the divide, so that the stored (payload, scale)
  pair round-trips exactly through :func:`kv_dequantize`;
- int8 rounds half to even (``torch.round``, as ``jnp.round``) and clips
  to +-127; fp8 clips to +-qmax and casts.

Scales are per row and append-local: a row's stored value never depends
on which other rows share its block, so whole and chunked prefill write
the same pool. The numerics are bit-equal to the JAX package's.
"""

from __future__ import annotations

import torch

#: quantized storage dtypes by knob value
QUANTIZED_DTYPES = {
    "int8": torch.int8,
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
}

#: accepted ``PagedConfig.kv_cache_dtype`` values; "bf16" is the fp pool at
#: the model (or ``cache_dtype``) precision, with no scale arrays
KV_CACHE_DTYPES = {"bf16": torch.bfloat16, **QUANTIZED_DTYPES}

#: storage dtype of the per-(row, head) scale arrays
KV_SCALE_DTYPE = torch.float16

# scale clamp: the lower bound keeps all-zero rows finite (and is an fp16
# normal, so a stored scale never flushes to 0), the upper bound keeps
# absmax outliers below fp16 inf
KV_SCALE_MIN = 1e-6
KV_SCALE_MAX = 3.0e4


def _qmax(dtype: torch.dtype) -> float:
    if dtype == torch.int8:
        return 127.0
    return float(torch.finfo(dtype).max)


def kv_cache_torch_dtype(name: str) -> torch.dtype:
    """Storage dtype for a ``kv_cache_dtype`` knob value (loud on typos)."""
    if name not in KV_CACHE_DTYPES:
        raise ValueError(
            f"kv_cache_dtype must be one of {sorted(KV_CACHE_DTYPES)}, "
            f"got {name!r}"
        )
    return KV_CACHE_DTYPES[name]


def kv_scale_itemsize(name: str) -> int:
    """Scale bytes per (token row, kv head): 0 for the fp pool."""
    kv_cache_torch_dtype(name)
    return 0 if name == "bf16" else torch.finfo(KV_SCALE_DTYPE).bits // 8


def kv_quantize(x: torch.Tensor, qdtype: torch.dtype):
    """Quantize fresh K/V rows ``(..., D)`` to ``(payload, scale)``: the
    scale is the absmax over the trailing head_dim of each leading index,
    clamped and rounded to :data:`KV_SCALE_DTYPE` before the divide."""
    qmax = _qmax(qdtype)
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.clamp(absmax / qmax, KV_SCALE_MIN, KV_SCALE_MAX)
    scale = scale.to(KV_SCALE_DTYPE)
    q = xf / scale.float()[..., None]
    if qdtype == torch.int8:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    else:
        q = torch.clamp(q, -qmax, qmax)
    return q.to(qdtype), scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype):
    """``payload (..., D) * scale (...)`` widened to fp32, then cast to
    ``dtype``: the formula the paged-decode kernel applies to each block it
    reads, so every read path sees the same operands."""
    return (q.float() * scale.float()[..., None]).to(dtype)
