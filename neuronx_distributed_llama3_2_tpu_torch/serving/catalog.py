"""Serving bucket ladders: the padded lengths every dispatch rounds up to.

Counterpart of the ladder helpers of
``neuronx_distributed_llama3_2_tpu/serving/catalog.py`` (``default_buckets``,
``pick_bucket``, ``complete_ladder``), copied unchanged. The JAX module
also expands the ladder into a manifest of compiled programs (the AOT
catalog and its golden file); here every program is an eager call, so that
part comes with the prewarm / CUDA-graph sub-slice of the port.
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = ["complete_ladder", "default_buckets", "pick_bucket"]


def default_buckets(max_seq_len: int, min_bucket: int = 128) -> List[int]:
    """Powers-of-2 bucket ladder up to max_seq_len (reference
    autobucketing.py:6 generate_buckets)."""
    buckets = []
    b = min_bucket
    while b < max_seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq_len)
    return buckets


def pick_bucket(buckets: Sequence[int], length: int) -> int:
    """Smallest bucket >= length (reference context-encode
    bucket-from-extent, autobucketing.py:62-124)."""
    for b in buckets:
        if b >= length:
            return b
    raise ValueError(f"length {length} exceeds largest bucket {buckets[-1]}")


def complete_ladder(buckets: Sequence[int], max_seq_len: int) -> List[int]:
    """Validated ascending ladder with ``max_seq_len`` appended when the
    declared rungs top out early — every serving dispatch length
    <= max_seq_len must route to SOME rung (the dense engine's
    ``_kv_bucket`` has the same clamp-to-full-cache fallback)."""
    out = [int(b) for b in buckets]
    if not out:
        raise ValueError("bucket ladder must not be empty")
    if any(b < 1 for b in out):
        raise ValueError(f"bucket ladder entries must be positive: {out}")
    if out != sorted(set(out)):
        raise ValueError(f"bucket ladder must be strictly ascending: {out}")
    if out[-1] > max_seq_len:
        raise ValueError(
            f"largest bucket {out[-1]} exceeds max_seq_len {max_seq_len}"
        )
    if out[-1] < max_seq_len:
        out.append(max_seq_len)
    return out
