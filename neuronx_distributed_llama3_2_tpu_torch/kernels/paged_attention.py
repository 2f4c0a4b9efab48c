"""Paged flash-decoding: attention over a block-pooled KV cache read in
place through per-lane block tables.

Counterpart of ``neuronx_distributed_llama3_2_tpu/kernels/paged_attention_pallas.py``
(``paged_flash_decode``, same signature and semantics). On a CUDA tensor
the wrapper launches the hand-written CUDA C++ kernel of
``csrc/paged_decode.cu`` (built for ``sm_90a`` at first use, see
:mod:`._build`); on a CPU tensor it runs :func:`paged_flash_decode_reference`,
the plain PyTorch version of the same function. Any other device raises:
there is no fallback from one to the other.

Logical row ``p`` of lane ``i`` lives at pool row
``block_tables[i, p // bs] * bs + p % bs``. A 3-dim q is the T == 1
token-gen step: rows ``<= positions[i]`` are attended. A 4-dim q is a fresh
block of t <= 8 tokens written at rows ``positions[i] .. positions[i] + t - 1``;
query ``ti`` attends rows ``<= positions[i] + ti`` (block-causal). Everything
else (padding, null-block garbage) is masked. ``kv_limit`` bounds the
logical rows visited; the caller guarantees every used query row sits
below it.

The quantized pool (``k_scale`` / ``v_scale``, ``quant_mxu``), ``row_live``
and ``tree_bits`` modes of the TPU kernel are later sub-slices of the port
and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

# kv-length split count: enough blocks to spread a long context over the
# SMs past small decode batches without shrinking per-split work below a
# few pool blocks
DEFAULT_NUM_SPLITS = 4
# what csrc/paged_decode.cu is compiled for
KERNEL_BLOCK_SIZE = 16
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_MAX_TILE_ROWS = 64  # t * G


class LaunchCounter:
    """Kernel launches, counted by the wrapper where it launches and
    nowhere else (the CPU path and the comparisons a caller runs against
    the plain version do not count)."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


#: launches of the CUDA paged-decode kernel in this process
launches = LaunchCounter()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _unported(**modes) -> None:
    for name, value in modes.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"paged_flash_decode({name}=...) is a later sub-slice of the "
                "port: only the bf16 pool with t == 1 and t <= 8 "
                "block-causal queries is ported"
            )


def _geometry(q, k_pool, block_tables, kv_limit, num_splits):
    b, t, n, d = q.shape
    _, bs, nkv, _ = k_pool.shape
    if n % nkv:
        raise ValueError(f"q heads ({n}) must be a multiple of kv heads ({nkv})")
    w = block_tables.shape[1]
    limit = kv_limit if kv_limit is not None else w * bs
    nblk = _ceil_div(limit, bs)
    if nblk > w:
        raise ValueError(f"kv_limit {limit} exceeds table capacity {w * bs}")
    splits = num_splits if num_splits is not None else DEFAULT_NUM_SPLITS
    splits = max(1, min(splits, nblk))
    return nblk, splits, _ceil_div(nblk, splits)


def paged_flash_decode_reference(
    q: torch.Tensor,             # (b, N, D) single query — or (b, t, N, D)
    k_pool: torch.Tensor,        # (num_blocks, bs, NKV, D)
    v_pool: torch.Tensor,        # (num_blocks, bs, NKV, D)
    block_tables: torch.Tensor,  # (b, W) int
    positions: torch.Tensor,     # (b,) int — row of the FIRST fresh query
    *,
    kv_limit: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`paged_flash_decode`: gather the
    first ``ceil(kv_limit / bs)`` table blocks of every lane, then one
    masked softmax in fp32 (q·k of the input-dtype operands accumulated in
    fp32, times ``D ** -0.5``). Returns q's shape in q's dtype. It
    materializes the (b, kv_limit, NKV, D) gather the kernel avoids."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, t, n, d = q.shape
    _, bs, nkv, _ = k_pool.shape
    g = n // nkv
    nblk, _, _ = _geometry(q, k_pool, block_tables, kv_limit, 1)
    blocks = block_tables[:, :nblk].long()                      # (b, nblk)
    k_all = k_pool[blocks].reshape(b, nblk * bs, nkv, d).float()
    v_all = v_pool[blocks].reshape(b, nblk * bs, nkv, d).float()
    qg = q.float().reshape(b, t, nkv, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k_all) * (d ** -0.5)
    rows = torch.arange(nblk * bs, device=q.device)
    last = positions.long()[:, None] + torch.arange(t, device=q.device)[None, :]
    mask = rows[None, None, :] <= last[:, :, None]               # (b, t, S)
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v_all).reshape(b, t, n, d)
    out = out.to(q.dtype)
    return out[:, 0] if squeeze else out


def paged_flash_decode(
    q: torch.Tensor,             # (b, N, D) single query — or (b, t, N, D)
    k_pool: torch.Tensor,        # (num_blocks, bs, NKV, D) pool slice
    v_pool: torch.Tensor,        # (num_blocks, bs, NKV, D)
    block_tables: torch.Tensor,  # (b, W) int32; entries must be < num_blocks
    positions: torch.Tensor,     # (b,) int32 — row of the FIRST fresh query
    *,
    kv_limit: Optional[int] = None,
    num_splits: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    quant_mxu: bool = False,
    row_live: Optional[torch.Tensor] = None,
    tree_bits: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather-free paged decode attention; returns q's shape in q.dtype
    (see the module docstring for the semantics)."""
    _unported(
        k_scale=k_scale, v_scale=v_scale, quant_mxu=quant_mxu,
        row_live=row_live, tree_bits=tree_bits,
    )
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    nblk, splits, bps = _geometry(q4, k_pool, block_tables, kv_limit, num_splits)
    dev = q.device.type
    if dev == "cpu":
        return paged_flash_decode_reference(
            q, k_pool, v_pool, block_tables, positions, kv_limit=kv_limit
        )
    if dev != "cuda":
        raise RuntimeError(
            f"paged_flash_decode runs its CUDA kernel on cuda tensors and its "
            f"plain version on cpu tensors; got a {dev!r} tensor"
        )
    out = _launch(q4, k_pool, v_pool, block_tables, positions, nblk, splits, bps)
    return out[:, 0] if squeeze else out


def _kernel():
    """The C entry point of csrc/paged_decode.cu, built at first use, with
    every pointer and the stream passed as ``c_void_p``."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels._build import load

    fn = load("paged_decode").paged_decode_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
    return fn


def _launch(q, k_pool, v_pool, block_tables, positions, nblk, splits, bps):
    b, t, n, d = q.shape
    nb, bs, nkv, _ = k_pool.shape
    g = n // nkv
    tensors = dict(
        q=q, k_pool=k_pool, v_pool=v_pool, block_tables=block_tables,
        positions=positions,
    )
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q", "k_pool", "v_pool"):
        if tensors[name].dtype != torch.bfloat16:
            raise ValueError(
                f"the CUDA kernel takes a bf16 {name}, got {tensors[name].dtype}"
            )
    for name in ("block_tables", "positions"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    if v_pool.shape != k_pool.shape or tuple(q.shape[-1:]) != (k_pool.shape[-1],):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k_pool {tuple(k_pool.shape)}, "
            f"v_pool {tuple(v_pool.shape)}"
        )
    if positions.shape != (b,) or block_tables.shape[0] != b:
        raise ValueError("block_tables and positions must have one row per lane")
    if bs != KERNEL_BLOCK_SIZE or d not in KERNEL_HEAD_DIMS or t * g > KERNEL_MAX_TILE_ROWS:
        raise ValueError(
            f"the CUDA kernel takes block_size {KERNEL_BLOCK_SIZE}, head_dim in "
            f"{KERNEL_HEAD_DIMS} and t * G <= {KERNEL_MAX_TILE_ROWS}; got "
            f"block_size {bs}, head_dim {d}, t {t}, G {g}"
        )
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the kernel's 16-byte K/V loads need 16-byte aligned pools")

    fn = _kernel()
    tg = t * g
    o_parts = torch.empty((b, nkv, splits, tg, d), dtype=torch.float32, device=q.device)
    m_parts = torch.empty((b, nkv, splits, tg), dtype=torch.float32, device=q.device)
    l_parts = torch.empty_like(m_parts)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(),
        o_parts.data_ptr(), m_parts.data_ptr(), l_parts.data_ptr(),
        out.data_ptr(),
        b, t, n, nkv, d, bs, block_tables.shape[1], nblk, splits, bps,
        d ** -0.5, stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_decode_bf16 launch failed: cudaError_t {err}")
    launches.count += 1
    return out
