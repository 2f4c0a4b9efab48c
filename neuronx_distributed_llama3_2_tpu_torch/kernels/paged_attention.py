"""Paged flash-decoding: attention over a block-pooled KV cache read in
place through per-lane block tables.

Counterpart of ``neuronx_distributed_llama3_2_tpu/kernels/paged_attention_pallas.py``
(``paged_flash_decode``, same signature and semantics). On a CUDA tensor
the wrapper launches a hand-written CUDA C++ kernel (built for ``sm_90a``
at first use, see :mod:`._build`) from one of three sources:
``csrc/paged_decode_t1.cu`` for every t == 1 call (any payload, ``G <=
T1_MAX_GROUP``), each lane's live blocks split evenly over a split count
that fills the card (:func:`t1_num_splits`, :func:`t1_split_ranges`) and
the splits merged in the same launch; ``csrc/paged_decode_tile.cu``, one
block owning a whole query tile on the tensor cores, for every call with
``t > 1`` and ``t * G <= TILE_MAX_ROWS`` (any payload: bf16, or int8 / fp8
in modes 3 and 6); ``csrc/paged_decode.cu`` for every other call (tiles
wider than ``TILE_MAX_ROWS``, ``G > T1_MAX_GROUP`` at t == 1).
:func:`kernel_route` is the rule. On a CPU tensor it runs
:func:`paged_flash_decode_reference`, the plain PyTorch version of the same
function. Any other device raises: there is no fallback from one to the
other.

Logical row ``p`` of lane ``i`` lives at pool row
``block_tables[i, p // bs] * bs + p % bs``. A 3-dim q is the T == 1
token-gen step: rows ``<= positions[i]`` are attended. A 4-dim q is a fresh
block of t tokens written at rows
``positions[i] .. positions[i] + t - 1``; query ``ti`` attends rows
``<= positions[i] + ti`` (block-causal). Everything else (padding,
null-block garbage) is masked. ``kv_limit`` bounds the logical rows
visited; the caller guarantees every used query row sits below it.

``row_live`` (b,) int32 marks a mixed-width block (mode 4 of the TPU
kernel, the fused mixed-mode step): lane ``i``'s query rows ``>=
row_live[i]`` are padding whose outputs the caller discards, and the
lane's walk stops at the pool block holding row ``positions[i] +
row_live[i] - 1`` instead of ``positions[i] + t - 1``. Every query row
keeps its ``row <= positions[i] + ti`` mask within the rows walked, so a
live row's output is what it is without ``row_live``, and a padding row's
is what the TPU kernel gives it (0 where it sees no row at all).

``k_scale`` / ``v_scale`` (each (num_blocks, bs, NKV) fp16) mark an int8
or fp8 pool (:mod:`..quantization.kv_cache`): each block's K and V are
dequantized as ``(payload.f32 * scale.f32).to(q.dtype)`` before the dots
(mode 3 of the TPU kernel). ``quant_mxu`` keeps the q.k dot in the
payload's precision (mode 6): an int8 pool requantizes each query row to
int8 (absmax / 127) and accumulates int8 x int8 in int32, an fp8 pool
casts q to the payload's fp8 type without saturation; the scales then
multiply the fp32 scores, and p.V keeps mode 3's dequantized V.

``tree_bits`` (b, t) int32 marks the fresh block as a packed draft tree
(mode 5, tree speculation): bit ``m`` of ``tree_bits[i, q]`` is set iff
node ``m`` is an ancestor-or-self of node ``q`` in lane ``i``'s tree, whose
node ``m`` sits at row ``positions[i] + m``. Within the fresh block query
``q`` then sees exactly its ancestors, and the committed prefix ``row <
positions[i]`` stays fully visible. Needs ``t <= 32``. A node's ancestors
precede it (topologically packed trees, as
:func:`..inference.speculative.tree_topology` gives), and the CUDA kernel
relies on it; a chain tree (``tree_bits[i, q] = (1 << (q + 1)) - 1``) is
bitwise the block-causal mask. It composes with ``row_live`` and with the
quantized modes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from neuronx_distributed_llama3_2_tpu_torch.quantization.kv_cache import (
    kv_dequantize,
)

# kv-length split count of csrc/paged_decode.cu and csrc/paged_decode_tile.cu
# (t > 1): enough blocks to spread a long context over the SMs past small
# decode batches without shrinking per-split work below a few pool blocks
DEFAULT_NUM_SPLITS = 4
# what the three CUDA sources are compiled for
KERNEL_BLOCK_SIZE = 16
KERNEL_HEAD_DIMS = (64, 128)
# tile rows (t * G) one block of csrc/paged_decode_tile.cu owns
TILE_MAX_ROWS = 128
# query heads of one kv head (G) a block of csrc/paged_decode_t1.cu serves
T1_MAX_GROUP = 8
# thread blocks (splits x NKV x lanes) t1_num_splits aims a t == 1 launch
# at: four on each of the H100's 132 SMs
T1_MIN_BLOCKS = 4 * 132
# tree_bits packs each node's ancestor set into one int32
MAX_TREE_NODES = 32


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
#: of those, the launches with per-lane live rows (mode 4, ``row_live``)
row_live_launches = LaunchCounter()
#: of those, the launches with per-node ancestor masks (mode 5, ``tree_bits``)
tree_launches = LaunchCounter()
#: of those, the launches of csrc/paged_decode_tile.cu
tile_launches = LaunchCounter()
#: of those, the launches of csrc/paged_decode_t1.cu (the rest, neither
#: tile nor t1, are csrc/paged_decode.cu's)
t1_launches = LaunchCounter()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _check_scales(k_pool, k_scale, v_scale, quant_mxu) -> bool:
    """Validate the quantized-pool arguments as the TPU kernel does;
    returns whether the pool is quantized."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    quantized = k_scale is not None
    if quant_mxu and not quantized:
        raise ValueError(
            "quant_mxu needs a quantized pool (k_scale/v_scale): the fp pool "
            "has no low-bit payload to keep in the dot"
        )
    if quantized:
        want = tuple(k_pool.shape[:3])
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(
                f"scale arrays must be (num_blocks, bs, NKV) = {want}, got "
                f"{tuple(k_scale.shape)} / {tuple(v_scale.shape)}"
            )
    return quantized


# an fp8 cast without saturation overflows past the format's rounding
# edge (max + half an ulp): e4m3fn has no inf and gives NaN there, e5m2
# gives inf at and past it (the tie rounds up, to the odd-free inf)
_FP8_E4M3_NAN_ABOVE = 464.0
_FP8_E5M2_INF_FROM = 61440.0


def fp8_query(q: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``q`` cast to the fp8 payload ``dtype`` as the TPU kernel's
    ``q.astype(k.dtype)`` does, widened back to fp32. torch's cast
    saturates e4m3fn to +-448 where the reference gives NaN, so the
    overflow is set explicitly."""
    qf = q.float()
    out = qf.to(dtype).float()
    if dtype == torch.float8_e4m3fn:
        return torch.where(qf.abs() > _FP8_E4M3_NAN_ABOVE, float("nan"), out)
    over = qf.abs() >= _FP8_E5M2_INF_FROM
    return torch.where(over, torch.copysign(torch.full_like(qf, float("inf")), qf), out)


def t1_num_splits(b: int, nkv: int, nblk: int) -> int:
    """The split count of a t == 1 launch that passes no ``num_splits``:
    the smallest power of two that gives at least ``T1_MIN_BLOCKS`` thread
    blocks (splits x NKV x b), never more than the ``nblk`` blocks a lane
    can walk nor fewer than 1."""
    want = _ceil_div(T1_MIN_BLOCKS, b * nkv)
    return max(1, min(1 << (want - 1).bit_length(), nblk))


def t1_split_ranges(positions, nblk: int, splits: int, row_live=None,
                    bs: int = KERNEL_BLOCK_SIZE) -> list:
    """Each lane's walk at t == 1 as csrc/paged_decode_t1.cu cuts it: the
    ``nb`` blocks :func:`walked_rows` gives the lane, in ranges of ``c =
    ceil(nb / splits)`` blocks, ``[(first, stop), ...]`` (split s takes the
    s-th; the splits past the last range walk nothing). A lane that walks
    no block has no range."""
    ranges = []
    for rows in walked_rows(positions, 1, nblk, bs, row_live).tolist():
        nb = rows // bs
        c = _ceil_div(nb, splits)
        ranges.append([(lb, min(lb + c, nb)) for lb in range(0, nb, c)] if nb else [])
    return ranges


def _geometry(q, k_pool, block_tables, kv_limit, num_splits, source="auto"):
    """(nblk, splits, blocks per split) of a call on ``source`` ("auto":
    the one :func:`kernel_route` picks): ``num_splits`` when given, else
    :func:`t1_num_splits` on csrc/paged_decode_t1.cu and
    ``DEFAULT_NUM_SPLITS`` on the other two; never more than nblk."""
    b, t, n, d = q.shape
    _, bs, nkv, _ = k_pool.shape
    if n % nkv:
        raise ValueError(f"q heads ({n}) must be a multiple of kv heads ({nkv})")
    w = block_tables.shape[1]
    limit = kv_limit if kv_limit is not None else w * bs
    nblk = _ceil_div(limit, bs)
    if nblk > w:
        raise ValueError(f"kv_limit {limit} exceeds table capacity {w * bs}")
    if source == "auto":
        source = kernel_route(k_pool.dtype, t, n // nkv, d)
    if num_splits is not None:
        splits = num_splits
    elif source == "t1":
        splits = t1_num_splits(b, nkv, nblk)
    else:
        splits = DEFAULT_NUM_SPLITS
    splits = max(1, min(splits, nblk))
    return nblk, splits, _ceil_div(nblk, splits)


def _check_row_live(row_live, b: int) -> None:
    if row_live is not None and tuple(row_live.shape) != (b,):
        raise ValueError(
            f"row_live must be (b,) = ({b},), got {tuple(row_live.shape)}"
        )


def _check_tree_bits(tree_bits, b: int, t: int) -> None:
    """The TPU kernel's checks: one int32 mask per node, (b, t)."""
    if tree_bits is None:
        return
    if t > MAX_TREE_NODES:
        raise ValueError(
            f"tree_bits packs ancestor sets into int32 bitmasks: t ({t}) must "
            f"be <= {MAX_TREE_NODES}"
        )
    if tuple(tree_bits.shape) != (b, t):
        raise ValueError(
            f"tree_bits must be (b, t) = ({b}, {t}), got {tuple(tree_bits.shape)}"
        )


def walked_rows(positions, t: int, nblk: int, bs: int, row_live=None):
    """(b,) logical rows the TPU kernel's walk reads per lane: whole blocks
    ``lb < nblk`` with ``lb * bs <= positions + frontier``, the frontier
    ``t - 1`` or, under ``row_live``, ``row_live - 1`` (no block at all
    when it lies before row 0)."""
    frontier = t - 1 if row_live is None else row_live.long() - 1
    last = positions.long() + frontier
    blocks = torch.where(
        last < 0, torch.zeros_like(last),
        torch.clamp(torch.div(last, bs, rounding_mode="floor") + 1, max=nblk),
    )
    return blocks * bs


def paged_flash_decode_reference(
    q: torch.Tensor,             # (b, N, D) single query — or (b, t, N, D)
    k_pool: torch.Tensor,        # (num_blocks, bs, NKV, D)
    v_pool: torch.Tensor,        # (num_blocks, bs, NKV, D)
    block_tables: torch.Tensor,  # (b, W) int
    positions: torch.Tensor,     # (b,) int — row of the FIRST fresh query
    *,
    kv_limit: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # (num_blocks, bs, NKV) fp16
    v_scale: Optional[torch.Tensor] = None,
    quant_mxu: bool = False,
    row_live: Optional[torch.Tensor] = None,  # (b,) int live query rows
    tree_bits: Optional[torch.Tensor] = None,  # (b, t) int ancestor masks
) -> torch.Tensor:
    """The plain PyTorch version of :func:`paged_flash_decode`: gather the
    first ``ceil(kv_limit / bs)`` table blocks of every lane, then one
    masked softmax in fp32 (q·k of the input-dtype operands accumulated in
    fp32, times ``D ** -0.5``). Returns q's shape in q's dtype. It
    materializes the (b, kv_limit, NKV, D) gather the kernel avoids.

    The mask is the TPU kernel's: ``row <= positions + ti`` (under
    ``tree_bits``: ``row < positions``, or bit ``row - positions`` of node
    ``ti``'s mask) within the rows its walk reads (:func:`walked_rows`;
    under ``row_live`` the walk ends at each lane's live frontier). A query
    row that sees no row gives 0, as the kernel's combine does (``l ==
    0``).

    A quantized pool follows the TPU kernel step for step: K and V
    dequantized and rounded to q's dtype; under ``quant_mxu`` the scores
    are ``acc * q_scale * k_scale * sm_scale`` (int8) or ``acc * k_scale *
    sm_scale`` (fp8), multiplied in that order."""
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    scores, mask, v_all = _masked_scores(
        q4, k_pool, v_pool, block_tables, positions, kv_limit=kv_limit,
        k_scale=k_scale, v_scale=v_scale, quant_mxu=quant_mxu, row_live=row_live,
        tree_bits=tree_bits,
    )
    b, t, n, d = q4.shape
    # a row with no visible key softmaxes to NaN; the kernel gives it 0
    probs = torch.softmax(scores, dim=-1).masked_fill(~mask, 0.0)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v_all).reshape(b, t, n, d)
    out = out.to(q.dtype)
    return out[:, 0] if squeeze else out


def _masked_scores(q, k_pool, v_pool, block_tables, positions, *, kv_limit,
                   k_scale, v_scale, quant_mxu, row_live, tree_bits):
    """The plain version's fp32 scores of a 4-dim q over the gathered rows,
    (b, NKV, G, t, nblk * bs), -inf where masked; the mask, broadcastable
    to them; and the gathered V in fp32 (dequantized and rounded to q's
    dtype on a quantized pool), (b, nblk * bs, NKV, D)."""
    quantized = _check_scales(k_pool, k_scale, v_scale, quant_mxu)
    b, t, n, d = q.shape
    _, bs, nkv, _ = k_pool.shape
    g = n // nkv
    sm_scale = d ** -0.5
    _check_row_live(row_live, b)
    _check_tree_bits(tree_bits, b, t)
    nblk, _, _ = _geometry(q, k_pool, block_tables, kv_limit, 1)
    blocks = block_tables[:, :nblk].long()                      # (b, nblk)
    k_all = k_pool[blocks].reshape(b, nblk * bs, nkv, d)
    v_all = v_pool[blocks].reshape(b, nblk * bs, nkv, d)
    if quantized:
        ks_all = k_scale[blocks].reshape(b, nblk * bs, nkv)
        vs_all = v_scale[blocks].reshape(b, nblk * bs, nkv)
        v_all = kv_dequantize(v_all, vs_all, q.dtype)
    v_all = v_all.float()
    qg = q.float().reshape(b, t, nkv, g, d)
    if quant_mxu:
        # the k scale of each column, and the integer (int8) or fp8 payload
        # widened to fp32: products and their sums over D stay exact in
        # fp32 for int8 (|sum| <= 127 * 127 * D < 2^24), as the int32
        # accumulation of the TPU kernel
        ks_col = ks_all.float().permute(0, 2, 1)[:, :, None, None, :]  # (b,k,1,1,S)
        if k_pool.dtype == torch.int8:
            q_scl = qg.abs().amax(dim=-1).clamp_min(1e-6) / 127.0     # (b,t,k,g)
            q_i8 = torch.clamp(torch.round(qg / q_scl[..., None]), -127.0, 127.0)
            acc = torch.einsum("btkgd,bskd->bkgts", q_i8, k_all.float())
            scores = (
                acc * q_scl.permute(0, 2, 3, 1)[..., None] * ks_col * sm_scale
            )
        else:
            q8 = fp8_query(qg, k_pool.dtype)
            acc = torch.einsum("btkgd,bskd->bkgts", q8, k_all.float())
            scores = acc * ks_col * sm_scale
    else:
        if quantized:
            k_all = kv_dequantize(k_all, ks_all, q.dtype)
        scores = torch.einsum("btkgd,bskd->bkgts", qg, k_all.float()) * sm_scale
    rows = torch.arange(nblk * bs, device=q.device)
    if tree_bits is None:
        last = positions.long()[:, None] + torch.arange(t, device=q.device)[None, :]
        seen = rows[None, None, :] <= last[:, :, None]            # (b, t, S)
    else:
        u = rows[None, None, :] - positions.long()[:, None, None]  # (b, 1, S)
        bit = (tree_bits.long()[:, :, None] >> u.clamp(0, MAX_TREE_NODES - 1)) & 1
        seen = (u < 0) | ((u < t) & (bit > 0))                    # (b, t, S)
    walked = walked_rows(positions, t, nblk, bs, row_live)        # (b,)
    mask = seen & (rows[None, None, :] < walked[:, None, None])
    mask = mask[:, None, None]
    return scores.masked_fill(~mask, float("-inf")), mask, v_all


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
    _check_scales(k_pool, k_scale, v_scale, quant_mxu)
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    _check_row_live(row_live, q4.shape[0])
    _check_tree_bits(tree_bits, q4.shape[0], q4.shape[1])
    nblk, splits, bps = _geometry(q4, k_pool, block_tables, kv_limit, num_splits)
    dev = q.device.type
    if dev == "cpu":
        return paged_flash_decode_reference(
            q, k_pool, v_pool, block_tables, positions, kv_limit=kv_limit,
            k_scale=k_scale, v_scale=v_scale, quant_mxu=quant_mxu,
            row_live=row_live, tree_bits=tree_bits,
        )
    if dev != "cuda":
        raise RuntimeError(
            f"paged_flash_decode runs its CUDA kernel on cuda tensors and its "
            f"plain version on cpu tensors; got a {dev!r} tensor"
        )
    out = _launch(
        q4, k_pool, v_pool, block_tables, positions, nblk, splits, bps,
        k_scale=k_scale, v_scale=v_scale, quant_mxu=quant_mxu, row_live=row_live,
        tree_bits=tree_bits,
    )
    return out[:, 0] if squeeze else out


#: the kernels' payload kinds, by pool dtype (csrc/paged_common.cuh KvKind)
KV_KINDS = {
    torch.bfloat16: 0,
    torch.int8: 1,
    torch.float8_e4m3fn: 2,
    torch.float8_e5m2: 3,
}

def kernel_route(kv_dtype: torch.dtype, t: int, group: int, head_dim: int) -> str:
    """Which CUDA source a launch goes to, for ``head_dim`` in
    ``KERNEL_HEAD_DIMS``: ``"t1"`` (csrc/paged_decode_t1.cu) for every t ==
    1 call with ``group <= T1_MAX_GROUP``; ``"tile"``
    (csrc/paged_decode_tile.cu) for every call with ``t > 1`` and ``t *
    group <= TILE_MAX_ROWS``; ``"split"`` (csrc/paged_decode.cu) for every
    other call. Each source takes every payload ``kv_dtype`` may name
    (bf16, int8, fp8 e4m3 or e5m2), so the pool's dtype moves no call."""
    if head_dim in KERNEL_HEAD_DIMS:
        if t == 1 and group <= T1_MAX_GROUP:
            return "t1"
        if t > 1 and t * group <= TILE_MAX_ROWS:
            return "tile"
    return "split"


def _entry(source: str, n_ptrs: int, n_ints: int):
    """The C entry point of csrc/<source>.cu, built at first use: ``n_ptrs``
    pointers, ``n_ints`` ints, then the softmax scale and the stream (every
    pointer and the stream passed as ``c_void_p``)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels._build import load

    fn = getattr(load(source), source)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
            ctypes.c_float, ctypes.c_void_p,
        ]
    return fn


def _kernel():
    return _entry("paged_decode", 13, 12)


def _tile_kernel():
    return _entry("paged_decode_tile", 13, 12)


def _t1_kernel():
    return _entry("paged_decode_t1", 14, 10)


# each device's (lane, kv head) arrival counters of csrc/paged_decode_t1.cu:
# zero between launches (the last split of a lane to arrive resets its own),
# so one buffer serves every launch on the device's stream, a CUDA graph's
# replays included. A graph keeps the address it captured, so the buffer
# must be sized by an eager launch of the same (lane, kv head) count before
# any capture, and raises if it would grow under one
_T1_ARRIVALS: dict = {}


def _t1_arrivals(device: torch.device, n: int) -> torch.Tensor:
    buf = _T1_ARRIVALS.get(device)
    if buf is None or buf.numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            # memory allocated under a capture belongs to the graph's pool,
            # which other graphs reuse: eager launches would then share
            # their counters with whatever a replay writes there
            raise RuntimeError(
                f"_t1_arrivals: {n} arrival counters on {device} would be "
                "allocated during a CUDA graph capture; an eager launch at "
                "this batch must size them before the first capture"
            )
        buf = _T1_ARRIVALS[device] = torch.zeros(n, dtype=torch.int32, device=device)
    return buf


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(
    q, k_pool, v_pool, block_tables, positions, nblk, splits, bps, *,
    k_scale=None, v_scale=None, quant_mxu=False, row_live=None, tree_bits=None,
    kernel="auto",
):
    """Validate and launch one call. ``kernel`` is ``"auto"`` on every path
    of the port (:func:`kernel_route` picks the source); ``"split"``,
    ``"tile"`` or ``"t1"`` forces one, for a comparison of two sources at
    the same call (``"tile"`` and ``"t1"`` raise on a call that their
    source does not take). ``splits`` and ``bps`` are ``_geometry``'s for
    the source; csrc/paged_decode_t1.cu cuts each lane's own walk into at
    most ``splits`` ranges and takes no ``bps``. A build or launch error
    raises: nothing retries on another source."""
    b, t, n, d = q.shape
    nb, bs, nkv, _ = k_pool.shape
    g = n // nkv
    quantized = k_scale is not None
    tensors = dict(
        q=q, k_pool=k_pool, v_pool=v_pool, block_tables=block_tables,
        positions=positions,
    )
    if quantized:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    if row_live is not None:
        tensors.update(row_live=row_live)
    if tree_bits is not None:
        tensors.update(tree_bits=tree_bits)
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes a bf16 q, got {q.dtype}")
    if quantized:
        payloads = (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2)
        if k_pool.dtype not in payloads or v_pool.dtype != k_pool.dtype:
            raise ValueError(
                f"the CUDA kernel takes int8, fp8_e4m3 or fp8_e5m2 payloads of "
                f"one dtype with scales, got k_pool {k_pool.dtype}, v_pool "
                f"{v_pool.dtype}"
            )
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if x.dtype != torch.float16:
                raise ValueError(f"{name} must be float16, got {x.dtype}")
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    elif k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16:
        raise ValueError(
            f"the CUDA kernel takes bf16 pools without scales, got k_pool "
            f"{k_pool.dtype}, v_pool {v_pool.dtype}"
        )
    for name in ("block_tables", "positions", "row_live", "tree_bits"):
        if name in tensors and tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    if v_pool.shape != k_pool.shape or tuple(q.shape[-1:]) != (k_pool.shape[-1],):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k_pool {tuple(k_pool.shape)}, "
            f"v_pool {tuple(v_pool.shape)}"
        )
    if (positions.shape != (b,) or block_tables.shape[0] != b
            or (row_live is not None and row_live.shape != (b,))):
        raise ValueError(
            "block_tables, positions and row_live must have one row per lane"
        )
    if bs != KERNEL_BLOCK_SIZE or d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the CUDA kernel takes block_size {KERNEL_BLOCK_SIZE} and head_dim "
            f"in {KERNEL_HEAD_DIMS}; got block_size {bs}, head_dim {d}"
        )
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the kernel's vector K/V loads need 16-byte aligned pools")
    if kernel not in ("auto", "split", "tile", "t1"):
        raise ValueError(
            f"kernel must be 'auto', 'split', 'tile' or 't1', got {kernel!r}")
    route = "split" if kernel == "split" else kernel_route(k_pool.dtype, t, g, d)
    if kernel == "tile" and route != "tile":
        raise ValueError(
            f"csrc/paged_decode_tile.cu takes 1 < t and t * G <= {TILE_MAX_ROWS}; got "
            f"t {t}, G {g}"
        )
    if kernel == "t1" and route != "t1":
        raise ValueError(
            f"csrc/paged_decode_t1.cu takes t == 1 and G <= {T1_MAX_GROUP}; got t "
            f"{t}, G {g}"
        )

    tg = t * g
    parts = torch.empty(b * nkv * splits * tg * (d + 2), dtype=torch.float32,
                        device=q.device)
    o_parts, m_parts, l_parts = parts.split(
        (b * nkv * splits * tg * d, b * nkv * splits * tg, b * nkv * splits * tg))
    out = torch.empty_like(q)
    masks = (
        row_live.data_ptr() if row_live is not None else None,
        tree_bits.data_ptr() if tree_bits is not None else None,
    )
    ptrs = (o_parts.data_ptr(), m_parts.data_ptr(), l_parts.data_ptr(), out.data_ptr())
    head = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr())
    lookup = (block_tables.data_ptr(), positions.data_ptr())
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if quantized else (None, None)
    mode = (KV_KINDS[k_pool.dtype], int(quant_mxu))
    w = block_tables.shape[1]
    if route == "t1":
        arrivals = _t1_arrivals(q.device, b * nkv)
        err = _t1_kernel()(
            *head, *scales, *lookup, *masks, *ptrs, arrivals.data_ptr(),
            b, n, nkv, d, bs, w, nblk, splits, *mode, d ** -0.5, _stream(q.device),
        )
    else:
        entry = _tile_kernel() if route == "tile" else _kernel()
        err = entry(
            *head, *scales, *lookup, *masks, *ptrs, b, t, n, nkv, d, bs, w, nblk, splits,
            bps, *mode, d ** -0.5, _stream(q.device),
        )
    if err != 0:
        source = "paged_decode" if route == "split" else f"paged_decode_{route}"
        raise RuntimeError(f"{source} launch failed: cudaError_t {err}")
    launches.count += 1
    if route == "tile":
        tile_launches.count += 1
    if route == "t1":
        t1_launches.count += 1
    if row_live is not None:
        row_live_launches.count += 1
    if tree_bits is not None:
        tree_launches.count += 1
    return out
