"""Flash attention: causal (or full) GQA attention, forward and backward.

Counterpart of two JAX modules in one:

- ``neuronx_distributed_llama3_2_tpu/kernels/flash_attention.py``: the
  dispatching :func:`flash_attention`, the plain blockwise
  :func:`flash_attention_reference` and :func:`blockwise_attention_stats`;
- ``neuronx_distributed_llama3_2_tpu/kernels/pallas_flash_attention.py``:
  :func:`flash_fwd` / :func:`flash_bwd` (``_flash_fwd`` / ``_flash_bwd``,
  same (B, N, S, D) layout and dtypes), the autograd function
  :class:`_FlashAttention` (the ``custom_vjp``) and the (B, S, N, D) entry
  point :func:`pallas_flash_attention`.

On a CUDA tensor :func:`flash_fwd` launches the hand-written CUDA C++
kernel K1 of ``csrc/flash_fwd.cu`` and :func:`flash_bwd` the kernels K2
(dq) and K3 (dk/dv) of ``csrc/flash_bwd.cu`` (built for ``sm_90a`` at first
use, see :mod:`._build`). All three have one design: two warpgroups a
block run every product on ``wgmma``, the block's own operand tile stays
in shared memory, and the tiles it walks over stream through a TMA ring
(the PTX pieces are in ``csrc/sm90.cuh``). On a CPU tensor they run their
plain PyTorch versions :func:`flash_fwd_reference` /
:func:`flash_bwd_reference`. Any other device raises: there is no
fallback from one to the other.

The plain versions round where the TPU kernels round: scores in fp32 from
the input-dtype operands, ``sm_scale`` on the fp32 product, softmax weights
rounded to the value dtype before P·V, dS rounded to the k/q dtype before
the dq and dk products, dq/dk/dv accumulated in fp32 and cast once. They
walk kv in chunks of ``block_kv`` as the TPU kernel walks its kv blocks;
the CUDA kernels use tiles of their own (stated in the sources).

The ``segment_ids`` mode (packed documents: a (q, kv) pair attends only
where the two positions carry the same id) needs Sq == Skv and one (B, S)
id array; on a CUDA tensor the ids go to all three kernels as contiguous
int32, where every tile compares them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from neuronx_distributed_llama3_2_tpu_torch.kernels.paged_attention import (
    LaunchCounter,
)

# plain-version chunking (the JAX dispatcher's defaults)
DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_KV = 512
# what csrc/flash_fwd.cu and csrc/flash_bwd.cu are compiled for
KERNEL_HEAD_DIMS = (64, 128)

#: launches of K1 (flash forward) in this process
fwd_launches = LaunchCounter()
#: launches of K2 (flash backward, dq) in this process
bwd_dq_launches = LaunchCounter()
#: launches of K3 (flash backward, dk/dv) in this process
bwd_dkv_launches = LaunchCounter()

NEG = -1e30  # the blockwise reference's mask value (flash_attention.py:64)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _mask(q_pos, kv_pos, causal, segment_ids):
    """(B or 1, 1, 1, Sq, Skv_chunk) bool: which (q, kv) pairs attend.
    ``segment_ids`` (B, S) masks across documents; ``q_pos`` / ``kv_pos``
    index it."""
    mask = torch.ones(
        (q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool, device=q_pos.device
    )
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]
    mask = mask[None, None, None]
    if segment_ids is not None:
        seg = segment_ids.long()
        same = seg[:, q_pos][:, :, None] == seg[:, kv_pos][:, None, :]
        mask = mask & same[:, None, None]
    return mask


def flash_fwd_reference(
    q: torch.Tensor,             # (B, N, Sq, D)
    k: torch.Tensor,             # (B, Nkv, Skv, D)
    v: torch.Tensor,             # (B, Nkv, Skv, D)
    segment_ids: Optional[torch.Tensor],
    causal: bool,
    sm_scale: float,
    block_kv: Optional[int] = None,
):
    """The plain PyTorch version of :func:`flash_fwd`: online softmax over
    kv chunks of ``block_kv`` (all of Skv when None) with the TPU kernel's
    roundings and its ``m == -inf`` guards. Returns o (B, N, Sq, D) in q's
    dtype and lse (B, N, Sq) fp32 (-inf, with o = 0, for a row with no
    key)."""
    b, n, sq, d = q.shape
    nkv, skv = k.shape[1], k.shape[2]
    g = n // nkv
    qf = q.float().reshape(b, nkv, g, sq, d)
    bk = skv if block_kv is None else block_kv
    dev = q.device
    q_pos = torch.arange(sq, device=dev)
    m = torch.full((b, nkv, g, sq), float("-inf"), device=dev)
    l = torch.zeros((b, nkv, g, sq), device=dev)
    acc = torch.zeros((b, nkv, g, sq, d), device=dev)
    for s0 in range(0, skv, bk):
        kc = k[:, :, s0:s0 + bk].float()
        vc = v[:, :, s0:s0 + bk]
        kv_pos = torch.arange(s0, s0 + kc.shape[2], device=dev)
        s = torch.einsum("bkgqd,bkjd->bkgqj", qf, kc) * sm_scale
        mask = _mask(q_pos, kv_pos, causal, segment_ids)
        s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.where(m == float("-inf"), 0.0, torch.exp(m - m_new))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgqj,bkjd->bkgqd", p.to(v.dtype).float(), vc.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    safe_l = torch.where(l == 0.0, 1.0, l)
    o = (acc / safe_l[..., None]).to(q.dtype).reshape(b, n, sq, d)
    lse = torch.where(m == float("-inf"), float("-inf"), m + torch.log(safe_l))
    return o, lse.reshape(b, n, sq)


def flash_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, segment_ids: Optional[torch.Tensor],
    causal: bool, sm_scale: float, block_kv: Optional[int] = None,
):
    """The plain PyTorch version of :func:`flash_bwd`: P rebuilt from
    (q, k, lse), δ = rowsum(o·do), per kv chunk of ``block_kv``
    dq += s·bf16(dS)·K, dv = Σ_q bf16(P)ᵀ·dO, dk = s·Σ_q bf16(dS)ᵀ·Q, with
    the GQA group summed in fp32. Returns (dq, dk, dv) in q's, k's and v's
    dtypes."""
    b, n, sq, d = q.shape
    nkv, skv = k.shape[1], k.shape[2]
    g = n // nkv
    dev = q.device
    delta = (o.float() * do.float()).sum(dim=-1).reshape(b, nkv, g, sq)
    qf = q.float().reshape(b, nkv, g, sq, d)
    dof = do.float().reshape(b, nkv, g, sq, d)
    lse_ = lse.float().reshape(b, nkv, g, sq)
    bk = skv if block_kv is None else block_kv
    q_pos = torch.arange(sq, device=dev)
    dq = torch.zeros((b, nkv, g, sq, d), device=dev)
    dk = torch.zeros((b, nkv, skv, d), device=dev)
    dv = torch.zeros((b, nkv, skv, d), device=dev)
    for s0 in range(0, skv, bk):
        kc = k[:, :, s0:s0 + bk].float()
        vc = v[:, :, s0:s0 + bk].float()
        e = s0 + kc.shape[2]
        kv_pos = torch.arange(s0, e, device=dev)
        s = torch.einsum("bkgqd,bkjd->bkgqj", qf, kc) * sm_scale
        mask = _mask(q_pos, kv_pos, causal, segment_ids)
        p = torch.where(mask, torch.exp(s - lse_[..., None]), 0.0)
        dp = torch.einsum("bkgqd,bkjd->bkgqj", dof, vc)
        ds = (p * (dp - delta[..., None])).to(k.dtype).float()
        dq += sm_scale * torch.einsum("bkgqj,bkjd->bkgqd", ds, kc)
        dv[:, :, s0:e] = torch.einsum(
            "bkgqj,bkgqd->bkjd", p.to(do.dtype).float(), dof
        )
        dk[:, :, s0:e] = sm_scale * torch.einsum("bkgqj,bkgqd->bkjd", ds, qf)
    return (
        dq.reshape(b, n, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    )


# ---------------------------------------------------------------------------
# the kernel pair: CUDA kernels on cuda tensors, plain versions on cpu
# ---------------------------------------------------------------------------

def _route(name: str, q: torch.Tensor, k: torch.Tensor, segment_ids) -> str:
    """The device the kernel pair runs on, after checking ``segment_ids``:
    one (B, S) array with S = Sq = Skv, as ``_seg_operands`` pads one array
    for both sides in the JAX package."""
    dev = q.device.type
    if dev not in ("cpu", "cuda"):
        raise RuntimeError(
            f"{name} runs its CUDA kernels on cuda tensors and its plain "
            f"version on cpu tensors; got a {dev!r} tensor"
        )
    if segment_ids is not None:
        b, _, sq, _ = q.shape
        if q.shape[2] != k.shape[2] or tuple(segment_ids.shape) != (b, sq):
            raise ValueError(
                f"{name}: segment_ids must be (B, S) = ({b}, {sq}) with Sq == "
                f"Skv; got segment_ids {tuple(segment_ids.shape)}, q "
                f"{tuple(q.shape)}, k {tuple(k.shape)}"
            )
        if segment_ids.dtype.is_floating_point or segment_ids.dtype == torch.bool:
            raise ValueError(f"{name}: segment_ids must be integer ids, got {segment_ids.dtype}")
    return dev


def flash_fwd(q, k, v, segment_ids, causal, sm_scale,
              block_q: int = DEFAULT_BLOCK_Q,
              block_kv: int = DEFAULT_BLOCK_KV):
    """q (B, N, Sq, D), k/v (B, Nkv, Skv, D) -> o (B, N, Sq, D) in q's
    dtype, lse (B, N, Sq) fp32. ``block_q`` / ``block_kv`` are TPU tile
    sizes: they set the chunking of the plain version only."""
    del block_q  # the plain version is not tiled over q
    if _route("flash_fwd", q, k, segment_ids) == "cpu":
        return flash_fwd_reference(
            q, k, v, segment_ids, causal, sm_scale, block_kv=block_kv
        )
    return _launch_fwd(q, k, v, segment_ids, causal, sm_scale)


def flash_bwd(q, k, v, o, lse, do, segment_ids, causal, sm_scale,
              block_q: int = DEFAULT_BLOCK_Q,
              block_kv: int = DEFAULT_BLOCK_KV):
    """-> (dq, dk, dv) in q's, k's and v's dtypes. δ = rowsum(o·do) is a
    plain torch op outside the kernels, as in the JAX package."""
    del block_q
    if _route("flash_bwd", q, k, segment_ids) == "cpu":
        return flash_bwd_reference(
            q, k, v, o, lse, do, segment_ids, causal, sm_scale,
            block_kv=block_kv,
        )
    delta = (o.float() * do.float()).sum(dim=-1)
    return _launch_bwd(q, k, v, do, lse, delta, segment_ids, causal, sm_scale)


class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of ``pallas_flash_attention.py:476-495``: the
    forward keeps (q, k, v, o, lse), the backward runs :func:`flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, sm_scale, block_q, block_kv):
        o, lse = flash_fwd(q, k, v, segment_ids, causal, sm_scale, block_q, block_kv)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.segment_ids = segment_ids
        ctx.args = (causal, sm_scale, block_q, block_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale, block_q, block_kv = ctx.args
        dq, dk, dv = flash_bwd(
            q, k, v, o, lse, do, ctx.segment_ids, causal, sm_scale,
            block_q, block_kv,
        )
        return dq, dk, dv, None, None, None, None, None


def pallas_flash_attention(q, k, v, causal: bool = True, segment_ids=None,
                           block_q: int = DEFAULT_BLOCK_Q,
                           block_kv: int = DEFAULT_BLOCK_KV):
    """(B, S, N, D) entry point of the kernel pair, named after its JAX
    counterpart: the CUDA kernels on the card, their plain versions on the
    CPU. Returns (B, S, N, D)."""
    o = _FlashAttention.apply(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), segment_ids,
        causal, q.shape[-1] ** -0.5, block_q, block_kv,
    )
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# dispatch and the plain blockwise path
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, causal: bool = True, segment_ids=None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_kv: int = DEFAULT_BLOCK_KV):
    """Causal (or full) attention over (B, S, N, D) q and (B, S, Nkv, D)
    k/v with Nkv | N; returns (B, S, N, D). Both devices go through
    :func:`pallas_flash_attention`, whose autograd function runs the CUDA
    kernels on a CUDA tensor and their plain versions on a CPU tensor, so
    the CPU runs the forward/backward route the card runs. (The JAX
    dispatcher sends a non-TPU backend to its blockwise jnp path; here
    :func:`flash_attention_reference` is that path, kept as a reference.)"""
    return pallas_flash_attention(
        q, k, v, causal=causal, segment_ids=segment_ids,
        block_q=block_q, block_kv=block_kv,
    )


def blockwise_attention_stats(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    q_off: int = 0, kv_off: int = 0, kv_len: Optional[int] = None,
    block_kv: int = DEFAULT_BLOCK_KV,
):
    """Online-softmax block loop returning the combinable triple
    ``(acc, m, l)``: acc (B, Sq, Nkv, G, D), m / l (B, Sq, Nkv, G), fp32.
    ``q_off`` / ``kv_off`` are the global positions of q[:, 0] / k[:, 0];
    ``kv_len`` masks positions >= it. Each block step runs under
    ``torch.utils.checkpoint`` when autograd records, so the backward
    recomputes the (Sq, block) score tile instead of keeping every block's
    softmax."""
    b, sq, n, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    g = n // nkv
    dev = q.device
    qg = q.reshape(b, sq, nkv, g, d).float() * d ** -0.5
    bk = min(block_kv, skv)
    if segment_ids is not None and q_segment_ids is None:
        q_segment_ids = segment_ids
    q_pos = q_off + torch.arange(sq, device=dev)

    def step(acc, m, l, kblk, vblk, s0):
        kv_pos = kv_off + s0 + torch.arange(kblk.shape[1], device=dev)
        s = torch.einsum("bsngd,btnd->bsngt", qg, kblk)
        mask = torch.ones((sq, kblk.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]
        if kv_len is not None:
            mask = mask & (kv_pos < kv_len)[None, :]
        mask = mask[None, :, None, None, :]
        if segment_ids is not None:
            seg_kv = segment_ids[:, s0:s0 + kblk.shape[1]]
            ok = seg_kv[:, None, :] == q_segment_ids[:, :, None]
            mask = mask & ok[:, :, None, None, :]
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l_new = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bsngt,btnd->bsngd", p, vblk)
        return acc, m_new, l_new

    acc = torch.zeros((b, sq, nkv, g, d), device=dev)
    m = torch.full((b, sq, nkv, g), NEG, device=dev)
    l = torch.zeros((b, sq, nkv, g), device=dev)
    for s0 in range(0, skv, bk):
        kblk = k[:, s0:s0 + bk].float()
        vblk = v[:, s0:s0 + bk].float()
        if torch.is_grad_enabled():
            acc, m, l = checkpoint(step, acc, m, l, kblk, vblk, s0, use_reentrant=False)
        else:
            acc, m, l = step(acc, m, l, kblk, vblk, s0)
    return acc, m, l


def flash_attention_reference(q, k, v, causal: bool = True, segment_ids=None,
                              block_kv: int = DEFAULT_BLOCK_KV):
    """Plain blockwise attention (fp32 inside, q's dtype out); autograd
    differentiates it through :func:`blockwise_attention_stats`."""
    b, sq, n, d = q.shape
    acc, m, l = blockwise_attention_stats(
        q, k, v, causal=causal, segment_ids=segment_ids, block_kv=block_kv
    )
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, n, d).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _kernel(lib: str, name: str, n_ptrs: int):
    """The C entry point ``name`` of csrc/<lib>.cu, built at first use:
    ``n_ptrs`` pointers (the last the segment ids, null for none), then b,
    N, Nkv, Sq, Skv, D, causal as ints, the scale and the stream."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels._build import load

    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
    return fn


def _checked(q, k, v, **more):
    """Contiguous bf16 views of the inputs, validated for the kernels."""
    b, n, sq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    nkv = k.shape[1]
    if n % nkv:
        raise ValueError(f"q heads ({n}) must be a multiple of kv heads ({nkv})")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    out = {}
    for name, x in dict(q=q, k=k, v=v, **more).items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        want = torch.float32 if name in ("lse", "delta") else torch.bfloat16
        if x.dtype != want:
            raise ValueError(f"the CUDA kernels take a {want} {name}, got {x.dtype}")
        x = x.contiguous()
        if x.data_ptr() % 16:
            raise ValueError(f"the kernels' TMA copies need a 16-byte aligned {name}")
        out[name] = x
    return out


def _geometry(q, k):
    b, n, sq, d = q.shape
    return b, n, k.shape[1], sq, k.shape[2], d


def _seg_ids(segment_ids, q):
    """The kernels' segment operand: the ids as contiguous int32 on q's
    device (kept alive by the caller until the launch is queued), or None,
    passed as a null pointer."""
    if segment_ids is None:
        return None
    if segment_ids.device != q.device:
        raise ValueError(f"segment_ids is on {segment_ids.device}, q on {q.device}")
    return segment_ids.to(torch.int32).contiguous()


def _ptr(x) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _launch_fwd(q, k, v, segment_ids, causal, sm_scale):
    t = _checked(q, k, v)
    seg = _seg_ids(segment_ids, q)
    b, n, nkv, sq, skv, d = _geometry(q, k)
    o = torch.empty((b, n, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel("flash_fwd", "flash_fwd_bf16", 6)(
        t["q"].data_ptr(), t["k"].data_ptr(), t["v"].data_ptr(),
        o.data_ptr(), lse.data_ptr(), _ptr(seg), b, n, nkv, sq, skv, d,
        int(causal), float(sm_scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd_bf16 launch failed: cudaError_t {err}")
    fwd_launches.count += 1
    return o, lse


def _launch_bwd(q, k, v, do, lse, delta, segment_ids, causal, sm_scale):
    t = _checked(q, k, v, do=do, lse=lse, delta=delta)
    seg = _seg_ids(segment_ids, q)
    b, n, nkv, sq, skv, d = _geometry(q, k)
    if t["do"].shape != q.shape or t["lse"].shape != (b, n, sq):
        raise ValueError(
            f"do {tuple(do.shape)} / lse {tuple(lse.shape)} do not match q "
            f"{tuple(q.shape)}"
        )
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [t[x].data_ptr() for x in ("q", "k", "v", "do", "lse", "delta")]
    dims = (b, n, nkv, sq, skv, d, int(causal), float(sm_scale), stream)

    dq = torch.empty_like(t["q"])
    err = _kernel("flash_bwd", "flash_bwd_dq_bf16", 8)(
        *ptrs, dq.data_ptr(), _ptr(seg), *dims
    )
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq_bf16 launch failed: cudaError_t {err}")
    bwd_dq_launches.count += 1

    dk = torch.empty_like(t["k"])
    dv = torch.empty_like(t["v"])
    err = _kernel("flash_bwd", "flash_bwd_dkv_bf16", 9)(
        *ptrs, dk.data_ptr(), dv.data_ptr(), _ptr(seg), *dims
    )
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv_bf16 launch failed: cudaError_t {err}")
    bwd_dkv_launches.count += 1
    return dq, dk, dv
