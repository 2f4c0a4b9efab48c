"""Llama-3 / Llama-3.2 model family, in PyTorch.

Counterpart of ``neuronx_distributed_llama3_2_tpu/models/llama.py``. Each
class keeps its JAX name and its parameter layout, so a weight pytree
crosses between the packages through :func:`params_from_jax` /
:func:`params_to_jax` without reshuffling:

- decoder layers are an ``nn.ModuleList`` (the JAX package stacks them on
  a leading L axis and scans; the bridge stacks and unstacks);
- linear kernels are stored (in, out) and applied as ``x @ kernel``;
- the fused SwiGLU weight is ``gate_up`` (H, 2, I);
- norm scales are fp32 whatever the compute dtype;
- the LM head is tied to the embedding unless the config says otherwise.

A model built under a live parallel state (:mod:`..parallel.state`) holds
this rank's shards, the ones the JAX ``specs()`` give it (:func:`param_specs`):
the attention heads and the SwiGLU's intermediate width split over tp
through :mod:`..parallel.layers`, the embedding (and the LM head tied to
it) split along the vocab, the norms replicated. Under sequence
parallelism the norms and residual adds run on sequence shards (the
embedding reduce-scatters, each column-parallel product all-gathers the
sequence, each row-parallel one reduce-scatters it), and attention, K1-K3
with ``use_flash_attention``, sees the whole sequence. Under context
parallelism (a mesh with cp > 1) each cp rank holds one chunk of every
sequence: the tokens, their positions and the shifted labels are permuted
once into the ring's layout (``cp_ring_layout``) and cut before the
embedding, attention is the ring over the cp group
(:mod:`..kernels.ring_attention`), and the loss sums and token counts are
all-reduced over cp. Under pipeline parallelism (a mesh with pp > 1) the
model is one stage (:class:`Stage`): it holds its stage's decoder layers
under their global names (``layers.<i>``), the embedding on the first stage
(and on the last, when the head is tied to it), the final norm and the head
on the last; :mod:`..pipeline` runs the stages. The MoE families
(:mod:`.mixtral`, :mod:`.dbrx`) subclass :class:`LlamaForCausalLM` with
their own decoder layer (``layer_class``); their expert leaves are split
over ep (:func:`param_specs`).

Training runs :meth:`LlamaForCausalLM.loss` (the chunked cross-entropy of
``loss_chunk_size``, vocab-parallel under tp) and the flash-attention
kernels when ``use_flash_attention`` is set. Each decoder layer runs under
the config's remat policy (JAX ``_remat_policy``), through
``torch.utils.checkpoint``:

- ``"none"`` keeps every activation; ``"full"`` keeps only the layer's
  input and recomputes the layer in the backward (``nothing_saveable``);
- ``"selective"`` keeps the outputs of the projections (``aten.mm``), not
  the attention's batched products (``dots_with_no_batch_dims_saveable``),
  and ``"dots"`` keeps every product's (``dots_saveable``): selective
  activation checkpointing with a policy over aten ops;
- ``"hybrid"`` keeps post-RoPE q, k, v and the attention output, and
  ``"kv"`` all of them but q (JAX's ``checkpoint_name`` sites ``q_rope``,
  ``kv_rope``, ``attn_out``): checkpointed segments between those tensors
  (:meth:`LlamaDecoderLayer.forward_named`).

The flash kernels are launched through ctypes inside an autograd function,
which selective checkpointing cannot keep: under every policy that does
not keep the attention output its forward (K1) runs again in the backward
(``FLASH_FWD_PER_LAYER``). A checkpointed segment's recompute runs after
the forward has left the cp layout's declaration, so it re-enters the
layout the forward ran under (:func:`_checkpoint`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from neuronx_distributed_llama3_2_tpu_torch.kernels.flash_attention import (
    DEFAULT_BLOCK_KV,
    DEFAULT_BLOCK_Q,
    flash_attention,
)
from neuronx_distributed_llama3_2_tpu_torch.kernels.ring_attention import (
    active_cp_layout,
    cp_layout,
    cp_layout_from_inv,
    resolve_cp_layout,
)
from neuronx_distributed_llama3_2_tpu_torch.kernels.ring_attention_pallas import (
    ring_attention_pallas,
    zigzag_permutation,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    GQAQKVColumnParallelLinear,
    KERNEL_INIT_STD,
    ParallelEmbedding,
    RowParallelLinear,
    _enter,
    divide,
    kv_mode,
    normal_init_,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.layout import (
    LeafSpec,
    axis_group,
    is_layer_name,
    mesh_coords,
    port_slice,
    region,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import (
    all_gather,
    all_reduce,
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    split,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.loss import (
    IGNORE_INDEX,
    fused_linear_cross_entropy,
    parallel_cross_entropy,
    valid_token_mask,
)
from neuronx_distributed_llama3_2_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Model hyperparameters (the fields of HF ``LlamaConfig``), with the
    JAX package's names and defaults. ``dtype`` is a torch dtype."""

    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 16
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None  # defaults to hidden // heads
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    # HF "llama3" rope_scaling (mandatory for published Llama-3.2 weights):
    # (factor, low_freq_factor, high_freq_factor, original_max_position).
    # None = plain RoPE (Llama-3 8B/70B).
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    dtype: Any = torch.bfloat16
    # training-side knobs, kept so configs read the same in both packages
    remat: str = "selective"
    scan_layers: bool = True
    # attention through kernels/flash_attention.py (the CUDA kernels K1-K3
    # on the card; the plain blockwise path on the CPU)
    use_flash_attention: bool = False
    flash_block_q: Optional[int] = None
    flash_block_kv: Optional[int] = None
    # paged serving decode: read the KV pool through the block table with
    # the hand-written paged-decode kernel (kernels/paged_attention.py)
    # instead of materializing a (b, kv_limit, NKV, D) gather; covers
    # T == 1 token-gen and fresh blocks up to paged_kernel_max_t tokens
    use_paged_kernel: bool = False
    # largest fresh-block length routed through the paged kernel: the t
    # fresh tokens fold into the kernel's query-tile rows, so this bounds
    # the (t * group) tile height
    paged_kernel_max_t: int = 8
    # low-precision q·k on a quantized pool: a later sub-slice
    quant_mxu: bool = False
    loss_chunk_size: Optional[int] = None
    # "rmsnorm" (Llama/Mixtral) | "layernorm" (DBRX/GPT-NeoX family)
    norm_type: str = "rmsnorm"
    norm_bias: bool = False
    # clamp Q/K/V projections to [-clip_qkv, clip_qkv] (DBRX)
    clip_qkv: Optional[float] = None
    # the cp ring's sequence layout: "auto" (zigzag on the card when the
    # sequence splits into 2·cp halves, which balances the causal work over
    # the ring; contiguous on the CPU), "contiguous" or "zigzag" (forced).
    # The model permutes its tokens once outside the layer stack and the
    # attention layers read the layout it declared
    # (kernels.ring_attention.resolve_cp_layout)
    cp_ring_layout: str = "auto"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.hidden_size // self.num_heads)
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        if self.remat not in ("none", "full", "selective", "hybrid", "kv", "dots"):
            raise ValueError(
                f"remat must be none/full/selective/hybrid/kv/dots, got {self.remat!r}"
            )
        if self.norm_type not in ("rmsnorm", "layernorm"):
            raise ValueError(
                f"norm_type must be rmsnorm|layernorm, got {self.norm_type!r}"
            )
        if self.cp_ring_layout not in ("auto", "contiguous", "zigzag"):
            raise ValueError(
                f"cp_ring_layout must be auto|contiguous|zigzag, got {self.cp_ring_layout!r}"
            )


# Published Llama-3.x architectures (HF config.json values).
LLAMA_CONFIGS: Dict[str, LlamaConfig] = {
    "llama3.2-1b": LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
        rope_theta=500000.0, rope_scaling=(32.0, 1.0, 4.0, 8192),
        max_seq_len=131072, tie_word_embeddings=True,
    ),
    "llama3.2-3b": LlamaConfig(
        vocab_size=128256, hidden_size=3072, intermediate_size=8192,
        num_layers=28, num_heads=24, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, rope_scaling=(32.0, 1.0, 4.0, 8192),
        max_seq_len=131072, tie_word_embeddings=True,
    ),
    "llama3-8b": LlamaConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, tie_word_embeddings=False,
    ),
    "llama3-70b": LlamaConfig(
        vocab_size=128256, hidden_size=8192, intermediate_size=28672,
        num_layers=80, num_heads=64, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, tie_word_embeddings=False,
    ),
    # hardware-free test config
    "tiny": LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=4, num_heads=8, num_kv_heads=4, head_dim=8,
        max_seq_len=128, rope_theta=10000.0, dtype=torch.float32,
        remat="none",
    ),
}


# ---------------------------------------------------------------------------
# RMSNorm + RoPE
# ---------------------------------------------------------------------------

def _sp_weight(w, sequence_parallel: bool):
    """A replicated weight read on a sequence shard: its gradient is this
    shard's part, summed over tp in the backward (the reference's
    ``allreduce_sequence_parallel_gradients``, grads.py:313)."""
    if w is None or not sequence_parallel:
        return w
    return copy_to_tensor_model_parallel_region(w)


class RMSNorm(nn.Module):
    """RMS layer norm with fp32 accumulation and an fp32 ``scale``."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16,
                 device=None, sequence_parallel: bool = False):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.sequence_parallel = sequence_parallel
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device)
        )

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        var = h.square().mean(dim=-1, keepdim=True)
        h = h * torch.rsqrt(var + self.eps)
        return (h * _sp_weight(self.scale, self.sequence_parallel)).to(self.dtype)


class LayerNorm(nn.Module):
    """Mean-centered layer norm with fp32 accumulation, optional bias (the
    DBRX/GPT-NeoX-family norm). Same parameter names as :class:`RMSNorm`."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16,
                 bias: bool = False, device=None, sequence_parallel: bool = False):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.sequence_parallel = sequence_parallel
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device)
        )
        self.bias = (
            nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))
            if bias else None
        )

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        h = h - h.mean(dim=-1, keepdim=True)
        var = h.square().mean(dim=-1, keepdim=True)
        h = h * torch.rsqrt(var + self.eps) * _sp_weight(self.scale, self.sequence_parallel)
        if self.bias is not None:
            h = h + _sp_weight(self.bias, self.sequence_parallel)
        return h.to(self.dtype)


def make_norm(config: LlamaConfig, device=None, sequence_parallel: bool = False) -> nn.Module:
    """Norm block per ``config.norm_type``."""
    if config.norm_type == "layernorm":
        return LayerNorm(
            config.hidden_size, config.rms_norm_eps, config.dtype,
            bias=config.norm_bias, device=device, sequence_parallel=sequence_parallel,
        )
    return RMSNorm(config.hidden_size, config.rms_norm_eps, config.dtype,
                   device=device, sequence_parallel=sequence_parallel)


def precompute_rope(
    head_dim: int,
    max_seq_len: int,
    theta: float,
    rope_scaling: Optional[Tuple[float, float, float, int]] = None,
    device: DeviceLike = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables of shape (max_seq_len, head_dim), fp32, in the HF
    layout. ``rope_scaling`` applies HF's "llama3" long-context frequency
    scaling (factor, low_freq_factor, high_freq_factor, original_max)."""
    f32 = torch.float32
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=f32, device=device) / head_dim)
    )
    if rope_scaling is not None:
        factor, low_f, high_f, orig_max = rope_scaling
        wavelen = 2 * math.pi / inv_freq
        smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
        smoothed = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(
            wavelen < orig_max / high_f,  # high freq: untouched
            inv_freq,
            torch.where(
                wavelen > orig_max / low_f,  # low freq: fully scaled
                inv_freq / factor,
                smoothed,  # medium: interpolate
            ),
        )
    t = torch.arange(max_seq_len, dtype=f32, device=device)
    freqs = torch.outer(t, inv_freq)  # (S, D/2)
    emb = torch.cat([freqs, freqs], dim=-1)  # (S, D) — HF layout
    return torch.sin(emb), torch.cos(emb)


def apply_rope(
    x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Rotate (B, S, n, D) by position (HF rotate_half convention)."""
    sin = sin[positions][:, :, None, :]  # (B,S,1,D)
    cos = cos[positions][:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    out = x.float() * cos + rotated.float() * sin
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def core_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(QK^T/√d)V with a causal mask and the softmax in fp32.
    q (B,S,N,D); k/v (B,T,Nkv,D) with Nkv dividing N (GQA repeat here).
    ``bias`` is an fp32 additive mask broadcastable to (B, N, S, T)."""
    b, s, n, d = q.shape
    nkv = k.shape[2]
    if nkv != n:
        rep = n // nkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bsnd,btnd->bnst", q, k) * (d ** -0.5)
    scores = scores.float()
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        st = torch.arange(s, device=q.device)[:, None]
        tt = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = scores.masked_fill(tt > st, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v)


class LlamaAttention(nn.Module):
    """GQA attention block: fused QKV, RoPE, core attention, output
    projection; this rank's ``n_heads`` q heads over ``n_kv_heads`` kv
    heads (all of them at tp = 1)."""

    def __init__(self, config: LlamaConfig, device=None, sequence_parallel: bool = False,
                 qkv_bias: bool = False, o_bias: bool = False):
        super().__init__()
        c = config
        self.config = c
        self.sequence_parallel = sequence_parallel
        self.qkv = GQAQKVColumnParallelLinear(
            c.hidden_size, c.num_heads, c.num_kv_heads, c.head_dim, use_bias=qkv_bias,
            sequence_parallel=sequence_parallel, dtype=c.dtype, device=device,
        )
        self.n_heads = self.qkv.q_local_heads
        self.n_kv_heads = self.qkv.kv_local_heads
        self.o = RowParallelLinear(
            c.num_heads * c.head_dim, c.hidden_size, use_bias=o_bias, dtype=c.dtype,
            sequence_parallel=sequence_parallel, device=device,
        )

    def reset_parameters(self, generator) -> None:
        self.qkv.reset_parameters(generator)
        self.o.reset_parameters(generator)

    def project_qkv(self, x: torch.Tensor):
        """(b, t, H) -> q (b, t, N, D), k/v (b, t, NKV, D), pre-RoPE."""
        c = self.config
        b, t = x.shape[:2]
        q, k, v = self.qkv(x)
        if c.clip_qkv is not None:
            q = q.clamp(-c.clip_qkv, c.clip_qkv)
            k = k.clamp(-c.clip_qkv, c.clip_qkv)
            v = v.clamp(-c.clip_qkv, c.clip_qkv)
        t = q.shape[1]  # the whole sequence, after the SP all-gather
        return (
            q.reshape(b, t, self.n_heads, c.head_dim),
            k.reshape(b, t, self.n_kv_heads, c.head_dim),
            v.reshape(b, t, self.n_kv_heads, c.head_dim),
        )

    def project(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """One of the three projections ("q", "k" or "v") alone, pre-RoPE,
        (b, t, heads, D): the same product as :meth:`project_qkv`'s."""
        c = self.config
        y = self.qkv.project(_enter(x, self.sequence_parallel), name)
        if c.clip_qkv is not None:
            y = y.clamp(-c.clip_qkv, c.clip_qkv)
        heads = self.n_heads if name == "q" else self.n_kv_heads
        return y.reshape(*y.shape[:2], heads, c.head_dim)

    def attend(self, q, k, v) -> torch.Tensor:
        """Causal attention of the post-RoPE q, k, v -> (b, s, N*D), the
        attention output (JAX's ``attn_out``). Under context parallelism q,
        k, v are this rank's chunk of the sequence (a kv head repeated past
        the kv heads under tp is gathered over tp along the heads alone, so
        the sequence stays split over cp) and attention is the ring over the
        cp group, in the layout the backbone declared: the kernel ring (K1-K3
        on the card, their plain versions on the CPU)."""
        c = self.config
        b, s = q.shape[:2]
        if parallel_state.context_parallel_size_or(1) > 1:
            attn = ring_attention_pallas(q, k, v, parallel_state.get_context_parallel_group(),
                                         causal=True, zigzag=active_cp_layout() == "zigzag")
        elif c.use_flash_attention:
            attn = flash_attention(
                q, k, v, causal=True,
                block_q=c.flash_block_q or DEFAULT_BLOCK_Q,
                block_kv=c.flash_block_kv or DEFAULT_BLOCK_KV,
            )
        else:
            attn = core_attention(q, k, v, causal=True)
        return attn.reshape(b, s, self.n_heads * c.head_dim)

    def rope(self, y: torch.Tensor, sin, cos, positions) -> torch.Tensor:
        """RoPE on q or k (b, t, heads, D): the whole head, rotate-half (JAX
        ``_apply_rope``; the partial-rotary families override it)."""
        return apply_rope(y, sin, cos, positions)

    def forward(self, x, sin, cos, positions) -> torch.Tensor:
        q, k, v = self.project_qkv(x)
        q = self.rope(q, sin, cos, positions)
        k = self.rope(k, sin, cos, positions)
        return self.o(self.attend(q, k, v))


class LlamaMLP(nn.Module):
    """SwiGLU MLP with the fused ``gate_up`` (H, 2, I) kernel."""

    def __init__(self, config: LlamaConfig, device=None, sequence_parallel: bool = False):
        super().__init__()
        c = config
        self.tp = parallel_state.tensor_parallel_size_or(1)
        self.tp_rank = parallel_state.tensor_parallel_rank_or(0)
        self.sequence_parallel = sequence_parallel
        # gate_up splits its intermediate width over tp (JAX spec (None, None, tp))
        self.gate_up = nn.Parameter(
            torch.empty(
                (c.hidden_size, 2, divide(c.intermediate_size, self.tp)), dtype=c.dtype,
                device=device,
            )
        )
        self.down = RowParallelLinear(
            c.intermediate_size, c.hidden_size, dtype=c.dtype,
            sequence_parallel=sequence_parallel, device=device,
        )

    def reset_parameters(self, generator) -> None:
        h, _, i = self.gate_up.shape
        normal_init_(self.gate_up, generator, KERNEL_INIT_STD, (h, 2, i * self.tp), 2, self.tp_rank)
        self.down.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.gate_up  # read once: a quantized layer dequantizes on each read
        h_dim, _, i_dim = w.shape
        x = _enter(x, self.sequence_parallel)
        # one (H, 2I) product; the view splits gate from up
        y = (x @ w.reshape(h_dim, 2 * i_dim)).unflatten(-1, (2, i_dim))
        gate, up = y[..., 0, :], y[..., 1, :]
        return self.down(nn.functional.silu(gate) * up)


# ---------------------------------------------------------------------------
# Remat policies
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
#: the aten products whose outputs ``"selective"`` and ``"dots"`` keep (JAX
#: ``dots_with_no_batch_dims_saveable`` / ``dots_saveable``): the
#: projections are ``mm`` (a 3-D input folded into 2-D), the attention's
#: products ``bmm`` (batched over batch and heads)
_SAVED_OPS = {
    "selective": frozenset({_aten.mm.default, _aten.addmm.default}),
    "dots": frozenset({_aten.mm.default, _aten.addmm.default,
                       _aten.bmm.default, _aten.baddbmm.default}),
}


def _save_ops_policy(ops):
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


#: K1 (flash forward) launches per layer in one train step under each
#: policy with flash attention on: 2 where the backward recomputes the
#: attention's forward, 1 where its output and residuals are kept. K2 and
#: K3 run once a layer under every policy.
FLASH_FWD_PER_LAYER = {"none": 1, "full": 2, "selective": 2, "dots": 2, "hybrid": 1, "kv": 2}


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _checkpoint(fn, *args, context_fn=noop_context_fn):
    """``torch.utils.checkpoint`` (non-reentrant) whose recompute, which
    the backward runs outside the backbone's ``cp_layout`` block, re-enters
    the cp layout active at the forward."""
    layout = active_cp_layout()

    def contexts():
        forward_ctx, recompute_ctx = context_fn()
        return forward_ctx, _both(recompute_ctx, cp_layout(layout))

    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)


class CpPlan(NamedTuple):
    """How a (B, S) batch sits on the cp ranks: the cp group, and the
    zigzag permutation and its inverse (None for the contiguous layout)."""

    group: Any
    perm: Optional[torch.Tensor]
    inv: Optional[torch.Tensor]


# ---------------------------------------------------------------------------
# Decoder layer / model
# ---------------------------------------------------------------------------

class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, sequence_parallel: bool = False):
        super().__init__()
        sp = sequence_parallel
        self.attn_norm = make_norm(config, device, sp)
        self.attn = LlamaAttention(config, device, sp)
        self.mlp_norm = make_norm(config, device, sp)
        self.mlp = LlamaMLP(config, device, sp)

    def reset_parameters(self, generator) -> None:
        self.attn_norm.reset_parameters()
        self.attn.reset_parameters(generator)
        self.mlp_norm.reset_parameters()
        self.mlp.reset_parameters(generator)

    def forward(self, x, sin, cos, positions):
        x = x + self.attn(self.attn_norm(x), sin, cos, positions)
        return x + self.mlp(self.mlp_norm(x))

    def _rest(self, x, attn):
        """The layer after its attention: o-proj, residual, the MLP block."""
        x = x + self.attn.o(attn)
        return x + self.mlp(self.mlp_norm(x))

    def forward_named(self, x, sin, cos, positions, keep_q: bool):
        """The layer in checkpointed segments whose boundaries are JAX's
        named saves: the post-RoPE q (``q_rope``, when ``keep_q``), k and v
        (``kv_rope``) and the attention output (``attn_out``) are kept for
        the backward, everything between them is recomputed. With flash
        attention and ``keep_q`` the kernel's own residuals (o, lse) are
        kept too, so its forward runs once; without ``keep_q`` the q
        projection is recomputed with the attention, whose forward then
        runs again in the backward."""
        a = self.attn

        def rope(y):
            return a.rope(y, sin, cos, positions)

        if keep_q:
            def qkv(x):
                q, k, v = a.project_qkv(self.attn_norm(x))
                return rope(q), rope(k), v

            q, k, v = _checkpoint(qkv, x)
            if a.config.use_flash_attention:
                attn = a.attend(q, k, v)
            else:  # the scores are recomputed, from the kept q, k, v
                attn = _checkpoint(a.attend, q, k, v)
        else:
            def kv(x):
                h = self.attn_norm(x)
                return rope(a.project(h, "k")), a.project(h, "v")

            def q_attend(x, k, v):
                return a.attend(rope(a.project(self.attn_norm(x), "q")), k, v)

            k, v = _checkpoint(kv, x)
            attn = _checkpoint(q_attend, x, k, v)
        return _checkpoint(self._rest, x, attn)


class Stage(NamedTuple):
    """What one pipeline stage (pp rank ``rank`` of ``pp``) holds: the
    layers of each of its ``chunks`` model chunks (chunk v is the layer
    block of virtual stage ``v * pp + rank``, JAX ``to_pipeline``), and
    whether it runs the embedding (the first stage) and the head (the
    last)."""

    rank: int
    pp: int
    chunk_layers: Tuple[Tuple[int, ...], ...]

    @property
    def chunks(self) -> int:
        return len(self.chunk_layers)

    @property
    def layers(self) -> Tuple[int, ...]:
        return tuple(i for block in self.chunk_layers for i in block)

    @property
    def first(self) -> bool:
        return self.rank == 0

    @property
    def last(self) -> bool:
        return self.rank == self.pp - 1


def pipeline_stage(num_layers: int, pp: int, rank: int, chunks: int = 1) -> Stage:
    """Stage ``rank`` of ``pp``: the layers split into ``pp * chunks`` equal
    blocks, block ``u`` on rank ``u % pp`` (the reference's even
    partition, partition.py:280; Megatron's chunk assignment under
    interleaving)."""
    if num_layers % (pp * chunks):
        raise ValueError(f"num_layers {num_layers} not divisible by pp*chunks {pp}*{chunks}")
    w = num_layers // (pp * chunks)
    return Stage(rank, pp, tuple(tuple(range(u * w, (u + 1) * w))
                                 for u in range(rank, pp * chunks, pp)))


class LayerStack(nn.ModuleList):
    """The decoder layers a stage holds, registered under their global
    indices so that their parameters keep the names ``layers.<i>.*``.
    Iteration and integer indexing go by position."""

    def __init__(self, layers: Mapping[int, nn.Module]):
        super().__init__()
        for i, layer in layers.items():
            self.add_module(str(i), layer)

    def __getitem__(self, idx: int) -> nn.Module:
        return list(self._modules.values())[idx]

    def by_index(self) -> Dict[int, nn.Module]:
        return {int(k): m for k, m in self._modules.items()}


class LlamaForCausalLM(nn.Module):
    """Full causal LM: ``forward(input_ids)`` returns logits (B, S, V).

    Parameters are allocated on ``device`` (the card unless the caller asks
    for another) and left uninitialized: load them with
    ``load_state_dict(params_from_jax(...))`` or draw them from a seed with
    :meth:`init_weights`. Built under a mesh with pp > 1 the model is this
    rank's pipeline stage (:class:`Stage`, ``num_model_chunks`` layer blocks
    of it under the interleaved schedule), run by
    :class:`..pipeline.PipelinedCausalLM`."""

    #: the decoder layer of the family (the MoE families swap it)
    layer_class = LlamaDecoderLayer

    def __init__(self, config: LlamaConfig, device: DeviceLike = "cuda",
                 num_model_chunks: int = 1):
        super().__init__()
        dev = resolve_device(device)
        c = config
        self.config = c
        self.tp = parallel_state.tensor_parallel_size_or(1)
        # Megatron SP only means something across several tp ranks
        self.sequence_parallel = parallel_state.sequence_parallel_enabled() and self.tp > 1
        sp = self.sequence_parallel
        pp = parallel_state.pipeline_parallel_size_or(1)
        self.stage = (
            pipeline_stage(c.num_layers, pp, parallel_state.pipeline_parallel_rank_or(0),
                           num_model_chunks)
            if pp > 1 else None
        )
        if self.stage is None and num_model_chunks != 1:
            raise ValueError("num_model_chunks > 1 needs a pipeline (pp > 1)")
        st = self.stage
        self.embed = (
            ParallelEmbedding(c.vocab_size, c.hidden_size, dtype=c.dtype, device=dev)
            if st is None or st.first or (st.last and c.tie_word_embeddings) else None
        )
        if st is None:
            self.layers = nn.ModuleList(
                self.layer_class(c, dev, sp) for _ in range(c.num_layers)
            )
        else:
            self.layers = LayerStack({i: self.layer_class(c, dev, sp) for i in st.layers})
        last = st is None or st.last
        self.final_norm = make_norm(c, dev, sp) if last else None
        self.lm_head = None if c.tie_word_embeddings or not last else self._make_lm_head(dev)
        self._device = dev

    def _make_lm_head(self, device) -> ColumnParallelLinear:
        """The untied LM head (vocab-parallel; a family with a head bias
        overrides it)."""
        c = self.config
        return ColumnParallelLinear(c.hidden_size, c.vocab_size, dtype=c.dtype, device=device)

    @property
    def device(self) -> torch.device:
        return self._device

    def init_weights(self, seed: int) -> "LlamaForCausalLM":
        """Random weights from ``seed`` (N(0, 0.02) kernels, unit norms),
        drawn on the parameters' own device. A pipeline stage draws what the
        whole model would, in the same order, and keeps its own: the parts
        another stage holds are drawn into a throwaway module of the same
        kind, so each stage's weights are the whole model's."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        c, dev, sp = self.config, self.device, self.sequence_parallel
        (self.embed or ParallelEmbedding(c.vocab_size, c.hidden_size, dtype=c.dtype,
                                         device=dev)).reset_parameters(g)
        held = (dict(enumerate(self.layers)) if self.stage is None
                else self.layers.by_index())
        for i in range(c.num_layers):
            (held.get(i) or self.layer_class(c, dev, sp)).reset_parameters(g)
        if self.final_norm is not None:
            self.final_norm.reset_parameters()
        if not c.tie_word_embeddings:
            (self.lm_head or self._make_lm_head(dev)).reset_parameters(g)
        return self

    def param_specs(self) -> Dict[str, "LeafSpec"]:
        """:func:`param_specs` of this model on the live mesh (its stage's
        chunks under a pipeline)."""
        return param_specs(self.config, chunks=self.stage.chunks if self.stage else 1)

    def _rope(self, s: int, device=None):
        c = self.config
        return precompute_rope(
            c.head_dim, s, c.rope_theta, c.rope_scaling,
            device=device if device is not None else self.device,
        )

    def _layer(self, layer, remat: str, x, sin, cos, positions):
        """One decoder layer under ``remat`` (module docstring)."""
        if remat == "none":
            return layer(x, sin, cos, positions)
        if remat in ("hybrid", "kv"):
            return layer.forward_named(x, sin, cos, positions, keep_q=remat == "hybrid")
        kw = {}
        if remat in _SAVED_OPS:
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_ops_policy(_SAVED_OPS[remat])
            )
        return _checkpoint(layer, x, sin, cos, positions, **kw)

    def _cp_plan(self, s: int, device) -> Optional[CpPlan]:
        """The layout of a length-``s`` sequence over the live cp group
        (JAX ``_zigzag_enter``'s decision, ``resolve_cp_layout`` on the
        config's ``cp_ring_layout``); None at cp = 1."""
        cp = parallel_state.context_parallel_size_or(1)
        if cp == 1:
            return None
        if s % cp:
            raise ValueError(f"sequence length {s} not divisible by cp={cp}")
        layout = resolve_cp_layout(s, cp, causal=True, force=self.config.cp_ring_layout,
                                   device=device)
        perm = inv = None
        if layout == "zigzag":
            perm, inv = zigzag_permutation(s, cp, device=device)
        return CpPlan(parallel_state.get_context_parallel_group(), perm, inv)

    @staticmethod
    def _cp_take(t: torch.Tensor, plan: Optional[CpPlan]) -> torch.Tensor:
        """This rank's part of a (B, S, ...) tensor: permuted into the
        plan's layout, then the rank's contiguous chunk."""
        if plan is None:
            return t
        if plan.perm is not None:
            t = t.index_select(1, plan.perm)
        return split(t, 1, plan.group)

    def _cp_labels(self, labels: torch.Tensor, plan: CpPlan) -> torch.Tensor:
        """This rank's labels: shifted once over the whole sequence (label s
        + 1 at position s, IGNORE_INDEX at the last), then permuted and cut
        as the ids are."""
        pad = torch.full_like(labels[:, :1], IGNORE_INDEX)
        return self._cp_take(torch.cat([labels[:, 1:], pad], dim=1), plan)

    def _positions(self, b: int, s: int, plan: Optional[CpPlan], device):
        """(positions, sin, cos) of a (b, s) batch: this rank's positions
        under context parallelism."""
        positions = torch.arange(s, device=device).expand(b, s)
        sin, cos = self._rope(s)
        return self._cp_take(positions, plan), sin, cos

    def _embed_tokens(self, input_ids: torch.Tensor, plan: Optional[CpPlan]) -> torch.Tensor:
        """This rank's embedded tokens: its cp chunk, and under SP its
        sequence shard (the embedding reduce-scatters along the sequence;
        the layers run on shards and attention sees the whole sequence)."""
        ids = self._cp_take(input_ids, plan)
        return self.embed(ids, sequence_parallel=self.sequence_parallel)

    def _run_layers(self, x: torch.Tensor, layers, positions, sin, cos,
                    plan: Optional[CpPlan]) -> torch.Tensor:
        """``layers`` in turn on ``x``, each under ``config.remat`` while
        autograd records (the serving and eval forward keeps nothing either
        way), in the cp layout of ``plan``."""
        remat = self.config.remat if torch.is_grad_enabled() else "none"
        with cp_layout_from_inv(plan.inv if plan is not None else None):
            for layer in layers:
                x = self._layer(layer, remat, x, sin, cos, positions)
        return x

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm, then out of the SP region (the LM head's input
        region sums the gradient over tp, so the backward keeps this rank's
        part)."""
        x = self.final_norm(x)
        if self.sequence_parallel:
            x = gather_from_sequence_parallel_region(x, dim=1, to_model_parallel=False)
        return x

    def _backbone(self, input_ids: torch.Tensor, plan: Optional[CpPlan] = None) -> torch.Tensor:
        """Embed + decoder stack + final norm -> hidden states (B, S, H),
        or under context parallelism (``plan``) this rank's (B, S/cp, H)
        chunk in the plan's layout."""
        b, s = input_ids.shape
        positions, sin, cos = self._positions(b, s, plan, input_ids.device)
        x = self._embed_tokens(input_ids, plan)
        return self._final(self._run_layers(x, self.layers, positions, sin, cos, plan))

    def _local_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """This rank's (..., V/tp) slice of the logits (all of them at tp
        = 1): the vocab-parallel LM head, tied to the embedding unless the
        config says otherwise."""
        if self.lm_head is None:
            return copy_to_tensor_model_parallel_region(hidden) @ self.embed.embedding.T
        return self.lm_head(hidden)

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Logits over the whole vocab (..., V): the slices gathered over tp
        (serving samples from them on every rank alike)."""
        return gather_from_tensor_model_parallel_region(self._local_logits(hidden), -1)

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Full logits (B, S, V), without autograd: the serving and eval
        forward. Training goes through :meth:`loss`. Under context
        parallelism the ranks' final hidden states are all-gathered over cp
        and put back in sequence order first (JAX ``_zigzag_exit``)."""
        plan = self._cp_plan(input_ids.shape[1], input_ids.device)
        hidden = self._backbone(input_ids, plan)
        if plan is not None:
            hidden = all_gather(hidden, 1, plan.group)
            if plan.inv is not None:
                hidden = hidden.index_select(1, plan.inv)
        return self._logits(hidden)

    def _loss_sums(self, hidden: torch.Tensor, shifted: torch.Tensor):
        """(sum of the masked CE, count of the tokens that carry loss), fp32
        scalars, of ``hidden`` (B, T, H) against the already shifted labels
        (B, T); chunked over the sequence
        (:func:`..parallel.loss.fused_linear_cross_entropy`) when
        ``loss_chunk_size`` is set, so the (B, T, V) logits never
        materialize."""
        if self.config.loss_chunk_size is not None:
            return fused_linear_cross_entropy(
                hidden, self._local_logits, shifted, chunk_size=self.config.loss_chunk_size,
            )
        per_tok = parallel_cross_entropy(self._local_logits(hidden), shifted)
        # the CE's own validity rule, so the denominator never counts a
        # token whose numerator was zeroed
        valid = valid_token_mask(shifted, self.config.vocab_size).float()
        return (per_tok * valid).sum(), valid.sum()

    def loss_from_hidden(
        self, hidden: torch.Tensor, labels: torch.Tensor
    ) -> torch.Tensor:
        """LM head + masked-mean cross-entropy over the shifted labels
        (:meth:`_loss_sums` of ``hidden[:, :-1]`` against ``labels[:, 1:]``)."""
        loss_sum, count = self._loss_sums(hidden[:, :-1, :], labels[:, 1:])
        return loss_sum / torch.clamp(count, min=1.0)

    def _head_sums(self, hidden: torch.Tensor, labels: torch.Tensor,
                   plan: Optional[CpPlan]):
        """(CE sum, count of the tokens that carry loss) of the final
        hidden states against the unshifted labels: under context
        parallelism this rank's chunk's, against its part of the shifted
        labels (:meth:`_cp_labels`), both all-reduced over cp (the sum's
        backward is the identity: each rank's gradient is its chunk's
        share, which the trainer sums over cp)."""
        if plan is None:
            return self._loss_sums(hidden[:, :-1, :], labels[:, 1:])
        loss_sum, count = self._loss_sums(hidden, self._cp_labels(labels, plan))
        loss_sum = reduce_from_tensor_model_parallel_region(loss_sum, group=plan.group)
        return loss_sum, all_reduce(count.detach(), plan.group)

    def loss(self, input_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy, fp32 scalar. ``labels`` are
        aligned with ``input_ids`` (HF convention: the shift happens here).
        Records autograd unless the caller disables it. Under context
        parallelism the sums and counts are those of every rank's chunk
        (:meth:`_head_sums`)."""
        plan = self._cp_plan(input_ids.shape[1], input_ids.device)
        loss_sum, count = self._head_sums(self._backbone(input_ids, plan), labels, plan)
        return loss_sum / torch.clamp(count, min=1.0)


# ---------------------------------------------------------------------------
# Weight bridge to the JAX package's parameter pytree
# ---------------------------------------------------------------------------

def _dig(tree: Mapping, path: Tuple[str, ...]):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def jax_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """(path of the JAX leaf, layer index or None) of a port parameter
    name: the port's names are the JAX paths with "." for "/",
    ``layers.<i>.<rest>`` is layer ``i`` of the stacked ``layers/<rest>``
    leaf, and a bracketed component ``[i]`` is item ``i`` of a JAX list
    (Mllama's irregular text layers, ``layers/<i>/<rest>``)."""
    parts = name.split(".")
    if is_layer_name(name):
        return ("layers", *parts[2:]), int(parts[1])
    return tuple(p[1:-1] if p.startswith("[") else p for p in parts), None


#: config class -> the ``param_specs`` of a family outside the Llama
#: lineage (models/bert.py registers BERT's)
FAMILY_SPECS: Dict[type, Callable[..., Dict[str, LeafSpec]]] = {}


def param_specs(config: LlamaConfig, tp: Optional[int] = None, pp: Optional[int] = None,
                chunks: int = 1, ep: Optional[int] = None) -> Dict[str, LeafSpec]:
    """Each port parameter name -> the :class:`..parallel.layout.LeafSpec`
    of its JAX leaf: the global shape (L first for the stacked layer
    leaves) and the JAX ``LlamaForCausalLM.specs()`` split, at tensor
    parallel size ``tp`` and pipeline size ``pp`` (the live ones by
    default). At pp > 1 the layer stack is split over pp in ``pp * chunks``
    blocks (:func:`pipeline_stage`), the embedding lives on the first stage
    (and the last when tied), the final norm and an untied head on the
    last (``LeafSpec.stages``). A MoE family's layers hold ``moe.router.
    kernel`` (replicated, fp32) and the experts ``moe.experts.gate_up`` /
    ``down``, split over ep on E at expert parallel size ``ep`` (JAX
    ``ExpertMLPs.specs``) and over tp on I, in place of the dense MLP. A
    LayerNorm with a bias holds ``<norm>.bias`` beside each scale; the
    GPT-NeoX family's biases and MLP are its own
    (:func:`..models.gptneox.layer_leaves`). A family of
    :data:`FAMILY_SPECS` gives its own specs."""
    family = FAMILY_SPECS.get(type(config))
    if family is not None:
        return family(config, tp=tp, pp=pp, chunks=chunks, ep=ep)
    c = config
    tp = parallel_state.tensor_parallel_size_or(1) if tp is None else tp
    pp = parallel_state.pipeline_parallel_size_or(1) if pp is None else pp
    ep = parallel_state.expert_parallel_size_or(1) if ep is None else ep
    L, H, I, D = c.num_layers, c.hidden_size, c.intermediate_size, c.head_dim
    T = parallel_state.TP_AXIS
    Lx = parallel_state.PP_AXIS if pp > 1 else None
    kv = T if kv_mode(c.num_heads, c.num_kv_heads, D, tp) != "replicated" else None
    layer = {
        "attn_norm.scale": ((L, H), (Lx, None)),
        "attn.qkv.q_kernel": ((L, H, c.num_heads * D), (Lx, None, T)),
        "attn.qkv.k_kernel": ((L, H, c.num_kv_heads * D), (Lx, None, kv)),
        "attn.qkv.v_kernel": ((L, H, c.num_kv_heads * D), (Lx, None, kv)),
        "attn.o.kernel": ((L, c.num_heads * D, H), (Lx, T, None)),
        "mlp_norm.scale": ((L, H), (Lx, None)),
        "mlp.gate_up": ((L, H, 2, I), (Lx, None, None, T)),
        "mlp.down.kernel": ((L, I, H), (Lx, T, None)),
    }
    if c.norm_bias:
        layer.update({"attn_norm.bias": ((L, H), (Lx, None)), "mlp_norm.bias": ((L, H), (Lx, None))})
    from neuronx_distributed_llama3_2_tpu_torch.models import gptneox

    if isinstance(c, gptneox.GPTNeoXConfig):
        layer = gptneox.layer_leaves(c, layer, Lx, T, kv)
    if hasattr(c, "num_experts"):
        E = parallel_state.EP_AXIS if ep > 1 else None
        del layer["mlp.gate_up"], layer["mlp.down.kernel"]
        layer.update({
            "moe.router.kernel": ((L, H, c.num_experts), (Lx, None, None)),
            "moe.experts.gate_up": ((L, c.num_experts, H, 2, I), (Lx, E, None, None, T)),
            "moe.experts.down": ((L, c.num_experts, I, H), (Lx, E, T, None)),
        })
    first, last = ((0,), (pp - 1,)) if pp > 1 else ((), ())
    embed_stages = tuple(sorted(set(first + last))) if c.tie_word_embeddings else first
    specs = {"embed.embedding": LeafSpec((c.vocab_size, H), (T, None), stages=embed_stages)}
    for i in range(L):
        for name, (shape, spec) in layer.items():
            specs[f"layers.{i}.{name}"] = LeafSpec(shape, spec, stacked=True,
                                                   chunks=chunks if pp > 1 else 1)
    specs["final_norm.scale"] = LeafSpec((H,), (None,), stages=last)
    if c.norm_bias:
        specs["final_norm.bias"] = LeafSpec((H,), (None,), stages=last)
    if not c.tie_word_embeddings:
        specs["lm_head.kernel"] = LeafSpec((H, c.vocab_size), (None, T), stages=last)
        if getattr(c, "lm_head_bias", False):
            specs["lm_head.bias"] = LeafSpec((c.vocab_size,), (T,), stages=last)
    return specs


#: the parameters kept in fp32 whatever the compute dtype (BERT's MLM
#: decoder bias among them)
FP32_LEAVES = ("scale", "norm.bias", "router.kernel", "mlm_bias")


def params_from_jax(
    np_params: Mapping[str, Any], config: LlamaConfig,
    device: DeviceLike = "cuda", *, tp_rank: Optional[int] = None,
    tp_size: Optional[int] = None, chunks: int = 1,
) -> Dict[str, torch.Tensor]:
    """The JAX package's Llama pytree, as numpy arrays, -> a state dict for
    :class:`LlamaForCausalLM`: rank ``tp_rank``'s shard of each leaf at
    tensor parallel size ``tp_size`` (the live parallel state's by
    default; whole tensors without one), cut by JAX's ``specs()``
    (:func:`param_specs`). ``layers`` leaves are stacked on a leading L axis
    (the fused MLP weight is ``gate_up`` (L, H, 2, I)) and unstacked per
    layer here (under a pipeline, the layers of this rank's stage in
    ``chunks`` blocks, and the other leaves its stage holds). Norm scales
    and the MoE router's kernel stay fp32, kernels take ``config.dtype``."""
    coords = dict(mesh_coords())
    if tp_size is not None:
        coords[parallel_state.TP_AXIS] = (tp_rank or 0, tp_size)
    elif tp_rank is not None:
        raise ValueError("tp_rank needs tp_size")
    return tree_from_jax(
        np_params, config,
        lambda name: torch.float32 if name.endswith(FP32_LEAVES) else config.dtype,
        device, specs=param_specs(config, coords[parallel_state.TP_AXIS][1], chunks=chunks),
        coords=coords,
    )


def tree_from_jax(
    np_tree: Mapping[str, Any], config: LlamaConfig,
    dtype_of: Callable[[str], torch.dtype], device: DeviceLike = "cuda",
    specs: Optional[Mapping[str, LeafSpec]] = None, coords=None,
) -> Dict[str, torch.Tensor]:
    """Any pytree shaped like the JAX package's Llama parameters (the
    weights, or one of AdamW's moments) -> a dict keyed by the port's
    parameter names, leaf ``name`` cast to ``dtype_of(name)``. With
    ``specs`` each tensor is the part of its leaf the rank at ``coords``
    holds (the live mesh's by default), and a layer tensor the rank holds
    no part of (ZeRO-1 split along the layer stack) is left out."""
    dev = resolve_device(device)
    coords = mesh_coords() if coords is None else coords
    if specs is None:
        specs = param_specs(config, 1, 1)
        coords = {}
    cache: Dict[Tuple[str, ...], np.ndarray] = {}
    sd: Dict[str, torch.Tensor] = {}
    for name, leaf in specs.items():
        path, layer = jax_path(name)
        arr = cache.get(path)
        if arr is None:
            arr = cache[path] = np.asarray(_dig(np_tree, path))
        held, index = port_slice(leaf, coords, layer)
        if not held:
            continue
        part = arr[layer] if layer is not None else arr
        sd[name] = torch.tensor(np.asarray(part[index], dtype=np.float32)).to(
            device=dev, dtype=dtype_of(name)
        )
    return sd


def gather_leaf(tensors: Dict[Optional[int], torch.Tensor], leaf: LeafSpec) -> np.ndarray:
    """The whole JAX leaf, as fp32 numpy, from this rank's tensors of it
    (by layer index, or None for an unstacked leaf), gathered over every
    mesh axis its spec splits: a leaf that lives on some stages of a
    pipeline is broadcast from the first of them, the layer stack is
    gathered over pp and its interleaved blocks put back in layer order.
    Every rank of the mesh must call it."""
    live = parallel_state.model_parallel_is_initialized()
    coords = mesh_coords()
    if leaf.stacked:
        t = torch.stack([tensors[i] for i in sorted(tensors)]) if tensors else None
    else:
        t = tensors.get(None)
    if leaf.stages and live and coords[parallel_state.PP_AXIS][1] > 1:
        src = leaf.stages[0]
        group = parallel_state.get_pipeline_model_parallel_group()
        shape = [b - a for a, b in region(dataclasses.replace(leaf, stages=()), coords)]
        buf = (t.detach().float().contiguous() if t is not None
               else torch.empty(shape, dtype=torch.float32, device=_mesh_device()))
        dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
        t = buf
    t = t.detach().float()
    for dim, axis in enumerate(leaf.spec):
        if axis is not None and live:
            t = all_gather(t, dim, axis_group(axis))
    if leaf.mentions(parallel_state.PP_AXIS) and leaf.chunks > 1:
        # gathered rank-major (rank r's chunks in turn); block u = v*pp + r
        pp, v = coords[parallel_state.PP_AXIS][1], leaf.chunks
        blocks = t.chunk(pp * v, dim=0)
        t = torch.cat([blocks[(u % pp) * v + u // pp] for u in range(pp * v)], dim=0)
    # a copy: on the CPU the array would share the parameter's memory
    return t.cpu().numpy().copy()


def _mesh_device() -> torch.device:
    return torch.device(parallel_state.get_parallel_state().mesh.device_type)


def params_to_jax(
    state_dict: Mapping[str, torch.Tensor], config: LlamaConfig,
    specs: Optional[Mapping[str, LeafSpec]] = None,
) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax` (and of :func:`tree_from_jax`): a
    dict keyed by :class:`LlamaForCausalLM` parameter names -> the JAX
    package's pytree as fp32 numpy arrays, layers stacked, every shard
    gathered back over the mesh by ``specs`` (:func:`param_specs` at the
    live tp by default). Under a mesh every rank must call it."""
    specs = param_specs(config) if specs is None else specs
    by_path: Dict[Tuple[str, ...], Dict[Optional[int], torch.Tensor]] = {}
    leaves: Dict[Tuple[str, ...], LeafSpec] = {}
    for name, leaf in specs.items():
        path, layer = jax_path(name)
        leaves[path] = leaf
        if name in state_dict:
            by_path.setdefault(path, {})[layer] = state_dict[name]
    out: Dict[str, Any] = {}
    for path, leaf in leaves.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = gather_leaf(by_path.get(path, {}), leaf)
    return _lists(out)


def _lists(tree):
    """The JAX lists back: a dict keyed by list indices (bracketed
    components of the port's names) as a list."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out
