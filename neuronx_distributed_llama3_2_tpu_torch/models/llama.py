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

Training runs on one device: :meth:`LlamaForCausalLM.loss` (the chunked
cross-entropy of ``loss_chunk_size``), per-layer remat ``"none"`` /
``"full"`` through ``torch.utils.checkpoint``, and the flash-attention
kernels when ``use_flash_attention`` is set. Sequence and context
parallelism wait for the multi-GPU slice; the other remat policies raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from neuronx_distributed_llama3_2_tpu_torch.kernels.flash_attention import (
    DEFAULT_BLOCK_KV,
    DEFAULT_BLOCK_Q,
    flash_attention,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    GQAQKVColumnParallelLinear,
    KERNEL_INIT_STD,
    ParallelEmbedding,
    RowParallelLinear,
    normal_init_,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.loss import (
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

class RMSNorm(nn.Module):
    """RMS layer norm with fp32 accumulation and an fp32 ``scale``."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
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
        return (h * self.scale).to(self.dtype)


class LayerNorm(nn.Module):
    """Mean-centered layer norm with fp32 accumulation, optional bias (the
    DBRX/GPT-NeoX-family norm). Same parameter names as :class:`RMSNorm`."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16,
                 bias: bool = False, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
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
        h = h * torch.rsqrt(var + self.eps) * self.scale
        if self.bias is not None:
            h = h + self.bias
        return h.to(self.dtype)


def make_norm(config: LlamaConfig, device=None) -> nn.Module:
    """Norm block per ``config.norm_type``."""
    if config.norm_type == "layernorm":
        return LayerNorm(
            config.hidden_size, config.rms_norm_eps, config.dtype,
            bias=config.norm_bias, device=device,
        )
    return RMSNorm(config.hidden_size, config.rms_norm_eps, config.dtype,
                   device=device)


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
    projection."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        self.qkv = GQAQKVColumnParallelLinear(
            c.hidden_size, c.num_heads, c.num_kv_heads, c.head_dim,
            dtype=c.dtype, device=device,
        )
        self.o = RowParallelLinear(
            c.num_heads * c.head_dim, c.hidden_size, dtype=c.dtype,
            device=device,
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
        return (
            q.reshape(b, t, c.num_heads, c.head_dim),
            k.reshape(b, t, c.num_kv_heads, c.head_dim),
            v.reshape(b, t, c.num_kv_heads, c.head_dim),
        )

    def forward(self, x, sin, cos, positions) -> torch.Tensor:
        c = self.config
        b, s = x.shape[:2]
        q, k, v = self.project_qkv(x)
        q = apply_rope(q, sin, cos, positions)
        k = apply_rope(k, sin, cos, positions)
        if c.use_flash_attention:
            attn = flash_attention(
                q, k, v, causal=True,
                block_q=c.flash_block_q or DEFAULT_BLOCK_Q,
                block_kv=c.flash_block_kv or DEFAULT_BLOCK_KV,
            )
        else:
            attn = core_attention(q, k, v, causal=True)
        return self.o(attn.reshape(b, s, c.num_heads * c.head_dim))


class LlamaMLP(nn.Module):
    """SwiGLU MLP with the fused ``gate_up`` (H, 2, I) kernel."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        c = config
        self.gate_up = nn.Parameter(
            torch.empty(
                (c.hidden_size, 2, c.intermediate_size), dtype=c.dtype,
                device=device,
            )
        )
        self.down = RowParallelLinear(
            c.intermediate_size, c.hidden_size, dtype=c.dtype, device=device
        )

    def reset_parameters(self, generator) -> None:
        normal_init_(self.gate_up, generator, KERNEL_INIT_STD)
        self.down.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h_dim, _, i_dim = self.gate_up.shape
        # one (H, 2I) product; the view splits gate from up
        y = (x @ self.gate_up.reshape(h_dim, 2 * i_dim)).unflatten(-1, (2, i_dim))
        gate, up = y[..., 0, :], y[..., 1, :]
        return self.down(nn.functional.silu(gate) * up)


# ---------------------------------------------------------------------------
# Decoder layer / model
# ---------------------------------------------------------------------------

class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.attn_norm = make_norm(config, device)
        self.attn = LlamaAttention(config, device)
        self.mlp_norm = make_norm(config, device)
        self.mlp = LlamaMLP(config, device)

    def reset_parameters(self, generator) -> None:
        self.attn_norm.reset_parameters()
        self.attn.reset_parameters(generator)
        self.mlp_norm.reset_parameters()
        self.mlp.reset_parameters(generator)

    def forward(self, x, sin, cos, positions):
        x = x + self.attn(self.attn_norm(x), sin, cos, positions)
        return x + self.mlp(self.mlp_norm(x))


class LlamaForCausalLM(nn.Module):
    """Full causal LM: ``forward(input_ids)`` returns logits (B, S, V).

    Parameters are allocated on ``device`` (the card unless the caller asks
    for another) and left uninitialized: load them with
    ``load_state_dict(params_from_jax(...))`` or draw them from a seed with
    :meth:`init_weights`."""

    def __init__(self, config: LlamaConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        c = config
        self.config = c
        self.embed = ParallelEmbedding(
            c.vocab_size, c.hidden_size, dtype=c.dtype, device=dev
        )
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(c, dev) for _ in range(c.num_layers)
        )
        self.final_norm = make_norm(c, dev)
        self.lm_head = (
            None if c.tie_word_embeddings
            else ColumnParallelLinear(
                c.hidden_size, c.vocab_size, dtype=c.dtype, device=dev
            )
        )

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def init_weights(self, seed: int) -> "LlamaForCausalLM":
        """Random weights from ``seed`` (N(0, 0.02) kernels, unit norms),
        drawn on the parameters' own device."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        self.embed.reset_parameters(g)
        for layer in self.layers:
            layer.reset_parameters(g)
        self.final_norm.reset_parameters()
        if self.lm_head is not None:
            self.lm_head.reset_parameters(g)
        return self

    def _rope(self, s: int, device=None):
        c = self.config
        return precompute_rope(
            c.head_dim, s, c.rope_theta, c.rope_scaling,
            device=device if device is not None else self.device,
        )

    def _backbone(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Embed + decoder stack + final norm -> hidden states (B, S, H).
        While autograd records, ``remat="full"`` runs each layer under
        ``torch.utils.checkpoint`` (nothing inside is kept; the backward
        recomputes the layer), as the JAX package's ``nothing_saveable``
        policy does; ``"none"`` keeps every activation."""
        c = self.config
        remat = torch.is_grad_enabled() and c.remat == "full"
        if torch.is_grad_enabled() and c.remat not in ("none", "full"):
            raise NotImplementedError(
                f"remat={c.remat!r} is not ported yet: the port trains with "
                "remat 'none' or 'full'"
            )
        b, s = input_ids.shape
        positions = torch.arange(s, device=input_ids.device).expand(b, s)
        sin, cos = self._rope(s)
        x = self.embed(input_ids)
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, sin, cos, positions, use_reentrant=False)
            else:
                x = layer(x, sin, cos, positions)
        return self.final_norm(x)

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return hidden @ self.embed.embedding.T
        return self.lm_head(hidden)

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Full logits (B, S, V), without autograd: the serving and eval
        forward. Training goes through :meth:`loss`."""
        return self._logits(self._backbone(input_ids))

    def loss_from_hidden(
        self, hidden: torch.Tensor, labels: torch.Tensor
    ) -> torch.Tensor:
        """LM head + masked-mean cross-entropy over the shifted labels;
        chunked over the sequence (:func:`..parallel.loss.fused_linear_cross_entropy`)
        when ``loss_chunk_size`` is set, so the (B, S, V) logits never
        materialize."""
        shifted = labels[:, 1:]
        if self.config.loss_chunk_size is not None:
            loss_sum, count = fused_linear_cross_entropy(
                hidden[:, :-1, :], self._logits, shifted,
                chunk_size=self.config.loss_chunk_size,
            )
            return loss_sum / torch.clamp(count, min=1.0)
        per_tok = parallel_cross_entropy(self._logits(hidden[:, :-1, :]), shifted)
        # the CE's own validity rule, so the denominator never counts a
        # token whose numerator was zeroed
        valid = valid_token_mask(shifted, self.config.vocab_size).float()
        return (per_tok * valid).sum() / torch.clamp(valid.sum(), min=1.0)

    def loss(self, input_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy, fp32 scalar. ``labels`` are
        aligned with ``input_ids`` (HF convention: the shift happens here).
        Records autograd unless the caller disables it."""
        return self.loss_from_hidden(self._backbone(input_ids), labels)


# ---------------------------------------------------------------------------
# Weight bridge to the JAX package's parameter pytree
# ---------------------------------------------------------------------------

# (path in the JAX layer pytree, attribute path in LlamaDecoderLayer)
_LAYER_LEAVES = (
    (("attn_norm", "scale"), "attn_norm.scale"),
    (("attn", "qkv", "q_kernel"), "attn.qkv.q_kernel"),
    (("attn", "qkv", "k_kernel"), "attn.qkv.k_kernel"),
    (("attn", "qkv", "v_kernel"), "attn.qkv.v_kernel"),
    (("attn", "o", "kernel"), "attn.o.kernel"),
    (("mlp_norm", "scale"), "mlp_norm.scale"),
    (("mlp", "gate_up"), "mlp.gate_up"),
    (("mlp", "down", "kernel"), "mlp.down.kernel"),
)


def _dig(tree: Mapping, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def params_from_jax(
    np_params: Mapping[str, Any], config: LlamaConfig,
    device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    """The JAX package's Llama pytree, as numpy arrays, -> a state dict for
    :class:`LlamaForCausalLM`. ``layers`` leaves are stacked on a leading L
    axis (the fused MLP weight is ``gate_up`` (L, H, 2, I)); they are
    unstacked per layer here. Norm scales stay fp32, kernels take
    ``config.dtype``."""
    return tree_from_jax(
        np_params, config,
        lambda name: torch.float32 if name.endswith("scale") else config.dtype,
        device,
    )


def tree_from_jax(
    np_tree: Mapping[str, Any], config: LlamaConfig,
    dtype_of: Callable[[str], torch.dtype], device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    """Any pytree shaped like the JAX package's Llama parameters (the
    weights, or one of AdamW's moments) -> a dict keyed by the port's
    parameter names, leaf ``name`` cast to ``dtype_of(name)``."""
    dev = resolve_device(device)

    def t(a, name):
        return torch.tensor(np.asarray(a, dtype=np.float32)).to(
            device=dev, dtype=dtype_of(name)
        )

    sd: Dict[str, torch.Tensor] = {
        "embed.embedding": t(np_tree["embed"]["embedding"], "embed.embedding"),
        "final_norm.scale": t(np_tree["final_norm"]["scale"], "final_norm.scale"),
    }
    for path, name in _LAYER_LEAVES:
        stacked = np.asarray(_dig(np_tree["layers"], path))
        for i in range(config.num_layers):
            sd[f"layers.{i}.{name}"] = t(stacked[i], f"layers.{i}.{name}")
    if not config.tie_word_embeddings:
        sd["lm_head.kernel"] = t(np_tree["lm_head"]["kernel"], "lm_head.kernel")
    return sd


def params_to_jax(
    state_dict: Mapping[str, torch.Tensor], config: LlamaConfig
) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax` (and of :func:`tree_from_jax`): a
    dict keyed by :class:`LlamaForCausalLM` parameter names -> the JAX
    package's pytree as fp32 numpy arrays, layers stacked."""

    def n(x):
        return x.detach().to("cpu", torch.float32).numpy()

    layers: Dict[str, Any] = {}
    for path, name in _LAYER_LEAVES:
        node = layers
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.stack(
            [n(state_dict[f"layers.{i}.{name}"]) for i in range(config.num_layers)]
        )
    out: Dict[str, Any] = {
        "embed": {"embedding": n(state_dict["embed.embedding"])},
        "layers": layers,
        "final_norm": {"scale": n(state_dict["final_norm.scale"])},
    }
    if not config.tie_word_embeddings:
        out["lm_head"] = {"kernel": n(state_dict["lm_head.kernel"])}
    return out
