"""GPT-NeoX family (GPT-NeoX-20B, Pythia, CodeGen), in PyTorch.

Counterpart of ``neuronx_distributed_llama3_2_tpu/models/gptneox.py``
(``GPTNeoXConfig`` :48, ``GPTNEOX_CONFIGS`` :95, ``apply_rope_interleaved``
:130, ``GPTNeoXAttention`` :152, ``GPTNeoXMLP`` :178, ``GPTNeoXDecoderLayer``
:225, ``GPTNeoXForCausalLM`` :268). One block family covers the
parallel-residual lineage through config:

- ``parallel_residual``: x + attn(ln1(x)) + mlp(ln2(x)) (GPT-NeoX), or the
  sequential residual (Pythia-style) otherwise;
- ``shared_layernorm``: CodeGen's single LayerNorm a block (the MLP reads
  ln1's output);
- ``rotary_pct`` / ``rotary_interleaved``: rotary on the first
  ``rotary_dims`` of each head, in the rotate-half (NeoX) or the GPT-J
  interleaved (CodeGen) convention;
- biases on the fused QKV, the attention output, the MLP and the LM head,
  per family.

Everything else is the port's Llama model (:class:`..models.llama.
LlamaForCausalLM`): tp / SP sharding, K1-K3 under ``use_flash_attention``,
the cp ring, remat, the chunked vocab-parallel loss and the pipeline stage.
The parameters keep JAX's names: ``layers.<i>.attn.qkv.{q,k,v}_bias``,
``attn.o.bias``, ``mlp.up.{kernel,bias}``, ``mlp.down.{kernel,bias}``, the
norms' ``bias`` (fp32, as the scales), ``lm_head.bias``
(:func:`layer_leaves` gives their specs). The HF converters (JAX :300-529)
come with the checkpoint converter (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LlamaAttention,
    LlamaConfig,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    apply_rope,
    make_norm,
    precompute_rope,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
)


@dataclasses.dataclass(frozen=True)
class GPTNeoXConfig(LlamaConfig):
    """LlamaConfig + the parallel-residual family's knobs (HF
    ``GPTNeoXConfig`` / ``CodeGenConfig`` fields)."""

    norm_type: str = "layernorm"
    norm_bias: bool = True
    tie_word_embeddings: bool = False
    rotary_pct: float = 0.25
    rotary_interleaved: bool = False  # True = GPT-J / CodeGen convention
    parallel_residual: bool = True
    shared_layernorm: bool = False  # True = CodeGen's single ln a block
    activation: str = "gelu"  # "gelu" (exact) | "gelu_new" (tanh approximation)
    qkv_bias: bool = True
    attn_out_bias: bool = True
    mlp_bias: bool = True
    lm_head_bias: bool = False

    @property
    def rotary_dims(self) -> int:
        d = int(self.head_dim * self.rotary_pct)
        return d - d % 2

    def __post_init__(self):
        super().__post_init__()
        if self.activation not in ("gelu", "gelu_new"):
            raise ValueError(f"activation must be gelu|gelu_new, got {self.activation!r}")
        if self.shared_layernorm and not self.parallel_residual:
            raise ValueError(
                "shared_layernorm=True requires parallel_residual=True: the "
                "sequential-residual path needs a post-attention norm "
                "(mlp_norm) that a shared-ln block does not have"
            )
        if self.rope_scaling is not None:
            raise ValueError(
                "rope_scaling is not supported for the GPT-NeoX/CodeGen "
                "family (partial rotary uses plain inverse-frequency tables)"
            )


GPTNEOX_CONFIGS: Dict[str, GPTNeoXConfig] = {
    # EleutherAI/gpt-neox-20b config.json (head_dim 96: K1-K4 run it through
    # their D 96 instances)
    "gpt-neox-20b": GPTNeoXConfig(
        vocab_size=50432, hidden_size=6144, intermediate_size=24576,
        num_layers=44, num_heads=64, num_kv_heads=64, head_dim=96,
        max_seq_len=2048, rope_theta=10000.0, rms_norm_eps=1e-5,
        rotary_pct=0.25,
    ),
    # EleutherAI/pythia-6.9b config.json
    "pythia-6.9b": GPTNeoXConfig(
        vocab_size=50432, hidden_size=4096, intermediate_size=16384,
        num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
        max_seq_len=2048, rope_theta=10000.0, rotary_pct=0.25,
    ),
    # Salesforce/codegen25-7b config.json (CodeGen architecture)
    "codegen25-7b": GPTNeoXConfig(
        vocab_size=51200, hidden_size=4096, intermediate_size=16384,
        num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
        max_seq_len=2048, rope_theta=10000.0,
        rotary_pct=64 / 128, rotary_interleaved=True,
        shared_layernorm=True, activation="gelu_new",
        qkv_bias=False, attn_out_bias=False, lm_head_bias=True,
    ),
    "tiny-neox": GPTNeoXConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=4, num_heads=8, num_kv_heads=8, head_dim=8,
        max_seq_len=128, rope_theta=10000.0, dtype=torch.float32,
        remat="none", rotary_pct=0.25,
    ),
    "tiny-codegen": GPTNeoXConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=4, num_heads=8, num_kv_heads=8, head_dim=8,
        max_seq_len=128, rope_theta=10000.0, dtype=torch.float32,
        remat="none", rotary_pct=0.5, rotary_interleaved=True,
        shared_layernorm=True, activation="gelu_new",
        qkv_bias=False, attn_out_bias=False, lm_head_bias=True,
    ),
}


def apply_rope_interleaved(
    x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, positions: torch.Tensor,
) -> torch.Tensor:
    """GPT-J / CodeGen rotary on (B, S, n, D): sin / cos interleave every two
    lanes (HF ``rotate_every_two``). ``sin`` / ``cos`` are the (S, D)
    rotate-half tables, whose first D/2 columns hold the per-frequency
    values."""
    d = x.shape[-1]
    sin_i = sin[:, : d // 2].repeat_interleave(2, dim=-1)[positions][:, :, None, :]
    cos_i = cos[:, : d // 2].repeat_interleave(2, dim=-1)[positions][:, :, None, :]
    rotated = torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)
    out = x.float() * cos_i + rotated.float() * sin_i
    return out.to(x.dtype)


class GPTNeoXAttention(LlamaAttention):
    """The Llama attention block (fused tp QKV, K1-K3 / the cp ring) with
    the family's biases and partial rotary."""

    def __init__(self, config: GPTNeoXConfig, device=None, sequence_parallel: bool = False):
        super().__init__(config, device, sequence_parallel, qkv_bias=config.qkv_bias,
                         o_bias=config.attn_out_bias)

    def rope(self, y: torch.Tensor, sin, cos, positions) -> torch.Tensor:
        """Rotary on the first ``rotary_dims`` of each head (the tables are
        that wide), in the config's convention; the rest passes through."""
        c = self.config
        rot = c.rotary_dims
        fn = apply_rope_interleaved if c.rotary_interleaved else apply_rope
        return torch.cat([fn(y[..., :rot], sin, cos, positions), y[..., rot:]], dim=-1)


class GPTNeoXMLP(nn.Module):
    """h -> I -> h with exact or tanh gelu and optional biases (HF
    ``GPTNeoXMLP`` / ``CodeGenMLP``): ``up`` column-, ``down`` row-parallel."""

    def __init__(self, config: GPTNeoXConfig, device=None, sequence_parallel: bool = False):
        super().__init__()
        c = config
        self.config = c
        self.up = ColumnParallelLinear(
            c.hidden_size, c.intermediate_size, use_bias=c.mlp_bias,
            sequence_parallel=sequence_parallel, dtype=c.dtype, device=device,
        )
        self.down = RowParallelLinear(
            c.intermediate_size, c.hidden_size, use_bias=c.mlp_bias,
            sequence_parallel=sequence_parallel, dtype=c.dtype, device=device,
        )

    def reset_parameters(self, generator) -> None:
        self.up.reset_parameters(generator)
        self.down.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = nn.functional.gelu(
            self.up(x).float(),
            approximate="tanh" if self.config.activation == "gelu_new" else "none",
        )
        return self.down(h.to(self.config.dtype))


class GPTNeoXDecoderLayer(LlamaDecoderLayer):
    """Parallel or sequential residual; CodeGen's shared LayerNorm has no
    ``mlp_norm``. The remat segments (``forward_named``) are the Llama
    layer's, ending in :meth:`_rest`."""

    def __init__(self, config: GPTNeoXConfig, device=None, sequence_parallel: bool = False):
        nn.Module.__init__(self)
        sp = sequence_parallel
        self.config = config
        self.attn_norm = make_norm(config, device, sp)
        self.attn = GPTNeoXAttention(config, device, sp)
        self.mlp = GPTNeoXMLP(config, device, sp)
        self.mlp_norm = None if config.shared_layernorm else make_norm(config, device, sp)

    def reset_parameters(self, generator) -> None:
        self.attn_norm.reset_parameters()
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        if self.mlp_norm is not None:
            self.mlp_norm.reset_parameters()

    def block(self, x: torch.Tensor, h1: torch.Tensor, attn_out: torch.Tensor) -> torch.Tensor:
        """The layer's output from its input ``x``, ``h1`` = ln1(x) and the
        attention block's output (after the o projection): the family's
        residual structure, shared with the decode model."""
        c = self.config
        if c.parallel_residual:
            h2 = h1 if c.shared_layernorm else self.mlp_norm(x)
            return x + attn_out + self.mlp(h2)
        x = x + attn_out
        return x + self.mlp(self.mlp_norm(x))

    def forward(self, x, sin, cos, positions):
        h1 = self.attn_norm(x)
        return self.block(x, h1, self.attn(h1, sin, cos, positions))

    def _rest(self, x, attn):
        """The layer after its attention (the remat segments' last)."""
        return self.block(x, self.attn_norm(x), self.attn.o(attn))


class GPTNeoXForCausalLM(LlamaForCausalLM):
    """The Llama causal LM protocol (init / specs / forward / loss) over
    GPT-NeoX blocks, so the trainer, ZeRO-1, checkpoints, the pipeline and
    the engines run unchanged. The head is untied, with a bias when the
    config says so; the rotary tables are ``rotary_dims`` wide."""

    layer_class = GPTNeoXDecoderLayer

    def _make_lm_head(self, device) -> ColumnParallelLinear:
        c = self.config
        return ColumnParallelLinear(c.hidden_size, c.vocab_size, use_bias=c.lm_head_bias,
                                    dtype=c.dtype, device=device)

    def _rope(self, s: int, device=None):
        c = self.config
        return precompute_rope(c.rotary_dims, s, c.rope_theta, None,
                               device=device if device is not None else self.device)


def layer_leaves(c: GPTNeoXConfig, layer: dict, Lx, T, kv) -> dict:
    """The Llama layer leaves of :func:`..models.llama.param_specs`
    (``name -> (global shape, spec)``) turned into the family's: the QKV,
    output and MLP biases, ``up`` / ``down`` for the fused SwiGLU, no
    ``mlp_norm`` under a shared LayerNorm."""
    L, H, I, D = c.num_layers, c.hidden_size, c.intermediate_size, c.head_dim
    layer = dict(layer)
    del layer["mlp.gate_up"]
    layer["mlp.up.kernel"] = ((L, H, I), (Lx, None, T))
    layer["mlp.down.kernel"] = ((L, I, H), (Lx, T, None))
    if c.mlp_bias:
        layer["mlp.up.bias"] = ((L, I), (Lx, T))
        layer["mlp.down.bias"] = ((L, H), (Lx, None))
    if c.qkv_bias:
        layer["attn.qkv.q_bias"] = ((L, c.num_heads * D), (Lx, T))
        layer["attn.qkv.k_bias"] = ((L, c.num_kv_heads * D), (Lx, kv))
        layer["attn.qkv.v_bias"] = ((L, c.num_kv_heads * D), (Lx, kv))
    if c.attn_out_bias:
        layer["attn.o.bias"] = ((L, H), (Lx, None))
    if c.shared_layernorm:
        for k in ("mlp_norm.scale", "mlp_norm.bias"):
            layer.pop(k, None)
    return layer
