"""Llama-3.2 Vision (Mllama), in PyTorch.

Counterpart of ``neuronx_distributed_llama3_2_tpu/models/mllama.py``
(configs :76-197, ``LayerNorm`` :204, ``_mha`` :224, ``VisionAttention``
:242, ``VisionMLP`` :281, ``text_group_pattern`` :314, ``_pack_text_layers``
:348, ``text_layer_slice`` :361, ``VisionEncoderLayer`` :372,
``MllamaVisionModel`` :433, ``TextCrossAttention`` :682,
``CrossAttentionDecoderLayer`` :769, ``prepare_cross_attention_mask``
:832, ``MllamaForConditionalGeneration`` :853): a tiled ViT (the
channel-parallel patch conv, gated tile and position embeddings, a local
stack whose states after ``intermediate_layers_indices`` are collected, a
tanh-gated global stack), a projector, and a Llama decoder whose
cross-attention layers (per-head RMSNorm on q and k, no rope, zero-init
tanh gates) attend the projected vision tokens. The JAX model runs no
Pallas kernel (its attention is the dense ``_mha``, its self layers leave
flash attention off, the patch conv is ``lax.conv_general_dilated``), and
neither does this one: its products are ``torch.matmul`` and ``conv2d``.

**The parameter layout.** The port holds each JAX leaf whole, under its
JAX path with "." for "/":

- the vision stacks: ``vision_model.transformer.<rest>`` (L, ...) and
  ``vision_model.global_transformer.<rest>`` (L_global, ...);
- the text layers, when the cross-attention layers form the regular
  pattern ``xpos + g·k`` (:func:`text_group_pattern`; every published
  config): ``layers.plain.<rest>`` (G, k - 1, ...) for the self-attention
  layers and ``layers.xattn.<rest>`` (G, ...) for the cross-attention ones;
- otherwise JAX's list of per-layer subtrees, ``layers.[i].<rest>`` (a
  bracketed component is a list index: JAX path ``layers/<i>/<rest>``).

A stack is a layer module whose every parameter carries the stack's
leading dims (``_stacked``); the forward reads each stacked weight once
through its module (so LoRA's adapted reads and the quantized layers'
dequantizing reads apply to the whole leaf), unbinds it, and calls, for
each layer, a shallow copy of a parameterless template of the layer that
holds that layer's slices as its parameters (:class:`_Stack`), the
counterpart of JAX's scan over a layer function. As every tensor is a whole JAX leaf,
:func:`..models.llama.params_from_jax` / ``params_to_jax``, the
checkpoints, ZeRO-1's split (the first free dim of the leaf), LoRA's two
stack dims (``lora.register_grouped_stack``) and the quantization scales
(per leaf) are JAX's without a per-layer mapping.

Under tensor parallelism each rank holds the shards of JAX's ``specs()``
(:func:`param_specs`): the vision attention and MLP and the text layers
split as Column -> Row pairs, the patch conv over its output channels with
the output gathered, the projector column-parallel with its output
gathered, the embedding (``vocab + 8`` rows) over the vocab, or over its
dim when tp does not divide the rows, and the LM head column-parallel, or
row-parallel when tp does not divide the vocab (its logits then arrive
whole and the loss is the plain CE). Sequence parallelism shards the text
stream between blocks (the cross layers' q and o projections gather and
reduce-scatter the sequence; the full-row mask is cut to the rank's rows).
There is no pipeline and no context parallelism for Mllama, as in JAX.
The HF converters (JAX :1106-1392) come with the checkpoint converter
(``ROADMAP.md``).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import create_selective_checkpoint_contexts

from neuronx_distributed_llama3_2_tpu_torch.lora.stacks import register_grouped_stack
from neuronx_distributed_llama3_2_tpu_torch.models import llama
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LayerNorm,
    LlamaConfig,
    LlamaDecoderLayer,
    LlamaMLP,
    RMSNorm,
    _checkpoint,
    _save_ops_policy,
    _sp_weight,
    precompute_rope,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.conv import OutputChannelParallelConv2d
from neuronx_distributed_llama3_2_tpu_torch.parallel.layers import (
    KERNEL_INIT_STD,
    ColumnParallelLinear,
    ParallelEmbedding,
    RowParallelLinear,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.layout import (
    LeafSpec,
    mesh_coords,
    port_slice,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.loss import fused_linear_cross_entropy
from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import (
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from neuronx_distributed_llama3_2_tpu_torch.utils.device import DeviceLike, resolve_device

NEG = -1e30

_REMATS = ("none", "full", "selective", "hybrid", "kv", "dots")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MllamaVisionConfig:
    """HF ``MllamaVisionConfig`` fields (JAX :76); the defaults are the
    11B's. ``dtype`` is a torch dtype."""

    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_global_layers: int = 8
    attention_heads: int = 16
    image_size: int = 448
    patch_size: int = 14
    num_channels: int = 3
    max_num_tiles: int = 4
    max_aspect_ratio_id: int = 8
    intermediate_layers_indices: Tuple[int, ...] = (3, 7, 15, 23, 30)
    norm_eps: float = 1e-5
    dtype: Any = torch.float32
    # activation checkpointing over the vision layers (the remat policies of
    # models/llama.py; "hybrid" and "kv" name nothing here and recompute all)
    remat: str = "none"

    def __post_init__(self):
        if self.remat not in _REMATS:
            raise ValueError(f"remat must be one of {_REMATS}, got {self.remat!r}")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.attention_heads

    @property
    def output_dim(self) -> int:
        # the final hidden state and one per collected intermediate layer
        return self.hidden_size * (1 + len(self.intermediate_layers_indices))


@dataclasses.dataclass(frozen=True)
class MllamaTextConfig:
    """HF ``MllamaTextConfig`` (JAX :113): a Llama decoder with gated
    cross-attention layers at ``cross_attention_layers``."""

    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 40
    num_heads: int = 32
    num_kv_heads: int = 8
    cross_attention_layers: Tuple[int, ...] = (3, 8, 13, 18, 23, 28, 33, 38)
    rope_theta: float = 500000.0
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: Any = torch.float32
    remat: str = "none"

    def __post_init__(self):
        if self.remat not in _REMATS:
            raise ValueError(f"remat must be one of {_REMATS}, got {self.remat!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def self_attn_layer_config(self) -> LlamaConfig:
        """The LlamaConfig of the self-attention layers (and of the cross
        layers' MLP): flash attention and the paged kernel off, as in JAX."""
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size, num_layers=1,
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim, rope_theta=self.rope_theta,
            rope_scaling=self.rope_scaling, rms_norm_eps=self.rms_norm_eps,
            max_seq_len=self.max_seq_len, dtype=self.dtype, remat="none",
            tie_word_embeddings=False,
        )


@dataclasses.dataclass(frozen=True)
class MllamaConfig:
    vision: MllamaVisionConfig = dataclasses.field(default_factory=MllamaVisionConfig)
    text: MllamaTextConfig = dataclasses.field(default_factory=MllamaTextConfig)

    @property
    def vocab_size(self) -> int:
        """The text vocabulary (what the trainer counts labels against)."""
        return self.text.vocab_size


MLLAMA_CONFIGS: Dict[str, MllamaConfig] = {
    # HF meta-llama/Llama-3.2-11B-Vision config.json: the defaults above are
    # the 11B's; the text tower adds llama3 rope scaling, both towers bf16
    "llama3.2-11b-vision": MllamaConfig(
        vision=MllamaVisionConfig(dtype=torch.bfloat16),
        text=MllamaTextConfig(rope_scaling=(8.0, 1.0, 4.0, 8192), max_seq_len=131072,
                              dtype=torch.bfloat16),
    ),
    "tiny-mllama": MllamaConfig(
        vision=MllamaVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_global_layers=1, attention_heads=2, image_size=28,
            patch_size=14, max_num_tiles=2, max_aspect_ratio_id=3,
            intermediate_layers_indices=(0, 1),
        ),
        text=MllamaTextConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_heads=4, num_kv_heads=2,
            cross_attention_layers=(1,), rope_theta=10000.0, max_seq_len=64,
        ),
    ),
}


# ---------------------------------------------------------------------------
# small building blocks
# ---------------------------------------------------------------------------

def _mha(q, k, v, bias, num_heads: int, head_dim: int) -> torch.Tensor:
    """Dense multi-head attention with an additive fp32 bias (JAX :224):
    q (B, Sq, n·D), k / v (B, Skv, n·D); the scores and the softmax in
    fp32, the probabilities cast back to q's dtype."""
    b, sq, _ = q.shape
    skv = k.shape[1]
    q = q.reshape(b, sq, num_heads, head_dim)
    k = k.reshape(b, skv, num_heads, head_dim)
    v = v.reshape(b, skv, num_heads, head_dim)
    scores = torch.einsum("bqnd,bknd->bnqk", q, k).float() * (head_dim ** -0.5)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", probs, v)
    return out.reshape(b, sq, num_heads * head_dim)


def _local_heads(n: int, what: str) -> int:
    tp = parallel_state.tensor_parallel_size_or(1)
    if n % tp:
        raise ValueError(f"tp={tp} does not divide the {n} {what}")
    return n // tp


def _fp32_param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


class VisionAttention(nn.Module):
    """MHA without biases (JAX :242): q / k / v column-, o row-parallel."""

    def __init__(self, config: MllamaVisionConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        self.n_heads = _local_heads(c.attention_heads, "vision attention heads")
        for name in ("q", "k", "v"):
            setattr(self, name, ColumnParallelLinear(c.hidden_size, c.hidden_size,
                                                     dtype=c.dtype, device=device))
        self.o = RowParallelLinear(c.hidden_size, c.hidden_size, dtype=c.dtype, device=device)

    def forward(self, x: torch.Tensor, bias) -> torch.Tensor:
        attn = _mha(self.q(x), self.k(x), self.v(x), bias, self.n_heads, self.config.head_dim)
        return self.o(attn)


class VisionMLP(nn.Module):
    """fc1 -> exact-erf GELU in fp32 -> fc2, with biases (JAX :281)."""

    def __init__(self, config: MllamaVisionConfig, device=None):
        super().__init__()
        c = config
        self.fc1 = ColumnParallelLinear(c.hidden_size, c.intermediate_size, use_bias=True,
                                        dtype=c.dtype, device=device)
        self.fc2 = RowParallelLinear(c.intermediate_size, c.hidden_size, use_bias=True,
                                     dtype=c.dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = nn.functional.gelu(self.fc1(x).float(), approximate="none").to(x.dtype)
        return self.fc2(h)


class VisionEncoderLayer(nn.Module):
    """Pre-LN ViT block (JAX :372); a global layer gates both residual
    branches by tanh of its fp32 gates (which promotes the stream to fp32,
    as in JAX)."""

    def __init__(self, config: MllamaVisionConfig, is_gated: bool = False, device=None):
        super().__init__()
        c = config
        self.is_gated = is_gated
        self.input_layernorm = LayerNorm(c.hidden_size, c.norm_eps, c.dtype, bias=True,
                                         device=device)
        self.self_attn = VisionAttention(c, device)
        self.post_attention_layernorm = LayerNorm(c.hidden_size, c.norm_eps, c.dtype,
                                                  bias=True, device=device)
        self.mlp = VisionMLP(c, device)
        if is_gated:
            self.gate_attn = _fp32_param((1,), device)
            self.gate_ffn = _fp32_param((1,), device)

    def forward(self, x: torch.Tensor, bias) -> torch.Tensor:
        h = self.self_attn(self.input_layernorm(x), bias)
        if self.is_gated:
            h = torch.tanh(self.gate_attn) * h
        x = x + h
        h = self.mlp(self.post_attention_layernorm(x))
        if self.is_gated:
            h = torch.tanh(self.gate_ffn) * h
        return x + h


# ---------------------------------------------------------------------------
# stacked layers
# ---------------------------------------------------------------------------

def _stacked(layer: nn.Module, stack: Tuple[int, ...], device) -> nn.Module:
    """``layer`` (built on the meta device) with each parameter replaced by
    an uninitialized one on ``device`` with the ``stack`` leading dims more:
    the holder of a JAX stacked leaf. It is read, never called."""
    for mod in layer.modules():
        for attr, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[attr] = nn.Parameter(
                    torch.empty((*stack, *p.shape), dtype=p.dtype, device=device))
    return layer


def _read(holder: nn.Module, name: str) -> torch.Tensor:
    """Weight ``name`` of ``holder`` read through its module's attribute
    (LoRA's adapted read, a quantized layer's dequantizing read)."""
    mod, _, attr = name.rpartition(".")
    return getattr(holder.get_submodule(mod) if mod else holder, attr)


def _bind(template: nn.Module, weights: Mapping[str, torch.Tensor], prefix: str = ""
          ) -> nn.Module:
    """A shallow copy of ``template``, its submodules copied likewise, whose
    parameters are ``weights`` by name (the template's configs, groups and
    buffers are shared): a layer to call as it is."""
    layer = copy.copy(template)
    layer.__dict__["_parameters"] = {
        k: None if v is None else weights[prefix + k] for k, v in template._parameters.items()}
    layer.__dict__["_modules"] = {
        k: None if m is None else _bind(m, weights, f"{prefix}{k}.")
        for k, m in template._modules.items()}
    return layer


class _Stack:
    """A stacked layer: the layer's parameterless template (its parameters
    on the meta device) and the stack's shape. :meth:`layers` reads the
    holder's weights once, unbinds them (the backward stacks the slices'
    gradients once) and binds each layer's slices to a copy of the
    template."""

    def __init__(self, template: nn.Module, stack: Tuple[int, ...]):
        self.template = template
        self.names = [n for n, _ in template.named_parameters()]
        self.stack = stack

    def layers(self, holder: nn.Module) -> List[nn.Module]:
        n = math.prod(self.stack)
        cols = {}
        for name in self.names:
            w = _read(holder, name)
            cols[name] = w.reshape(n, *w.shape[len(self.stack):]).unbind(0)
        return [_bind(self.template, {name: cols[name][i] for name in self.names})
                for i in range(n)]


def _remat_run(remat: str, fn, *args):
    """``fn(*args)`` under the remat policy while autograd records (JAX
    ``_remat_policy``; "hybrid" and "kv" save the names JAX's self layers
    tag, which these layers do not have, so they recompute everything)."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if remat in llama._SAVED_OPS:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_ops_policy(llama._SAVED_OPS[remat]))
    return _checkpoint(fn, *args, **kw)


# ---------------------------------------------------------------------------
# vision model
# ---------------------------------------------------------------------------

def tile_validity_bias(aspect_ratio_mask: torch.Tensor, n_pat: int, tlen: int) -> torch.Tensor:
    """The (BM, 1, S, S) additive bias of the vision tower (JAX :600-614):
    ``NEG`` where token i AND token j are both invalid (a padded position,
    or a position of an invalid tile), 0 elsewhere. (JAX's comment says
    "iff both are valid"; its code, and HF's, put NEG only where both are
    invalid, and this follows the code.)"""
    bm, t = aspect_ratio_mask.shape
    tok_ok = aspect_ratio_mask.float().repeat_interleave(tlen, dim=1)
    pad_pos = torch.arange(tlen, device=tok_ok.device) >= n_pat
    tok_ok = tok_ok * torch.where(pad_pos.repeat(t), 0.0, 1.0)[None, :]
    inv = 1.0 - tok_ok
    return ((inv[:, :, None] * inv[:, None, :]) * NEG)[:, None]


class _GatedEmbedding(nn.Module):
    """A gated table: ``embedding`` and the fp32 ``gate`` (1,); the
    positional one has a ``tile_embedding`` too."""

    def __init__(self, shape, device, tile_shape=None):
        super().__init__()
        self.embedding = _fp32_param(shape, device)
        if tile_shape is not None:
            self.tile_embedding = _fp32_param(tile_shape, device)
        self.gate = _fp32_param((1,), device)


class MllamaVisionModel(nn.Module):
    """The tiled ViT (JAX :433): (B, M, T, C, H, W) pixels, (B, M) aspect
    ratio ids and the (B, M, T) tile mask -> (B, M, T, P + 1,
    ``output_dim``) features, the final hidden state followed by the
    states after each of ``intermediate_layers_indices`` (interleaved per
    channel, as JAX stacks them on a last axis)."""

    def __init__(self, config: MllamaVisionConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        H, P, T, R = c.hidden_size, c.num_patches, c.max_num_tiles, c.max_aspect_ratio_id + 1
        self.patch_embedding = OutputChannelParallelConv2d(
            c.num_channels, H, c.patch_size, stride=c.patch_size, use_bias=False,
            gather_output=True, dtype=c.dtype, device=device)
        self.class_embedding = _fp32_param((H,), device)
        self.gated_positional_embedding = _GatedEmbedding((P, H), device, (R, T * P * H))
        self.pre_tile_positional_embedding = _GatedEmbedding((R, T * H), device)
        self.post_tile_positional_embedding = _GatedEmbedding((R, T * H), device)
        self.layernorm_pre = LayerNorm(H, c.norm_eps, c.dtype, bias=True, device=device)
        self.layernorm_post = LayerNorm(H, c.norm_eps, c.dtype, bias=True, device=device)
        meta = torch.device("meta")
        self.transformer = _stacked(VisionEncoderLayer(c, False, meta), (c.num_hidden_layers,),
                                    device)
        self.global_transformer = _stacked(VisionEncoderLayer(c, True, meta),
                                           (c.num_global_layers,), device)
        self._local = _Stack(VisionEncoderLayer(c, False, meta), (c.num_hidden_layers,))
        self._global = _Stack(VisionEncoderLayer(c, True, meta), (c.num_global_layers,))

    def _tile_embedding(self, pe: _GatedEmbedding, hidden, ar_ids):
        """hidden (BM, T, P, H) + tanh(gate) · the aspect ratio's per-tile row."""
        c = self.config
        emb = pe.embedding[ar_ids].reshape(-1, c.max_num_tiles, 1, c.hidden_size)
        return hidden + torch.tanh(pe.gate) * emb

    def _positional_embedding(self, pe: _GatedEmbedding, hidden, ar_ids):
        """(1 - tanh g) · pos + tanh g · the aspect ratio's tile positions."""
        c = self.config
        g = torch.tanh(pe.gate)
        hidden = hidden + (1.0 - g) * pe.embedding.reshape(1, 1, c.num_patches, c.hidden_size)
        tile = pe.tile_embedding[ar_ids].reshape(-1, c.max_num_tiles, c.num_patches,
                                                 c.hidden_size)
        return hidden + g * tile

    def _run_stack(self, stack: _Stack, holder: nn.Module, x, bias, collect=()):
        """The layers of a stack in turn, each under the remat policy; the
        states after the layers of ``collect``."""
        remat = self.config.remat
        states = []
        for i, layer in enumerate(stack.layers(holder)):
            x = _remat_run(remat, functools.partial(layer, bias=bias), x)
            if i in collect:
                states.append(x)
        return x, states

    def forward(self, pixel_values: torch.Tensor, aspect_ratio_ids: torch.Tensor,
                aspect_ratio_mask: torch.Tensor) -> torch.Tensor:
        c = self.config
        b, m, t, ch, hgt, wid = pixel_values.shape
        H = c.hidden_size
        x = pixel_values.reshape(b * m * t, ch, hgt, wid).to(c.dtype)
        patches = self.patch_embedding.forward_nchw(x)  # (N, H, h, w)
        n_pat = patches.shape[2] * patches.shape[3]
        hidden = patches.flatten(2).transpose(1, 2)  # (N, patches, H), row-major
        ar_ids = aspect_ratio_ids.reshape(b * m).long()
        hidden = hidden.reshape(b * m, t, n_pat, H)
        hidden = self._tile_embedding(self.pre_tile_positional_embedding, hidden, ar_ids)
        cls = self.class_embedding.to(c.dtype).expand(b * m * t, 1, H)
        hidden = hidden.reshape(b * m * t, n_pat, H)
        hidden = torch.cat([cls.to(hidden.dtype), hidden], dim=1)
        n_pat += 1
        hidden = hidden.reshape(b * m, t, n_pat, H)
        hidden = self._positional_embedding(self.gated_positional_embedding, hidden, ar_ids)
        hidden = self.layernorm_pre(hidden)
        # the patch dim padded to a multiple of 8 (JAX :596-599)
        npad = (8 - n_pat % 8) % 8
        if npad:
            hidden = nn.functional.pad(hidden, (0, 0, 0, npad))
        tlen = n_pat + npad
        bias = tile_validity_bias(aspect_ratio_mask.reshape(b * m, t), n_pat, tlen)
        hidden = hidden.reshape(b * m, t * tlen, H)
        hidden, states = self._run_stack(self._local, self.transformer, hidden, bias,
                                         collect=set(c.intermediate_layers_indices))
        hidden = self.layernorm_post(hidden)
        hidden = hidden.reshape(b * m, t, tlen, H)
        hidden = self._tile_embedding(self.post_tile_positional_embedding, hidden, ar_ids)
        hidden = hidden.reshape(b * m, t * tlen, H)
        hidden, _ = self._run_stack(self._global, self.global_transformer, hidden, bias)
        # strip the padding; the final state, then the collected ones
        hidden = hidden.reshape(b * m, t, tlen, H)[:, :, :n_pat]
        inter = torch.stack(states, dim=-1).reshape(b * m, t, tlen, -1)[:, :, :n_pat]
        dtype = torch.promote_types(hidden.dtype, inter.dtype)
        out = torch.cat([hidden.to(dtype), inter.to(dtype)], dim=-1)
        return out.reshape(b, m, t, n_pat, c.output_dim)


# ---------------------------------------------------------------------------
# text side
# ---------------------------------------------------------------------------

def text_group_pattern(t: MllamaTextConfig) -> Optional[Tuple[int, int, int]]:
    """(G, k, xpos) when the cross-attention layers are ``xpos + g·k`` for g
    < G (every HF config; the 11B's is (8, 5, 3)), with k >= 2; None for an
    irregular config or one of cross layers only (the list layout)."""
    xl = tuple(t.cross_attention_layers)
    G = len(xl)
    if G == 0 or t.num_hidden_layers % G:
        return None
    k = t.num_hidden_layers // G
    if k < 2:
        return None
    xpos = xl[0]
    if xpos >= k or xl != tuple(xpos + g * k for g in range(G)):
        return None
    return G, k, xpos


# the grouped text stack lifts the plain layers' 2-D kernels to (G, k - 1,
# in, out): LoRA's split reads two stack dims there (JAX :344-346)
register_grouped_stack(
    "layers/plain/", (r"q_kernel$", r"k_kernel$", r"v_kernel$", r"/kernel$"))


def _pack_text_layers(layer_list: Sequence[Mapping[str, Any]], pattern) -> Dict[str, Dict]:
    """Per-layer weight dicts (name -> tensor or array) -> the grouped layout
    {"plain": name -> (G, k - 1, ...), "xattn": name -> (G, ...)} (JAX :348)."""
    G, k, xpos = pattern
    stack = torch.stack if isinstance(next(iter(layer_list[0].values())), torch.Tensor) else np.stack

    def stacked(trees):
        return {n: stack([tr[n] for tr in trees]) for n in trees[0]}

    plains, xatts = [], []
    for g in range(G):
        grp = layer_list[g * k:(g + 1) * k]
        xatts.append(grp[xpos])
        plains.append(stacked([grp[j] for j in range(k) if j != xpos]))
    return {"plain": stacked(plains), "xattn": stacked(xatts)}


def text_layer_slice(layers: Mapping[str, Sequence], i: int, pattern):
    """(layer ``i``'s entry, is it a cross layer) of the grouped layout
    ``layers`` = {"plain": the G·(k - 1) self layers' entries in order,
    "xattn": the G cross layers'} (JAX :361)."""
    G, k, xpos = pattern
    g, j = divmod(i, k)
    if j == xpos:
        return layers["xattn"][g], True
    return layers["plain"][g * (k - 1) + (j if j < xpos else j - 1)], False


class TextCrossAttention(nn.Module):
    """GQA over the vision tokens with per-head RMSNorm on q and k, no rope
    (JAX :682). Under tp each rank holds its q and kv heads (tp must divide
    both); the norms' scales meet this rank's heads only, so their gradient
    is summed over tp."""

    def __init__(self, config: MllamaTextConfig, device=None, sequence_parallel: bool = False):
        super().__init__()
        c = config
        self.config = c
        D = c.head_dim
        self.n_heads = _local_heads(c.num_heads, "q heads")
        self.n_kv_heads = _local_heads(c.num_kv_heads, "kv heads of the cross attention")
        self.q = ColumnParallelLinear(c.hidden_size, c.num_heads * D, dtype=c.dtype,
                                      sequence_parallel=sequence_parallel, device=device)
        self.k = ColumnParallelLinear(c.hidden_size, c.num_kv_heads * D, dtype=c.dtype,
                                      device=device)
        self.v = ColumnParallelLinear(c.hidden_size, c.num_kv_heads * D, dtype=c.dtype,
                                      device=device)
        self.o = RowParallelLinear(c.num_heads * D, c.hidden_size, dtype=c.dtype,
                                   sequence_parallel=sequence_parallel, device=device)
        heads_split = parallel_state.tensor_parallel_size_or(1) > 1
        self.q_norm = RMSNorm(D, c.rms_norm_eps, c.dtype, device=device,
                              sequence_parallel=heads_split)
        self.k_norm = RMSNorm(D, c.rms_norm_eps, c.dtype, device=device,
                              sequence_parallel=heads_split)

    def project_kv(self, vision_tokens: torch.Tensor):
        """k-normed K and raw V (B, S_vis, NKV, D) of the vision tokens:
        what the decoder computes once a request (JAX :727)."""
        c = self.config
        b, skv, _ = vision_tokens.shape
        k = self.k(vision_tokens).reshape(b, skv, self.n_kv_heads, c.head_dim)
        v = self.v(vision_tokens).reshape(b, skv, self.n_kv_heads, c.head_dim)
        return self.k_norm(k), v

    def forward(self, x, vision_tokens, bias, kv=None) -> torch.Tensor:
        """``kv``: (k, v) from :meth:`project_kv` (the decode path), else
        projected here from ``vision_tokens``."""
        c = self.config
        q = self.q(x)
        b, sq = q.shape[:2]
        q = self.q_norm(q.reshape(b, sq, self.n_heads, c.head_dim))
        k, v = kv if kv is not None else self.project_kv(vision_tokens)
        skv = k.shape[1]
        group = self.n_heads // self.n_kv_heads
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
        attn = _mha(q.reshape(b, sq, -1), k.reshape(b, skv, -1), v.reshape(b, skv, -1), bias,
                    self.n_heads, c.head_dim)
        return self.o(attn)


class CrossAttentionDecoderLayer(nn.Module):
    """Zero-init tanh gates on both branches, each gated residual computed
    in fp32 and cast back to the stream's dtype; the MLP branch zeroed on
    the text rows that attend no vision token (JAX :769)."""

    def __init__(self, config: MllamaTextConfig, device=None, sequence_parallel: bool = False):
        super().__init__()
        c = config
        sp = sequence_parallel
        self.sequence_parallel = sp
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype, device=device,
                                       sequence_parallel=sp)
        self.cross_attn = TextCrossAttention(c, device, sp)
        self.cross_attn_attn_gate = _fp32_param((1,), device)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype,
                                                device=device, sequence_parallel=sp)
        self.mlp = LlamaMLP(c.self_attn_layer_config(), device, sp)
        self.cross_attn_mlp_gate = _fp32_param((1,), device)

    def forward(self, x, vision_tokens, bias, full_row, kv=None) -> torch.Tensor:
        sp = self.sequence_parallel
        h = self.cross_attn(self.input_layernorm(x), vision_tokens, bias, kv=kv)
        gate = torch.tanh(_sp_weight(self.cross_attn_attn_gate, sp))
        x = x + (gate * h.float()).to(x.dtype)
        h = self.mlp(self.post_attention_layernorm(x))
        if full_row is not None:
            # (B, 1, S, 1) -> (B, S, 1), this rank's rows under SP
            rows = full_row[:, 0]
            h = (scatter_to_sequence_parallel_region(rows, 1) if sp else rows) * h
        gate = torch.tanh(_sp_weight(self.cross_attn_mlp_gate, sp))
        return x + (gate * h.float()).to(x.dtype)


def prepare_cross_attention_mask(cross_attention_mask: torch.Tensor, num_vision_tokens: int):
    """(bias (B, 1, S, M·T·P) fp32, full_row (B, 1, S, 1) fp32) of a (B, S,
    M, T) 1 = attend mask (JAX :832): each tile's entry repeated over its
    vision tokens, NEG where not attended, and the rows that attend nothing
    zeroed in the bias and flagged 0 in ``full_row``."""
    b, s = cross_attention_mask.shape[:2]
    mask = cross_attention_mask.repeat_interleave(num_vision_tokens, dim=3)
    mask = mask.reshape(b, s, -1)[:, None].float()
    bias = (1.0 - mask) * NEG
    full_row = (bias != NEG).any(dim=-1).float()[..., None]
    return bias * full_row, full_row


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

class MllamaForConditionalGeneration(nn.Module):
    """Vision encoder -> projector -> the Llama decoder with gated
    cross-attention (JAX :853). ``forward`` gives the logits (B, S, V)
    without autograd, :meth:`loss` the mean next-token CE (the trainer's
    ``model.loss(input_ids, labels, **image inputs)``).

    Parameters are allocated on ``device`` (the card unless the caller asks
    for another) and left uninitialized: load them with
    ``load_state_dict(params_from_jax(...))`` or draw them from a seed with
    :meth:`init_weights`. Built under a live mesh the model holds this
    rank's shards (module docstring)."""

    def __init__(self, config: MllamaConfig, device: DeviceLike = "cuda"):
        super().__init__()
        for what, size in (("pipeline", parallel_state.pipeline_parallel_size_or(1)),
                           ("context", parallel_state.context_parallel_size_or(1)),
                           ("expert", parallel_state.expert_parallel_size_or(1))):
            if size > 1:
                raise NotImplementedError(
                    f"Mllama runs no {what} parallelism ({what} size {size}), as in the JAX "
                    "package (its layer stacks are heterogeneous)")
        dev = resolve_device(device)
        self._device = dev
        self.config = config
        t = config.text
        self.tp = parallel_state.tensor_parallel_size_or(1)
        self.sequence_parallel = parallel_state.sequence_parallel_enabled() and self.tp > 1
        sp = self.sequence_parallel
        self.vision_model = MllamaVisionModel(config.vision, dev)
        self.multi_modal_projector = ColumnParallelLinear(
            config.vision.output_dim, t.hidden_size, use_bias=True, gather_output=True,
            dtype=t.dtype, device=dev)
        rows = t.vocab_size + 8
        # +8 rows (HF's special tokens): at a tp that does not divide them
        # the table splits along its dim instead
        self.embed = ParallelEmbedding(rows, t.hidden_size, dtype=t.dtype, device=dev,
                                       shard_dim="vocab" if rows % self.tp == 0 else "embed")
        self.pattern = text_group_pattern(t)
        meta = torch.device("meta")
        self_cfg = t.self_attn_layer_config()
        if self.pattern is not None:
            G, k, _ = self.pattern
            self.layers = nn.Module()
            self.layers.plain = _stacked(LlamaDecoderLayer(self_cfg, meta, sp), (G, k - 1), dev)
            self.layers.xattn = _stacked(CrossAttentionDecoderLayer(t, meta, sp), (G,), dev)
            self._plain = _Stack(LlamaDecoderLayer(self_cfg, meta, sp), (G, k - 1))
            self._xattn = _Stack(CrossAttentionDecoderLayer(t, meta, sp), (G,))
        else:
            self.layers = nn.ModuleDict({
                f"[{i}]": (CrossAttentionDecoderLayer(t, dev, sp)
                           if i in t.cross_attention_layers else LlamaDecoderLayer(self_cfg, dev, sp))
                for i in range(t.num_hidden_layers)})
        self.final_norm = RMSNorm(t.hidden_size, t.rms_norm_eps, t.dtype, device=dev,
                                  sequence_parallel=sp)
        # column-parallel; row-parallel when tp does not divide the vocab
        # (its logits are then whole on every rank)
        self.head_is_column = t.vocab_size % self.tp == 0
        head = ColumnParallelLinear if self.head_is_column else RowParallelLinear
        self.lm_head = head(t.hidden_size, t.vocab_size, dtype=t.dtype, device=dev)

    @property
    def device(self) -> torch.device:
        return self._device

    def param_specs(self) -> Dict[str, LeafSpec]:
        return param_specs(self.config)

    def init_weights(self, seed: int) -> "MllamaForConditionalGeneration":
        """Random weights from ``seed``, drawn whole leaf by leaf on the
        parameters' device (each rank keeps its shard, so the weights are
        the same at any tp): N(0, 0.02) kernels, embeddings and tile
        tables, H^-0.5 · N(0, 1) class and position embeddings, unit norm
        scales, zero biases and gates but the global layers' (pi / 4), as
        JAX's ``init`` (not its draws)."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        own = dict(self.named_parameters())
        coords = mesh_coords()
        H = self.config.vision.hidden_size
        with torch.no_grad():
            for name, leaf in self.param_specs().items():
                full = torch.empty(leaf.shape, dtype=torch.float32, device=self.device)
                if name.endswith("scale"):
                    full.fill_(1.0)
                elif name.endswith(("gate_attn", "gate_ffn")):
                    full.fill_(math.pi / 4)
                elif name.endswith(("bias", "gate")):
                    full.zero_()
                elif name.endswith(("class_embedding", "gated_positional_embedding.embedding")):
                    full.normal_(0.0, 1.0, generator=g).mul_(H ** -0.5)
                else:
                    full.normal_(0.0, KERNEL_INIT_STD, generator=g)
                _, index = port_slice(leaf, coords, None)
                own[name].copy_(full[index])
        return self

    # -- the text layers ----------------------------------------------------

    def text_layers(self) -> List[Tuple[bool, nn.Module]]:
        """(is cross, layer) per text layer, in order: the list layout's
        modules, or the grouped stacks' layers bound to their slices (the
        stacks read once here)."""
        t = self.config.text
        if self.pattern is None:
            return [(i in t.cross_attention_layers, self.layers[f"[{i}]"])
                    for i in range(t.num_hidden_layers)]
        grouped = {"plain": self._plain.layers(self.layers.plain),
                   "xattn": self._xattn.layers(self.layers.xattn)}
        return [text_layer_slice(grouped, i, self.pattern)[::-1]
                for i in range(t.num_hidden_layers)]

    # -- forward ------------------------------------------------------------

    def encode_images(self, pixel_values, aspect_ratio_ids, aspect_ratio_mask) -> torch.Tensor:
        """(B, M·T·P, H_text) projected vision tokens."""
        v = self.vision_model(pixel_values, aspect_ratio_ids, aspect_ratio_mask)
        proj = self.multi_modal_projector(v.to(self.config.text.dtype))
        return proj.reshape(v.shape[0], -1, self.config.text.hidden_size)

    def _hidden(self, input_ids, pixel_values, aspect_ratio_ids, aspect_ratio_mask,
                cross_attention_mask) -> torch.Tensor:
        """The final-normed decoder states (B, S, H), whole over the
        sequence."""
        t = self.config.text
        vision_tokens = self.encode_images(pixel_values, aspect_ratio_ids, aspect_ratio_mask)
        bias = full_row = None
        if cross_attention_mask is not None:
            bias, full_row = prepare_cross_attention_mask(cross_attention_mask,
                                                          self.config.vision.num_patches)
        b, s = input_ids.shape
        x = self.embed(input_ids, sequence_parallel=self.sequence_parallel)
        positions = torch.arange(s, device=input_ids.device).expand(b, s)
        sin, cos = precompute_rope(t.head_dim, s, t.rope_theta, t.rope_scaling,
                                   device=input_ids.device)
        remat = t.remat
        for cross, layer in self.text_layers():
            if cross:
                x = _remat_run(remat, functools.partial(layer, bias=bias, full_row=full_row),
                               x, vision_tokens)
            else:
                x = _remat_run(remat, functools.partial(layer, sin=sin, cos=cos,
                                                        positions=positions), x)
        x = self.final_norm(x)
        if self.sequence_parallel:
            x = gather_from_sequence_parallel_region(x, dim=1, to_model_parallel=False)
        return x

    def _local_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """This rank's (..., V/tp) logits under the column-parallel head,
        the whole (..., V) under the row-parallel one (its input cut to the
        rank's slice of H, the partial products all-reduced)."""
        if self.head_is_column:
            return self.lm_head(hidden)
        return self.lm_head(scatter_to_tensor_model_parallel_region(hidden, -1))

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Logits over the whole vocab (..., V) on every rank."""
        local = self._local_logits(hidden)
        return gather_from_tensor_model_parallel_region(local, -1) if self.head_is_column else local

    @torch.no_grad()
    def forward(self, input_ids, pixel_values, aspect_ratio_ids, aspect_ratio_mask,
                cross_attention_mask=None) -> torch.Tensor:
        return self.logits(self._hidden(input_ids, pixel_values, aspect_ratio_ids,
                                        aspect_ratio_mask, cross_attention_mask))

    def loss(self, input_ids, labels, pixel_values, aspect_ratio_ids, aspect_ratio_mask,
             cross_attention_mask=None) -> torch.Tensor:
        """Mean next-token CE (labels aligned with the ids, shifted here),
        fp32 scalar: the chunked fused CE with chunks of min(512, S), the
        (B, S, V) logits never whole."""
        hidden = self._hidden(input_ids, pixel_values, aspect_ratio_ids, aspect_ratio_mask,
                              cross_attention_mask)
        loss_sum, count = fused_linear_cross_entropy(
            hidden[:, :-1], self._local_logits, labels[:, 1:],
            chunk_size=min(512, hidden.shape[1]), vocab_parallel=self.head_is_column)
        return loss_sum / torch.clamp(count, min=1.0)


# ---------------------------------------------------------------------------
# specs and the weight bridge
# ---------------------------------------------------------------------------

def _vision_layer_leaves(c: MllamaVisionConfig, gated: bool) -> Dict[str, tuple]:
    """One vision layer's leaves: name -> (shape, split)."""
    H, I, T = c.hidden_size, c.intermediate_size, parallel_state.TP_AXIS
    out = {}
    for ln in ("input_layernorm", "post_attention_layernorm"):
        out[f"{ln}.scale"] = out[f"{ln}.bias"] = ((H,), (None,))
    for p in ("q", "k", "v"):
        out[f"self_attn.{p}.kernel"] = ((H, H), (None, T))
    out["self_attn.o.kernel"] = ((H, H), (T, None))
    out["mlp.fc1.kernel"] = ((H, I), (None, T))
    out["mlp.fc1.bias"] = ((I,), (T,))
    out["mlp.fc2.kernel"] = ((I, H), (T, None))
    out["mlp.fc2.bias"] = ((H,), (None,))
    if gated:
        out["gate_attn"] = out["gate_ffn"] = ((1,), (None,))
    return out


def _self_layer_leaves(t: MllamaTextConfig, tp: int) -> Dict[str, tuple]:
    """One self-attention layer's leaves (the Llama layer's, at ``tp``)."""
    specs = llama.param_specs(t.self_attn_layer_config(), tp=tp, pp=1, ep=1)
    return {k[len("layers.0."):]: (s.shape[1:], s.spec[1:])
            for k, s in specs.items() if k.startswith("layers.0.")}


def _cross_layer_leaves(t: MllamaTextConfig) -> Dict[str, tuple]:
    H, I, D, T = t.hidden_size, t.intermediate_size, t.head_dim, parallel_state.TP_AXIS
    N, NKV = t.num_heads * D, t.num_kv_heads * D
    return {
        "input_layernorm.scale": ((H,), (None,)),
        "cross_attn.q.kernel": ((H, N), (None, T)),
        "cross_attn.k.kernel": ((H, NKV), (None, T)),
        "cross_attn.v.kernel": ((H, NKV), (None, T)),
        "cross_attn.o.kernel": ((N, H), (T, None)),
        "cross_attn.q_norm.scale": ((D,), (None,)),
        "cross_attn.k_norm.scale": ((D,), (None,)),
        "cross_attn_attn_gate": ((1,), (None,)),
        "post_attention_layernorm.scale": ((H,), (None,)),
        "mlp.gate_up": ((H, 2, I), (None, None, T)),
        "mlp.down.kernel": ((I, H), (T, None)),
        "cross_attn_mlp_gate": ((1,), (None,)),
    }


def _stack_leaves(prefix: str, leaves: Mapping[str, tuple], stack: Tuple[int, ...]):
    n = len(stack)
    return {f"{prefix}.{k}": LeafSpec((*stack, *shape), (None,) * n + tuple(spec))
            for k, (shape, spec) in leaves.items()}


def param_specs(config: MllamaConfig, tp: Optional[int] = None, pp: Optional[int] = None,
                chunks: int = 1, ep: Optional[int] = None) -> Dict[str, LeafSpec]:
    """Each :class:`MllamaForConditionalGeneration` parameter name -> the
    :class:`..parallel.layout.LeafSpec` of its JAX leaf (JAX ``specs()``):
    the whole leaf's shape, its stack dims unsplit, at tensor parallel size
    ``tp`` (the live one by default)."""
    del chunks, ep
    pp = parallel_state.pipeline_parallel_size_or(1) if pp is None else pp
    if pp > 1:
        raise NotImplementedError("Mllama runs no pipeline (pp > 1), as in the JAX package")
    tp = parallel_state.tensor_parallel_size_or(1) if tp is None else tp
    v, t = config.vision, config.text
    T = parallel_state.TP_AXIS
    H, Hv, P = t.hidden_size, v.hidden_size, v.num_patches
    R, TL = v.max_aspect_ratio_id + 1, v.max_num_tiles
    specs = {
        "vision_model.patch_embedding.kernel": LeafSpec(
            (v.patch_size, v.patch_size, v.num_channels, Hv), (None, None, None, T)),
        "vision_model.class_embedding": LeafSpec((Hv,), (None,)),
        "vision_model.gated_positional_embedding.embedding": LeafSpec((P, Hv), (None, None)),
        "vision_model.gated_positional_embedding.tile_embedding": LeafSpec(
            (R, TL * P * Hv), (None, None)),
        "vision_model.gated_positional_embedding.gate": LeafSpec((1,), (None,)),
    }
    for pe in ("pre_tile_positional_embedding", "post_tile_positional_embedding"):
        specs[f"vision_model.{pe}.embedding"] = LeafSpec((R, TL * Hv), (None, None))
        specs[f"vision_model.{pe}.gate"] = LeafSpec((1,), (None,))
    for ln in ("layernorm_pre", "layernorm_post"):
        for p in ("scale", "bias"):
            specs[f"vision_model.{ln}.{p}"] = LeafSpec((Hv,), (None,))
    specs.update(_stack_leaves("vision_model.transformer", _vision_layer_leaves(v, False),
                               (v.num_hidden_layers,)))
    specs.update(_stack_leaves("vision_model.global_transformer", _vision_layer_leaves(v, True),
                               (v.num_global_layers,)))
    specs["multi_modal_projector.kernel"] = LeafSpec((v.output_dim, H), (None, T))
    specs["multi_modal_projector.bias"] = LeafSpec((H,), (T,))
    rows = t.vocab_size + 8
    specs["embed.embedding"] = LeafSpec((rows, H), (T, None) if rows % tp == 0 else (None, T))
    pattern = text_group_pattern(t)
    if pattern is not None:
        G, k, _ = pattern
        specs.update(_stack_leaves("layers.plain", _self_layer_leaves(t, tp), (G, k - 1)))
        specs.update(_stack_leaves("layers.xattn", _cross_layer_leaves(t), (G,)))
    else:
        for i in range(t.num_hidden_layers):
            leaves = (_cross_layer_leaves(t) if i in t.cross_attention_layers
                      else _self_layer_leaves(t, tp))
            specs.update(_stack_leaves(f"layers.[{i}]", leaves, ()))
    specs["final_norm.scale"] = LeafSpec((H,), (None,))
    specs["lm_head.kernel"] = LeafSpec(
        (H, t.vocab_size), (None, T) if t.vocab_size % tp == 0 else (T, None))
    return specs


llama.FAMILY_SPECS[MllamaConfig] = param_specs


def _leaf_dtypes(config: MllamaConfig) -> Dict[str, torch.dtype]:
    """Each parameter's dtype: the module's own (a model built on the meta
    device)."""
    model = MllamaForConditionalGeneration(config, device="meta")
    return {n: p.dtype for n, p in model.named_parameters()}


def params_from_jax(np_params: Mapping[str, Any], config: MllamaConfig,
                    device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """The JAX package's Mllama pytree, as numpy arrays, -> a state dict for
    :class:`MllamaForConditionalGeneration`: each leaf whole (this rank's
    shard under a live mesh), in its parameter's dtype (fp32 for the norms,
    the gates and the class / position / tile tables, as JAX keeps them)."""
    dtypes = _leaf_dtypes(config)
    return llama.tree_from_jax(np_params, config, dtypes.__getitem__, device,
                               specs=param_specs(config))


def params_to_jax(state_dict: Mapping[str, torch.Tensor], config: MllamaConfig,
                  specs: Optional[Mapping[str, LeafSpec]] = None) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax`: the JAX pytree as fp32 numpy
    arrays (``layers`` a list in the irregular layout), every shard
    gathered over the mesh. Under a mesh every rank must call it."""
    return llama.params_to_jax(state_dict, config, param_specs(config) if specs is None else specs)
