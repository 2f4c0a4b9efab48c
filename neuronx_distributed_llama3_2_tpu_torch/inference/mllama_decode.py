"""Mllama (Llama-3.2 Vision) generation: a KV-cache decode whose
cross-attention K/V are projected once a request.

Counterpart of ``neuronx_distributed_llama3_2_tpu/inference/mllama_decode.py``
(``MllamaCache`` :56, ``MllamaDecoder`` :66). The vision encoder and the
projector run once a request, and so does each cross-attention layer's
``project_kv`` over the vision tokens (they never grow while decoding);
the token loop only writes the self-attention layers' dense caches.

The self-attention layers run through the text engine's own
:meth:`..inference.model.LlamaDecode._decode_layer` (the dense cache
write and the block-causal cache attention), and the cross layers through
the model's own :class:`..models.mllama.CrossAttentionDecoderLayer` with
the precomputed K/V, so the decode cannot drift from the model's forward.

``params`` is the :class:`..models.mllama.MllamaForConditionalGeneration`
holding the weights. ``_live_params`` binds it once for a call, as JAX's
jitted ``forward`` traces its tree once: the text layers bound to their
slices of the grouped stacks
(:meth:`..models.mllama.MllamaForConditionalGeneration.text_layers`) and
the rope tables over ``max_seq_len``; ``generate`` binds once a request
and every token's ``forward`` runs on that binding. A quantized model
(:func:`..quantization.quantize_model`) keeps its int8 / fp8 payloads
resident and each leaf dequantizes inside its read, to the dtype its
weight had: the vision tower's to the vision dtype, the rest to the text
dtype (JAX ``_live_params``). The binding reads each text leaf once, so
a request holds its dequantized text layers until it ends.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch
from torch import nn

from neuronx_distributed_llama3_2_tpu_torch.inference.model import LlamaDecode
from neuronx_distributed_llama3_2_tpu_torch.models.llama import precompute_rope
from neuronx_distributed_llama3_2_tpu_torch.models.mllama import (
    MllamaConfig,
    MllamaForConditionalGeneration,
    prepare_cross_attention_mask,
)
from neuronx_distributed_llama3_2_tpu_torch.quantization import live_params


class MllamaCache(NamedTuple):
    """The self-attention layers' dense caches (one (B, S_max, NKV, D) k and
    v per self layer) and the cross layers' static K/V (one (B, S_vis,
    NKV, D) each, k-normed)."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    cross_k: List[torch.Tensor]
    cross_v: List[torch.Tensor]


class LiveParams(NamedTuple):
    """A model bound for a call: the model (its quantized layers dequantize
    on read), its text layers as ``text_layers`` gives them, and the rope
    tables over the decoder's ``max_seq_len``."""

    model: MllamaForConditionalGeneration
    layers: List[Tuple[bool, nn.Module]]
    sin: torch.Tensor
    cos: torch.Tensor


class MllamaDecoder:
    """Greedy generation for the vision model, one sequence at a time (JAX
    :66). ``generate`` stops at ``eos_token_id`` (-1 never stops)."""

    def __init__(self, config: MllamaConfig, params: MllamaForConditionalGeneration,
                 max_seq_len: int = 512):
        self.config = config
        self.params = params
        self.max_seq_len = max_seq_len
        # the text engine's decode layer, for the self-attention cache path
        self._decode = LlamaDecode(config.text.self_attn_layer_config())
        t = config.text
        self._self_layers = [i for i in range(t.num_hidden_layers)
                             if i not in t.cross_attention_layers]

    def _live_params(self, params) -> LiveParams:
        """The weights the call runs on (JAX :87): the model, its quantized
        layers dequantizing on read, each to its own dtype, bound once
        (:class:`LiveParams`); a binding passes through as it is."""
        if isinstance(params, LiveParams):
            return params
        t = self.config.text
        model = live_params(params)
        sin, cos = precompute_rope(t.head_dim, self.max_seq_len, t.rope_theta, t.rope_scaling,
                                   device=model.device)
        return LiveParams(model, model.text_layers(), sin, cos)

    # -- once a request ---------------------------------------------------------

    @torch.no_grad()
    def precompute_cross_kv(self, pixel_values, aspect_ratio_ids, aspect_ratio_mask
                            ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
        """(vision tokens, cross k per cross layer, cross v per cross layer)."""
        model = live_params(self.params)
        vision_tokens = model.encode_images(pixel_values, aspect_ratio_ids, aspect_ratio_mask)
        ks, vs = [], []
        for cross, layer in model.text_layers():
            if cross:
                k, v = layer.cross_attn.project_kv(vision_tokens)
                ks.append(k)
                vs.append(v)
        return vision_tokens, ks, vs

    def init_cache(self, cross_k, cross_v, batch: int = 1) -> MllamaCache:
        """Zeroed self-attention caches of ``max_seq_len`` rows beside the
        request's cross K/V."""
        t = self.config.text
        dev = self.params.device
        shape = (batch, self.max_seq_len, self._decode.kv_heads, t.head_dim)
        return MllamaCache(
            k=[torch.zeros(shape, dtype=t.dtype, device=dev) for _ in self._self_layers],
            v=[torch.zeros(shape, dtype=t.dtype, device=dev) for _ in self._self_layers],
            cross_k=list(cross_k), cross_v=list(cross_v))

    # -- block forward ----------------------------------------------------------

    @torch.no_grad()
    def forward(self, params, cache: MllamaCache, tokens: torch.Tensor, positions: torch.Tensor,
                bias, full_row) -> Tuple[torch.Tensor, MllamaCache]:
        """The block ``tokens`` (B, T) at ``positions`` (B,): block-causal over
        the self-attention caches (written in place), the cross layers over
        the static K/V with ``bias`` / ``full_row`` for this block.
        ``params``: the model, or its binding (``_live_params``). Returns
        (logits (B, T, V), cache)."""
        live = self._live_params(params)
        model = live.model
        b, tlen = tokens.shape
        positions = positions.to(torch.int32)
        x = model.embed(tokens)
        pos_block = positions[:, None] + torch.arange(tlen, dtype=torch.int32,
                                                      device=tokens.device)[None, :]
        slots = torch.arange(b, device=tokens.device)
        si = ci = 0
        for cross, layer in live.layers:
            if cross:
                x = layer(x, None, bias, full_row, kv=(cache.cross_k[ci], cache.cross_v[ci]))
                ci += 1
            else:
                x = self._decode._decode_layer(layer, x, cache.k[si], cache.v[si], live.sin,
                                               live.cos, pos_block, pos_block, positions,
                                               context_encode=False, slots=slots)
                si += 1
        x = model.final_norm(x)
        return model.logits(x), cache

    # -- generation -------------------------------------------------------------

    @staticmethod
    def step_mask(cross_attention_mask: torch.Tensor) -> torch.Tensor:
        """The (1, 1, M, T) mask of a generated token: the last prompt row's
        tile visibility (JAX :228-233; HF extends the mask the same way)."""
        return cross_attention_mask[:, -1:]

    def generate(self, prompt: Sequence[int], pixel_values, aspect_ratio_ids,
                 aspect_ratio_mask, cross_attention_mask, max_new_tokens: int = 32,
                 eos_token_id: int = -1) -> List[int]:
        """Greedy continuation of ``prompt`` (JAX :183); the cross-attention
        mask is (1, len(prompt), M, T), and each generated token takes the
        last prompt row's (as HF extends it)."""
        c_vis = self.config.vision
        if max_new_tokens < 1:
            return []
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        dev = self.params.device
        _, cross_k, cross_v = self.precompute_cross_kv(pixel_values, aspect_ratio_ids,
                                                       aspect_ratio_mask)
        cache = self.init_cache(cross_k, cross_v)
        live = self._live_params(self.params)  # once a request
        xmask = torch.as_tensor(cross_attention_mask, device=dev)
        bias, full_row = prepare_cross_attention_mask(xmask, c_vis.num_patches)
        toks = torch.tensor([list(prompt)], dtype=torch.long, device=dev)
        zero = torch.zeros((1,), dtype=torch.int32, device=dev)
        logits, cache = self.forward(live, cache, toks, zero, bias, full_row)
        out = [int(logits[0, len(prompt) - 1].argmax())]
        step_bias, step_full = prepare_cross_attention_mask(self.step_mask(xmask),
                                                            c_vis.num_patches)
        pos = len(prompt)
        while len(out) < max_new_tokens and out[-1] != eos_token_id:
            logits, cache = self.forward(
                live, cache, torch.tensor([[out[-1]]], dtype=torch.long, device=dev),
                torch.tensor([pos], dtype=torch.int32, device=dev), step_bias, step_full)
            out.append(int(logits[0, 0].argmax()))
            pos += 1
        return out
