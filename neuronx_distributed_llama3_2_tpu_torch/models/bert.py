"""BERT family (MLM + NSP pretraining), in PyTorch.

Counterpart of ``neuronx_distributed_llama3_2_tpu/models/bert.py``
(``BertConfig`` :48, ``BERT_CONFIGS`` :69, ``BertEmbeddings`` :82,
``BertLayer`` :130, ``BertForPreTraining`` :226): a bidirectional post-LN
encoder with learned positions, an MLM head (transform, gelu, LayerNorm,
the decoder tied to the word embedding, a free fp32 bias) and an NSP head
(the tanh pooler on the first token). Attention is the JAX package's
``core_attention(causal=False, bias=...)`` with the additive padding bias,
plain torch by the reference's own design: the JAX model reaches no
Pallas kernel either.

The parameters keep JAX's names and layout (``embeddings.word.embedding``,
``embeddings.position``, ``embeddings.token_type``, ``layers.<i>.attn.qkv.
{q,k,v}_{kernel,bias}``, ``layers.<i>.attn.o``, ``layers.<i>.mlp.{up,
down}``, the norms, ``pooler``, ``mlm_transform``, ``mlm_norm``,
``mlm_bias``, ``nsp``), so :func:`..models.llama.params_from_jax` /
``params_to_jax`` and the checkpoints carry them (:func:`param_specs`,
registered in ``llama.FAMILY_SPECS``). Under tensor parallelism the heads,
the MLP, the pooler and the transform split as in JAX's ``specs()``, the
word embedding along the vocab, and the MLM logits stay vocab-parallel
into the cross-entropy. There is no sequence parallelism and no pipeline
(JAX runs neither for BERT).

:meth:`BertForPreTraining.loss` is the MLM loss on the trainer's
``(input_ids, labels)`` batch (labels unshifted, -100 where unmasked);
:meth:`BertForPreTraining.pretraining_loss` adds token types, the padding
mask and the NSP term. The HF converters (JAX :404-557) come with the
checkpoint converter (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import create_selective_checkpoint_contexts

from neuronx_distributed_llama3_2_tpu_torch.models import llama
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LayerNorm,
    _checkpoint,
    _save_ops_policy,
    core_attention,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.layers import (
    KERNEL_INIT_STD,
    ColumnParallelLinear,
    GQAQKVColumnParallelLinear,
    ParallelEmbedding,
    RowParallelLinear,
    kv_mode,
    normal_init_,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.layout import LeafSpec
from neuronx_distributed_llama3_2_tpu_torch.parallel.loss import (
    parallel_cross_entropy,
    valid_token_mask,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_tensor_model_parallel_region,
)
from neuronx_distributed_llama3_2_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """HF ``BertConfig`` fields the reference example trains from, with the
    JAX package's names and defaults. ``dtype`` is a torch dtype."""

    vocab_size: int = 30522
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: Any = torch.bfloat16
    remat: str = "none"
    scan_layers: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


BERT_CONFIGS: Dict[str, BertConfig] = {
    # bert-large-uncased (the reference example's target model)
    "bert-large": BertConfig(),
    "bert-base": BertConfig(
        hidden_size=768, intermediate_size=3072, num_layers=12, num_heads=12
    ),
    "tiny-bert": BertConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=4,
        num_heads=8, max_position_embeddings=128, dtype=torch.float32,
    ),
}


def _norm(c: BertConfig, device) -> LayerNorm:
    return LayerNorm(c.hidden_size, c.layer_norm_eps, c.dtype, bias=True, device=device)


def _normal(p: nn.Parameter, generator) -> None:
    normal_init_(p, generator, KERNEL_INIT_STD)


class BertEmbeddings(nn.Module):
    """Word (vocab-parallel) + learned position + token type, then the
    LayerNorm."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        c = config
        self.word = ParallelEmbedding(c.vocab_size, c.hidden_size, dtype=c.dtype, device=device)
        self.position = nn.Parameter(torch.empty(
            (c.max_position_embeddings, c.hidden_size), dtype=c.dtype, device=device))
        self.token_type = nn.Parameter(torch.empty(
            (c.type_vocab_size, c.hidden_size), dtype=c.dtype, device=device))
        self.norm = _norm(c, device)

    def reset_parameters(self, generator) -> None:
        self.word.reset_parameters(generator)
        _normal(self.position, generator)
        _normal(self.token_type, generator)
        self.norm.reset_parameters()

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        x = self.word(input_ids)
        x = x + self.position[None, :s, :]
        x = x + self.token_type[token_type_ids]
        return self.norm(x)


class _Attention(nn.Module):
    """The ``attn`` subtree: the fused QKV (N = NKV, biased) and ``o``."""

    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.qkv = GQAQKVColumnParallelLinear(
            c.hidden_size, c.num_heads, c.num_heads, c.head_dim, use_bias=True,
            dtype=c.dtype, device=device,
        )
        self.o = RowParallelLinear(c.hidden_size, c.hidden_size, use_bias=True, dtype=c.dtype,
                                   device=device)


class _MLP(nn.Module):
    """The ``mlp`` subtree: ``up`` column-, ``down`` row-parallel, biased."""

    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.up = ColumnParallelLinear(c.hidden_size, c.intermediate_size, use_bias=True,
                                       dtype=c.dtype, device=device)
        self.down = RowParallelLinear(c.intermediate_size, c.hidden_size, use_bias=True,
                                      dtype=c.dtype, device=device)


class BertLayer(nn.Module):
    """Post-LN encoder layer: LN(x + attn(x)), LN(x + mlp(x)), attention
    non-causal with the additive padding bias."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.config = config
        self.attn = _Attention(config, device)
        self.attn_norm = _norm(config, device)
        self.mlp = _MLP(config, device)
        self.mlp_norm = _norm(config, device)

    def reset_parameters(self, generator) -> None:
        self.attn.qkv.reset_parameters(generator)
        self.attn.o.reset_parameters(generator)
        self.attn_norm.reset_parameters()
        self.mlp.up.reset_parameters(generator)
        self.mlp.down.reset_parameters(generator)
        self.mlp_norm.reset_parameters()

    def forward(self, x: torch.Tensor, mask_bias: Optional[torch.Tensor]) -> torch.Tensor:
        c = self.config
        b, s, _ = x.shape
        n = self.attn.qkv.q_local_heads
        q, k, v = self.attn.qkv(x)
        att = core_attention(
            q.reshape(b, s, n, c.head_dim), k.reshape(b, s, n, c.head_dim),
            v.reshape(b, s, n, c.head_dim), causal=False, bias=mask_bias,
        )
        x = self.attn_norm(x + self.attn.o(att.reshape(b, s, n * c.head_dim)))
        h = nn.functional.gelu(self.mlp.up(x).float()).to(c.dtype)
        return self.mlp_norm(x + self.mlp.down(h))


class _NSP(nn.Module):
    def __init__(self, c: BertConfig, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((c.hidden_size, 2), dtype=c.dtype, device=device))
        self.bias = nn.Parameter(torch.empty((2,), dtype=c.dtype, device=device))


class BertForPreTraining(nn.Module):
    """MLM + NSP pretraining model (HF ``BertForPreTraining``): ``forward``
    returns (prediction logits (B, S, V), seq-relationship logits (B, 2)).

    Parameters are allocated on ``device`` (the card unless the caller asks
    for another) and left uninitialized: load them with
    ``load_state_dict(params_from_jax(...))`` or draw them from a seed with
    :meth:`init_weights`."""

    def __init__(self, config: BertConfig, device: DeviceLike = "cuda"):
        super().__init__()
        if parallel_state.pipeline_parallel_size_or(1) > 1:
            raise NotImplementedError("BERT runs no pipeline (pp > 1), as in the JAX package")
        dev = resolve_device(device)
        c = config
        self.config = c
        self.embeddings = BertEmbeddings(c, dev)
        self.layers = nn.ModuleList(BertLayer(c, dev) for _ in range(c.num_layers))
        self.pooler = ColumnParallelLinear(c.hidden_size, c.hidden_size, use_bias=True,
                                           gather_output=True, dtype=c.dtype, device=dev)
        self.mlm_transform = ColumnParallelLinear(c.hidden_size, c.hidden_size, use_bias=True,
                                                  gather_output=True, dtype=c.dtype, device=dev)
        self.mlm_norm = _norm(c, dev)
        # the decoder is tied to the word embedding; its bias is free (HF
        # cls.predictions.bias), fp32
        self.mlm_bias = nn.Parameter(torch.empty((c.vocab_size,), dtype=torch.float32,
                                                 device=dev))
        self.nsp = _NSP(c, dev)
        self._device = dev

    @property
    def device(self) -> torch.device:
        return self._device

    def init_weights(self, seed: int) -> "BertForPreTraining":
        """Random weights from ``seed``: N(0, 0.02) kernels and tables, unit
        norms, zero biases."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        self.embeddings.reset_parameters(g)
        for layer in self.layers:
            layer.reset_parameters(g)
        self.pooler.reset_parameters(g)
        self.mlm_transform.reset_parameters(g)
        self.mlm_norm.reset_parameters()
        _normal(self.nsp.kernel, g)
        with torch.no_grad():
            self.mlm_bias.zero_()
            self.nsp.bias.zero_()
        return self

    def param_specs(self) -> Dict[str, LeafSpec]:
        return param_specs(self.config)

    def _layer(self, layer: BertLayer, x, mask_bias):
        remat = self.config.remat if torch.is_grad_enabled() else "none"
        if remat == "none":
            return layer(x, mask_bias)
        kw = {}
        if remat in llama._SAVED_OPS:
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_ops_policy(llama._SAVED_OPS[remat]))
        # the named saves of "hybrid" / "kv" name nothing in BERT: all recompute
        return _checkpoint(layer, x, mask_bias, **kw)

    def _encode(self, input_ids: torch.Tensor, token_type_ids: Optional[torch.Tensor],
                attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        mask_bias = None
        if attention_mask is not None:
            # (B, T) 1 = keep -> additive (B, 1, 1, T)
            mask_bias = ((1.0 - attention_mask.float()) * -1e30)[:, None, None, :]
        for layer in self.layers:
            x = self._layer(layer, x, mask_bias)
        return x

    def _mlm_local_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """This rank's (B, S, V/tp) slice of the MLM logits (all of them at
        tp = 1): the transform, gelu, the norm, then the tied decoder."""
        c = self.config
        h = nn.functional.gelu(self.mlm_transform(hidden).float()).to(c.dtype)
        h = self.mlm_norm(h)
        emb = self.embeddings.word
        # the replicated bias is read in slices: its gradient sums over tp
        bias = copy_to_tensor_model_parallel_region(self.mlm_bias)
        bias = bias[emb.vocab_start:emb.vocab_start + emb.embedding.shape[0]]
        logits = copy_to_tensor_model_parallel_region(h) @ emb.embedding.T
        return logits + bias.to(logits.dtype)

    def _nsp_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        pooled = torch.tanh(self.pooler(hidden[:, 0, :]))
        return (pooled @ self.nsp.kernel + self.nsp.bias).float()

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor, token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(prediction logits (B, S, V), seq-relationship logits (B, 2)),
        without autograd; the vocab slices gathered over tp."""
        hidden = self._encode(input_ids, token_type_ids, attention_mask)
        mlm = gather_from_tensor_model_parallel_region(self._mlm_local_logits(hidden), -1)
        return mlm, self._nsp_logits(hidden)

    def _mlm_loss(self, local_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Unshifted masked-position CE; labels -100 where unmasked."""
        per_tok = parallel_cross_entropy(local_logits, labels)
        valid = valid_token_mask(labels, self.config.vocab_size).float()
        return (per_tok * valid).sum() / torch.clamp(valid.sum(), min=1.0)

    def loss(self, input_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The MLM loss on the trainer's (input_ids, labels) batch (labels
        unshifted, -100 = unmasked), fp32 scalar."""
        hidden = self._encode(input_ids, None, None)
        return self._mlm_loss(self._mlm_local_logits(hidden), labels)

    def pretraining_loss(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The whole MLM + NSP objective (the reference's ``run_pretrain``
        loss): ``batch`` holds input_ids, labels, next_sentence_label and,
        optionally, token_type_ids and attention_mask."""
        hidden = self._encode(batch["input_ids"], batch.get("token_type_ids"),
                              batch.get("attention_mask"))
        mlm = self._mlm_loss(self._mlm_local_logits(hidden), batch["labels"])
        logp = torch.log_softmax(self._nsp_logits(hidden), dim=-1)
        nsp = -logp.gather(1, batch["next_sentence_label"].long()[:, None])[:, 0].mean()
        return mlm + nsp


def param_specs(config: BertConfig, tp: Optional[int] = None, pp: Optional[int] = None,
                chunks: int = 1, ep: Optional[int] = None) -> Dict[str, LeafSpec]:
    """Each :class:`BertForPreTraining` parameter name -> the
    :class:`..parallel.layout.LeafSpec` of its JAX leaf (JAX ``specs()``):
    the global shape (L first for the layer stack) and its split at tensor
    parallel size ``tp`` (the live one by default)."""
    del chunks, ep
    pp = parallel_state.pipeline_parallel_size_or(1) if pp is None else pp
    if pp > 1:
        raise NotImplementedError("BERT runs no pipeline (pp > 1), as in the JAX package")
    c = config
    tp = parallel_state.tensor_parallel_size_or(1) if tp is None else tp
    T = parallel_state.TP_AXIS
    L, H, I, V = c.num_layers, c.hidden_size, c.intermediate_size, c.vocab_size
    kv = T if kv_mode(c.num_heads, c.num_heads, c.head_dim, tp) != "replicated" else None
    norm = {"scale": ((H,), (None,)), "bias": ((H,), (None,))}
    layer = {
        "attn.qkv.q_kernel": ((H, H), (None, T)), "attn.qkv.q_bias": ((H,), (T,)),
        "attn.qkv.k_kernel": ((H, H), (None, kv)), "attn.qkv.k_bias": ((H,), (kv,)),
        "attn.qkv.v_kernel": ((H, H), (None, kv)), "attn.qkv.v_bias": ((H,), (kv,)),
        "attn.o.kernel": ((H, H), (T, None)), "attn.o.bias": ((H,), (None,)),
        "mlp.up.kernel": ((H, I), (None, T)), "mlp.up.bias": ((I,), (T,)),
        "mlp.down.kernel": ((I, H), (T, None)), "mlp.down.bias": ((H,), (None,)),
        **{f"{n}.{k}": v for n in ("attn_norm", "mlp_norm") for k, v in norm.items()},
    }
    top = {
        "embeddings.word.embedding": ((V, H), (T, None)),
        "embeddings.position": ((c.max_position_embeddings, H), (None, None)),
        "embeddings.token_type": ((c.type_vocab_size, H), (None, None)),
        **{f"embeddings.norm.{k}": v for k, v in norm.items()},
    }
    specs = {k: LeafSpec(*v) for k, v in top.items()}
    for i in range(L):
        for name, (shape, spec) in layer.items():
            specs[f"layers.{i}.{name}"] = LeafSpec((L, *shape), (None, *spec), stacked=True)
    for head in ("pooler", "mlm_transform"):
        specs[f"{head}.kernel"] = LeafSpec((H, H), (None, T))
        specs[f"{head}.bias"] = LeafSpec((H,), (T,))
    specs.update({f"mlm_norm.{k}": LeafSpec(*v) for k, v in norm.items()})
    specs["mlm_bias"] = LeafSpec((V,), (None,))
    specs["nsp.kernel"] = LeafSpec((H, 2), (None, None))
    specs["nsp.bias"] = LeafSpec((2,), (None,))
    return specs


llama.FAMILY_SPECS[BertConfig] = param_specs
