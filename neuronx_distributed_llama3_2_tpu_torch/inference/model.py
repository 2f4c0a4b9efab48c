"""KV-cache decoder model: the dense per-slot cache and the paged pool.

Counterpart of ``neuronx_distributed_llama3_2_tpu/inference/model.py``
(``KVCache``, ``PagedKVCache`` and ``LlamaDecode``). One function covers
every forward mode of both engines::

    forward(params, cache, tokens (b, T), positions (b,), slots (b,))
    forward(params, cache, tokens (b, T), positions (b,), block_tables=...)

The dense cache (:class:`KVCache`, :class:`..inference.engine.
InferenceEngine`) reserves a ``max_len`` row per slot: the fresh K/V land
at ``(slots, positions + t)``, a prefill (``context_encode=True``) attends
the fresh block only, and every other block attends the first
``kv_limit`` rows of its slots through :meth:`LlamaDecode._cache_attention`
(``tree=`` for Medusa's candidate trees). A row past ``max_len`` is
dropped, as JAX's scatter drops it (:meth:`LlamaDecode._attend_dense`).

The paged pool serves these modes:

- whole-prompt prefill  = ``context_encode=True``, positions == 0: attention
  over the fresh block only (:func:`..models.llama.core_attention`); the
  first chunk of a chunked prefill takes this path too;
- token-gen             = T == 1, through the paged-decode kernel;
- suffix prefill        = T > 1 after a prefix-cache hit, or a later chunk
  of a chunked prefill: the paged-decode kernel when T <=
  ``paged_kernel_max_t``, else the gather of the cached rows plus
  :meth:`LlamaDecode._cache_attention`;
- speculative verify    = :meth:`LlamaDecode.verify_step`, the block
  ``[cur, drafts]`` scored in one forward and accepted on the device;
- tree verify           = :meth:`LlamaDecode.tree_verify_step`, a packed
  candidate tree scored in one ancestor-masked forward (the kernel's
  ``tree_bits`` mode, or the gather with the ancestor mask past t = 32),
  its deepest accepted path moved to the lane's frontier rows;
- fused mixed-mode step = :meth:`LlamaDecode.mixed_step`, decode, verify and
  prefill-chunk rows of different live widths in one t-row block, with
  ``row_live`` cutting each lane's kernel walk at its live frontier; with
  ``parents`` its verify rows are packed trees.

A quantized pool (``kv_cache_dtype`` int8 / fp8, :mod:`..quantization.
kv_cache`) holds low-bit payloads beside per-(row, kv head) fp16 scales.
Fresh K/V are quantized on write, and every attention consumer reads the
round-tripped values: the whole-prompt prefill attends the dequantized
fresh block, the kernel dequantizes each block it reads, and the gather
dequantizes the gathered rows, so all paths see the same operands.

``params`` is the :class:`..models.llama.LlamaForCausalLM` module holding the
weights; ``LlamaDecode`` itself holds none, as in the JAX package. The JAX
package donates the cache to every program and gets a new pool back; here
the fresh K/V rows are written into the pool tensors in place, and the
cache returned is the same object that came in.

Rows a garbage lane (idle, or parked) writes past the block table land in
the null block, as the JAX package's gathers and scatters put them (an
out-of-range table column reads INT_MIN there, whose row product wraps to
block 0). Their rope rows are zero, where ``jnp.take`` fills NaN: NaN K/V
in the null block would reach a live lane whose walk reads a null-backed
block, since a masked row's weight 0 times NaN is NaN. Zero rotates those
rows to q = k = 0, and every value stays finite.

With ``sampling=`` the steps draw their tokens on the device
(:func:`..inference.sampling.sample_lanes`, ``PagedConfig.
on_device_sampling``), each keyed by the token's landing index, as the
JAX package's steps are. With ``logit_poison=`` (the serving engine's
checked programs, ``PagedConfig.detect_nonfinite``) each step runs
:meth:`LlamaDecode.finite_logit_check` on its logits before sampling and
before the accept rule, and returns one ``finite`` bool per lane beside
its tokens.

Under tensor parallelism (a model built under a live mesh, one process
per rank) each rank's caches hold its kv heads: ``NKV/tp`` when tp divides
them (:meth:`LlamaDecode.paged_cache_specs` / :meth:`LlamaDecode.
cache_specs`, JAX ``:187``/``:207``), the heads its q heads read otherwise;
the block dim stays whole, so the block tables index alike on every rank.
The kernel takes a call on a pure-tp mesh whose tp divides both head
counts (:meth:`LlamaDecode._paged_kernel_eligible`, JAX's gate), each rank
running K4 on its own heads (:func:`..kernels.paged_attention.
paged_flash_decode_tp`); the row-parallel o-projection all-reduces after
it, and the LM head's vocab slices are gathered before sampling, so every
rank draws the same token.

:class:`MixtralDecode` is the MoE families' decode model (Mixtral, DBRX):
the same attention and caches with each layer's MLP swapped for its MoE
block, which never drops a token (JAX ``MixtralDecode``, :1204). A fresh
block of T tokens whose T·k assignments do not exceed E gathers each
token's chosen experts (the selective path), a larger one runs every
expert on every token; ``moe_paths`` counts, per decoder-layer call, which
ran. Both are static-shape ``topk`` / ``index_select`` / ``einsum`` code, so
a step stays capturable in a CUDA graph. :class:`GPTNeoXDecode` is the
GPT-NeoX / CodeGen family's (JAX :1248): the same caches and attention
paths under its block and its partial rotary. :func:`decode_model_for`
picks the decode model of a config (JAX :1311).
"""

from __future__ import annotations

import collections
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import sample_lanes
from neuronx_distributed_llama3_2_tpu_torch.inference.speculative import (
    accept_rule,
    tree_accept_rule,
    tree_topology,
)
from neuronx_distributed_llama3_2_tpu_torch.kernels.paged_attention import (
    paged_flash_decode,
    paged_flash_decode_tp,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.layers import kv_mode
from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    core_attention,
)
from neuronx_distributed_llama3_2_tpu_torch.quantization.kv_cache import (
    KV_SCALE_DTYPE,
    kv_cache_torch_dtype,
    kv_dequantize,
    kv_quantize,
)
from neuronx_distributed_llama3_2_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)


class KVCache(NamedTuple):
    """Stacked-layer dense KV cache: k/v (L, B, S_max, n_kv, head_dim), one
    ``S_max``-row slot per request."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_batch(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


class PagedKVCache(NamedTuple):
    """Block-pooled KV cache: k/v (L, num_blocks, block_size, n_kv, head_dim).

    Sequence rows live in fixed-size blocks drawn from one global pool
    (vLLM PagedAttention) and a per-request *block table* maps logical
    block index -> pool block id. Block 0 is reserved as the null block:
    block-table entries past a request's allocated frontier point at it, so
    bucket-padding writes land in garbage rows that no masked read ever
    sees.

    Quantized (``kv_cache_dtype`` int8 / fp8): ``k`` / ``v`` hold the
    low-bit payloads and ``k_scale`` / ``v_scale`` the per-(token row, kv
    head) fp16 scales, (L, num_blocks, block_size, n_kv). ``None`` scales
    are the fp pool."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A 1-byte payload seen as uint8: torch's index_copy_ has no fp8
    kernels, and a byte copy moves the same bits."""
    return x.view(torch.uint8) if x.element_size() == 1 else x


def _pool_rows(tables: torch.Tensor, rows: torch.Tensor, bs: int) -> torch.Tensor:
    """Pool rows of the logical ``rows`` (b, n) of each lane through its
    block table: ``tables[i, p // bs] * bs + p % bs``. A row past the table
    maps to the null block (id 0), as in the JAX package (see the module
    note)."""
    tables = tables.long()
    rows = rows.long()
    cols = rows // bs
    w = tables.shape[1]
    blk = torch.gather(tables, 1, cols.clamp(max=w - 1))
    blk = torch.where(cols < w, blk, torch.zeros_like(blk))
    return blk * bs + rows % bs


def tree_bits_of(ancestors: torch.Tensor) -> torch.Tensor:
    """The paged kernel's ``tree_bits`` (b, t) int32 of an ancestor matrix
    (b, t, t): bit ``m`` of row ``j`` is ``ancestors[:, j, m]`` (bit 31 is
    the int32 sign bit)."""
    t = ancestors.shape[-1]
    shifts = torch.arange(t, device=ancestors.device)
    bits = (ancestors.long() << shifts).sum(dim=-1)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).contiguous()


def _sample_at(logits: torch.Tensor, sampling: tuple, index: torch.Tensor) -> torch.Tensor:
    """:func:`..inference.sampling.sample_lanes` of ``logits`` with the
    per-lane ``sampling`` tuple ``(rng_data, temperature, top_k, top_p)``,
    each draw keyed by its landing ``index``."""
    rng_data, temperature, top_k, top_p = sampling
    return sample_lanes(logits, rng_data, index, temperature, top_k, top_p)


class LlamaDecode:
    """Decode-mode Llama over the weights of a :class:`LlamaForCausalLM`.

    ``attention_paths`` counts, per decoder-layer call, which attention
    path ran: ``"context"`` (whole-prompt prefill, plain torch),
    ``"kernel"`` (the paged-decode kernel) or ``"gather"`` (block-table
    gather plus plain-torch cache attention)."""

    def __init__(self, config: LlamaConfig) -> None:
        self.config = config
        self.attention_paths: collections.Counter = collections.Counter()
        self._rope: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, ...]] = {}
        c = config
        # this rank's heads under the live mesh's tp (all of them at tp = 1):
        # the kv heads its attention layer projects (parallel/layers.py)
        self.tp = parallel_state.tensor_parallel_size_or(1)
        mode = kv_mode(c.num_heads, c.num_kv_heads, c.head_dim, self.tp)
        self.n_heads = c.num_heads // self.tp
        self.kv_heads = {"sharded": c.num_kv_heads // self.tp, "flat": 1,
                         "replicated": self.n_heads}[mode]

    def _rope_tables(self, params: LlamaForCausalLM, max_len: int, device: torch.device):
        """Rotary tables for ``max_len`` rows, the model's own (its
        ``_rope``: partial rotary for the GPT-NeoX family, as JAX's
        ``_rope_tables`` reads the model's), built once per (length,
        device): every layer of every step shares them. ``max_len`` more
        rows of zeros follow, which a garbage lane's rows past the table
        read (the module note says why not NaN, as in the JAX package)."""
        key_ = (max_len, device)
        tables = self._rope.get(key_)
        if tables is None:
            tables = tuple(
                torch.cat([x, torch.zeros_like(x)])
                for x in params._rope(max_len, device=device)
            )
            self._rope[key_] = tables
        return tables

    # -- cache ------------------------------------------------------------

    def _head_axis(self) -> Optional[str]:
        """"tp" where the kv heads split over tp, None where each rank
        keeps its own copy (JAX ``_head_axis``)."""
        c = self.config
        return parallel_state.TP_AXIS if self.tp > 1 and c.num_kv_heads % self.tp == 0 else None

    def paged_cache_specs(self, quantized: bool = False) -> PagedKVCache:
        """Each pool's split, per dim (JAX ``paged_cache_specs``): kv heads
        over tp when tp divides them, the block dim whole, so that any
        block is writable by any request and the tables index alike on
        every rank; the scale arrays split their kv-head axis alike."""
        spec = (None, None, None, self._head_axis(), None)
        if not quantized:
            return PagedKVCache(k=spec, v=spec)
        return PagedKVCache(k=spec, v=spec, k_scale=spec[:-1], v_scale=spec[:-1])

    def cache_specs(self, max_batch: Optional[int] = None) -> KVCache:
        """The dense cache's split, per dim (JAX ``cache_specs``): kv heads
        over tp when divisible. The batch stays whole: each process serves
        every slot of its tp group (dp replicas are engines of their own)."""
        spec = (None, None, None, self._head_axis(), None)
        return KVCache(k=spec, v=spec)

    def init_cache(
        self, max_batch: int, max_len: int, dtype=None, device: DeviceLike = "cuda",
    ) -> KVCache:
        """Zeroed dense cache of ``max_batch`` slots of ``max_len`` rows, at
        ``dtype or config.dtype``, on ``device``."""
        c = self.config
        shape = (c.num_layers, max_batch, max_len, self.kv_heads, c.head_dim)
        dev = resolve_device(device)
        dtype = dtype or c.dtype
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
        )

    def init_paged_cache(
        self, num_blocks: int, block_size: int, dtype=None,
        kv_cache_dtype: Optional[str] = None, device: DeviceLike = "cuda",
    ) -> PagedKVCache:
        """Zeroed block pool of ``num_blocks * block_size`` token rows shared
        by every request, on ``device``: at ``dtype or config.dtype`` for
        ``kv_cache_dtype`` None / "bf16", else the int8 / fp8 payload pools
        plus their (L, num_blocks, block_size, n_kv) fp16 scale arrays."""
        c = self.config
        shape = (c.num_layers, num_blocks, block_size, self.kv_heads, c.head_dim)
        dev = resolve_device(device)
        if kv_cache_dtype in (None, "bf16"):
            dtype = dtype or c.dtype
            return PagedKVCache(
                k=torch.zeros(shape, dtype=dtype, device=dev),
                v=torch.zeros(shape, dtype=dtype, device=dev),
            )
        if dtype is not None:
            raise ValueError(
                "cache dtype override and quantized kv_cache_dtype are "
                "mutually exclusive: the storage dtype is the quantization"
            )
        qdt = kv_cache_torch_dtype(kv_cache_dtype)
        sshape = shape[:-1]
        return PagedKVCache(
            k=torch.zeros(shape, dtype=qdt, device=dev),
            v=torch.zeros(shape, dtype=qdt, device=dev),
            k_scale=torch.zeros(sshape, dtype=KV_SCALE_DTYPE, device=dev),
            v_scale=torch.zeros(sshape, dtype=KV_SCALE_DTYPE, device=dev),
        )

    # -- forward ----------------------------------------------------------

    @torch.no_grad()
    def forward(
        self,
        params: LlamaForCausalLM,
        cache,                     # KVCache (dense) or PagedKVCache
        tokens: torch.Tensor,      # (b, T) int
        positions: torch.Tensor,   # (b,) int — absolute start position
        slots: Optional[torch.Tensor] = None,  # (b,) int dense cache rows
        *,
        context_encode: bool = False,
        return_hidden: bool = False,
        tree=None,
        kv_limit: Optional[int] = None,
        block_tables: Optional[torch.Tensor] = None,  # (b, W) int32
        row_live: Optional[torch.Tensor] = None,
    ):
        """Block-causal forward over the cache.

        Returns (logits (b, T, V) — or the final-norm hidden states with
        ``return_hidden`` — , cache). The cache is written in place and the
        cache returned is the one that came in.

        Dense (``block_tables`` None, a :class:`KVCache`): row ``i`` of the
        batch lives in cache slot ``slots[i]`` (``None``: slot ``i``), its
        fresh rows land at ``positions[i] + t`` and the rope tables span
        ``cache.max_len`` rows. ``context_encode=True`` asserts positions
        == 0 and attends the fresh block only (bucket-causal, the training
        model's :func:`..models.llama.core_attention`); otherwise the first
        ``kv_limit`` rows of each slot are read (all of them for None).

        Paged: row ``i``'s logical position ``p`` lives at pool row
        ``block_tables[i, p // bs] * bs + p % bs``;
        ``kv_limit`` bounds the logical rows attention reads, and the caller
        guarantees ``position + T <= kv_limit``. ``slots`` is ignored: the
        table is the indirection. A quantized cache's layer slices travel as
        (payload, scale) pairs, and its pools are written in place too.

        ``row_live`` (b,) int32 (the kernel path only): lane ``i``'s fresh
        rows ``>= row_live[i]`` are packing padding whose outputs the
        caller discards, and the kernel stops the lane's walk at its live
        frontier (:func:`..kernels.paged_attention.paged_flash_decode`).
        The gather path ignores it, as in the JAX package: the
        block-causal mask already governs every live row.

        ``tree`` = ``(depths, ancestors)`` (:func:`..inference.speculative.
        tree_topology`, per lane (b, T) / (b, T, T), or one tree (T,) /
        (T, T) for every lane) makes the fresh block a packed candidate
        tree: node ``j`` is written at row ``position + j`` but roped at
        ``position + depths[j]``, and attends the committed prefix plus its
        own ancestors. The kernel takes the ancestors as ``tree_bits``
        (t <= 32), the gather as a mask."""
        quantized = getattr(cache, "k_scale", None) is not None
        if quantized and block_tables is None:
            raise ValueError(
                "quantized KV storage is paged-only: the dense slot cache "
                "has no scale arrays (use block_tables / PagedServingEngine)"
            )
        if context_encode and tree is not None:
            raise ValueError(
                "tree verification runs through the cache-attention path; "
                "context_encode=True would silently ignore the ancestor mask"
            )
        b, t = tokens.shape
        positions = positions.to(torch.int32)
        write_rows = positions[:, None] + torch.arange(
            t, dtype=torch.int32, device=positions.device
        )[None, :]
        tree_bits = None
        if tree is None:
            pos_block = write_rows
        else:
            depths, ancestors = tree
            if ancestors.dim() == 2:
                depths = depths[None].expand(b, t)
                ancestors = ancestors[None].expand(b, t, t)
            tree = (depths, ancestors)
            pos_block = positions[:, None] + depths.to(torch.int32)
            if block_tables is not None and self._paged_kernel_eligible(t, tree):
                tree_bits = tree_bits_of(ancestors)
        if block_tables is None:
            if slots is None:
                slots = torch.arange(b, device=tokens.device)
            slots = slots.long()
            rope_len = cache.max_len
        else:
            # paged: logical capacity is the table width (write positions can
            # reach the bucket-padding overflow region past max_seq_len)
            rope_len = block_tables.shape[1] * cache.block_size
        sin, cos = self._rope_tables(params, rope_len, tokens.device)

        x = params.embed(tokens)
        for i, layer in enumerate(params.layers):
            kc, vc = cache.k[i], cache.v[i]
            if quantized:
                kc, vc = (kc, cache.k_scale[i]), (vc, cache.v_scale[i])
            x = self._decode_layer(
                layer, x, kc, vc, sin, cos, pos_block, write_rows,
                positions, context_encode=context_encode, kv_limit=kv_limit,
                block_tables=block_tables, row_live=row_live, tree=tree,
                tree_bits=tree_bits, slots=slots,
            )
        x = params.final_norm(x)
        if return_hidden:
            return x, cache
        return params._logits(x), cache

    def _decode_layer(
        self, layer: LlamaDecoderLayer, x, kc, vc, sin, cos, pos_block,
        write_rows, positions, *, context_encode: bool, kv_limit=None,
        block_tables=None, row_live=None, tree=None, tree_bits=None, slots=None,
    ) -> torch.Tensor:
        """One decoder layer with cache write and read. kc/vc: this layer's
        (B, S_max, NKV, D) dense slice (``block_tables`` None), or its
        (num_blocks, block_size, NKV, D) pool slice, or (payload, scale)
        pairs of a quantized pool; x: (b, T, H). Fresh K/V land at
        ``write_rows``, roped at ``pos_block`` (the two differ for a tree)."""
        h = layer.attn_norm(x)
        att = self._attention(
            layer, h, kc, vc, sin, cos, pos_block, write_rows, positions,
            context_encode=context_encode, kv_limit=kv_limit, block_tables=block_tables,
            row_live=row_live, tree=tree, tree_bits=tree_bits, slots=slots,
        )
        x = x + att
        return x + self._mlp_block(layer, layer.mlp_norm(x))

    def _attention(
        self, layer, h, kc, vc, sin, cos, pos_block, write_rows, positions, *,
        context_encode: bool, kv_limit=None, block_tables=None, row_live=None, tree=None,
        tree_bits=None, slots=None,
    ) -> torch.Tensor:
        """The layer's attention block on the normed ``h`` (b, T, H), with
        the cache write and read, through the o projection."""
        c = self.config
        b, t, _ = h.shape
        q, k, v = layer.attn.project_qkv(h)
        q = layer.attn.rope(q, sin, cos, pos_block)
        k = layer.attn.rope(k, sin, cos, pos_block)
        if block_tables is None:
            att = self._attend_dense(
                q, k, v, kc, vc, slots, write_rows, pos_block, positions,
                context_encode=context_encode, kv_limit=kv_limit, tree=tree,
            )
        else:
            att = self._attend_paged(
                q, k, v, kc, vc, block_tables, write_rows, pos_block, positions,
                context_encode=context_encode, kv_limit=kv_limit, row_live=row_live,
                tree=tree, tree_bits=tree_bits,
            )
        return layer.attn.o(att.reshape(b, t, layer.attn.n_heads * c.head_dim))

    def _mlp_block(self, layer, h: torch.Tensor) -> torch.Tensor:
        """The layer's feed-forward block on the normed hidden states."""
        return layer.mlp(h)

    def _attend_dense(
        self, q, k, v, kc, vc, slots, write_rows, pos_block, positions,
        *, context_encode: bool, kv_limit=None, tree=None,
    ) -> torch.Tensor:
        """Dense cache write + attention (JAX ``_attend_with_cache``'s dense
        branch): the fresh K/V, cast to the cache's dtype, land at ``(slots,
        write_rows)`` of this layer's (B, S_max, NKV, D) slices in place, so
        a captured graph holds the cache's address. Then the bucket-causal
        attention over the fresh block (``context_encode``), or the first
        ``kv_limit`` rows of the batch's slots through
        :meth:`_cache_attention` (its ancestor mask for a ``tree``).

        A row at or past ``S_max`` is dropped, as JAX's scatter drops it:
        out-of-range indices would be a device-side assert on the card. Its
        write is sent to row 0 of its slot with the value already there;
        such a row exists only when the block starts past row 0 (a block is
        never longer than the cache), so no live write shares that row. A
        prefill starts at row 0 and never needs it. Returns att (b, T, N,
        D)."""
        b, t = write_rows.shape
        s_max = kc.shape[1]
        rows = write_rows.long()
        sl = slots[:, None].expand(b, t)
        kw, vw = k.to(kc.dtype), v.to(vc.dtype)
        if not context_encode:
            valid = (rows < s_max)[..., None, None]
            rows = torch.where(rows < s_max, rows, torch.zeros_like(rows))
            kw = torch.where(valid, kw, kc[sl, rows])
            vw = torch.where(valid, vw, vc[sl, rows])
        kc.index_put_((sl, rows), kw)
        vc.index_put_((sl, rows), vw)
        if context_encode:
            self.attention_paths["context"] += 1
            return core_attention(q, k, v, causal=True)
        self.attention_paths["dense"] += 1
        kr = kc if kv_limit is None else kc[:, :kv_limit]
        vr = vc if kv_limit is None else vc[:, :kv_limit]
        k_all = kr.index_select(0, slots).to(q.dtype)  # (b, S<=max, NKV, D)
        v_all = vr.index_select(0, slots).to(q.dtype)
        return self._cache_attention(q, k_all, v_all, pos_block, positions, tree)

    def _attend_paged(
        self, q, k, v, kc, vc, block_tables, write_rows, pos_block, positions,
        *, context_encode: bool, kv_limit=None, row_live=None, tree=None,
        tree_bits=None,
    ) -> torch.Tensor:
        """Paged cache write + attention: the block table translates logical
        sequence rows to pool rows for both the fresh-block write and the
        attention read. Garbage rows (stale blocks, null-block padding) are
        removed by the ``j <= position + t`` mask (a tree's ancestor mask)
        on every path. kc/vc are (payload, scale) pairs for a quantized
        pool; ``tree_bits`` is ``tree``'s ancestor matrix packed for the
        kernel, set when the kernel takes the call. Returns att (b, T, N,
        D)."""
        quantized = isinstance(kc, tuple)
        ksc = vsc = None
        if quantized:
            kc, ksc = kc
            vc, vsc = vc
        nb, bs = kc.shape[0], kc.shape[1]
        kflat = kc.view((nb * bs,) + kc.shape[2:])
        vflat = vc.view((nb * bs,) + vc.shape[2:])
        # rows past the allocated frontier map to the null block (id 0), and
        # so do a garbage lane's rows past the table (see the module note)
        tables = block_tables.long()
        wr_phys = _pool_rows(tables, write_rows, bs).reshape(-1)

        def write(pool, rows):  # rows (b, t, ...) land at the wr_phys rows
            _bytes(pool).index_copy_(0, wr_phys, _bytes(rows.reshape((-1,) + rows.shape[2:])))

        # in place: the JAX package donates the pool and scatters into a new
        # one; here the fresh rows are written straight into the pool tensors
        if quantized:
            ksflat = ksc.view(nb * bs, -1)
            vsflat = vsc.view(nb * bs, -1)
            # quantize on write: payload and scale of a row land together,
            # so an overwrite replaces both
            kq, ks = kv_quantize(k, kflat.dtype)  # (b,t,NKV,D) / (b,t,NKV)
            vq, vs = kv_quantize(v, vflat.dtype)
            write(kflat, kq)
            write(vflat, vq)
            write(ksflat, ks)
            write(vsflat, vs)
            # the fresh block the prefill softmax consumes is the same
            # round trip a later chunk reads back from the pool
            k = kv_dequantize(kq, ks, q.dtype)
            v = kv_dequantize(vq, vs, q.dtype)
        else:
            write(kflat, k.to(kflat.dtype))
            write(vflat, v.to(vflat.dtype))

        if context_encode:
            self.attention_paths["context"] += 1
            return core_attention(q, k, v, causal=True)
        limit = kv_limit if kv_limit is not None else block_tables.shape[1] * bs
        if self._paged_kernel_eligible(q.shape[1], tree):
            # gather-free read: the kernel walks the block table itself, so
            # the (b, limit, NKV, D) K/V copy below never materializes; a
            # tree's branches share its one read of each block
            self.attention_paths["kernel"] += 1
            kw = dict(kv_limit=limit, k_scale=ksc, v_scale=vsc,
                      quant_mxu=self.config.quant_mxu and quantized,
                      row_live=row_live, tree_bits=tree_bits)
            if self.tp > 1:
                # each rank's K4 on its own heads; o's all-reduce follows
                c = self.config
                return paged_flash_decode_tp(
                    q, kc, vc, block_tables, positions, num_heads=c.num_heads,
                    num_kv_heads=c.num_kv_heads, tp_size=self.tp, **kw)
            return paged_flash_decode(q, kc, vc, block_tables, positions, **kw)
        self.attention_paths["gather"] += 1
        jlog = torch.arange(limit, device=q.device)
        rd_phys = tables[:, jlog // bs] * bs + (jlog % bs)[None, :]
        if quantized:
            # dequantized outside any kernel, by the formula the kernel
            # applies to each block it reads
            k_all = kv_dequantize(kflat[rd_phys], ksflat[rd_phys], q.dtype)
            v_all = kv_dequantize(vflat[rd_phys], vsflat[rd_phys], q.dtype)
        else:
            k_all = kflat[rd_phys].to(q.dtype)  # (b, limit, NKV, D)
            v_all = vflat[rd_phys].to(q.dtype)
        return self._cache_attention(q, k_all, v_all, pos_block, positions, tree)

    @torch.no_grad()
    def decode_step(
        self,
        params: LlamaForCausalLM,
        cache: PagedKVCache,
        tokens: torch.Tensor,        # (b,) int — last sampled token per lane
        positions: torch.Tensor,     # (b,) int32 — write row per lane
        block_tables: torch.Tensor,  # (b, W) int32
        *,
        kv_limit: Optional[int] = None,
        pos_cap: Optional[int] = None,
        sampling: Optional[tuple] = None,
        logit_poison: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """One resident-state decode step: T=1 paged forward plus the state
        advance. Returns ``(logits (b, V), new_positions, cache)`` with
        ``new_positions = positions + 1``, clamped to ``pos_cap``: idle
        lanes keep stepping with all-null tables, and the cap keeps a
        long-idle lane's position inside the rope table.

        ``sampling`` (on-device sampling) is a ``(rng_data (b, 2),
        temperature (b,), top_k (b,), top_p (b,))`` tuple of per-lane
        tensors: the first return is then the sampled int32 tokens, drawn
        by :func:`..inference.sampling.sample_lanes` with each lane's key
        folded by the landing index ``positions + 1`` (before the cap,
        which binds only on garbage lanes). ``logit_poison`` (b,) int32
        makes it the checked step: :meth:`finite_logit_check` runs on the
        logits before sampling, and a ``finite`` (b,) bool follows the
        first return: ``(out, finite, new_positions, cache)``."""
        logits, cache = self.forward(
            params, cache, tokens[:, None], positions, None,
            block_tables=block_tables, kv_limit=kv_limit,
        )
        new_positions = positions + 1
        if pos_cap is not None:
            new_positions = torch.clamp(new_positions, max=pos_cap)
        out = logits[:, 0, :]
        finite = None
        if logit_poison is not None:
            out, finite = self.finite_logit_check(out, logit_poison)
        if sampling is not None:
            out = _sample_at(out, sampling, positions + 1)
        if finite is not None:
            return out, finite, new_positions, cache
        return out, new_positions, cache

    @staticmethod
    def finite_logit_check(
        logits: torch.Tensor, poison_mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The per-lane logit health check of the serving engine's checked
        programs: returns ``(logits, finite (b,) bool)``, ``finite[i]``
        being the on-device ``isfinite`` reduction over lane i's logits, so
        one bool a lane rides the token readback. ``poison_mask`` (b,)
        int32 is the fault injector's hook: a lane with a nonzero mask has
        its logits overwritten with NaN before the check (and before
        sampling or the accept rule), so an injected fault takes the path a
        genuine numerical blow-up takes."""
        if poison_mask is not None:
            bad = (poison_mask > 0).reshape(poison_mask.shape + (1,) * (logits.ndim - 1))
            logits = torch.where(bad, torch.full_like(logits, float("nan")), logits)
        finite = torch.isfinite(logits).flatten(1).all(dim=1)
        return logits, finite

    @torch.no_grad()
    def verify_step(
        self,
        params: LlamaForCausalLM,
        cache: PagedKVCache,
        tokens: torch.Tensor,        # (b, k+1) int — [cur, d_0 .. d_{k-1}]
        positions: torch.Tensor,     # (b,) int32 — cur's write row per lane
        block_tables: torch.Tensor,  # (b, W) int32
        draft_len: torch.Tensor,     # (b,) int32 — valid drafts per lane, <= k
        *,
        kv_limit: Optional[int] = None,
        pos_cap: Optional[int] = None,
        logit_poison: Optional[torch.Tensor] = None,
        sampling: Optional[tuple] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """One speculative verify step, the greedy multi-token sibling of
        :meth:`decode_step`: the block ``[cur, d_0 .. d_{k-1}]`` is scored
        in one block-causal forward (K/V written at rows ``positions ..
        positions + k``), the longest draft prefix agreeing with the
        target's argmax is accepted on the device, capped per lane by
        ``draft_len`` (a lane with no drafts takes a plain decode step),
        and the resident state advances with no host round trip.

        Returns ``(emitted (b, k+1), accept (b,), new_tokens (b,),
        new_positions (b,), cache)``: ``emitted[i, :accept[i] + 1]`` are
        the tokens lane ``i`` commits, ``new_tokens[i] = emitted[i,
        accept[i]]`` its new resident token and ``new_positions =
        positions + accept + 1`` (clamped to ``pos_cap``) its write row.
        Rejected rows need no rollback: the next step overwrites them
        before any mask admits them. With ``sampling`` (the tuple of
        :meth:`decode_step`) the targets are the draws the lane WOULD make
        at rows ``positions + j + 1``, keyed by that landing index, so the
        accept comparison replays the sequential sampled stream.
        ``logit_poison`` (b,) int32 runs :meth:`finite_logit_check` before
        the accept rule, and the return grows a ``finite`` (b,) bool before
        the cache: ``(emitted, accept, new_tokens, new_positions, finite,
        cache)``."""
        logits, cache = self.forward(
            params, cache, tokens, positions, None,
            block_tables=block_tables, kv_limit=kv_limit,
        )
        finite = None
        if logit_poison is not None:
            logits, finite = self.finite_logit_check(logits, logit_poison)
        # targets[i, j]: the target's argmax, or its draw, for row
        # positions[i] + j + 1
        if sampling is None:
            targets = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            ar = torch.arange(tokens.shape[1], dtype=positions.dtype, device=positions.device)
            targets = _sample_at(logits, sampling, positions[:, None] + 1 + ar)
        accept, emitted = accept_rule(tokens[:, 1:], targets, draft_len=draft_len)
        new_tokens = torch.gather(emitted, 1, accept[:, None].long())[:, 0]
        new_positions = positions + accept + 1
        if pos_cap is not None:
            new_positions = torch.clamp(new_positions, max=pos_cap)
        if finite is not None:
            return emitted, accept, new_tokens, new_positions, finite, cache
        return emitted, accept, new_tokens, new_positions, cache

    @torch.no_grad()
    def mixed_step(
        self,
        params: LlamaForCausalLM,
        cache: PagedKVCache,
        tokens: torch.Tensor,        # (b,) int — resident decode token per lane
        positions: torch.Tensor,     # (b,) int32 — resident write row per lane
        block_tables: torch.Tensor,  # (b, W) int32
        rows: torch.Tensor,          # (b, t) int32 — per-lane packed row payload
        row_start: torch.Tensor,     # (b,) int32 — forced rows' first write row
        row_len: torch.Tensor,       # (b,) int32 — live payload rows, <= t
        forced: torch.Tensor,        # (b,) int32 — 1 = prefill-chunk lane
        *,
        kv_limit: Optional[int] = None,
        pos_cap: Optional[int] = None,
        logit_poison: Optional[torch.Tensor] = None,
        sampling: Optional[tuple] = None,
        parents: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """One fused mixed-mode step: decode lanes, speculative-verify rows
        and prefill-chunk rows share one t-row block-causal forward over
        the paged pool. Per lane, ``forced`` selects the role:

        - ``forced == 0`` (decode/verify): the block is ``[tokens[i],
          rows[i, :t-1]]`` at rows ``positions[i] ..``; ``row_len`` is the
          draft count, so ``row_len == 0`` is a plain decode step and
          ``row_len == k`` exactly :meth:`verify_step` at width ``k + 1``.
        - ``forced == 1`` (prefill chunk): the block is the next
          ``row_len`` prompt tokens at rows ``row_start[i] ..`` over the
          lane's own table; the accept length is forced to ``row_len - 1``,
          so the emitted token is the target for row ``row_start +
          row_len``: on the final chunk, the request's first token.

        Rows past a lane's live width (``row_len`` forced, ``row_len + 1``
        otherwise) are padding: their outputs are never selected, and the
        next dispatch over the same rows rewrites them before any mask
        admits them. ``row_live`` carries the live widths to the kernel,
        which stops each lane's walk at its live frontier.

        ``parents`` (b, t) makes the verify rows packed trees
        (:meth:`tree_verify_step`): ``rows[:, :t-1]`` are draft nodes 1 ..
        t-1 of a tree rooted at the resident token, accepted along the
        deepest root-anchored path and moved to the frontier. Forced lanes
        ride the chain topology, whose ancestor mask is the block-causal
        mask and whose commit is the identity, so chunks are unchanged.

        Returns the :meth:`verify_step` tuple with ``new_positions =
        eff_pos + accept + 1`` (clamped to ``pos_cap``), ``eff_pos`` being
        ``row_start`` on forced lanes and ``positions`` otherwise. With
        ``sampling`` (the tuple of :meth:`decode_step`) row ``j``'s target
        is drawn at landing index ``eff_pos + 1 + j`` (``eff_pos + 1 +
        depth(j)`` on a tree), a forced lane's last row at ``row_start +
        row_len``, the suffix prefill's index. ``logit_poison`` composes
        as in :meth:`verify_step` (over every row of a lane, forced or
        not)."""
        t = rows.shape[1]
        is_forced = forced > 0
        eff_pos = torch.where(is_forced, row_start, positions)
        # decode/verify lanes score [resident token, drafts]; forced lanes
        # score the chunk payload verbatim
        block = torch.where(
            is_forced[:, None], rows,
            torch.cat([tokens[:, None].to(rows.dtype), rows[:, : t - 1]], dim=1),
        )
        live = torch.where(is_forced, row_len, row_len + 1)
        topo = eff_parents = None
        if parents is not None:
            chain = torch.clamp(
                torch.arange(t, dtype=parents.dtype, device=parents.device) - 1, min=0
            )
            eff_parents = torch.where(is_forced[:, None], chain[None, :], parents)
            topo = tree_topology(eff_parents)
        logits, cache = self.forward(
            params, cache, block, eff_pos, None,
            block_tables=block_tables, kv_limit=kv_limit, row_live=live, tree=topo,
        )
        finite = None
        if logit_poison is not None:
            logits, finite = self.finite_logit_check(logits, logit_poison)
        if sampling is None:
            targets = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            offsets = (
                torch.arange(t, dtype=eff_pos.dtype, device=eff_pos.device)[None, :]
                if topo is None else topo[0]
            )
            targets = _sample_at(logits, sampling, eff_pos[:, None] + 1 + offsets)
        # forced lanes carry draft_len 0 (linear) / node_len 1 (tree), so
        # the rule hands back their targets (the root's bonus) untouched;
        # their accept is then set to the chunk's last row, whose target is
        # keyed row_start + row_len, and on the tree path their emitted row
        # is restored to the raw targets that the accept indexes
        if topo is None:
            dl = torch.where(is_forced, torch.zeros_like(row_len), row_len)
            raw_accept, emitted = accept_rule(block[:, 1:], targets, draft_len=dl)
        else:
            node_len = torch.where(is_forced, torch.ones_like(row_len), row_len + 1)
            raw_accept, emitted, best = tree_accept_rule(
                block, targets, eff_parents, node_len=node_len, topology=topo,
            )
            emitted = torch.where(is_forced[:, None], targets, emitted)
            cache = self._tree_frontier_commit(
                cache, block_tables, eff_pos, topo[0], topo[1], best,
            )
        accept = torch.where(is_forced, torch.clamp(row_len - 1, min=0), raw_accept)
        new_tokens = torch.gather(emitted, 1, accept[:, None].long())[:, 0]
        new_positions = eff_pos + accept + 1
        if pos_cap is not None:
            new_positions = torch.clamp(new_positions, max=pos_cap)
        if finite is not None:
            return emitted, accept, new_tokens, new_positions, finite, cache
        return emitted, accept, new_tokens, new_positions, cache

    @torch.no_grad()
    def tree_verify_step(
        self,
        params: LlamaForCausalLM,
        cache: PagedKVCache,
        tokens: torch.Tensor,        # (b, t) int — [cur, node_1 .. node_{t-1}]
        positions: torch.Tensor,     # (b,) int32 — cur's write row per lane
        block_tables: torch.Tensor,  # (b, W) int32
        parents: torch.Tensor,       # (b, t) int — parents[j] < j, node space
        node_len: torch.Tensor,      # (b,) int — live nodes incl. the root, <= t
        *,
        kv_limit: Optional[int] = None,
        pos_cap: Optional[int] = None,
        logit_poison: Optional[torch.Tensor] = None,
        sampling: Optional[tuple] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """One tree verify step, the branching sibling of
        :meth:`verify_step`. The packed candidate tree ``tokens`` (node 0
        the resident token, parents before children) is scored in one
        ancestor-masked forward: node ``j`` writes K/V at row ``positions +
        j``, is roped at ``positions + depth(j)`` and sees the committed
        prefix plus its own root-to-self chain. The deepest accepted
        root-anchored path is then chosen on the device
        (:func:`..inference.speculative.tree_accept_rule`) and its K/V rows
        moved to the lane's frontier rows (:meth:`_tree_frontier_commit`).
        On a chain (``parents[j] == j - 1``) the step is :meth:`verify_step`.
        ``node_len`` caps acceptance per lane (``<= 1``: a plain decode
        step).

        Returns the :meth:`verify_step` tuple ``(emitted (b, t), accept
        (b,), new_tokens (b,), new_positions (b,), cache)``. With
        ``sampling`` (the tuple of :meth:`decode_step`) node ``j``'s target
        is the draw at its child's landing index ``positions + 1 +
        depth(j)``, the draw the sequential sampled decode of the accepted
        path makes. ``logit_poison`` composes as in :meth:`verify_step`."""
        depths, ancestors = tree_topology(parents)
        logits, cache = self.forward(
            params, cache, tokens, positions, None,
            block_tables=block_tables, kv_limit=kv_limit, tree=(depths, ancestors),
        )
        finite = None
        if logit_poison is not None:
            logits, finite = self.finite_logit_check(logits, logit_poison)
        if sampling is None:
            targets = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            targets = _sample_at(logits, sampling, positions[:, None] + 1 + depths)
        accept, emitted, best = tree_accept_rule(
            tokens, targets, parents, node_len=node_len, topology=(depths, ancestors),
        )
        cache = self._tree_frontier_commit(
            cache, block_tables, positions, depths, ancestors, best,
        )
        new_tokens = torch.gather(emitted, 1, accept[:, None].long())[:, 0]
        new_positions = positions + accept + 1
        if pos_cap is not None:
            new_positions = torch.clamp(new_positions, max=pos_cap)
        if finite is not None:
            return emitted, accept, new_tokens, new_positions, finite, cache
        return emitted, accept, new_tokens, new_positions, cache

    def _tree_frontier_commit(
        self, cache: PagedKVCache, block_tables, positions, depths, ancestors, best,
    ) -> PagedKVCache:
        """Move the accepted root-to-``best`` path's K/V rows to the lane's
        frontier. A packed tree writes node ``j`` at row ``positions + j``;
        the committed history must sit at rows ``positions + 1 ..
        positions + accept``. Depth ``d``'s destination row ``positions +
        d`` takes the path's node at depth ``d``, or itself where the path
        has none (past the accepted depth, or ``best == 0``), so every lane
        takes the same uniform move. Every source row is gathered before
        the one scatter, so overlapping rows move their pre-commit values.
        In place; a quantized pool's scales move with their payload (byte
        views: torch has no fp8 indexing kernels). Only rows inside each
        lane's own allocated blocks move; garbage lanes' rows land in the
        null block."""
        t = depths.shape[1]
        if t <= 1:
            return cache
        b = depths.shape[0]
        dev = depths.device
        path = torch.gather(
            ancestors, 1, best.long()[:, None, None].expand(b, 1, t)
        )[:, 0]                                                     # (b, t)
        dd = torch.arange(1, t, dtype=depths.dtype, device=dev)     # (t-1,)
        dsel = path[:, None, :] & (depths[:, None, :] == dd[None, :, None])
        node = (dsel * torch.arange(t, device=dev)).sum(dim=-1)     # (b, t-1)
        src = torch.where(dsel.any(dim=-1), node, dd.long()[None, :])
        pos = positions.long()[:, None]
        bs = cache.block_size
        src_phys = _pool_rows(block_tables, pos + src, bs).reshape(-1)
        dst_phys = _pool_rows(block_tables, pos + dd.long()[None, :], bs).reshape(-1)
        pools = (cache.k, cache.v)
        if cache.quantized:
            pools += (cache.k_scale, cache.v_scale)
        for x in pools:
            flat = _bytes(x).view((x.shape[0], x.shape[1] * bs) + x.shape[3:])
            flat[:, dst_phys] = flat[:, src_phys]
        return cache

    def _paged_kernel_eligible(self, t: int, tree) -> bool:
        """Gate for the paged-decode kernel: the ``use_paged_kernel`` config
        opt-in and a fresh block of at most ``paged_kernel_max_t`` tokens —
        T == 1 token-gen, verify blocks (linear, or packed trees of at most
        32 nodes, whose ancestor masks ride in as ``tree_bits``) and short
        suffix prefills; longer blocks take the gather. Over several
        ranks (JAX's tp gate, ``:1106-1142``) the kernel needs a pure-tp
        mesh whose tp divides both head counts, each rank then running it
        on its own heads; a mesh with dp, or heads tp does not divide, takes
        the gather."""
        if not self.config.use_paged_kernel:
            return False
        if not 1 <= t <= self.config.paged_kernel_max_t:
            return False
        if tree is not None and t > 32:
            return False
        if (parallel_state.model_parallel_is_initialized()
                and parallel_state.get_parallel_state().world_size > 1):
            if not parallel_state.mesh_is_tp_only():
                return False
            tp = parallel_state.get_tensor_model_parallel_size()
            if self.config.num_kv_heads % tp or self.config.num_heads % tp:
                return False
        return True

    def paged_dispatch_path(self, t: int, tree=None) -> str:
        """``"kernel"`` when :meth:`_paged_kernel_eligible` admits the
        paged-decode kernel at fresh-block width ``t``, ``"gather"``
        otherwise."""
        return "kernel" if self._paged_kernel_eligible(t, tree) else "gather"

    def _cache_attention(
        self, q, k_all, v_all, pos_block, positions=None, tree=None,
    ) -> torch.Tensor:
        """q (b,T,N,D) against gathered cache rows (b,S,NKV,D) with the mask
        ``cache_index <= position + t`` (block-causal across the fresh
        block, full visibility of the committed prefix; garbage rows beyond
        the write frontier are masked out), or under ``tree`` the committed
        prefix ``cache_index < position`` plus each node's ancestors among
        rows ``position .. position + T - 1``. GQA runs as grouped einsums
        rather than a repeat of the cache."""
        b, t, n, d = q.shape
        s_max, nkv = k_all.shape[1], k_all.shape[2]
        g = n // nkv
        qg = q.reshape(b, t, nkv, g, d)
        scores = torch.einsum("bskd,btkgd->bkgts", k_all, qg) * (d ** -0.5)
        scores = scores.reshape(b, n, t, s_max).float()
        j = torch.arange(s_max, device=q.device)[None, None, :]
        if tree is None:
            mask = j <= pos_block[:, :, None]  # (b, T, S)
        else:
            u = j - positions.long()[:, None, None]                  # (b, 1, S)
            u_cl = u.clamp(0, t - 1).expand(b, t, s_max)
            in_tree = torch.gather(tree[1], 2, u_cl)                 # (b, T, S)
            mask = (u < 0) | ((u < t) & in_tree)
        scores = scores.masked_fill(~mask[:, None], -1e30)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        pg = probs.reshape(b, nkv, g, t, s_max)
        return torch.einsum("bkgts,bskd->btkgd", pg, v_all).reshape(b, t, n, d)


class MixtralDecode(LlamaDecode):
    """Decode-mode Mixtral / DBRX over the weights of a
    :class:`..models.mixtral.MixtralForCausalLM` (module docstring). The
    training config's capacity factor is ignored: decode never drops a
    token. Expert parallelism is refused, as in JAX (the Mixtral inference
    of the reference is tp-only too)."""

    def __init__(self, config) -> None:
        super().__init__(config)
        #: per decoder-layer call: "selective" or "all_experts"
        self.moe_paths: collections.Counter = collections.Counter()

    def _mlp_block(self, layer, h: torch.Tensor) -> torch.Tensor:
        if parallel_state.expert_parallel_size_or(1) > 1:
            raise NotImplementedError(
                "MixtralDecode does not support expert parallelism: decode "
                "under an ep>1 mesh would allgather every EP-sharded expert "
                "weight per token. Serve MoE models with tp/dp sharding."
            )
        moe = layer.moe
        b, t, hdim = h.shape
        x = h.reshape(b * t, hdim)
        _, gates, idx = moe.route(x)
        k = idx.shape[1]
        ex = moe.experts
        if b * t * k <= ex.num_experts:
            self.moe_paths["selective"] += 1
            y = ex.forward_selective(x, gates, idx)
        else:
            self.moe_paths["all_experts"] += 1
            y = ex.forward_all_experts(x, gates, idx)
        return y.reshape(b, t, hdim)


class GPTNeoXDecode(LlamaDecode):
    """Decode-mode GPT-NeoX / Pythia / CodeGen over the weights of a
    :class:`..models.gptneox.GPTNeoXForCausalLM` (JAX ``GPTNeoXDecode``
    :1248): the same caches and attention paths (K4 under
    ``use_paged_kernel``) under the family's block, parallel or sequential
    residual with its LayerNorms and biases (the layer's own ``block``),
    and partial rotary in either convention (the attention's ``rope`` over
    the model's ``rotary_dims``-wide tables)."""

    def _decode_layer(self, layer, x, kc, vc, sin, cos, pos_block, write_rows, positions,
                      **kw) -> torch.Tensor:
        h1 = layer.attn_norm(x)
        att = self._attention(layer, h1, kc, vc, sin, cos, pos_block, write_rows, positions,
                              **kw)
        return layer.block(x, h1, att)


def decode_model_for(config) -> LlamaDecode:
    """The decode model of a config (JAX ``decode_model_for`` :1311):
    :class:`MixtralDecode` for the MoE families (Mixtral, DBRX),
    :class:`GPTNeoXDecode` for GPT-NeoX / CodeGen, :class:`LlamaDecode` for
    Llama. BERT has no KV-cache decode."""
    from neuronx_distributed_llama3_2_tpu_torch.models.gptneox import GPTNeoXConfig
    from neuronx_distributed_llama3_2_tpu_torch.models.mixtral import MixtralConfig

    if not isinstance(config, LlamaConfig):
        raise NotImplementedError(
            "BERT is a bidirectional encoder — there is no KV-cache decode; "
            "use BertForPreTraining's forward directly"
        )
    if isinstance(config, GPTNeoXConfig):
        return GPTNeoXDecode(config)
    if isinstance(config, MixtralConfig):
        return MixtralDecode(config)
    return LlamaDecode(config)
