"""Serving bucket ladders and the catalog manifest of the serving programs.

Counterpart of ``neuronx_distributed_llama3_2_tpu/serving/catalog.py``:
the ladder helpers (``default_buckets``, ``pick_bucket``,
``complete_ladder``), :class:`BucketLadder`, :class:`CatalogManifest`,
:func:`validate_ladder` and the key rendering (``format_key``). A
:class:`BucketLadder` declares every shape the engine pads a dispatch
into; a :class:`CatalogManifest` expands it into the exact key set of the
engine's program registry. The keys keep the JAX package's tuple layout,
so that their lines are the JAX package's for the same configuration
(under on-device sampling the sampling slot is the ``"lane"`` sentinel,
as there). The decode-time keys' checked bit is the engine's
``_check_logits`` (``PagedConfig.detect_nonfinite``, or a fault plan that
can fire ``nan``), as there: an engine holds only checked or only
unchecked decode-time programs. ``PagedConfig.spill_enabled`` adds the
tiered KV storage's ``("block_save", quantized)`` and ``("block_restore",
quantized)`` keys, as there. ``PagedConfig.degrade_after_faults`` (the
degradation ladder armed) adds the kernel-shed rung's gather twin of
every prefill and decode-time key to the legal universe
(:meth:`CatalogManifest.keys`), as there; ``prewarm`` captures none of
them (:meth:`CatalogManifest.graph_keys` is gather-free, as the JAX
package's ``prewarm_keys`` is): the rung captures each twin at its first
use.

Where the JAX package compiles every key, ``PagedConfig.prewarm`` here
captures the program kinds (:data:`GRAPH_KINDS`: the prefills ``pctx`` /
``psfx`` and the decode-time ``pdecode``, ``pverify``, ``ptree``,
``pmixed``) as CUDA graphs before traffic; the in-place state writes
(``copy_block``, ``lane_set``, ``table_delta``, and the spill tier's
``block_save`` / ``block_restore``) stay eager calls.
``nearest_key`` and the golden catalog file, which serve the JAX
package's static analyzers, are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, FrozenSet, List, Sequence, Tuple

__all__ = [
    "GRAPH_KINDS",
    "BucketLadder",
    "CatalogManifest",
    "complete_ladder",
    "default_buckets",
    "format_key",
    "pick_bucket",
    "validate_ladder",
]

#: the catalog kinds that prewarm captures as CUDA graphs; every other
#: kind (the in-place state writes) runs as an eager call
GRAPH_KINDS = frozenset({"pctx", "psfx", "pdecode", "pverify", "ptree", "pmixed"})


def default_buckets(max_seq_len: int, min_bucket: int = 128) -> List[int]:
    """Powers-of-2 bucket ladder up to max_seq_len (reference
    autobucketing.py:6 generate_buckets)."""
    buckets = []
    b = min_bucket
    while b < max_seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq_len)
    return buckets


def pick_bucket(buckets: Sequence[int], length: int) -> int:
    """Smallest bucket >= length (reference context-encode
    bucket-from-extent, autobucketing.py:62-124)."""
    for b in buckets:
        if b >= length:
            return b
    raise ValueError(f"length {length} exceeds largest bucket {buckets[-1]}")


def complete_ladder(buckets: Sequence[int], max_seq_len: int) -> List[int]:
    """Validated ascending ladder with ``max_seq_len`` appended when the
    declared rungs top out early — every serving dispatch length
    <= max_seq_len must route to SOME rung (the dense engine's
    ``_kv_bucket`` has the same clamp-to-full-cache fallback)."""
    out = [int(b) for b in buckets]
    if not out:
        raise ValueError("bucket ladder must not be empty")
    if any(b < 1 for b in out):
        raise ValueError(f"bucket ladder entries must be positive: {out}")
    if out != sorted(set(out)):
        raise ValueError(f"bucket ladder must be strictly ascending: {out}")
    if out[-1] > max_seq_len:
        raise ValueError(
            f"largest bucket {out[-1]} exceeds max_seq_len {max_seq_len}"
        )
    if out[-1] < max_seq_len:
        out.append(max_seq_len)
    return out


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """The declared shape ladder every serving dispatch pads into.

    ``prefill_buckets`` are padded prompt/chunk token counts (pctx/psfx
    programs), ``kv_buckets`` the kv_limit attention extents
    (psfx/pdecode/pverify), ``verify_t`` the speculative draft widths
    (one per configured ``spec_draft_tokens`` — the verify program's T is
    ``k + 1``). ``decode_batch`` is the fixed lane count B every batched
    program is traced at. Both bucket ladders end at ``max_seq_len``
    (see :func:`complete_ladder`)."""

    decode_batch: int
    max_seq_len: int
    prefill_buckets: Tuple[int, ...]
    kv_buckets: Tuple[int, ...]
    verify_t: Tuple[int, ...] = ()
    # fused-step row-width rungs (PagedConfig.fused_step): each rung is
    # the fixed query-row count T of a pmixed program packing
    # prefill-chunk, verify and decode rows into one grid — one rung per
    # engine today (max(prefill_chunk_tokens or 8, spec_k + 1))
    mixed_t: Tuple[int, ...] = ()

    def kv_bucket(self, needed: int) -> int:
        """Smallest kv rung covering ``needed`` rows, clamped to the full
        cache past the ladder top."""
        for b in self.kv_buckets:
            if b >= needed:
                return b
        return self.kv_buckets[-1]

    def prefill_bucket(self, length: int) -> int:
        return pick_bucket(self.prefill_buckets, max(length, 1))

    def suffix_pairs(self) -> List[Tuple[int, int]]:
        """Legal (prefill bucket, kv_limit) pairs for suffix prefill: a
        psfx dispatch at bucket ``b`` carries
        ``kv_limit = kv_bucket(min(cached + b, max_seq_len))`` with
        ``cached >= 1`` (cached == 0 routes to pctx), so exactly the kv
        rungs >= ``kv_bucket(min(1 + b, max_seq_len))`` are reachable."""
        out = []
        for b in self.prefill_buckets:
            lo = self.kv_bucket(min(1 + b, self.max_seq_len))
            out.extend((b, kv) for kv in self.kv_buckets if kv >= lo)
        return out


@dataclasses.dataclass(frozen=True)
class CatalogManifest:
    """Ladder × variant-flag expansion into the exact legal key set of
    the engine's ``_programs`` registry. ``gather_variants`` admits the
    degradation ladder's kernel-shed twins (gather bit True) as legal keys
    without capturing them: :meth:`prewarm_keys` and :meth:`graph_keys`
    are the gather-free subset. The decode-time keys' checked bit is
    ``checked`` (see the module docstring)."""

    ladder: BucketLadder
    # SamplingConfig (frozen/hashable — rides inside keys), or "lane"
    # under on-device sampling
    sampling: Any
    quantized: bool = False
    # the engine's fixed _check_logits bit: the checked (finite-verified)
    # decode-time programs replace the unchecked ones
    checked: bool = False
    # PagedConfig.degrade_after_faults: the kernel-shed rung's gather twins
    # are legal keys (captured at first use, never by prewarm)
    gather_variants: bool = False
    # PagedConfig.fused_step: prefill suffixes ride the pmixed grid, so
    # the psfx keys leave the universe entirely and the mixed_t × kv
    # ladder replaces the psfx suffix-pair product
    fused_step: bool = False
    # PagedConfig.spill_enabled: the host spill tier adds the block_save /
    # block_restore state writes to the universe (and only then)
    spill: bool = False
    # PagedConfig.spec_tree: verify rungs become ptree keys (packed-tree
    # ancestor-masked verify) instead of pverify — same kv × k product,
    # so the manifest stays exactly as bounded as linear speculation's
    spec_tree: bool = False

    @classmethod
    def from_engine(cls, engine: Any) -> "CatalogManifest":
        """Derive the manifest a :class:`PagedServingEngine` (duck-typed)
        declares: its serving ladders, sampling config, quantization,
        checked bit, whether the degradation ladder may mint gather twins,
        fused step, spill tier and tree speculation."""
        spec_k = int(getattr(engine, "_spec_k", 0) or 0)
        mixed_t = int(getattr(engine, "_mixed_t", 0) or 0)
        ladder = BucketLadder(
            decode_batch=engine.engine.max_batch,
            max_seq_len=engine.engine.max_seq_len,
            prefill_buckets=tuple(engine._prefill_buckets),
            kv_buckets=tuple(engine._kv_buckets),
            verify_t=(spec_k,) if spec_k else (),
            mixed_t=(mixed_t,) if mixed_t else (),
        )
        return cls(
            ladder=ladder,
            # on-device sampling replaces the static SamplingConfig slot
            # with the "lane" sentinel: the per-lane parameters are
            # runtime residents, so one program serves every config
            sampling=(
                "lane" if getattr(engine, "_fused", False) else engine.gen.sampling
            ),
            quantized=bool(getattr(engine, "_kv_quantized", False)),
            checked=bool(getattr(engine, "_check_logits", False)),
            gather_variants=bool(engine.paged.degrade_after_faults),
            fused_step=bool(getattr(engine, "_fused_step", False)),
            spill=bool(getattr(engine, "_spill", False)),
            spec_tree=bool(getattr(engine, "_spec_tree", False)),
        )

    def _expand(self, gathers: Tuple[bool, ...]) -> List[tuple]:
        lad, cfg, chk = self.ladder, self.sampling, self.checked
        keys: List[tuple] = [
            ("copy_block", self.quantized),
            ("lane_set",),
            ("table_delta",),
        ]
        if self.spill:
            keys.append(("block_save", self.quantized))
            keys.append(("block_restore", self.quantized))
        for g in gathers:
            for b in lad.prefill_buckets:
                keys.append(("pctx", b, cfg, g))
            if not self.fused_step:
                # fused mode NEVER dispatches a suffix prefill: cached > 0
                # admissions route to the pmixed grid, so the psfx
                # suffix-pair product leaves the universe entirely
                for b, kv in lad.suffix_pairs():
                    keys.append(("psfx", b, kv, cfg, g))
            for kv in lad.kv_buckets:
                keys.append(("pdecode", cfg, kv, g, chk))
            verify_kind = "ptree" if self.spec_tree else "pverify"
            for k in lad.verify_t:
                for kv in lad.kv_buckets:
                    keys.append((verify_kind, kv, k, g, chk))
            for t in lad.mixed_t:
                for kv in lad.kv_buckets:
                    keys.append(("pmixed", t, kv, cfg, g, chk))
        return keys

    def keys(self) -> FrozenSet[tuple]:
        """Every key the engine may legally hold (the gather twins included
        when the degradation ladder is armed)."""
        gathers = (False, True) if self.gather_variants else (False,)
        return frozenset(self._expand(gathers))

    def prewarm_keys(self) -> List[tuple]:
        """The gather-free manifest in the JAX package's deterministic
        compile order: the kernel-shed rung registers its gather twins at
        their first use."""
        return self._expand((False,))

    def graph_keys(self) -> List[tuple]:
        """The part of :meth:`prewarm_keys` that the port's ``prewarm``
        captures as CUDA graphs (:data:`GRAPH_KINDS`), in the same
        order."""
        return [k for k in self.prewarm_keys() if k[0] in GRAPH_KINDS]

    def lines(self) -> List[str]:
        """Sorted human/golden-file rendering of :meth:`keys`."""
        return sorted(format_key(k) for k in self.keys())

    def describe(self) -> str:
        lad = self.ladder
        kinds = {k[0] for k in self.graph_keys()}
        flags = [f for f, on in (
            ("quant", self.quantized), ("checked", self.checked),
            ("gather-variants", self.gather_variants), ("fused-step", self.fused_step),
            ("spill", self.spill), ("spec-tree", self.spec_tree),
        ) if on]
        return (
            f"B={lad.decode_batch} prefill={list(lad.prefill_buckets)} "
            f"kv={list(lad.kv_buckets)} verify_t={list(lad.verify_t)} "
            f"mixed_t={list(lad.mixed_t)} "
            f"cfg={_format_sampling(self.sampling)}"
            + (f" [{','.join(flags)}]" if flags else "")
            + f" -> {len(self.keys())} keys, {len(self.graph_keys())} "
            f"captured as CUDA graphs ({', '.join(sorted(kinds))}), the rest "
            "eager"
        )


def validate_ladder(model: Any, ladder: BucketLadder) -> List[str]:
    """Declaration-time warnings a prewarmed catalog should surface
    instead of discovering at first dispatch: a verify or mixed width past
    the paged CUDA kernel's bound (``paged_kernel_max_t``), whose every
    dispatch then pays the dense gather. Advisory (the gather paths are
    correct), returned as strings for the engine to log."""
    out = []
    path_of = getattr(model, "paged_dispatch_path", None)
    if path_of is None:
        return out
    for k in ladder.verify_t:
        if path_of(k + 1) != "kernel":
            out.append(
                f"verify_t={k} (T={k + 1}) exceeds the paged kernel's "
                "paged_kernel_max_t — every verify dispatch at this width takes "
                "the dense-gather path"
            )
    for t in ladder.mixed_t:
        if path_of(t) != "kernel":
            out.append(
                f"mixed_t={t} exceeds the paged kernel's paged_kernel_max_t — "
                "every fused mixed-mode dispatch takes the dense-gather "
                "path (shrink prefill_chunk_tokens / spec_draft_tokens)"
            )
    return out


# ---------------------------------------------------------------------------
# Key rendering
# ---------------------------------------------------------------------------


def _format_sampling(cfg: Any) -> str:
    """Compact, comma-free SamplingConfig rendering for key strings (the
    on-device sampling "lane" sentinel passes through verbatim)."""
    if isinstance(cfg, str):
        return cfg
    if getattr(cfg, "greedy", False):
        return "greedy"
    bits = [f"T{cfg.temperature:g}"]
    if getattr(cfg, "top_k", 0):
        bits.append(f"k{cfg.top_k}")
    if getattr(cfg, "top_p", 1.0) < 1.0:
        bits.append(f"p{cfg.top_p:g}")
    return "-".join(bits)


def format_key(key: tuple) -> str:
    """Stable one-line rendering of a ``_programs`` registry key —
    ``kind[field=value,...,gather,checked]``, the JAX package's lines
    for the same key."""
    kind = key[0]
    bits: List[str] = []
    gather = checked = False
    if kind == "pctx":
        _, b, cfg, gather = key
        bits = [f"bucket={b}", f"cfg={_format_sampling(cfg)}"]
    elif kind == "psfx":
        _, b, kv, cfg, gather = key
        bits = [f"bucket={b}", f"kv_limit={kv}", f"cfg={_format_sampling(cfg)}"]
    elif kind == "pdecode":
        _, cfg, kv, gather, checked = key
        bits = [f"kv_limit={kv}", f"cfg={_format_sampling(cfg)}"]
    elif kind in ("pverify", "ptree"):
        _, kv, k, gather, checked = key
        bits = [f"kv_limit={kv}", f"k={k}"]
    elif kind == "pmixed":
        _, t, kv, cfg, gather, checked = key
        bits = [f"t={t}", f"kv_limit={kv}", f"cfg={_format_sampling(cfg)}"]
    elif kind in ("copy_block", "block_save", "block_restore"):
        bits = [f"quantized={key[1]}"]
    else:  # lane_set / table_delta: render fields raw
        bits = [str(f) for f in key[1:]]
    if gather:
        bits.append("gather")
    if checked:
        bits.append("checked")
    return str(kind) + (f"[{','.join(bits)}]" if bits else "")
