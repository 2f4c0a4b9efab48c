"""Static device-cost accounting for the paged serving engine.

Counterpart of ``neuronx_distributed_llama3_2_tpu/serving/accounting.py``
(:data:`COMPUTE_KINDS`, :data:`MOVE_KINDS`, :class:`CostProfile`,
:class:`EngineDims`, :func:`analytic_cost`, :func:`analytic_profile`,
:func:`harvest_cost_profiles`, :func:`analytic_profiles`,
:class:`HBMLedger`, :func:`device_hbm_budget`, :func:`hbm_ledger`,
:func:`cost_table_lines`), a copy of its own in torch idiom. It answers
what the engine's programs cost:

- a per-program :class:`CostProfile` for every record of the engine's
  program registry: FLOPs and HBM bytes from the analytic formulas of
  :mod:`..flops` (the model's ``2·N + 4·L·H·K`` per token at each key's
  attention extent) and from the key alone;
- an :class:`HBMLedger` summing the KV pool (scales included), the
  parameters, the resident token / position / table tensors and the
  largest program output into a footprint and a headroom against the
  card's memory;
- :func:`analytic_profiles`, the same figures for every key of the
  catalog without a dispatch.

PyTorch has no counterpart of XLA's ``cost_analysis()``, so every profile
here is analytic: ``flops_source`` is ``"analytic"`` for the model
programs and ``"analytic-move"`` for the state writes, whose "flops" count
the elements moved. A captured record's output bytes are its graph
outputs' own. The peaks are the H100's (:mod:`..flops`), never a TPU's.

Everything is host arithmetic, run once at the end of ``prewarm`` (or on
demand through ``engine.ensure_cost_profiles()``); the per-dispatch fold
in the engine is a dict lookup and two float adds. No device work, no
upload.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from neuronx_distributed_llama3_2_tpu_torch import flops as flops_mod
from neuronx_distributed_llama3_2_tpu_torch.quantization.kv_cache import (
    kv_scale_itemsize,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.block_allocator import (
    kv_pool_bytes_per_rank,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.catalog import format_key

# program kinds that run model math (nonzero FLOPs); the others only move
# bytes and report their element traffic
COMPUTE_KINDS = frozenset({"pctx", "psfx", "pdecode", "pverify", "ptree", "pmixed"})
MOVE_KINDS = frozenset(
    {"copy_block", "lane_set", "table_delta", "block_save", "block_restore"}
)

# The rate the tiered-KV restore-vs-recompute crossover prices a
# restore's payload bytes at (PagedServingEngine._restore_price): the
# restore path's own cost, not the link's. A restore's bytes cross the
# link at 7-13 GB/s, but the path around them (the drain, the snapshot
# of each block its allocations evict, the uploads and in-place copies)
# is bound by the host. 1.57e9: the median of 16 unwatched restores of
# the 256-token prefix (16 blocks, 8 MiB) on the prewarmed async 1B
# serve, bytes over the admission's host-clock ms (spread 0.57-1.86
# GB/s; the eager serve's median 2.04), chip_smoke.py's spill phase and
# churn_serve(breakdown=True), NVIDIA H100 80GB HBM3, 700.00 W
HOST_LINK_BW_BYTES_PER_S = 1.57e9


@dataclasses.dataclass(frozen=True)
class CostProfile:
    """Static cost figures of one serving program.

    ``flops_source`` is ``"analytic"`` (the shared FLOP formula, the model
    programs) or ``"analytic-move"`` (the state writes, whose "flops"
    count elements moved, so that no profile is zero; the engine folds
    only :data:`COMPUTE_KINDS` into its dispatched FLOPs)."""

    key: tuple
    kind: str
    flops: float
    bytes_accessed: float
    argument_bytes: int
    output_bytes: int
    temp_bytes: int = 0
    flops_source: str = "analytic"

    @property
    def label(self) -> str:
        return format_key(self.key)

    def arithmetic_intensity(self) -> float:
        """FLOPs per byte accessed: the roofline x-coordinate."""
        return self.flops / max(self.bytes_accessed, 1.0)

    def roofline_mfu(
        self,
        peak_flops: float = flops_mod.H100_BF16_FLOPS_PER_S,
        peak_bw: float = flops_mod.H100_HBM_BYTES_PER_S,
    ) -> float:
        """The bandwidth roofline's ceiling on MFU at this program's
        arithmetic intensity: below the balance point the program is
        bandwidth-bound and reaches at most AI / balance of the peak."""
        balance = peak_flops / peak_bw
        return min(1.0, self.arithmetic_intensity() / balance)

    def to_dict(self) -> dict:
        return {
            "key": self.label,
            "kind": self.kind,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "flops_source": self.flops_source,
            "arithmetic_intensity": round(self.arithmetic_intensity(), 4),
            "roofline_mfu": round(self.roofline_mfu(), 6),
        }


@dataclasses.dataclass(frozen=True)
class EngineDims:
    """The model and pool dimensions the analytic estimators need,
    captured once per engine."""

    num_params: int
    param_bytes: int             # whole (unsharded) parameter bytes
    num_layers: int
    hidden_size: int
    num_kv_heads: int
    head_dim: int
    vocab_size: int
    max_batch: int
    table_width: int
    block_size: int
    num_blocks: int
    kv_bytes_per_elem: int
    scale_bytes: int             # per-(row, kv-head) scale bytes, 0 if bf16
    tp_size: int
    quant_mxu: bool = False      # the q.k dot in the payload's precision
    fused_sampling: bool = False  # per-lane sampling residents in lane_set

    @classmethod
    def from_engine(cls, engine: Any) -> "EngineDims":
        """The dimensions of a :class:`.engine.PagedServingEngine`: its
        weights' parameter tensors (counted once each), its model config,
        ladders and pool."""
        params = list(engine.engine.params.parameters())
        mc = engine.model.config
        return cls(
            num_params=sum(p.numel() for p in params),
            param_bytes=sum(p.numel() * p.dtype.itemsize for p in params),
            num_layers=mc.num_layers,
            hidden_size=mc.hidden_size,
            num_kv_heads=mc.num_kv_heads,
            head_dim=mc.head_dim,
            vocab_size=mc.vocab_size,
            max_batch=engine.engine.max_batch,
            table_width=engine.table_width,
            block_size=engine.paged.block_size,
            num_blocks=engine.paged.num_blocks,
            kv_bytes_per_elem=engine.cache.k.dtype.itemsize,
            scale_bytes=kv_scale_itemsize(engine.paged.kv_cache_dtype),
            tp_size=max(int(engine.metrics.tp_size), 1),
            quant_mxu=bool(getattr(mc, "quant_mxu", False)),
            fused_sampling=bool(getattr(engine, "_fused", False)),
        )

    @property
    def kv_heads_local(self) -> int:
        """KV heads resident per rank (the tp shard when it divides)."""
        if self.num_kv_heads % self.tp_size == 0:
            return max(self.num_kv_heads // self.tp_size, 1)
        return self.num_kv_heads

    @property
    def param_bytes_local(self) -> int:
        """Per-rank parameter bytes (a uniform tp shard)."""
        return self.param_bytes // self.tp_size

    def kv_row_bytes(self) -> int:
        """Bytes one KV row holds over all layers, K and V, the local
        heads, scales included when the pool is quantized."""
        per_head = self.head_dim * self.kv_bytes_per_elem + self.scale_bytes
        return 2 * self.num_layers * self.kv_heads_local * per_head


def _flops_per_token(dims: EngineDims, context: int, quant_mxu: bool = False) -> float:
    f = flops_mod.model_flops_per_token(
        dims.num_params, dims.num_layers, dims.hidden_size, max(context, 1)
    )
    if quant_mxu:
        # the q.k half of the attention term runs in the payload's
        # precision at twice the bf16 rate: charged at half its
        # bf16-equivalent cost, so MFU stays against the bf16 peak
        f -= dims.num_layers * dims.hidden_size * max(context, 1)
    return f


def analytic_cost(key: tuple, dims: EngineDims) -> Tuple[float, float, str]:
    """(flops, bytes_accessed, flops_source) of a registry or catalog key,
    from the key alone: the model programs by the per-token formula at the
    key's attention extent, the state writes by the elements they move
    (``analytic-move``), so that no profile is zero."""
    kind = key[0]
    if kind == "pctx":
        # causal prefill of a b-row bucket: row i attends i rows, so the
        # attention term integrates to b^2 / 2
        b = int(key[1])
        f = b * 2 * dims.num_params + 2 * dims.num_layers * dims.hidden_size * b * b
        rows = b
        tokens = b
    elif kind == "psfx":
        # suffix prefill: b rows each attending up to kv_limit rows
        b, kv = int(key[1]), int(key[2])
        f = b * _flops_per_token(dims, kv)
        rows = kv
        tokens = b
    elif kind == "pdecode":
        kv = int(key[2])
        f = dims.max_batch * _flops_per_token(dims, kv, dims.quant_mxu)
        rows = dims.max_batch * kv
        tokens = dims.max_batch
    elif kind in ("pverify", "ptree"):
        # a packed tree costs what a linear verify of the same width does:
        # B (k + 1) query rows over kv + k rows; the ancestor mask changes
        # which rows a query sees, not how many it streams
        kv, k = int(key[1]), int(key[2])
        f = dims.max_batch * (k + 1) * _flops_per_token(dims, kv + k, dims.quant_mxu)
        rows = dims.max_batch * (kv + k)
        tokens = dims.max_batch * (k + 1)
    elif kind == "pmixed":
        # B lanes x t query rows over the shared pool: the verify formula
        # at draft width t - 1
        t, kv = int(key[1]), int(key[2])
        f = dims.max_batch * t * _flops_per_token(dims, kv + t - 1, dims.quant_mxu)
        rows = dims.max_batch * (kv + t - 1)
        tokens = dims.max_batch * t
    elif kind == "copy_block":
        elems = 2 * dims.num_layers * dims.block_size * dims.kv_heads_local * dims.head_dim
        return float(elems), float(2 * elems * dims.kv_bytes_per_elem), "analytic-move"
    elif kind == "lane_set":
        # on-device sampling adds 5 per-lane resident elements: temperature,
        # top-k, top-p and the two words of the key data
        per_lane = 2 + dims.table_width + (5 if dims.fused_sampling else 0)
        elems = dims.max_batch * per_lane
        return float(elems), float(2 * elems * 4), "analytic-move"
    elif kind == "table_delta":
        elems = dims.max_batch * dims.table_width
        return 1.0, float(2 * elems * 4), "analytic-move"
    elif kind in ("block_save", "block_restore"):
        # tiered KV: one block's payload crossing the pool boundary, its
        # scale tiles with it under quantized storage; the bytes the
        # restore-vs-recompute crossover divides by the host link's rate
        elems = 2 * dims.num_layers * dims.block_size * dims.kv_heads_local * dims.head_dim
        byts = 2 * dims.block_size * dims.kv_row_bytes()
        return float(elems), float(byts), "analytic-move"
    else:
        return 1.0, 1.0, "analytic-move"
    # the parameters stream once, the touched KV rows once, and the logits
    # land in fp32
    byts = dims.param_bytes_local + rows * dims.kv_row_bytes() + tokens * dims.vocab_size * 4
    return float(f), float(byts), "analytic"


def analytic_profile(key: tuple, dims: EngineDims) -> CostProfile:
    """The :class:`CostProfile` of a key alone: a model program's
    arguments are the parameters and the whole pool, its outputs one
    int32 token a lane; a state write's are one block's rows."""
    f, b, src = analytic_cost(key, dims)
    kind = str(key[0])
    if kind in COMPUTE_KINDS:
        pool = kv_pool_bytes_per_rank(
            num_layers=dims.num_layers,
            num_blocks=dims.num_blocks,
            block_size=dims.block_size,
            num_kv_heads=dims.num_kv_heads,
            head_dim=dims.head_dim,
            dtype_bytes=dims.kv_bytes_per_elem,
            tp_size=dims.tp_size,
            scale_bytes=dims.scale_bytes,
        )
        arg = dims.param_bytes_local + pool
        out = dims.max_batch * 4
    else:
        arg = dims.block_size * dims.kv_row_bytes()
        out = arg
    return CostProfile(
        key=key, kind=kind, flops=f, bytes_accessed=b,
        argument_bytes=int(arg), output_bytes=int(out), flops_source=src,
    )


def profile_record(rec: Any, dims: EngineDims) -> CostProfile:
    """The :class:`CostProfile` of one registered
    :class:`.engine.ProgramRecord`: its key's analytic figures, and, where
    the record holds a captured graph, the graph outputs' own bytes as its
    outputs."""
    p = analytic_profile(rec.key, dims)
    if rec.graph is None:
        return p
    return dataclasses.replace(p, output_bytes=sum(int(t.nbytes) for t in rec.outputs))


def harvest_cost_profiles(engine: Any) -> Dict[tuple, CostProfile]:
    """A :class:`CostProfile` for every record of the engine's program
    registry (under prewarm, every captured key of its catalog)."""
    dims = EngineDims.from_engine(engine)
    return {key: profile_record(rec, dims) for key, rec in engine.program_registry().items()}


def analytic_profiles(engine: Any) -> Dict[tuple, CostProfile]:
    """The analytic profile of every key of the engine's catalog, in its
    prewarm order: no dispatch, no capture."""
    dims = EngineDims.from_engine(engine)
    return {key: analytic_profile(key, dims) for key in engine.catalog.prewarm_keys()}


# ---------------------------------------------------------------------------
# HBM ledger
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HBMLedger:
    """The serving engine's static device-memory footprint, summed from
    what its construction knows. ``headroom_bytes`` may go negative: the
    engine is over its budget."""

    budget_bytes: int
    param_bytes: int             # per-rank parameter bytes
    pool_bytes: int              # KV pool per rank, scales included
    resident_bytes: int          # token / position / table residents
    workspace_bytes: int         # largest program output + temp estimate
    footprint_bytes: int
    headroom_bytes: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def device_hbm_budget(device: Any = None, default: int = int(flops_mod.H100_HBM_BYTES)) -> int:
    """The device-memory budget: the card's total memory
    (``torch.cuda.mem_get_info``) on a CUDA ``device``, else ``default``
    (the H100's 80 GB), so that the ledger stays deterministic on the
    CPU."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return int(default)


def hbm_ledger(
    engine: Any,
    profiles: Optional[Dict[tuple, CostProfile]] = None,
    budget_bytes: Optional[int] = None,
) -> HBMLedger:
    dims = EngineDims.from_engine(engine)
    resident = sum(
        int(t.nbytes) for t in (engine._d_tokens, engine._d_positions, engine._d_tables)
    )
    workspace = 0
    for p in (profiles or {}).values():
        if p.kind in COMPUTE_KINDS:
            workspace = max(workspace, p.output_bytes + p.temp_bytes)
    budget = int(budget_bytes) if budget_bytes else device_hbm_budget(engine.device)
    pool = int(engine.metrics.pool_bytes_per_rank)
    footprint = dims.param_bytes_local + pool + resident + workspace
    return HBMLedger(
        budget_bytes=budget,
        param_bytes=dims.param_bytes_local,
        pool_bytes=pool,
        resident_bytes=resident,
        workspace_bytes=workspace,
        footprint_bytes=footprint,
        headroom_bytes=budget - footprint,
    )


# ---------------------------------------------------------------------------
# cost table rendering
# ---------------------------------------------------------------------------


def cost_table_lines(profiles: Dict[tuple, CostProfile]) -> List[str]:
    """One line per profile, ``<formatted key> flops=<g> bytes=<g>
    arg=<d> src=<s>``, sorted: the JAX package's lines for the same
    analytic profiles."""
    lines = []
    for p in profiles.values():
        lines.append(
            f"{p.label} flops={p.flops:.6g} bytes={p.bytes_accessed:.6g} "
            f"arg={p.argument_bytes} src={p.flops_source}"
        )
    return sorted(lines)
