"""Paged serving engine: block-budget admission, prefix-cached prefill,
preempt-and-requeue under pool pressure.

Counterpart of ``neuronx_distributed_llama3_2_tpu/serving/engine.py``
(``PagedConfig``, ``PagedServingEngine``, ``make_serving_engine``), ported
for the FIFO and the SLO-aware step policies, synchronous or async:

- KV rows live in a global pool of fixed-size blocks
  (:class:`..inference.model.PagedKVCache`); each request carries a block
  table and the model translates logical rows through it (vLLM
  PagedAttention). Block 0 is the reserved null block.
- A :class:`.radix_index.RadixPrefixIndex` maps token prefixes to block
  chains: a new request's shared prefix is admitted *by reference*
  (reported as ``cached_tokens``) and only the suffix is prefilled
  (SGLang RadixAttention); a partially shared last block is copied on
  write first.
- Admission is block-budget control: admit while free + evictable blocks
  cover the prompt plus a decode reserve. On pool exhaustion mid-decode the
  youngest request is preempted and requeued — never an exception out of
  :meth:`PagedServingEngine.step`.
- With ``PagedConfig.prefill_chunk_tokens`` set, a suffix longer than one
  chunk is admitted with its whole table allocated but an all-null
  decode-visible table row, and prefilled one chunk per step
  (Sarathi-Serve) between the decode steps of the other lanes; the last
  chunk installs the table, registers the prefix and samples the first
  token.
- ``PagedConfig.kv_cache_dtype`` int8 / fp8 stores the pool as low-bit
  payloads with per-(row, kv head) fp16 scales (:mod:`..quantization.
  kv_cache`), quantized on write; copy-on-write copies a block's scales
  with its payload. ``quant_mxu`` keeps the kernel's q.k dot in the
  payload's precision.
- ``PagedConfig.spec_draft_tokens`` turns on linear speculative decoding:
  a drafter (:class:`.drafter.NGramDrafter` by default) proposes up to k
  tokens per lane, one verify dispatch scores ``[cur, drafts]`` for every
  decode lane and accepts the agreeing prefix on the device
  (:meth:`..inference.model.LlamaDecode.verify_step`). Host sampling
  must be greedy; ``on_device_sampling`` lifts that.
- ``PagedConfig.spec_tree`` verifies a packed candidate tree of up to k
  nodes per lane instead (the drafter's ``propose_tree``, up to
  ``spec_tree_branches`` branches), scored in one ancestor-masked forward;
  the deepest accepted path is committed to the lane's frontier rows on the
  device (:meth:`..inference.model.LlamaDecode.tree_verify_step`, and
  ``mixed_step(parents=)`` under ``fused_step``).
- ``PagedConfig.fused_step`` packs the prefill chunks, the verify rows and
  the plain decode lanes of a step into one ``mixed_step`` dispatch while
  any lane is mid-prefill; every cached-prefix admission chunks through it,
  with the lane's table live at once and its resident row parked past the
  prompt. Host sampling must be greedy; ``on_device_sampling`` lifts that.
- ``PagedConfig.on_device_sampling`` draws every token on the device
  (:func:`..inference.sampling.sample_lanes`): each lane's temperature,
  top-k, top-p and threefry key data are device residents beside its token
  and position, written only by the lane-set flush, and each draw is keyed
  by the token's landing index, so sampled steady-state decode uploads
  nothing, sampled speculation and the fused step replay the plain
  sampled stream, a preempted request resumes it token for token, and one
  captured graph serves every sampling config. The draws are the JAX
  engine's bit for bit.
- Each :meth:`PagedServingEngine.step` runs its step policy's schedule
  (serving/policy.py; FIFO by default): drain, admit (with inline
  prefill), then one fused mixed dispatch while a lane prefills under
  ``fused_step``, else one chunk per prefilling lane and a verify dispatch
  (speculation) or one batched T=1 decode over every active lane, read
  back. ``step_policy="slo"`` (or ``policy=SloPolicy(...)``,
  :mod:`.scheduler`) ranks the waiting queue by service class, burn and
  tenant (an ADMIT's ``admit_order``) and caps a step's prefill chunks
  (a PREFILL_CHUNK's ``budget_tokens``).
- ``PagedConfig.async_loop`` runs the steady state (no waiting request,
  no lane mid-prefill) as a depth-1 lookahead: step N+1 is dispatched from
  the device-resident state before step N's tokens are read back, so a
  finish is seen one step late and the finished lane's lookahead token is
  discarded (the lame-duck drain). A step that would have to preempt, and
  every step that admits, prefills, verifies or runs the mixed step, drops
  to the synchronous sequence, which drains the lookahead first.
- Fault tolerance: a fault aborts only the request it hits. An
  ``injector`` (:class:`.faults.FaultInjector`) fires at the JAX engine's
  funnels: before every prefill, decode, verify and mixed dispatch (the
  victim lane's request fails, survivors redispatch from untouched
  state), at the drafter (absorbed), at ``BlockAllocator.alloc``
  (back-off) and at the transfers (latency). ``PagedConfig.
  detect_nonfinite`` (or a plan that can fire ``nan``) runs the checked
  programs: every decode-time step returns one ``finite`` bool a lane
  beside its tokens (``LlamaDecode.finite_logit_check``), and a lane whose
  logits are not finite is quarantined (failed, nothing committed).
  ``audit_interval`` / ``audit_debug`` run the invariant auditor
  (:mod:`.invariants`), ``stall_step_limit`` the stall watchdog
  (:class:`.faults.EngineStalledError`), ``trace_enabled`` the flight
  recorder (:meth:`PagedServingEngine.export_trace`) and
  ``metrics_log_every`` the periodic metrics line.
- The degradation ladder (``PagedConfig.degrade_after_faults``): every
  failed request, fault without a victim, pool-pressure preemption,
  drafter fault and (under ``slo_degrade``) SLO alert is an event; that
  many events inside ``degrade_window_steps`` climb one rung (1 sheds
  speculation, 2 the async lookahead, 3 the paged-attention kernel: every
  program then binds a ``use_paged_kernel=False`` twin of the decode
  model, the catalog's gather twins, 4 sheds the youngest lane by
  preemption), and ``degrade_recover_steps`` clean steps step one rung
  back down. Under prewarm a gather twin is captured at its first use
  and does not count in ``steadystate_compiles``.
- Tiered KV storage (``PagedConfig.spill_enabled``): a cached block the
  allocator evicts is not discarded; its payload (K, V, and the scale
  tiles of a quantized pool) is snapshotted on the device, copied into
  pinned host memory behind an event and committed to a byte-budgeted
  :class:`.block_allocator.HostTier`, and its radix node stays matchable
  in a spilled state. An admission whose prefix runs into spilled nodes
  prices restoring the payloads against re-prefilling them
  (``restore_crossover``, :mod:`.accounting`) and, when restoring wins,
  copies them back into fresh pool blocks in place, through the counted
  upload funnel.
- Cost accounting (``cost_accounting``, on by default): at the end of
  :meth:`PagedServingEngine.prewarm` every registered program gets an
  analytic :class:`.accounting.CostProfile` and the engine an
  :class:`.accounting.HBMLedger`; every dispatch then adds its program's
  FLOPs and bytes to the metrics, which report a serve MFU and bandwidth
  utilization against the H100's peaks. ``slo_ttft_p99_ms`` /
  ``slo_tpot_p99_ms`` arm the burn-rate monitor (:mod:`.slo`).

The JAX package compiles each of these as a jitted program, kept in a
program registry and bounded by the catalog manifest
(:class:`.catalog.CatalogManifest`). Here every prefill, decode, verify
and mixed dispatch goes through the registry too (:class:`ProgramRecord`):
it copies its per-step payload into the family's static buffers and calls
its key's record, which runs the step eagerly, or, under
``PagedConfig.prewarm`` on the card, replays the CUDA graph that
:meth:`PagedServingEngine.prewarm` captured before traffic;
:meth:`PagedServingEngine.mark_steady` freezes the key set. The in-place
state writes (copy-on-write, lane sets, table deltas) stay eager calls.
The spill tier's block saves and restores are eager in-place
writes too. The decode state (tokens, positions, block tables) lives on
the device as in the JAX package and is updated in place from host
mirrors when a lane changes.

``PagedConfig`` keeps every field of the JAX package. A knob whose feature
is not ported makes the constructor raise ``NotImplementedError`` naming
it (see :data:`UNPORTED_KNOBS`).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from neuronx_distributed_llama3_2_tpu_torch import flops as flops_mod
from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
    GenerationConfig,
    InferenceEngine,
)
from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import (
    GREEDY_TEMPERATURE,
    sample,
    sample_lanes,
)
from neuronx_distributed_llama3_2_tpu_torch.quantization.kv_cache import (
    kv_cache_torch_dtype,
    kv_scale_itemsize,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.accounting import (
    COMPUTE_KINDS,
    HOST_LINK_BW_BYTES_PER_S,
    EngineDims,
    analytic_cost,
    harvest_cost_profiles,
    hbm_ledger,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.block_allocator import (
    NULL_BLOCK,
    BlockAllocator,
    HostTier,
    kv_pool_bytes_per_rank,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.catalog import (
    GRAPH_KINDS,
    CatalogManifest,
    complete_ladder,
    format_key,
    pick_bucket,
    validate_ladder,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.drafter import NGramDrafter
from neuronx_distributed_llama3_2_tpu_torch.serving.faults import (
    EngineStalledError,
    FaultInjector,
    InjectedFault,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.invariants import (
    InvariantViolation,
    audit_engine,
    summarize_violations,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.metrics import ServingMetrics
from neuronx_distributed_llama3_2_tpu_torch.serving.policy import (
    ActionType,
    EngineView,
    StepAction,
    StepPolicy,
    make_policy,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.radix_index import (
    SPILLED_BLOCK,
    RadixPrefixIndex,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.slo import SLOMonitor, SLOPolicy
from neuronx_distributed_llama3_2_tpu_torch.serving.tracing import EngineTracer
from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger

logger = get_logger()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Knobs for the paged KV pool, field for field the JAX package's
    ``PagedConfig`` (see docs/serving.md). Fields named in
    :data:`UNPORTED_KNOBS` must keep their defaults in this port."""

    block_size: int = 16
    # pool size INCLUDING the reserved null block (id 0): usable capacity is
    # (num_blocks - 1) * block_size token rows shared by all requests
    num_blocks: int = 128
    # admission headroom: blocks a request must be able to claim beyond its
    # prompt before it is admitted, delaying the first preemption
    decode_reserve_blocks: int = 2
    enable_prefix_caching: bool = True
    # tiered KV storage: spill eviction victims' payloads into a host-RAM
    # tier behind the radix index instead of discarding them; a later
    # prefix hit restores them when the cost model says the transfer beats
    # re-prefilling. Needs enable_prefix_caching and host_tier_bytes > 0
    spill_enabled: bool = False
    # the host tier's byte budget; its own LRU evicts past it (dropping the
    # spilled trie nodes whose payloads are gone)
    host_tier_bytes: int = 0
    # restore a spilled run when restore_seconds <= restore_crossover *
    # recompute_seconds (payload bytes over the host link against prefill
    # FLOPs at the padded rung, at the H100's rates): 1.0 break-even, a
    # large value always restores, 0 never does (while still spilling)
    restore_crossover: float = 1.0
    # enqueued-but-undrained spill snapshots; past it the oldest drains
    spill_queue_depth: int = 8
    cache_dtype: Any = None
    # quantized KV pool: "bf16" = the pool at the model (or cache_dtype)
    # precision, no scale arrays
    kv_cache_dtype: str = "bf16"
    quant_mxu: bool = False
    on_device_sampling: bool = False
    metrics_log_every: int = 0
    # chunked prefill (Sarathi-Serve); None/0 = whole-suffix prefill
    prefill_chunk_tokens: Optional[int] = None
    fused_step: bool = False
    async_loop: bool = False
    # speculative decoding (linear and tree)
    spec_draft_tokens: int = 0
    spec_tree: bool = False
    spec_tree_branches: int = 2
    spec_ngram_max: int = 3
    spec_ngram_min: int = 1
    spec_min_accept_rate: float = 0.2
    spec_probation_tokens: int = 32
    spec_retry_steps: int = 4
    # fault tolerance
    detect_nonfinite: bool = False
    audit_interval: int = 0
    audit_debug: bool = False
    stall_step_limit: int = 0
    # degradation ladder
    degrade_after_faults: int = 0
    degrade_window_steps: int = 64
    degrade_recover_steps: int = 64
    # flight recorder
    trace_enabled: bool = False
    trace_buffer_steps: int = 256
    # serving bucket ladders: kv_buckets are the kv_limit attention extents
    # of decode / suffix-prefill calls, prefill_buckets the padded prompt
    # token counts of prefill calls. None = the InferenceEngine's ladder;
    # either gets max_seq_len appended when it tops out early
    kv_buckets: Optional[tuple] = None
    prefill_buckets: Optional[tuple] = None
    prewarm: bool = False
    # device-cost ledger: cost profiles and the HBM ledger at the end of
    # prewarm, the per-dispatch FLOP fold (host only)
    cost_accounting: bool = True
    # the ledger's device-memory budget (None: the card's total memory)
    hbm_budget_bytes: Optional[int] = None
    # latency objectives (p99 targets in ms; None = not declared) and the
    # burn-rate alerts; slo_degrade feeds an alert to the degradation ladder
    slo_ttft_p99_ms: Optional[float] = None
    slo_tpot_p99_ms: Optional[float] = None
    slo_eval_steps: int = 16
    slo_burn_window: int = 4
    slo_burn_threshold: float = 1.0
    slo_degrade: bool = False
    # step scheduling: "fifo" or "slo" (serving/scheduler.py); the
    # certified policy tables of "table" are not ported
    step_policy: str = "fifo"
    policy_table_path: Optional[str] = None


#: PagedConfig fields whose feature is not ported yet, with that feature.
#: Any value other than the default (a falsy value counts as the default
#: where the default is falsy) makes PagedServingEngine raise. ``prewarm``
#: is ported (every prefill and decode-time program as a CUDA graph) for
#: greedy decoding and, under ``on_device_sampling``, sampled decoding;
#: host-sampled decoding raises in :meth:`PagedServingEngine.prewarm`.
#: Every other knob is ported but the policy tables, which the analyzer
#: ``analysis/graftplan.py`` certifies (``step_policy="table"`` raises in
#: :func:`.policy.make_policy` for the same reason).
UNPORTED_KNOBS: Dict[str, str] = {
    "policy_table_path": (
        "certified policy tables (TablePolicy and analysis/graftplan.py, which "
        "come with the analyzer slice)"
    ),
}


def check_ported(paged: PagedConfig) -> None:
    """Raise ``NotImplementedError`` naming the first knob of ``paged``
    that asks for a feature this port does not have yet."""
    defaults = PagedConfig()
    for name, feature in UNPORTED_KNOBS.items():
        value, default = getattr(paged, name), getattr(defaults, name)
        if value != default and (value or default):
            raise NotImplementedError(
                f"PagedConfig.{name}={value!r}: {feature} is not ported to "
                "the PyTorch package yet"
            )


@dataclasses.dataclass
class ProgramRecord:
    """One prefill or decode-time program of the catalog (counterpart of
    the JAX package's ``ProgramRecord``): the step it runs and, under
    prewarm on a CUDA engine, the CUDA graph that step was captured into.

    ``fn`` runs the step over the engine's KV pool, its resident decode
    state and ``inputs``, the static payload buffers its family shares
    (a prefill's ids, start, length and table row; drafts, rows, ...); a
    decode-time step writes its new tokens and positions back into the
    residents in place; it returns the tensors the engine reads back.
    Where ``graph`` is set, each call replays it, and ``outputs`` are the
    tensors of the capture, in the memory pool every graph of the engine
    shares: the next replay of any graph may overwrite them, so the engine
    reads them before its next dispatch. Otherwise (no prewarm, or a CPU
    engine) ``graph`` is None and each call runs ``fn`` eagerly through
    the same buffers.
    ``replays`` counts the calls (under a graph, the kernels' Python launch
    counters tick only while it is captured)."""

    key: tuple
    kind: str
    fn: Callable[[], tuple]
    inputs: Dict[str, torch.Tensor]
    graph: Any = None
    outputs: tuple = ()
    replays: int = 0

    def __call__(self) -> tuple:
        if self.graph is None:
            self.outputs = self.fn()
        else:
            self.graph.replay()
        self.replays += 1
        return self.outputs


#: service classes a request may be submitted under (a scheduling hint and
#: a metrics label; it never reaches the device path)
SERVICE_CLASSES = frozenset({"interactive", "batch"})


@dataclasses.dataclass
class _PagedRequest:
    rid: int
    prompt: List[int]
    out: List[int]
    lane: Optional[int] = None
    table: List[int] = dataclasses.field(default_factory=list)
    position: int = 0            # == len(prompt + out) - 1 while active
    cached_tokens: int = 0       # cumulative across (re-)admissions
    preemptions: int = 0
    done: bool = False
    # mid-way through a chunked prefill: the lane holds its blocks and
    # prefill_pos walks to prefill_target (= len(prompt + out) at
    # admission), one chunk per step; the lane joins the decode batch after
    # the last chunk
    prefilling: bool = False
    prefill_pos: int = 0
    prefill_target: int = 0
    # the (1, W) block-table row on the device, uploaded once per chunk walk
    # and copied into the prefill programs' static row for each chunk
    table_dev: Any = None
    # speculation: drafts offered / accepted over the request's life; a lane
    # whose accept rate stays below spec_min_accept_rate past probation
    # stops drafting (spec_disabled) and takes plain decode steps
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_disabled: bool = False
    # terminal failure (cancel): the request is done with partial output
    # and `error` holds the detail
    failed: bool = False
    error: Optional[str] = None
    # lifecycle timestamps (time.perf_counter seconds): request_info
    # derives queue_ms / ttft_ms / tpot_ms from these
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None    # first admission only
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    prefill_ms: float = 0.0                # cumulative across re-admissions
    service_class: str = "batch"
    tenant: str = "default"
    submitted_step: int = 0


class PagedServingEngine:
    """Block-granular continuous batching over an :class:`InferenceEngine`'s
    model and weights, on the weights' device."""

    def __init__(
        self,
        engine: InferenceEngine,
        gen: GenerationConfig = GenerationConfig(),
        paged: PagedConfig = PagedConfig(),
        drafter: Optional[Any] = None,
        injector: Optional[FaultInjector] = None,
        policy: Optional[StepPolicy] = None,
    ) -> None:
        check_ported(paged)
        self.engine = engine
        self.model = engine.model
        self.gen = gen
        self.paged = paged
        self.device = engine.device
        # the chaos source; every hook below is guarded by `is not None`
        self.injector = injector
        bs = paged.block_size
        if bs < 1:
            raise ValueError("block_size must be positive")
        if paged.decode_reserve_blocks < 1:
            # a solo request's re-admission after self-preemption is only
            # guaranteed to fit when admission kept >= 1 block of headroom
            raise ValueError("decode_reserve_blocks must be >= 1")
        self._spec_k = int(paged.spec_draft_tokens or 0)
        if self._spec_k < 0:
            raise ValueError("spec_draft_tokens must be >= 0")
        # tree speculation: verify a packed candidate tree instead of a chain
        self._spec_tree = bool(paged.spec_tree)
        if self._spec_tree and not self._spec_k:
            raise ValueError(
                "spec_tree requires spec_draft_tokens > 0 (the tree's node "
                "budget is the draft-token budget)"
            )
        if self._spec_tree and self._spec_k + 1 > 32:
            raise ValueError(
                "spec_tree packs ancestor sets into int32 bitmasks: "
                f"spec_draft_tokens ({self._spec_k}) must be <= 31"
            )
        if paged.spec_tree_branches < 1:
            raise ValueError("spec_tree_branches must be >= 1")
        # on-device sampling: per-lane sampling residents, every draw keyed
        # by its landing index (sample_lanes)
        self._fused = bool(paged.on_device_sampling)
        if self._spec_k and not gen.sampling.greedy and not self._fused:
            # host-sampled acceptance compares the target's argmax; a
            # sampled stream would silently stop matching the plain loop.
            # Fused sampling lifts this: the accept targets become the
            # landing-index-keyed draws of sequential decoding
            raise ValueError(
                "speculative serving with host sampling requires greedy "
                "(SamplingConfig(greedy=True)) — or turn on "
                "PagedConfig.on_device_sampling for sampled verify"
            )
        self._fused_step = bool(paged.fused_step)
        if self._fused_step and not gen.sampling.greedy and not self._fused:
            # one mixed dispatch draws every row's token: a host-sampled
            # stream cannot replay the unfused engine's draw order; fused
            # draws are keyed by landing index, whatever the dispatch shape
            raise ValueError(
                "fused_step with host sampling requires greedy "
                "(SamplingConfig(greedy=True)) — or turn on "
                "PagedConfig.on_device_sampling for sampled mixed steps"
            )
        # the mixed row width covers the chunk budget and the widest verify
        self._mixed_t = (
            max(int(paged.prefill_chunk_tokens or 8), self._spec_k + 1)
            if self._fused_step else 0
        )
        self.drafter = drafter
        if self._spec_k and self.drafter is None:
            self.drafter = NGramDrafter(
                max_n=paged.spec_ngram_max, min_n=paged.spec_ngram_min
            )
        # the degradation ladder: level 0 = everything on; 1 sheds
        # speculation, 2 the async lookahead (both read by the policy), 3
        # the paged-attention kernel (the programs bind a gather twin of
        # the decode model, _step_model), 4 sheds the youngest lane by
        # preemption on each further climb
        self._degrade_level = 0
        self._event_steps: deque = deque()  # step indices of recent events
        self._last_event_step = 0
        self._gather_model = None  # the use_paged_kernel=False twin, lazily
        self.policy = policy if policy is not None else make_policy(
            paged.step_policy
        )
        self.policy.reset()
        self._view = EngineView(self)
        self._last_verify_drafted = False
        self._last_async_fell_back = False
        self._last_mixed_dispatched = False
        # per-step (step_index, pending_at_start, [StepAction...]) records
        self.action_trace: deque = deque(maxlen=paged.trace_buffer_steps or 256)
        self._step_actions: List[StepAction] = []
        # bucket ladders: every call shape pads into one of these rungs;
        # max_seq_len is appended to a ladder that tops out early
        self._prefill_buckets = complete_ladder(
            paged.prefill_buckets or engine.buckets, engine.max_seq_len
        )
        self._kv_buckets = complete_ladder(
            paged.kv_buckets or engine.buckets, engine.max_seq_len
        )
        # table width: logical blocks covering max_seq_len, plus overflow
        # entries (always null) absorbing bucket-padding writes past it
        self.table_width = _ceil_div(engine.max_seq_len, bs) + _ceil_div(
            self._prefill_buckets[-1], bs
        )
        if self._spec_k and engine.max_seq_len + self._spec_k > self.table_width * bs:
            # verify writes reach row position + k; the overflow region
            # (always null-backed) must absorb the rejected tail of a lane
            # sitting at the sequence cap
            raise ValueError(
                f"spec_draft_tokens ({self._spec_k}) exceeds the table's "
                f"overflow region ({self.table_width * bs - engine.max_seq_len} "
                f"rows past max_seq_len)"
            )
        if paged.prefill_chunk_tokens is not None and paged.prefill_chunk_tokens < 0:
            raise ValueError("prefill_chunk_tokens must be positive (or None / 0: off)")
        kv_cache_torch_dtype(paged.kv_cache_dtype)  # validate the knob early
        self._kv_quantized = paged.kv_cache_dtype != "bf16"
        if self._kv_quantized and paged.cache_dtype is not None:
            raise ValueError(
                "cache_dtype and a quantized kv_cache_dtype are mutually "
                "exclusive: the quantized storage dtype is the pool dtype"
            )
        if paged.quant_mxu:
            if not self._kv_quantized:
                raise ValueError(
                    "quant_mxu requires a quantized kv_cache_dtype (int8/fp8): "
                    "the fp pool has no low-bit payload to keep in the dot"
                )
            if not self.model.config.quant_mxu:
                # a twin of the decode model with the kernel knob set; it
                # holds no weights, and the caller's model is untouched
                self.model = type(self.model)(
                    dataclasses.replace(self.model.config, quant_mxu=True)
                )
        self.cache = self.model.init_paged_cache(
            paged.num_blocks, bs, paged.cache_dtype,
            kv_cache_dtype=paged.kv_cache_dtype, device=self.device,
        )
        self.allocator = BlockAllocator(paged.num_blocks, bs)
        self.index = RadixPrefixIndex(self.allocator)
        # tiered KV storage: the host-RAM spill tier behind the radix index,
        # set before the catalog (spill adds its state-write keys)
        self._spill = bool(paged.spill_enabled)
        self.host_tier: Optional[HostTier] = None
        # enqueued-but-undrained snapshots: (sid, host payload, event or
        # None, nbytes)
        self._spill_pending: deque = deque()
        # on the card, the pinned host buffers of every payload alive in
        # the queue or the tier (sid -> tensors), and the buffers of those
        # dropped since, free for the next spill of the same shape, each
        # behind the event recorded at its drop ((shape, dtype) -> [(buffer,
        # event)]): a spill reuses one instead of pinning fresh memory
        self._pinned_live: Dict[int, tuple] = {}
        self._pinned_free: Dict[tuple, list] = {}
        self._restore_dims: Optional[EngineDims] = None
        # the rate a restore's bytes are priced at: the restore path's
        # measured rate, host work included (accounting.py)
        self.host_link_bw = HOST_LINK_BW_BYTES_PER_S
        if self._spill:
            if not paged.enable_prefix_caching:
                raise ValueError(
                    "spill_enabled requires enable_prefix_caching (the "
                    "spilled residency state lives in the radix index)"
                )
            if paged.host_tier_bytes <= 0:
                raise ValueError("spill_enabled requires a positive host_tier_bytes")
            self.host_tier = HostTier(
                paged.host_tier_bytes, on_evict=self.index.invalidate_spilled,
            )
            self.allocator.host_tier = self.host_tier
            self.allocator.spill_hook = self._spill_block
            self.index.on_spill_drop = self._drop_spill_payload
        self.metrics = ServingMetrics()
        # the flight recorder: every hook is a no-op attribute test unless
        # trace_enabled, and none touches device state
        self.tracer = EngineTracer(
            enabled=paged.trace_enabled, buffer_steps=paged.trace_buffer_steps or 256,
        )
        if injector is not None:
            # fault firings land in the flight recorder as they fire, and
            # alloc() consults the plan
            injector.on_fire = self._trace_fault
            self.allocator.fault_hook = injector.alloc_fault
        # the checked programs (a separate catalog key each): every
        # decode-time step reads its family's static (B,) poison mask and
        # returns one `finite` bool a lane; chosen by the knob, or implied by
        # a plan that can fire nan faults
        self._check_logits = bool(
            paged.detect_nonfinite or (injector is not None and injector.wants("nan"))
        )
        # families whose poison mask holds a fired nan fault: cleared by
        # their next dispatch, so a clean checked step uploads nothing
        self._poisoned: set = set()
        # stall watchdog and periodic metrics log
        self._stall_steps = 0
        self._last_progress_sig: Optional[tuple] = None
        self._last_log_step = 0
        mc = self.model.config
        pool_bytes = kv_pool_bytes_per_rank(
            num_layers=mc.num_layers, num_blocks=paged.num_blocks,
            block_size=bs, num_kv_heads=mc.num_kv_heads,
            head_dim=mc.head_dim, dtype_bytes=self.cache.k.element_size(),
            scale_bytes=kv_scale_itemsize(paged.kv_cache_dtype),
        )
        self.metrics.tp_size = 1
        self.metrics.kv_dtype = paged.kv_cache_dtype
        self.metrics.pool_bytes_total = pool_bytes
        self.metrics.pool_bytes_per_rank = pool_bytes
        self._step_index = 0

        self._next_rid = 0
        self._queue: List[_PagedRequest] = []
        self._active: Dict[int, _PagedRequest] = {}  # lane -> request
        self._finished: Dict[int, _PagedRequest] = {}
        self._requests: Dict[int, _PagedRequest] = {}
        self._free_lanes = list(range(engine.max_batch))
        # host sampling draws from one generator on the engine's device;
        # greedy sampling draws nothing
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(gen.seed)
        # host MIRRORS of the decode state; the scheduler reads these for
        # kv-bucket routing and block accounting
        self._tokens = np.zeros((engine.max_batch,), np.int32)
        self._positions = np.zeros((engine.max_batch,), np.int32)
        self._tables = np.full(
            (engine.max_batch, self.table_width), NULL_BLOCK, np.int32
        )
        # device-RESIDENT decode state, consumed by every decode call; the
        # call's sampled tokens and advanced positions replace it, and lane
        # changes are written into it in place (_flush_state)
        self._d_tokens = self._upload(self._tokens)
        self._d_positions = self._upload(self._positions)
        self._d_tables = self._upload(self._tables)
        # on-device sampling residents: each lane's temperature, top-k,
        # top-p and raw threefry key data (two 32-bit words, carried in
        # int64), written in place by the lane-set flush only and read by
        # every fused dispatch; an idle lane sits at the greedy sentinel
        # with a null key
        self._temps = np.full((engine.max_batch,), GREEDY_TEMPERATURE, np.float32)
        self._topks = np.zeros((engine.max_batch,), np.int32)
        self._topps = np.ones((engine.max_batch,), np.float32)
        self._rng = np.zeros((engine.max_batch, 2), np.uint32)
        self._d_temps = self._d_topks = self._d_topps = self._d_rng = None
        if self._fused:
            self._d_temps = self._upload(self._temps, torch.float32)
            self._d_topks = self._upload(self._topks)
            self._d_topps = self._upload(self._topps, torch.float32)
            self._d_rng = self._upload(self._rng.astype(np.int64), torch.int64)
        # advanced positions are clamped here: keeps a long-idle garbage
        # lane's position inside the rope table (see LlamaDecode.decode_step)
        self._pos_cap = self.table_width * bs - 1
        # lanes whose host mirrors must be pushed to the device before the
        # next decode, and single block-table entries from decode growth
        self._dirty_lanes: set = set()
        self._table_delta_list: List[tuple] = []  # (lane, col, block_id)
        # the async loop's in-flight lookahead step (_snapshot's tuple),
        # which the step policy asks about; the sync loop reads every
        # decode back before returning. Each decode dispatch's tokens are
        # copied, in stream order right after it, into one of two host
        # buffers (pinned on the card), taken in turn with their events:
        # the next dispatch rewrites the resident tokens in place
        self._pending: Optional[tuple] = None
        pin = self.device.type == "cuda"
        self._host_tokens = [
            (
                torch.zeros((engine.max_batch,), dtype=torch.int32, pin_memory=pin),
                torch.cuda.Event() if pin else None,
            )
            for _ in range(2)
        ]
        # a checked dispatch's `finite` rides beside its tokens, in the
        # same turn's host buffer
        self._host_finite = [
            torch.ones((engine.max_batch,), dtype=torch.bool, pin_memory=pin)
            for _ in range(2)
        ]
        self._host_turn = 0
        # decode, verify and mixed dispatches so far, and how many of them
        # lay between the last readback's dispatch and its read (1 for an
        # async step's)
        self._dispatch_count = 0
        self._last_readback_lag = 0
        self._wait_ms = 0.0
        # the program registry (prewarm): key -> ProgramRecord,
        # every family's static payload buffers, the memory pool the
        # graphs share, and the key set mark_steady froze
        self.catalog = CatalogManifest.from_engine(self)
        self._programs: Dict[tuple, ProgramRecord] = {}
        self._graph_inputs: Dict[str, Dict[str, torch.Tensor]] = {}
        self._graph_pool = None
        self._warm_stream = None
        self._frozen_keys: Optional[frozenset] = None
        self._prewarming = False
        # the device-cost ledger (serving/accounting.py), filled by
        # ensure_cost_profiles(), at the end of prewarm() when
        # cost_accounting is on; _flops_by_key holds (flops, bytes) per
        # model-program key for the per-dispatch fold
        self.cost_profiles: Optional[Dict[tuple, Any]] = None
        self.hbm: Optional[Any] = None
        self._flops_by_key: Dict[tuple, tuple] = {}
        self.metrics.peak_flops_per_chip = flops_mod.H100_BF16_FLOPS_PER_S
        self.metrics.peak_hbm_bw_per_chip = flops_mod.H100_HBM_BYTES_PER_S
        # the SLO burn-rate monitor (serving/slo.py), built only when an
        # objective is declared
        slo_policy = SLOPolicy.from_paged(paged)
        self._slo: Optional[SLOMonitor] = (
            SLOMonitor(slo_policy, self.metrics) if slo_policy.active else None
        )
        if paged.prewarm:
            self.prewarm()

    # -- host<->device choke points ---------------------------------------

    def _upload(self, x, dtype=torch.int32) -> torch.Tensor:
        """Every host->device transfer on the serving path funnels through
        here, so the uploads are countable. Always a copy: on a CPU engine
        a resident must not share memory with its host mirror."""
        if self.injector is not None:
            self.injector.maybe_latency("upload")
        self.metrics.h2d_uploads += 1
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device, copy=True)

    def _upload_into(self, dst: torch.Tensor, x) -> None:
        """:meth:`_upload` into a graph's static input ``dst``, in place:
        one counted transfer, as the eager dispatch's own upload is."""
        if self.injector is not None:
            self.injector.maybe_latency("upload")
        self.metrics.h2d_uploads += 1
        dst.copy_(torch.as_tensor(np.asarray(x), dtype=dst.dtype))

    def _upload_tensor(self, t: torch.Tensor) -> torch.Tensor:
        """:meth:`_upload` of a host tensor of any dtype (a spilled block's
        bf16, int8 or fp8 payload and fp16 scales, which numpy cannot
        hold): one counted transfer, asynchronous from pinned memory."""
        if self.injector is not None:
            self.injector.maybe_latency("upload")
        self.metrics.h2d_uploads += 1
        return t.to(self.device, non_blocking=True)

    def _read_tokens(self, toks: torch.Tensor, ready=None) -> np.ndarray:
        """Every device->host token readback funnels through here; the
        blocking wait is accounted as device time. ``ready`` is the CUDA
        event after which ``toks``, a host buffer of :meth:`_snapshot`,
        holds its copy: the wait is on it."""
        if self.injector is not None:
            self.injector.maybe_latency("read")
        t0 = time.perf_counter()
        if ready is not None:
            ready.synchronize()
        # a copy: a host buffer is rewritten two dispatches later
        arr = toks.cpu().numpy().copy()
        t1 = time.perf_counter()
        self._wait_ms += (t1 - t0) * 1e3
        if self.tracer.enabled:
            self.tracer.complete("readback", t0, t1, n=int(arr.size))
        return arr

    def _snapshot(self, toks: torch.Tensor, lanes: List[int],
                  finite: Optional[torch.Tensor] = None) -> tuple:
        """A decode dispatch's readback, enqueued: ``toks`` (the resident
        tokens, which the next dispatch rewrites in place) and a checked
        dispatch's ``finite`` (a graph output the next replay may
        overwrite) copied into the next host buffers without blocking, and
        an event recorded after the copies on the same stream, so they land
        before any later dispatch writes. Returns the pending tuple ``(host
        tokens, event, lanes, dispatch index, host finite or None)`` that
        :meth:`_read_and_apply` reads. On a CPU engine the copies are made
        at once (``.cpu()`` would alias)."""
        host, ready = self._host_tokens[self._host_turn]
        host_fin = self._host_finite[self._host_turn] if finite is not None else None
        self._host_turn ^= 1
        host.copy_(toks, non_blocking=ready is not None)
        if host_fin is not None:
            host_fin.copy_(finite, non_blocking=ready is not None)
        if ready is not None:
            ready.record()
        return host, ready, lanes, self._dispatch_count, host_fin

    def _emit_action(self, atype: ActionType, mode: str = "", **meta) -> None:
        """Record one executed step action into this step's trace entry."""
        self._step_actions.append(StepAction(atype, mode, meta))

    def _kv_bucket(self, needed: int) -> int:
        """kv_limit rung covering ``needed`` rows over the serving kv
        ladder, with a clamp to the ladder top past it."""
        for b in self._kv_buckets:
            if b >= needed:
                return b
        return self._kv_buckets[-1]

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: pool block ``src`` -> ``dst`` in every layer, in
        place (the JAX package donates the pool to a copy program). A
        quantized pool's scales are part of the block's value and are
        copied with its payload."""
        for x in self._pool_tensors():
            x[:, dst] = x[:, src]

    # -- programs (prewarm) ---------------------------------------------------

    def _family_inputs(self, kind: str) -> Dict[str, torch.Tensor]:
        """The static payload buffers every program of ``kind`` reads, made
        once (int32 zeros, but a prefill's length 1; under on-device
        sampling a prefill's lane sampling parameters too: the key data
        int64, temperature and top-p float32, top-p 1; for the checked
        decode-time programs the (B,) poison mask, :meth:`_nan_mask`): a
        dispatch uploads its payload into them before it calls its
        program."""
        inputs = self._graph_inputs.get(kind)
        if inputs is None:
            b, k, t = self.engine.max_batch, self._spec_k, self._mixed_t
            # a prefill key reads ids[:, :bucket], a view at a fixed address
            prefill = dict(
                ids=(1, self._prefill_buckets[-1]), start=(1,), length=(1,),
                table=(1, self.table_width),
                **(dict(rng=(1, 2), temp=(1,), topk=(1,), topp=(1,)) if self._fused else {}),
            )
            shapes = {
                "pctx": prefill,
                "psfx": prefill,
                "pdecode": {},
                "pverify": dict(drafts=(b, k), draft_len=(b,)),
                "ptree": dict(drafts=(b, k), parents=(b, k + 1), node_len=(b,)),
                "pmixed": dict(
                    rows=(b, t), row_start=(b,), row_len=(b,), forced=(b,),
                    **(dict(parents=(b, t)) if self._spec_tree else {}),
                ),
            }[kind]
            if self._check_logits and kind not in ("pctx", "psfx"):
                shapes = dict(shapes, poison=(b,))
            dtypes = dict(rng=torch.int64, temp=torch.float32, topp=torch.float32)
            inputs = self._graph_inputs[kind] = {
                name: torch.zeros(
                    shape, dtype=dtypes.get(name, torch.int32), device=self.device
                )
                for name, shape in shapes.items()
            }
            if "length" in inputs:
                # a capture's warm-up gathers row length - 1: keep it a row
                inputs["length"].fill_(1)
            if "topp" in inputs:
                inputs["topp"].fill_(1.0)
        return inputs

    def _decode_cfg(self):
        """The sampling slot of the pctx / psfx / pdecode / pmixed keys: the
        static :class:`SamplingConfig` on the host-sampling path, the
        ``"lane"`` sentinel under on-device sampling, where the per-lane
        parameters are runtime residents and one program serves every
        sampling config."""
        return "lane" if self._fused else self.gen.sampling

    def _step_model(self):
        """The decode model a program registered now binds: ``self.model``,
        or at ladder level >= 3 a ``use_paged_kernel=False`` twin of it,
        built at the first climb, so that every program registered on that
        rung takes the block-table gather instead of the paged-attention
        kernel. The twin holds no weights (the steps take the engine's
        ``params``) and reads the same pool, so a rung only changes which
        registered program a dispatch picks."""
        if self._degrade_level >= 3 and self.model.config.use_paged_kernel:
            if self._gather_model is None:
                self._gather_model = type(self.model)(
                    dataclasses.replace(self.model.config, use_paged_kernel=False)
                )
            return self._gather_model
        return self.model

    def _gather_shed(self) -> bool:
        """The gather bit of the program keys: the kernel-shed rung."""
        return self._step_model() is not self.model

    def _lane_sampling(self) -> Optional[tuple]:
        """The ``sampling=`` tuple of the model's steps under on-device
        sampling, the residents themselves; None on the host path."""
        if not self._fused:
            return None
        return self._d_rng, self._d_temps, self._d_topks, self._d_topps

    def _write_back(self, tokens: torch.Tensor, positions: torch.Tensor) -> None:
        """A program's new resident tokens and positions, written into the
        residents in place: the graphs read them at their captured
        addresses."""
        self._d_tokens.copy_(tokens)
        self._d_positions.copy_(positions)

    def _step_fn(self, key_: tuple, inputs: Dict[str, torch.Tensor]) -> Callable[[], tuple]:
        """The step a catalog key runs: a prefill's ``forward`` over the
        pool, then the last real row's logits and the sample; or the
        model's own ``decode_step`` / ``verify_step`` / ``tree_verify_step``
        / ``mixed_step`` over the residents and ``inputs``, then the
        write-back. Returns a callable giving ``(tokens,)`` (a prefill's
        (1,) token; pdecode's resident itself) or ``(emitted, accept)``; a
        checked key's (its last field) step reads the family's poison mask
        and returns its (B,) ``finite`` last. The step binds
        :meth:`_step_model`: a gather key's (registered on the kernel-shed
        rung) the gather twin."""
        model, params, cap = self._step_model(), self.engine.params, self._pos_cap
        kind = key_[0]
        # the decode-time keys end in their checked bit
        poison = inputs.get("poison") if kind not in ("pctx", "psfx") and key_[-1] else None
        checked = poison is not None
        if kind in ("pctx", "psfx"):
            if kind == "pctx":
                _, bucket, cfg, _g = key_
                kv = None
            else:
                _, bucket, kv, cfg, _g = key_

            @torch.no_grad()  # the LM head runs outside the no-grad forward
            def fn():
                # pctx: the whole prompt from row 0 (start stays 0), plain
                # attention over the fresh block; psfx: the suffix after
                # the cached prefix, attending it through the table
                hidden, _ = model.forward(
                    params, self.cache, inputs["ids"][:, :bucket], inputs["start"],
                    None, context_encode=kind == "pctx", return_hidden=True,
                    block_tables=inputs["table"], kv_limit=kv,
                )
                # the last real row, at the length on the device (a Python
                # int would be frozen into a graph)
                last = torch.index_select(hidden, 1, (inputs["length"] - 1).long())
                logits = params._logits(last[:, 0])
                if cfg != "lane":
                    return (sample(logits, self._generator, cfg),)
                # the sampled token lands at sequence index start + length
                # (pctx: start 0), the index a decode step from the last
                # prompt row would fold
                index = inputs["length"] + (inputs["start"] if kind == "psfx" else 0)
                return (sample_lanes(
                    logits, inputs["rng"], index, inputs["temp"], inputs["topk"],
                    inputs["topp"],
                ),)
        elif kind == "pdecode":
            _, cfg, kv, _g, _c = key_

            def fn():
                # under on-device sampling the step checks its logits before
                # the draw; on the host path the check runs here, first
                step = model.decode_step(
                    params, self.cache, self._d_tokens, self._d_positions,
                    self._d_tables, kv_limit=kv, pos_cap=cap,
                    sampling=self._lane_sampling(),
                    logit_poison=poison if cfg == "lane" else None,
                )
                out, positions = step[0], step[-2]
                finite = step[1] if checked and cfg == "lane" else None
                if cfg != "lane":
                    if checked:
                        out, finite = model.finite_logit_check(out, poison)
                        if not cfg.greedy:
                            # a quarantined lane's draw is discarded, but the
                            # host sampler must not see its NaN row
                            out = torch.where(finite[:, None], out, torch.zeros_like(out))
                    out = sample(out, self._generator, cfg)
                self._write_back(out, positions)
                return (self._d_tokens,) + ((finite,) if checked else ())
        elif kind in ("pverify", "ptree"):
            _, kv, _k, _g, _c = key_

            def fn():
                tokens = torch.cat([self._d_tokens[:, None], inputs["drafts"]], dim=1)
                if kind == "ptree":
                    step = model.tree_verify_step(
                        params, self.cache, tokens, self._d_positions, self._d_tables,
                        inputs["parents"], inputs["node_len"], kv_limit=kv, pos_cap=cap,
                        sampling=self._lane_sampling(), logit_poison=poison,
                    )
                else:
                    step = model.verify_step(
                        params, self.cache, tokens, self._d_positions, self._d_tables,
                        inputs["draft_len"], kv_limit=kv, pos_cap=cap,
                        sampling=self._lane_sampling(), logit_poison=poison,
                    )
                emitted, accept, new_tokens, new_positions = step[:4]
                self._write_back(new_tokens, new_positions)
                return (emitted, accept) + ((step[4],) if checked else ())
        else:  # pmixed
            _, _t, kv, _cfg, _g, _c = key_

            def fn():
                step = model.mixed_step(
                    params, self.cache, self._d_tokens, self._d_positions,
                    self._d_tables, inputs["rows"], inputs["row_start"],
                    inputs["row_len"], inputs["forced"], kv_limit=kv, pos_cap=cap,
                    parents=inputs.get("parents"), sampling=self._lane_sampling(),
                    logit_poison=poison,
                )
                emitted, accept, new_tokens, new_positions = step[:4]
                self._write_back(new_tokens, new_positions)
                return (emitted, accept) + ((step[4],) if checked else ())
        return fn

    def _capture(self, fn: Callable[[], tuple]):
        """Capture ``fn`` as a CUDA graph into the engine's shared pool.
        First an eager warm-up call on a side stream (as torch.cuda.graphs
        asks): it builds the kernel sources, the cuBLAS handles, the
        model's rope tables and the t1 kernel's arrival counters before
        the capture, so nothing lazily built is allocated from the graphs'
        pool; the resident tokens and positions are put back after it.
        Returns ``(graph, outputs)``. A failure raises."""
        dev = self.device
        saved = (self._d_tokens.clone(), self._d_positions.clone())
        main = torch.cuda.current_stream(dev)
        if self._warm_stream is None:
            self._warm_stream = torch.cuda.Stream(dev)
        self._warm_stream.wait_stream(main)
        with torch.cuda.stream(self._warm_stream):
            fn()
        main.wait_stream(self._warm_stream)
        self._write_back(*saved)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool):
            outputs = fn()
        if self._graph_pool is None:
            self._graph_pool = graph.pool()
        return graph, outputs

    def _register_program(self, key_: tuple) -> ProgramRecord:
        """Build and register the program of ``key_``: under
        ``PagedConfig.prewarm`` on a CUDA engine its graph
        (:meth:`_capture`), otherwise the step itself, which each call
        runs eagerly. Counts in ``programs_compiled``, and in
        ``prewarm_compiles`` during :meth:`prewarm` or
        ``steadystate_compiles`` after :meth:`mark_steady`, but for the
        kernel-shed rung's gather twins, which ``prewarm`` never captures
        and the rung registers at their first use, as the JAX package
        exempts them.

        Such a capture happens mid-serve, and drains the device first:
        ``torch.cuda.graph`` synchronizes before it begins, so every
        replay, spill copy and lookahead step in flight has finished (a
        lookahead's tokens already sit in their host buffer behind its
        event; the FIFO and SLO policies turn the async loop off at rung 2
        anyway). Its warm-up call runs the step the replay then runs (the
        dispatch's payload is in the static buffers already, and the
        residents are put back after it), so its pool writes are the
        replay's own, and it allocates from the graphs' shared pool, whose
        graphs replay one at a time on the compute stream. A twin that
        fails to capture raises, as any key does."""
        kind = key_[0]
        if kind not in GRAPH_KINDS:
            raise ValueError(
                f"{format_key(key_)}: the port runs {kind!r} writes as eager "
                "calls, not as CUDA graphs"
            )
        inputs = self._family_inputs(kind)
        fn = self._step_fn(key_, inputs)
        rec = ProgramRecord(key=key_, kind=kind, fn=fn, inputs=inputs)
        gather = self._gather_shed()
        if self.paged.prewarm and self.device.type == "cuda":
            rec.graph, rec.outputs = self._capture(fn)
        self._programs[key_] = rec
        self.metrics.programs_compiled += 1
        if self._prewarming:
            self.metrics.prewarm_compiles += 1
        elif self._frozen_keys is not None and not gather:
            # a capture after the freeze is a stall under live traffic:
            # the runtime twin of the JAX package's GC008. The kernel-shed
            # rung's gather twins are exempt: it mints them on purpose
            self.metrics.steadystate_compiles += 1
        return rec

    def _program(self, key_: tuple) -> ProgramRecord:
        """The registered program of ``key_``, registered now if it is not
        yet (under prewarm, a key past the manifest: it is captured and
        then replayed, never run eagerly in its place)."""
        rec = self._programs.get(key_)
        return rec if rec is not None else self._register_program(key_)

    def program_registry(self) -> Dict[tuple, ProgramRecord]:
        """key -> :class:`ProgramRecord` for every program this engine has
        registered (captured, under prewarm on the card)."""
        return dict(self._programs)

    def catalog_manifest(self) -> CatalogManifest:
        """The declared program catalog (:mod:`.catalog`), static for the
        engine's lifetime."""
        return self.catalog

    def ensure_cost_profiles(self) -> Dict[tuple, Any]:
        """Harvest the device-cost ledger (:mod:`.accounting`): a
        :class:`.accounting.CostProfile` for every registered program
        (analytic figures; a captured record's outputs its graph's), the
        :class:`.accounting.HBMLedger` against ``PagedConfig.
        hbm_budget_bytes`` or the card's memory, each kv rung's decode
        roofline, and the per-key figures the dispatch fold adds. Host
        arithmetic only; runs at the end of :meth:`prewarm` when
        ``PagedConfig.cost_accounting`` is on."""
        profiles = harvest_cost_profiles(self)
        self.cost_profiles = profiles
        self._flops_by_key = {
            k: (p.flops, p.bytes_accessed) for k, p in profiles.items()
            if p.kind in COMPUTE_KINDS
        }
        ledger = hbm_ledger(self, profiles=profiles, budget_bytes=self.paged.hbm_budget_bytes)
        self.hbm = ledger
        m = self.metrics
        m.cost_profiled_programs = len(profiles)
        m.hbm_budget_bytes = ledger.budget_bytes
        m.hbm_footprint_bytes = ledger.footprint_bytes
        m.hbm_headroom_bytes = ledger.headroom_bytes
        # each kv rung's roofline ceiling, from its plain (unchecked)
        # decode profile: the MFU the memory system allows a decode there
        peak_flops = m.peak_flops_per_chip * max(m.tp_size, 1)
        peak_bw = m.peak_hbm_bw_per_chip * max(m.tp_size, 1)
        by_rung: Dict[int, dict] = {}
        for key_, p in profiles.items():
            if p.kind != "pdecode" or key_[3] or key_[4]:
                continue
            by_rung[int(key_[2])] = {
                "flops": p.flops,
                "bytes": p.bytes_accessed,
                "arithmetic_intensity": round(p.arithmetic_intensity(), 6),
                "roofline_mfu": round(p.roofline_mfu(peak_flops, peak_bw), 6),
            }
        m.mfu_by_rung = by_rung
        return profiles

    def _dispatch_cost(self, key_: tuple) -> tuple:
        """(flops, bytes) of a model program's profile, (0, 0) before the
        harvest: what a dispatch adds to the metrics."""
        return self._flops_by_key.get(key_) or (0.0, 0.0)

    def mark_steady(self) -> None:
        """Freeze the program registry: every later capture counts in
        ``metrics.steadystate_compiles``. Called at the end of
        :meth:`prewarm`; a harness warming up through real traffic can
        call it once its working set is captured."""
        self._frozen_keys = frozenset(self._programs)

    def prewarm(self) -> None:
        """Capture every program key of the catalog
        (``catalog.graph_keys()``: ``pctx`` per prefill rung, ``psfx`` per
        (prefill rung, kv rung) pair, ``pdecode`` per kv rung, ``pverify``
        / ``ptree`` per (kv, k), ``pmixed`` per (t, kv)) before any
        traffic, then :meth:`mark_steady`. Called by the constructor when
        ``PagedConfig.prewarm`` is set; every prefill, decode, verify and
        mixed dispatch then replays its key's graph. The state-write keys
        stay eager calls. A key that fails to capture raises: nothing
        falls back to an eager call.

        Each capture's warm-up runs with the resident state as it is, and
        every table row (the prefills' static row too) still null, so its
        writes land in the null block;
        the residents are put back after it, and no transfer counts in
        ``h2d_uploads``. On a CPU engine nothing is captured or run: the
        records run their steps eagerly when dispatched. A graph reads
        the weights, the KV pool and the residents at their captured
        addresses: nothing may move them after this (no ``.to()``, no
        ``load_state_dict`` that replaces a tensor). Sampled decoding needs
        ``PagedConfig.on_device_sampling``: its per-lane parameters and
        keys are residents the graphs read, so one capture serves every
        sampling config, greedy or sampled; the host sampler's draws are
        not captured."""
        if not self.gen.sampling.greedy and not self._fused:
            raise NotImplementedError(
                "prewarm with sampled decoding: the host sampler's draws are "
                "not captured; turn on PagedConfig.on_device_sampling (or use "
                "SamplingConfig(greedy=True))"
            )
        t0 = time.perf_counter()
        self._prewarming = True
        try:
            for key_ in self.catalog.graph_keys():
                if key_ not in self._programs:
                    self._register_program(key_)
        finally:
            self._prewarming = False
        self.mark_steady()
        for warning in validate_ladder(self.model, self.catalog.ladder):
            logger.warning("catalog: %s", warning)
        logger.info(
            "prewarmed %d program(s) in %.3f s: %s", self.metrics.prewarm_compiles,
            time.perf_counter() - t0, self.catalog.describe(),
        )
        if self.paged.cost_accounting:
            # every captured key is registered now: harvest the ledger
            self.ensure_cost_profiles()

    # -- on-device sampling lane state (PagedConfig.on_device_sampling) ------

    def _lane_rng(self, rid: int) -> np.ndarray:
        """Per-request base key data (2,) uint32, derived from ``(gen.seed,
        rid)`` by SeedSequence as the JAX engine derives it: a preempted
        request re-installs the SAME key on re-admission, and with every
        draw keyed by its landing index the resumed stream replays the
        unpreempted run token for token."""
        return np.random.SeedSequence(
            [int(self.gen.seed), int(rid)]
        ).generate_state(2).astype(np.uint32)

    def _sampling_mode(self) -> str:
        """Tracer label and counter bucket of a decode / verify / mixed
        dispatch: ``"greedy"`` (argmax, in either mode), ``"fused"`` (drawn
        on the device from the residents) or ``"host"`` (the host-path
        sampler)."""
        if self.gen.sampling.greedy:
            return "greedy"
        return "fused" if self._fused else "host"

    def _note_sampling_dispatch(self) -> str:
        mode = self._sampling_mode()
        if mode == "fused":
            self.metrics.sampled_steps += 1
        elif mode == "host":
            self.metrics.host_sample_fallbacks += 1
        return mode

    def _trace_dispatch(self, t_d: float, key_: tuple, mode: str, smode: str,
                        lanes: int, kv_limit: int) -> None:
        """One decode / verify / mixed dispatch on the tracer's step
        timeline, with its program key and sampling label."""
        self.tracer.complete(
            "dispatch", t_d, program=format_key(key_), mode=mode, sampling=smode,
            lanes=lanes, kv_bucket=kv_limit,
        )

    def _install_lane_sampling(self, lane: int, req: _PagedRequest) -> None:
        """Admission-time install of a lane's sampling parameters and base
        key into the host mirrors (the next lane-set flush writes the
        residents). A greedy GenerationConfig installs the temperature
        sentinel, so the fused draw is the exact argmax for the lane."""
        if not self._fused:
            return
        s = self.gen.sampling
        if s.greedy:
            self._temps[lane] = GREEDY_TEMPERATURE
            self._topks[lane] = 0
            self._topps[lane] = 1.0
        else:
            self._temps[lane] = s.temperature
            self._topks[lane] = s.top_k
            self._topps[lane] = s.top_p
        self._rng[lane] = self._lane_rng(req.rid)
        self.metrics.rng_reseeds += 1

    def _clear_lane_sampling(self, lane: int) -> None:
        """Teardown twin of :meth:`_install_lane_sampling`: park the lane
        at the greedy sentinel with a null key (idle lanes keep stepping in
        the resident batch)."""
        if not self._fused:
            return
        self._temps[lane] = GREEDY_TEMPERATURE
        self._topks[lane] = 0
        self._topps[lane] = 1.0
        self._rng[lane] = 0

    def _upload_lane_sampling(self, inputs: Dict[str, torch.Tensor], lane: int) -> None:
        """A fused prefill's sampling payload: ``lane``'s key data,
        temperature, top-k and top-p uploaded into the prefill family's
        static (1, ...) buffers, four counted transfers (the JAX engine's
        ``_lane_sampling_args``); prefills pay per-call uploads anyway, and
        only decode-time steps must read residents alone."""
        s = slice(lane, lane + 1)
        self._upload_into(inputs["rng"], self._rng[s].astype(np.int64))
        self._upload_into(inputs["temp"], self._temps[s])
        self._upload_into(inputs["topk"], self._topks[s])
        self._upload_into(inputs["topp"], self._topps[s])

    # -- request lifecycle ------------------------------------------------

    def _release_lane(self, req: _PagedRequest) -> None:
        """THE lane-teardown funnel (finish / fail / preempt): release the
        request's blocks and null the lane's host mirrors, marking the
        lane dirty for the next full-lane sync."""
        lane = req.lane
        for b in req.table:
            self.allocator.release(b)
        req.table = []
        req.table_dev = None
        del self._active[lane]
        self._free_lanes.append(lane)
        self._tables[lane, :] = NULL_BLOCK
        self._tokens[lane] = 0
        self._positions[lane] = 0
        self._clear_lane_sampling(lane)
        self._dirty_lanes.add(lane)
        req.lane = None

    def _fail_request(self, req: _PagedRequest, error: str) -> None:
        """Terminal failure: blocks released, lane freed, the request lands
        in ``_finished`` with ``failed=True`` and its partial output. Nothing
        is registered in the prefix index. A degradation-ladder event. Only
        with no lookahead in flight (callers drain first)."""
        if self._pending is not None:
            raise RuntimeError("failing a lane with a step in flight")
        if req.rid in self._finished:
            return
        req.failed = True
        req.done = True
        req.error = str(error)
        if req in self._queue:
            self._queue.remove(req)
        if req.lane is not None:
            lane = req.lane
            req.prefilling = False
            self._release_lane(req)
            self._emit_action(
                ActionType.FINISH, rid=req.rid, lane=lane, failed=True,
            )
        self._finished[req.rid] = req
        self.metrics.failed_requests += 1
        self._note_terminal(req)
        self.tracer.instant("request_failed", rid=req.rid, error=req.error[:160])
        self.tracer.request_state(req.rid, "failed")
        self._note_event()
        logger.warning(
            "request %d failed after %d tokens: %s",
            req.rid, len(req.out), req.error,
        )
        if self.paged.audit_debug:
            self._audit(strict=True)

    # -- fault handling ---------------------------------------------------

    def _chaos_device(self, site: str, lanes: Sequence[int]) -> None:
        """The chaos funnel in front of a program dispatch. It raises before
        the call, so the pool and the resident decode state are never
        half-mutated: failing the victim lane and redispatching the
        survivors is sound. (Under prewarm the family's static buffers may
        already hold the payload of the dispatch that never ran; the next
        dispatch writes its own over it.)"""
        if self.injector is None:
            return
        victim = self.injector.device_fault(site, lanes)
        if victim is not None:
            raise InjectedFault("device", site, lanes=(victim,))

    def _nan_mask(self, kind: str, lanes: Sequence[int], site: str) -> None:
        """Set a checked dispatch's poison mask, the (B,) static buffer of
        the ``kind`` family that its programs read: written (one counted
        upload) only when the injector fires a nan fault, cleared on the
        device by the family's next dispatch, untouched otherwise, so a
        clean checked step uploads nothing."""
        poison = self.injector.nan_lanes(site, lanes) if self.injector is not None else []
        mask = self._family_inputs(kind)["poison"]
        if poison:
            m = np.zeros((self.engine.max_batch,), np.int32)
            m[poison] = 1
            self._upload_into(mask, m)
            self._poisoned.add(kind)
        elif kind in self._poisoned:
            mask.zero_()
            self._poisoned.discard(kind)

    def _quarantine(self, req: _PagedRequest, site: str) -> None:
        """Non-finite logits on this lane: its tokens (and any KV written
        from them) are garbage, so the request fails instead of committing.
        The other lanes are untouched: attention is per lane."""
        self.metrics.lane_quarantines += 1
        self._fail_request(req, f"non-finite logits at {site} step (lane quarantined)")

    def _recover_fault(self, fault: InjectedFault) -> bool:
        """A device fault raised at a dispatch funnel: retire the lookahead
        in flight (its tokens are valid: it ran before the fault), fail the
        victim lanes' requests, and keep serving; the survivors redispatch
        next step from untouched state. The fault is one ladder event."""
        self._drain_pending()
        failed_any = False
        for lane in fault.lanes:
            req = self._active.get(lane)
            if req is not None:
                self._fail_request(req, str(fault))
                failed_any = True
        if not failed_any:
            self._note_event()  # _fail_request notes it otherwise
        return bool(self._active or self._queue)

    def _trace_fault(self, step: int, kind: str, site: str, lanes) -> None:
        """``FaultInjector.on_fire``: every firing lands in the flight
        recorder as an instant."""
        self.tracer.instant("fault", kind=kind, site=site, lanes=list(lanes))

    def _note_event(self) -> None:
        """Record one fault or pressure event for the degradation ladder."""
        self._last_event_step = self._step_index
        if self.paged.degrade_after_faults:
            self._event_steps.append(self._step_index)

    def _update_ladder(self) -> None:
        """Climb one rung when ``degrade_after_faults`` events fall inside
        the last ``degrade_window_steps`` steps; step one rung back down
        after ``degrade_recover_steps`` steps without one. A climb consumes
        its window, and at the top rung every climb sheds the youngest lane
        by preemption (after draining the lookahead), which is not itself
        an event."""
        cfg = self.paged
        if not cfg.degrade_after_faults:
            return
        horizon = self._step_index - cfg.degrade_window_steps
        while self._event_steps and self._event_steps[0] <= horizon:
            self._event_steps.popleft()
        if len(self._event_steps) >= cfg.degrade_after_faults:
            self._event_steps.clear()
            self._last_event_step = self._step_index
            if self._degrade_level < 4:
                self._degrade_level += 1
                self.metrics.degradations += 1
                self.metrics.degradation_level = self._degrade_level
                logger.warning("degradation ladder: climbing to level %d", self._degrade_level)
                self.tracer.instant(
                    "degradation", level=self._degrade_level, direction="climb",
                )
            if self._degrade_level >= 4 and len(self._active) > 1:
                self._drain_pending()
                victim = max(self._active.values(), key=lambda r: r.rid)
                self._preempt(victim, shed=True)
        elif (
            self._degrade_level
            and self._step_index - self._last_event_step >= cfg.degrade_recover_steps
        ):
            self._degrade_level -= 1
            self.metrics.degradation_level = self._degrade_level
            # one rung per clean window
            self._last_event_step = self._step_index
            logger.info("degradation ladder: recovered to level %d", self._degrade_level)
            self.tracer.instant(
                "degradation", level=self._degrade_level, direction="recover",
            )

    def _progress_sig(self) -> tuple:
        """Everything that moves when the engine does useful work: two
        equal signatures in a row with work outstanding are a stalled
        step."""
        m = self.metrics
        return (
            m.admitted, m.finished, m.failed_requests, m.preemptions,
            m.prefill_chunks, m.prefill_tokens, len(self._queue),
            sum(len(r.out) for r in self._active.values()),
            sum(r.prefill_pos for r in self._active.values() if r.prefilling),
        )

    def _check_stall(self) -> None:
        """The stall watchdog (``PagedConfig.stall_step_limit``): raise
        :class:`.faults.EngineStalledError`, naming the stuck work, after
        that many steps in a row without progress."""
        limit = self.paged.stall_step_limit
        if not limit:
            return
        if not (self._active or self._queue):
            self._stall_steps = 0
            self._last_progress_sig = None
            return
        sig = self._progress_sig()
        if sig == self._last_progress_sig:
            self._stall_steps += 1
            if self._stall_steps >= limit:
                raise EngineStalledError(
                    limit,
                    {lane: r.rid for lane, r in self._active.items()},
                    [r.rid for r in self._queue],
                )
        else:
            self._stall_steps = 0
        self._last_progress_sig = sig

    def _audit(self, strict: bool = False) -> List[str]:
        """Run the invariant auditor (:mod:`.invariants`): log and count
        violations, raise :class:`.invariants.InvariantViolation` only when
        ``strict`` (``PagedConfig.audit_debug``)."""
        violations = audit_engine(self)
        self._emit_action(ActionType.AUDIT, strict=strict, violations=len(violations))
        if violations:
            self.metrics.audit_violations += len(violations)
            logger.error("serving invariant violations: %s", violations)
            self.tracer.instant(
                "invariant_violation", count=len(violations),
                detail=summarize_violations(violations),
            )
            if strict:
                raise InvariantViolation(violations)
        return violations

    def _note_first_token(self, req: _PagedRequest) -> None:
        """First sampled token for this request: stamp TTFT."""
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
            ms = (req.first_token_at - req.submitted_at) * 1e3
            self.metrics.hist_ttft_ms.observe(ms)
            self.metrics.observe_class_latency("ttft", req.service_class, ms)

    def _note_terminal(self, req: _PagedRequest) -> None:
        """Terminal transition: stamp the end time and fold the request's
        mean inter-token latency into the TPOT histogram."""
        if req.finished_at is not None:
            return
        req.finished_at = time.perf_counter()
        if req.first_token_at is not None and len(req.out) > 1:
            ms = (
                (req.finished_at - req.first_token_at) * 1e3
                / (len(req.out) - 1)
            )
            self.metrics.hist_tpot_ms.observe(ms)
            self.metrics.observe_class_latency("tpot", req.service_class, ms)
        self.metrics.note_class_event(
            req.service_class, "failed" if req.failed else "finished"
        )

    def submit(
        self,
        prompt: Sequence[int],
        *,
        service_class: str = "batch",
        tenant: str = "default",
    ) -> int:
        if service_class not in SERVICE_CLASSES:
            raise ValueError(
                f"unknown service_class {service_class!r}; expected one of "
                f"{sorted(SERVICE_CLASSES)}"
            )
        if len(prompt) + self.gen.max_new_tokens > self.engine.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({self.gen.max_new_tokens}) exceeds cache capacity "
                f"({self.engine.max_seq_len})"
            )
        bs = self.paged.block_size
        worst = (
            _ceil_div(len(prompt) + self.gen.max_new_tokens, bs)
            + self.paged.decode_reserve_blocks
        )
        if worst > self.allocator.usable_blocks:
            raise ValueError(
                f"request needs up to {worst} KV blocks but the pool has "
                f"{self.allocator.usable_blocks} usable blocks — raise "
                f"PagedConfig.num_blocks or shrink max_new_tokens"
            )
        rid = self._next_rid
        self._next_rid += 1
        req = _PagedRequest(
            rid=rid, prompt=list(prompt), out=[],
            submitted_at=time.perf_counter(),
            service_class=service_class, tenant=tenant,
            submitted_step=self._step_index,
        )
        self._queue.append(req)
        self._requests[rid] = req
        self.metrics.submitted += 1
        self.metrics.note_class_event(service_class, "submitted")
        self.metrics.queued_requests = len(self._queue)
        self.tracer.request_state(rid, "queued")
        return rid

    def cancel(self, rid: int, reason: str = "cancelled by client") -> bool:
        """Client-initiated terminal cancel: queued and decoding requests
        alike fail with ``error=reason``, blocks released and lane freed;
        survivors' streams are unchanged. Returns True if the request
        transitioned to terminal now, False if it was already done. Raises
        KeyError for an unknown rid. Call between steps."""
        req = self._requests.get(rid)
        if req is None:
            raise KeyError(f"unknown request id {rid}")
        if req.done:
            return False
        self._drain_pending()
        self._fail_request(req, reason)
        self.metrics.cancelled_requests += 1
        self.metrics.queued_requests = len(self._queue)
        return True

    # -- tiered KV storage (host-RAM spill tier) ----------------------------

    def _pool_tensors(self) -> tuple:
        """The pool tensors a block's value spans: K and V, and a quantized
        pool's scale tiles."""
        c = self.cache
        return (c.k, c.v) + ((c.k_scale, c.v_scale) if c.quantized else ())

    def _spill_block(self, bid: int) -> bool:
        """``BlockAllocator.spill_hook``: move the eviction victim's
        payload toward host RAM instead of discarding it. The block is
        snapshotted on the device (a clone of each pool tensor's slice, on
        the compute stream: after every write the block has had, before
        any write of its next owner, which the allocator hands the id to
        at once), the snapshot is copied into pinned host memory without
        blocking and an event recorded after the copy; the radix node
        turns spilled and the entry joins the bounded drain queue, which
        waits on the event. On a CPU engine the clone is the host payload.
        False: no index node to keep, and the allocator discards the
        block."""
        if not self._spill or bid not in self.index._by_block:
            return False
        snap = tuple(x[:, bid].clone() for x in self._pool_tensors())
        sid = self.host_tier.allocate_sid()
        ready = None
        if self.device.type == "cuda":
            host = tuple(self._pinned_take(t) for t in snap)
            for h, t in zip(host, snap):
                h.copy_(t, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            snap = self._pinned_live[sid] = host
        nbytes = sum(t.numel() * t.element_size() for t in snap)
        self.index.mark_spilled(bid, sid)
        self._spill_pending.append((sid, snap, ready, nbytes))
        self.metrics.blocks_spilled += 1
        # bounded queue: past the depth, the oldest snapshot drains now
        while len(self._spill_pending) > self.paged.spill_queue_depth:
            self._drain_one_spill()
        return True

    def _pinned_take(self, like: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer of ``like``'s shape and dtype: one a
        dropped payload freed, once the compute stream has passed the
        event recorded at its drop (a stream wait, not a host one), else
        freshly pinned memory."""
        free = self._pinned_free.get((tuple(like.shape), like.dtype))
        if not free:
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        buf, dropped = free.pop()
        torch.cuda.current_stream(self.device).wait_event(dropped)
        return buf

    def _drain_one_spill(self) -> None:
        sid, payload, ready, nbytes = self._spill_pending.popleft()
        if sid not in self.index._spilled:
            return  # the node was dropped while the snapshot waited
        if ready is not None:
            t0 = time.perf_counter()
            ready.synchronize()  # the copy into pinned memory has landed
            self._wait_ms += (time.perf_counter() - t0) * 1e3
        self.host_tier.put_at(sid, payload, nbytes)
        self.metrics.spill_bytes += nbytes

    def _drain_spills(self) -> None:
        """Commit every enqueued snapshot to the host tier: at the end of
        :meth:`step` and before a restore prices a spilled run. The wait is
        on each snapshot's event, counted as device wait."""
        if not self._spill_pending:
            return
        t0 = time.perf_counter()
        n = len(self._spill_pending)
        while self._spill_pending:
            self._drain_one_spill()
        self.tracer.complete("spill_drain", t0, time.perf_counter(), blocks=n)

    def _drop_spill_payload(self, sid: int) -> None:
        """``RadixPrefixIndex.on_spill_drop``: forget a spilled payload
        wherever it is, in the host tier or in the drain queue. Its pinned
        buffers go back to the free list behind an event recorded now,
        after every copy enqueued from or into them (the snapshot's, a
        restore's upload)."""
        if self.host_tier is not None:
            self.host_tier.drop(sid)
        if self._spill_pending:
            self._spill_pending = deque(e for e in self._spill_pending if e[0] != sid)
        host = self._pinned_live.pop(sid, None)
        if host is not None:
            dropped = torch.cuda.Event()
            dropped.record()
            for t in host:
                self._pinned_free.setdefault((tuple(t.shape), t.dtype), []).append((t, dropped))

    def _restore_price(self, n_bytes: int, gain: int) -> tuple:
        """``(restore_seconds, recompute_seconds)`` of a spilled run: its
        payload bytes at the restore path's rate (``host_link_bw``)
        against the prefill FLOPs of ``gain`` tokens at the padded rung
        over the peak (``metrics.peak_flops_per_chip``). Every cost
        profile of the port is this same analytic figure (torch has no
        compiler cost analysis to prefer), so the formula is read
        directly."""
        if self._restore_dims is None:
            self._restore_dims = EngineDims.from_engine(self)
        bucket = pick_bucket(self._prefill_buckets, max(gain, 1))
        flops = analytic_cost(("pctx", bucket), self._restore_dims)[0]
        peak = self.metrics.peak_flops_per_chip * max(self.metrics.tp_size, 1)
        return n_bytes / self.host_link_bw, flops / max(peak, 1.0)

    def _restore_block(self, sid: int, nb: int, payload: tuple) -> None:
        """Write spilled payload ``sid`` into fresh pool block ``nb`` in
        place (the captured graphs read the pool at its addresses), each
        tensor through the counted upload funnel."""
        for x, t in zip(self._pool_tensors(), payload):
            x[:, nb].copy_(self._upload_tensor(t))
        self.metrics.restore_uploads += len(payload)

    def _maybe_restore(self, seq: List[int], matched: int, mblocks: List[int]) -> tuple:
        """Restore or recompute, at admission: when the radix walk runs
        past the resident prefix into spilled nodes, price the spilled run
        and, when restoring wins, write the payloads into fresh blocks,
        heal the nodes back to resident and hand the longer match to the
        admission. An injected host-tier fault (or a payload the tier's
        budget dropped) drops the spilled run inside its own failure
        domain and the admission re-prefills it; resident blocks are
        untouched. Returns ``(matched, blocks)``."""
        ext_matched, chain = self.index.walk(seq)
        spilled = [n for n in chain if n.block == SPILLED_BLOCK]
        gain = ext_matched - matched
        if not spilled or gain <= 0:
            return matched, mblocks
        self._drain_spills()  # the payloads must be in the host tier
        if self.injector is not None and self.injector.host_tier_fault():
            # the shallowest spilled node's subtree, the whole spilled run,
            # is the failure domain: drop it and re-prefill
            self.index.invalidate_spilled(spilled[0].sid)
            self.metrics.restore_fallbacks += 1
            return matched, mblocks
        payloads = []
        for node in spilled:
            p = self.host_tier.get(node.sid)
            if p is None:
                self.metrics.restore_fallbacks += 1
                return matched, mblocks
            payloads.append(p)
        total_bytes = sum(t.numel() * t.element_size() for p in payloads for t in p)
        restore_s, recompute_s = self._restore_price(total_bytes, gain)
        xo = self.paged.restore_crossover
        alloc = self.allocator
        if xo <= 0 or restore_s > xo * recompute_s or alloc.available() < len(spilled) + 1:
            self.metrics.restore_declined += 1
            return matched, mblocks
        t0 = time.perf_counter()
        # hold the chain's resident blocks, so that our own allocations
        # cannot evict them; restored blocks join the held list, and all
        # are released (parked cached) once the chain is healed
        held: List[int] = []
        for node in chain:
            if node.block >= 0:
                alloc.incref(node.block)
                held.append(node.block)
        ok = True
        n_restored = 0
        for node, payload in zip(spilled, payloads):
            if node.sid not in self.index._spilled:
                ok = False
                break
            nb = alloc.alloc()
            if nb is None:
                ok = False
                break
            self._restore_block(node.sid, nb, payload)
            self.index.heal(node, nb)  # drops the host payload too
            held.append(nb)
            n_restored += 1
        for b in held:
            alloc.release(b)
        if not ok:
            self.metrics.restore_fallbacks += 1
            return matched, mblocks
        self.metrics.blocks_restored += n_restored
        self.metrics.restore_hits += 1
        self.metrics.restore_bytes += total_bytes
        self.index.hit_tokens += gain  # restored tokens are prefix hits
        self.tracer.complete(
            "restore", t0, time.perf_counter(), blocks=n_restored, bytes=total_bytes,
            tokens=gain,
        )
        self._emit_action(ActionType.RESTORE, lanes=[], blocks=n_restored, tokens=gain)
        return ext_matched, [n.block for n in chain]

    # -- admission and prefill ----------------------------------------------

    def _reorder_queue(self, order: Sequence[int]) -> None:
        """Reorder the waiting queue to ``order``, a ranking of rids (an
        ADMIT's ``admit_order``). Rids no longer queued are ignored;
        queued requests ``order`` leaves out keep their FCFS order behind
        the ranked ones, so a policy can promote a request but not lose
        one."""
        by_rid = {r.rid: r for r in self._queue}
        ranked = [by_rid.pop(rid) for rid in order if rid in by_rid]
        self._queue = ranked + [r for r in self._queue if r.rid in by_rid]

    def _admit(self) -> None:
        """Admission wave, recorded as one ADMIT action."""
        if not (self._queue and self._free_lanes):
            return
        lanes_before = set(self._active)
        try:
            self._admit_wave()
        finally:
            # a lane admitted-and-finished inside the wave is absent here;
            # its FINISH record (already emitted) carries the lane id
            self._emit_action(
                ActionType.ADMIT,
                lanes=sorted(set(self._active) - lanes_before),
                waiting=len(self._queue),
            )

    def _admit_wave(self) -> None:
        bs = self.paged.block_size
        alloc = self.allocator
        while self._queue and self._free_lanes:
            req = self._queue[0]
            seq = req.prompt + req.out  # resume re-prefills generated tokens
            if self.paged.enable_prefix_caching:
                matched, mblocks = self.index.match(seq)
                if self._spill and self.index.num_spilled:
                    # the walk may run past the resident prefix into
                    # spilled nodes: restore them when the bytes beat
                    # re-prefilling
                    matched, mblocks = self._maybe_restore(seq, matched, mblocks)
            else:
                matched, mblocks = 0, []
            # always leave >= 1 token to prefill: the admission forward must
            # produce the logits at the last position
            cached = min(matched, len(seq) - 1)
            n_total = _ceil_div(len(seq), bs)
            n_shared_full = cached // bs
            need_new = (n_total - n_shared_full) + self.paged.decode_reserve_blocks
            if alloc.available() < need_new:
                self.metrics.admit_blocked += 1
                return  # FCFS head-of-line: wait for blocks to drain
            self._queue.pop(0)
            # take shared refs BEFORE allocating, so our own allocations
            # cannot evict the blocks we are about to use
            table = list(mblocks[: _ceil_div(cached, bs)])
            for b in table:
                alloc.incref(b)
            ok = True
            if cached % bs:
                # partially shared last block: the suffix's first write lands
                # inside it -> move onto a private copy now
                src = table[-1]
                wb, copied = alloc.copy_on_write(src)
                if wb is None:
                    ok = False
                else:
                    if copied:
                        self._copy_block(src, wb)
                    table[-1] = wb
            while ok and len(table) < n_total:
                nb = alloc.alloc()
                if nb is None:
                    ok = False
                else:
                    table.append(nb)
            if not ok:
                # lost the budget race (should not happen: available() was
                # checked); back off cleanly and retry next step
                for b in table:
                    alloc.release(b)
                self._queue.insert(0, req)
                return
            lane = self._free_lanes.pop(0)
            req.lane = lane
            req.table = table
            req.cached_tokens += cached
            self._tables[lane, :] = NULL_BLOCK
            self._active[lane] = req
            # on-device sampling: (re-)install the lane's parameters and base
            # key before any prefill of this admission draws from them
            self._install_lane_sampling(lane, req)
            self.metrics.admitted += 1
            self.metrics.cached_tokens += cached
            if req.admitted_at is None:  # queue_ms = first admission wait
                req.admitted_at = time.perf_counter()
            self.tracer.request_state(req.rid, "prefilling")
            chunk = self.paged.prefill_chunk_tokens
            if (chunk and len(seq) - cached > chunk) or (
                self._fused_step and cached > 0
            ):
                # chunked admission: the lane holds its blocks but joins the
                # decode batch only after the final chunk. Until then its
                # decode-visible table row stays all-null: the batched
                # decode writes K/V for every lane, and a live row would let
                # those garbage writes land in this request's blocks
                # mid-prefill. Prefix registration waits for the last chunk
                # too, when the blocks hold valid rows.
                #
                # Fused mixed-mode step: every cached-prefix admission takes
                # this route (the suffix prefill never runs) and the table
                # goes live at once, since the mixed step reads and writes
                # the chunk rows through it. A garbage row a batched step
                # writes is rewritten by the dispatch that first admits it
                # into a mask, and rows past the allocation land in the
                # null block
                req.prefilling = True
                req.prefill_pos = cached
                req.prefill_target = len(seq)
                self._tokens[lane] = 0
                self._positions[lane] = 0
                if self._fused_step:
                    self._tables[lane, : len(table)] = table
                    # park the resident write row past the prompt: row 0 of
                    # a live table can be a shared prefix block, and every
                    # batched step writes garbage at every lane's resident
                    # row; prefill_target's row is private (or null past
                    # the allocation) and decode overwrites it first
                    self._positions[lane] = req.prefill_target
                self._dirty_lanes.add(lane)
                continue
            suffix = seq[cached:]
            t_p = time.perf_counter()
            try:
                self._chaos_device("prefill", (lane,))
                first = self._prefill(suffix, cached, table, lane=lane)
            except InjectedFault as fault:
                # an admission prefill fault: only this request dies, and its
                # teardown leaves the admission wave consistent
                self._fail_request(req, str(fault))
                continue
            t_p1 = time.perf_counter()
            req.prefill_ms += (t_p1 - t_p) * 1e3
            self.tracer.complete("prefill", t_p, t_p1, rid=req.rid, tokens=len(suffix),
                                 cached=cached)
            req.out.append(first)
            req.position = len(seq)
            self._note_first_token(req)
            self.tracer.request_state(req.rid, "active")
            self._tokens[lane] = first
            self._positions[lane] = req.position
            self._tables[lane, : len(table)] = table
            self._dirty_lanes.add(lane)
            self.metrics.prefill_tokens += len(suffix)
            if self.paged.enable_prefix_caching:
                # register the prompt's full blocks immediately so requests
                # admitted later in this same wave share them; the partial
                # tail block stays private (decode writes into it)
                n_full = len(seq) // bs
                if n_full:
                    self.index.insert(seq[: n_full * bs], table[:n_full])
            self._maybe_finish(req)

    def _prefill(
        self, suffix: List[int], cached: int, table: List[int], table_dev=None,
        lane: Optional[int] = None,
    ) -> int:
        """Run one (whole or chunk) prefill and read its sampled token back:
        the whole prompt (``pctx``, plain-torch attention over the fresh
        block) when nothing is cached, else the suffix after the cached
        prefix (``psfx``, attending the earlier rows through the table).
        The payload (ids, start, length and the table row; under on-device
        sampling ``lane``'s sampling mirrors, :meth:`_upload_lane_sampling`)
        lands in the family's static buffers and the key's record runs.
        ``table_dev`` is the (1, W) table row already on the device (a chunk
        walk uploads it once), copied into the static row."""
        eng = self.engine
        kind = "pctx" if cached == 0 else "psfx"
        inputs = self._family_inputs(kind)
        bucket = pick_bucket(self._prefill_buckets, max(len(suffix), 1))
        ids = np.zeros((1, bucket), np.int32)
        ids[0, : len(suffix)] = suffix
        length = max(len(suffix), 1)
        if table_dev is None:
            tbl = np.full((1, self.table_width), NULL_BLOCK, np.int32)
            tbl[0, : len(table)] = table
            self._upload_into(inputs["table"], tbl)
        else:
            inputs["table"].copy_(table_dev)
        self._upload_into(inputs["ids"][:, :bucket], ids)
        self._upload_into(inputs["length"], [length])
        if self._fused:
            self._upload_lane_sampling(inputs, lane)
        if cached == 0:
            key_ = ("pctx", bucket, self._decode_cfg(), self._gather_shed())
        else:
            kv_limit = self._kv_bucket(min(cached + bucket, eng.max_seq_len))
            self._upload_into(inputs["start"], [cached])
            key_ = ("psfx", bucket, kv_limit, self._decode_cfg(), self._gather_shed())
        (tok,) = self._program(key_)()
        self.metrics.note_prefill_dispatch(bucket, length, *self._dispatch_cost(key_))
        return int(self._read_tokens(tok)[0])

    def _advance_prefills(self, budget_tokens: Optional[int] = None) -> None:
        """One chunk per prefilling lane per step (Sarathi-Serve chunked
        prefill). Each chunk is a prefill starting at ``prefill_pos``: the
        first of an uncached prompt through the whole-prompt path, the rest
        through the suffix path, attending the earlier chunks through the
        table. A non-final chunk's sampled token is discarded; bucket
        padding is safe because padded writes land at rows a later chunk
        overwrites before any mask admits them.

        ``budget_tokens`` (a PREFILL_CHUNK's meta, from the SLO-aware
        policy) caps the wave's prefill tokens: once one chunk ran and the
        budget is spent, the other prefilling lanes wait for the next step,
        so a budget paces prefill and never starves it. It does not change
        a chunk's size, so every chunk still lands on a catalog key. None
        (FIFO's) is the unbounded wave."""
        chunk = self.paged.prefill_chunk_tokens
        bs = self.paged.block_size
        spent = 0
        for lane, req in list(self._active.items()):
            if not req.prefilling:
                continue
            if budget_tokens is not None and spent > 0 and spent >= budget_tokens:
                break
            seq = req.prompt + req.out
            start = req.prefill_pos
            piece = seq[start: start + chunk]
            final = start + len(piece) >= req.prefill_target
            if req.table_dev is None:
                # one upload for the whole chunk walk: the admission
                # allocated the full table, so every chunk sees the same row
                tbl = np.full((1, self.table_width), NULL_BLOCK, np.int32)
                tbl[0, : len(req.table)] = req.table
                req.table_dev = self._upload(tbl)
            t_p = time.perf_counter()
            try:
                self._chaos_device("prefill", (lane,))
                tok = self._prefill(piece, start, req.table, req.table_dev, lane=lane)
            except InjectedFault as fault:
                # a chunk fault: this lane's walk dies, the other lanes are
                # untouched
                self._fail_request(req, str(fault))
                continue
            t_p1 = time.perf_counter()
            req.prefill_ms += (t_p1 - t_p) * 1e3
            self.tracer.complete("prefill_chunk", t_p, t_p1, rid=req.rid,
                                 tokens=len(piece), final=final)
            req.prefill_pos = start + len(piece)
            spent += len(piece)
            self.metrics.prefill_tokens += len(piece)
            self.metrics.prefill_chunks += 1
            self._emit_action(
                ActionType.PREFILL_CHUNK, rid=req.rid, lane=lane,
                tokens=len(piece), final=final,
            )
            if not final:
                continue
            # final chunk: sample the first token, install the real table
            # into the decode batch, register the prompt for prefix sharing
            req.prefilling = False
            req.table_dev = None
            req.out.append(tok)
            req.position = req.prefill_target
            self._note_first_token(req)
            self.tracer.request_state(req.rid, "active")
            self._tokens[lane] = tok
            self._positions[lane] = req.position
            self._tables[lane, : len(req.table)] = req.table
            self._dirty_lanes.add(lane)
            if self.paged.enable_prefix_caching:
                n_full = len(seq) // bs
                if n_full:
                    self.index.insert(seq[: n_full * bs], req.table[:n_full])
            self._maybe_finish(req)

    # -- decode -----------------------------------------------------------

    def _preempt(self, req: _PagedRequest, shed: bool = False) -> None:
        """Pool exhausted: bump the request back to the queue head. Its
        registered prefix blocks park in the cached LRU, so re-admission
        usually re-shares them instead of re-prefilling from scratch. A
        pool-pressure preemption is a degradation-ladder event; the top
        rung's own load shedding (``shed=True``) is not, so that shedding
        does not climb the ladder again."""
        lane = req.lane
        self._release_lane(req)
        req.position = 0
        # a victim caught mid-chunked-prefill restarts its prefill from the
        # (possibly re-matched) cached prefix on re-admission
        req.prefilling = False
        req.prefill_pos = 0
        req.prefill_target = 0
        self._queue.insert(0, req)
        req.preemptions += 1
        self.metrics.preemptions += 1
        self._emit_action(ActionType.PREEMPT, rid=req.rid, lane=lane, shed=shed)
        self.tracer.instant("preempt", rid=req.rid, shed=shed)
        self.tracer.request_state(req.rid, "preempted")
        if not shed:
            self._note_event()  # sustained pool pressure feeds the ladder
        logger.debug(
            "preempted request %d (pool exhausted): %d generated so far",
            req.rid, len(req.out),
        )
        if self.paged.audit_debug:
            self._audit(strict=True)

    def _ensure_decode_blocks(self) -> None:
        """Every active lane's next write row must be backed by a real
        block; allocate on block boundaries, preempting the youngest active
        request when the pool (free + evictable) runs dry."""
        bs = self.paged.block_size
        for lane in sorted(self._active, key=lambda l: self._active[l].rid):
            req = self._active.get(lane)
            if req is None:
                continue  # preempted while servicing an older lane
            if req.prefilling:
                continue  # admission already allocated the whole-prompt table
            if int(self._positions[lane]) // bs < len(req.table):
                continue
            while True:
                nb = self.allocator.alloc()
                if nb is not None:
                    self._append_block(lane, req, nb)
                    break
                victim = max(self._active.values(), key=lambda r: r.rid)
                self._preempt(victim)
                if victim is req:
                    break  # preempted ourselves; nothing left to back

    def _ensure_decode_blocks_async(self) -> bool:
        """The async dispatch's :meth:`_ensure_decode_blocks`, without
        preempting: back every decode lane's next write row from the pool
        (evicting cached LRU blocks is host bookkeeping), but report False
        where that would need an active lane preempted, so that the step
        drops to the synchronous sequence, which drains the in-flight step
        first and preempts with a consistent view."""
        bs = self.paged.block_size
        for lane in sorted(self._active, key=lambda l: self._active[l].rid):
            req = self._active[lane]
            if req.prefilling:
                continue
            if int(self._positions[lane]) // bs < len(req.table):
                continue
            nb = self.allocator.alloc()
            if nb is None:
                return False  # pool dry: preemption needed -> sync fallback
            self._append_block(lane, req, nb)
        return True

    def _append_block(self, lane: int, req: _PagedRequest, nb: int) -> None:
        req.table.append(nb)
        col = len(req.table) - 1
        self._tables[lane, col] = nb
        self._table_delta_list.append((lane, col, nb))

    def _finish_due(self, req: _PagedRequest) -> bool:
        eos = self.gen.eos_token_id
        return (
            req.done
            or (eos is not None and bool(req.out) and req.out[-1] == eos)
            or len(req.out) >= self.gen.max_new_tokens
        )

    def _maybe_finish(self, req: _PagedRequest) -> None:
        if not self._finish_due(req) or req.rid in self._finished:
            return
        req.done = True
        bs = self.paged.block_size
        if self.paged.enable_prefix_caching and req.table:
            # cache the whole materialized sequence (prompt + generated):
            # rows [0, position) are valid — the final token's KV was never
            # written, so it is excluded
            seq = (req.prompt + req.out)[: req.position]
            self.index.insert(seq, req.table[: _ceil_div(req.position, bs)])
        lane = req.lane
        if req.lane is not None:
            self._release_lane(req)
        self._emit_action(ActionType.FINISH, rid=req.rid, lane=lane, failed=False)
        self._finished[req.rid] = req
        self.metrics.finished += 1
        self._note_terminal(req)
        self.tracer.request_state(req.rid, "finished")
        if self.paged.audit_debug:
            self._audit(strict=True)

    def _flush_state(self) -> None:
        """Push queued host-side lane mutations into the device-resident
        arrays, in place: single block-table entries from decode growth,
        then whole lanes that were admitted, finished or preempted. A table
        delta is a scalar write into the resident, queued behind any step
        in flight without blocking the host, so deltas may go out while a
        lookahead runs; a full-lane sync uploads from host memory, which
        would wait for it, and runs only with no step pending (lanes are
        dirtied only by scheduler events, which drain first)."""
        in_flight = self._pending is not None
        if self._table_delta_list:
            self._emit_action(
                ActionType.TABLE_DELTA_FLUSH, n=len(self._table_delta_list),
                in_flight=in_flight,
            )
            for lane, col, val in self._table_delta_list:
                if lane in self._dirty_lanes:
                    continue  # the full-lane sync below rewrites the row
                self._d_tables[lane, col] = val
                self.metrics.h2d_uploads += 1
                self.metrics.table_deltas += 1
            self._table_delta_list.clear()
        if self._dirty_lanes:
            if in_flight:
                raise RuntimeError("full-lane sync with a step in flight")
            lanes = sorted(self._dirty_lanes)
            self._emit_action(ActionType.LANE_SET_FLUSH, lanes=lanes, in_flight=False)
            idx = self._upload(lanes, torch.long)
            self._d_tokens[idx] = self._upload(self._tokens[lanes])
            self._d_positions[idx] = self._upload(self._positions[lanes])
            self._d_tables[idx] = self._upload(self._tables[lanes])
            if self._fused:
                # the sampling residents change only here, so a sampled
                # steady-state step uploads nothing
                self._d_temps[idx] = self._upload(self._temps[lanes], torch.float32)
                self._d_topks[idx] = self._upload(self._topks[lanes])
                self._d_topps[idx] = self._upload(self._topps[lanes], torch.float32)
                self._d_rng[idx] = self._upload(
                    self._rng[lanes].astype(np.int64), torch.int64
                )
            self.metrics.lane_syncs += len(lanes)
            self._dirty_lanes.clear()

    def _commit_tokens(
        self, arr: np.ndarray, fin: Optional[np.ndarray], lanes: List[int],
        finishing: List[_PagedRequest], quarantined: List[_PagedRequest],
        dead: frozenset = frozenset(),
    ) -> None:
        """Append one decode step's token to each of ``lanes``' requests
        and note the ones now due to finish. A lane in ``dead`` finished
        (or was quarantined) one step earlier: its lookahead token is
        discarded and its frontier mirror stepped back (the lame-duck
        drain). A lane whose checked logits were not finite (``fin``)
        commits nothing and is noted in ``quarantined``."""
        for lane in lanes:
            if lane in dead:
                self.metrics.lame_duck_tokens += 1
                self._positions[lane] -= 1
                continue
            req = self._active.get(lane)
            if req is None:
                continue  # lane torn down between dispatch and readback
            if fin is not None and not bool(fin[lane]):
                quarantined.append(req)
                continue
            req.out.append(int(arr[lane]))
            req.position += 1
            self._tokens[lane] = arr[lane]
            if req.position >= self.engine.max_seq_len - 1:
                req.done = True
            if self._finish_due(req):
                finishing.append(req)

    def _read_pending(self, pending: tuple) -> tuple:
        """``(tokens, finite or None, lanes)`` of a pending readback, read
        back (the finite flags after the tokens' event, through the same
        funnel), and the readback lag noted."""
        host, ready, lanes, idx, host_fin = pending
        arr = self._read_tokens(host, ready)
        fin = None if host_fin is None else self._read_tokens(host_fin)
        self._last_readback_lag = self._dispatch_count - idx
        return arr, fin, lanes

    def _read_and_apply(self, pending: tuple) -> None:
        """Read one decode dispatch's tokens (``pending``, from
        :meth:`_snapshot`) and advance request state. If a lane finished,
        the lookahead step in flight, if any, is its lame-duck step: it is
        read too and applied to the surviving lanes (for them an ordinary
        step), the finished lanes' tokens from it are discarded, and only
        then are the finished lanes' blocks released: stream order puts
        the lame-duck step's KV writes before anything later that reuses
        those blocks. A lane whose checked dispatch reported non-finite
        logits commits nothing and is quarantined like a finishing lane:
        the lookahead, dispatched from its garbage token, is its lame-duck
        step, and its request fails."""
        arr, fin, lanes = self._read_pending(pending)
        finishing: List[_PagedRequest] = []
        quarantined: List[_PagedRequest] = []
        self._commit_tokens(arr, fin, lanes, finishing, quarantined)
        self._emit_action(ActionType.READBACK, lanes=list(lanes), lag=self._last_readback_lag)
        if (finishing or quarantined) and self._pending is not None:
            arr2, fin2, lanes2 = self._read_pending(self._pending)
            self._pending = None
            dead = frozenset(r.lane for r in finishing + quarantined)
            self._commit_tokens(arr2, fin2, lanes2, finishing, quarantined, dead=dead)
            self._emit_action(
                ActionType.READBACK, lanes=list(lanes2),
                lag=self._last_readback_lag, lame_duck=True,
            )
        for req in finishing:
            self._maybe_finish(req)
        for req in quarantined:
            self._quarantine(req, "decode")

    def _drain_pending(self) -> None:
        """Retire the lookahead step in flight, if any, before the scheduler
        changes lane state: after it the readback lag is 0 and full-lane
        syncs are legal again."""
        if self._pending is None:
            return
        pending, self._pending = self._pending, None
        self._read_and_apply(pending)

    def _async_eligible(self) -> bool:
        """Steady state: nothing for the scheduler to do this step but
        advance the decode lanes (no waiting request, no lane
        mid-prefill)."""
        if self._queue or not self._active:
            return False
        return not any(r.prefilling for r in self._active.values())

    def _dispatch_decode(self, mode: str) -> tuple:
        """Flush lane state and dispatch one T=1 step over every decode
        lane (``mode`` "sync" or "async", for the action trace), the chaos
        funnel before it. Returns the step's pending readback
        (:meth:`_snapshot`)."""
        self._flush_state()
        decode_lanes = [l for l, r in self._active.items() if not r.prefilling]
        self._chaos_device("decode", decode_lanes)
        kv_need = int(max(self._positions[l] for l in decode_lanes)) + 1
        kv_limit = self._kv_bucket(kv_need)
        key_ = ("pdecode", self._decode_cfg(), kv_limit, self._gather_shed(), self._check_logits)
        self.metrics.note_decode_dispatch(kv_limit, kv_need, *self._dispatch_cost(key_))
        smode = self._note_sampling_dispatch()
        if self._check_logits:
            self._nan_mask("pdecode", decode_lanes, "decode")
        t_d = self.tracer.now()
        toks, *finite = self._program(key_)()
        self._trace_dispatch(t_d, key_, mode, smode, len(decode_lanes), kv_limit)
        self._dispatch_count += 1
        self._emit_action(
            ActionType.DECODE_DISPATCH, mode=mode, lanes=list(decode_lanes), kv=kv_limit,
        )
        for lane in decode_lanes:
            self._positions[lane] += 1  # mirror the on-device advance
        self.metrics.decode_steps += 1
        return self._snapshot(toks, decode_lanes, *finite)

    def _step_async(self) -> bool:
        """One lookahead decode step: dispatch step N+1 from the
        device-resident state alone (no host-to-device upload unless a
        lane grew a block), then read back step N, which the device
        finished while the host scheduled, for the finish checks one step
        late."""
        prev, self._pending = self._pending, self._dispatch_decode("async")
        self.metrics.decode_steps_async += 1
        if prev is not None:
            self._read_and_apply(prev)
        return bool(self._active or self._queue)

    def _dispatch_sync_decode(self) -> bool:
        """The decode tail of a synchronous step: back the write rows,
        flush lane state, run one T=1 step over every lane and read it
        back. A lane mid-way through a chunked prefill rides the batched
        step with its all-null table (its write lands in the null block)
        and is not a decode lane: its sampled token is dropped and its
        position kept."""
        if not any(not r.prefilling for r in self._active.values()):
            return bool(self._active or self._queue)
        self._ensure_decode_blocks()
        if all(r.prefilling for r in self._active.values()):
            return bool(self._active or self._queue)  # re-admit next step
        self._read_and_apply(self._dispatch_decode("sync"))
        return bool(self._active or self._queue)

    # -- speculative decoding and the fused mixed-mode step ------------------

    def _collect_drafts(self) -> tuple:
        """Ask the drafter for up to ``spec_draft_tokens`` proposals per
        decode-ready lane: ``(proposals, tree parents)``, ``lane -> tokens``
        and, under ``spec_tree``, ``lane -> parents``, the lane's packed
        candidate tree (token ``i`` is node ``i + 1``, ``parents[i]`` its
        parent's index, 0 the resident root; a drafter without
        ``propose_tree`` proposes its chain, token-identical to linear
        speculation). A lane abstains when the drafter finds nothing, when
        it is spec-disabled, or when fewer than two tokens remain (a plain
        step finishes it anyway). Draft counts, and a tree's node count,
        which bounds its depth, are clamped so that acceptance never
        overshoots ``max_new_tokens``, which with submit()'s capacity
        check keeps every committed row below ``max_seq_len``."""
        k = self._spec_k
        propose_tree = (
            getattr(self.drafter, "propose_tree", None) if self._spec_tree else None
        )
        proposals: Dict[int, List[int]] = {}
        tree_parents: Dict[int, List[int]] = {}
        for lane, req in self._active.items():
            if req.prefilling or req.spec_disabled:
                continue
            remaining = self.gen.max_new_tokens - len(req.out)
            limit = min(k, remaining - 1)
            if limit < 1:
                continue
            history = req.prompt + req.out
            try:
                if self.injector is not None:
                    self.injector.drafter_fault()
                if propose_tree is not None:
                    drafts, parents = propose_tree(
                        history, limit, self.paged.spec_tree_branches
                    )
                else:
                    drafts = self.drafter.propose(history, limit)
                    parents = range(len(drafts))
            except Exception as exc:  # noqa: BLE001 -- drafting is advisory
                # a drafter bug costs this lane its speculation for one
                # step, never the request: the lane takes a plain step
                self.metrics.drafter_faults += 1
                self._note_event()
                logger.warning("drafter failed for request %d: %s", req.rid, exc)
                continue
            if drafts:
                # a trailing trim keeps a tree: parents precede children
                proposals[lane] = list(drafts[:limit])
                if self._spec_tree:
                    tree_parents[lane] = list(parents[:limit])
        return proposals, tree_parents

    def _prepare_spec_blocks(self, proposals: Dict[int, List[int]]) -> None:
        """Back each drafting lane's verify-write rows (``position ..
        position + draft_len``) with real blocks without preempting:
        evicting cached LRU blocks is fine, but when the pool runs dry the
        draft is trimmed to the rows already backed (down to a plain
        decode). Rows past ``draft_len`` stay null-backed, and ``accept <=
        draft_len`` keeps every accepted query inside the backed
        frontier. A tree's node ``j`` is written at row ``position + j``
        too, and a trailing trim keeps it a tree: parents precede
        children."""
        bs = self.paged.block_size
        for lane in sorted(proposals):
            req = self._active[lane]
            need = (int(self._positions[lane]) + len(proposals[lane])) // bs + 1
            while len(req.table) < need:
                nb = self.allocator.alloc()
                if nb is None:
                    break
                self._append_block(lane, req, nb)
            backed = len(req.table) * bs - 1 - int(self._positions[lane])
            if backed < len(proposals[lane]):
                if backed < 1:
                    del proposals[lane]
                else:
                    proposals[lane] = proposals[lane][:backed]

    def _commit_accepted(
        self, req: _PagedRequest, lane: int, emitted: np.ndarray, a: int,
        drafted: int, finishing: List[_PagedRequest], tree_shape: str = "",
    ) -> None:
        """Commit one decode lane's verify outcome: ``a`` accepted drafts of
        ``drafted`` plus the correction token, the host mirrors advanced as
        the device advanced them, and the spec-disable heuristic. A tree
        verify names its packed width in ``tree_shape`` (``"t32"``), under
        which the accept is also counted."""
        cfg = self.paged
        self.metrics.accepted_tokens += a
        if drafted:
            self.metrics.hist_accept_len.observe(a)
            if tree_shape:
                self.metrics.note_tree_accept(tree_shape, a)
        req.spec_drafted += drafted
        req.spec_accepted += a
        self._positions[lane] += a + 1  # mirror the on-device advance
        for j in range(a + 1):
            req.out.append(int(emitted[lane, j]))
            req.position += 1
            self._tokens[lane] = emitted[lane, j]
            if req.position >= self.engine.max_seq_len - 1:
                req.done = True
            if self._finish_due(req):
                # EOS (or a cap) inside the accepted run: the committed
                # device rows past it are moot, the finish resets the lane
                break
        if self._finish_due(req):
            finishing.append(req)
        elif (
            not req.spec_disabled
            and req.spec_drafted >= cfg.spec_probation_tokens
            and req.spec_accepted < cfg.spec_min_accept_rate * req.spec_drafted
        ):
            req.spec_disabled = True
            self.metrics.spec_disabled_lanes += 1

    def _verify_phase(self) -> bool:
        """The VERIFY action: one verify dispatch
        (:meth:`..inference.model.LlamaDecode.verify_step`) for every
        decode lane. Drafting lanes advance by their on-device accept
        length + 1; lanes whose drafter abstained carry ``draft_len`` 0 and
        take a plain greedy decode step. Returns whether anything was
        dispatched: False (the drafter abstained everywhere, or backing
        preempted every drafting lane) lets the policy schedule a plain
        decode instead. Under ``spec_tree`` each lane's draft is a packed
        tree (:meth:`..inference.model.LlamaDecode.tree_verify_step`), and
        accept lengths are root-path depths."""
        proposals, tree_parents = self._collect_drafts()
        if proposals:
            self._prepare_spec_blocks(proposals)
        if proposals:
            self._ensure_decode_blocks()
            # base-row backing may have preempted drafting lanes (youngest
            # first); their proposals die with them
            proposals = {
                l: d for l, d in proposals.items()
                if self._active.get(l) is not None
                and not self._active[l].prefilling
            }
        if not proposals:
            return False
        decode_lanes = [l for l, r in self._active.items() if not r.prefilling]
        self._chaos_device("verify", decode_lanes)
        self._flush_state()
        eng = self.engine
        k = self._spec_k
        draft_len = np.zeros((eng.max_batch,), np.int32)
        drafts = np.zeros((eng.max_batch, k), np.int32)
        # node space of a tree: node j >= 1 is drafts[j - 1], node 0 the root
        parents = np.zeros((eng.max_batch, k + 1), np.int32)
        for lane, d in proposals.items():
            drafts[lane, : len(d)] = d
            draft_len[lane] = len(d)
            if self._spec_tree:
                parents[lane, 1 : 1 + len(d)] = tree_parents[lane][: len(d)]
        kv_need = int(max(self._positions[l] for l in decode_lanes)) + k + 1
        kv_limit = self._kv_bucket(kv_need)
        kind = "ptree" if self._spec_tree else "pverify"
        key_ = (kind, kv_limit, k, self._gather_shed(), self._check_logits)
        self.metrics.note_decode_dispatch(kv_limit, kv_need, *self._dispatch_cost(key_))
        smode = self._note_sampling_dispatch()
        # the payload lands before the lookup: a late capture's warm-up
        # call then writes the rows the replay writes
        inputs = self._family_inputs(kind)
        t_d = self.tracer.now()
        self._upload_into(inputs["drafts"], drafts)
        if self._spec_tree:
            self._upload_into(inputs["parents"], parents)
            self._upload_into(inputs["node_len"], draft_len + 1)
        else:
            self._upload_into(inputs["draft_len"], draft_len)
        if self._check_logits:
            self._nan_mask(kind, decode_lanes, "verify")
        emitted_d, accept_d, *finite_d = self._program(key_)()
        self._trace_dispatch(t_d, key_, "verify", smode, len(decode_lanes), kv_limit)
        self._dispatch_count += 1
        drafted = int(draft_len.sum())
        tree_meta = dict(tree=True, nodes=drafted) if self._spec_tree else {}
        self._emit_action(
            ActionType.VERIFY, lanes=list(decode_lanes), k=k,
            drafts=drafted, kv=kv_limit, **tree_meta,
        )
        self.metrics.decode_steps += 1
        self.metrics.verify_steps += 1
        self.metrics.draft_tokens += drafted
        if self._spec_tree:
            self.metrics.tree_verify_steps += 1
            self.metrics.tree_draft_tokens += drafted
        emitted = self._read_tokens(emitted_d)      # (B, k+1)
        accept = self._read_tokens(accept_d)        # (B,)
        fin = self._read_tokens(*finite_d) if finite_d else None
        self._last_readback_lag = 0
        finishing: List[_PagedRequest] = []
        quarantined: List[_PagedRequest] = []
        for lane in decode_lanes:
            if fin is not None and not bool(fin[lane]):
                # a poisoned verify: every emitted token and the accept
                # length are garbage, so the lane commits nothing
                quarantined.append(self._active[lane])
                continue
            self._commit_accepted(
                self._active[lane], lane, emitted, int(accept[lane]),
                int(draft_len[lane]), finishing,
                tree_shape=f"t{k + 1}" if self._spec_tree else "",
            )
        for req in finishing:
            self._maybe_finish(req)
        for req in quarantined:
            self._quarantine(req, "verify")
        return True

    def _mixed_phase(self) -> bool:
        """The MIXED_DISPATCH action (``fused_step``): one
        :meth:`..inference.model.LlamaDecode.mixed_step` dispatch advances
        every lane this step. Prefilling lanes consume their next chunk as
        forced rows (a non-final chunk's sampled row is discarded; the
        final chunk's is the request's first token, and the step itself
        installs the lane's resident token and position); decode lanes
        ride as verify rows over the same grid (no drafts: a plain decode
        row). Returns whether it dispatched: False (no lane is mid-prefill,
        or backing preempted them all) lets the policy schedule the plain
        verify or decode tail."""
        if not self._fused_step:
            return False
        if not any(r.prefilling for r in self._active.values()):
            return False
        t = self._mixed_t
        proposals: Dict[int, List[int]] = {}
        tree_parents: Dict[int, List[int]] = {}
        if self._spec_k:
            proposals, tree_parents = self._collect_drafts()
            # row 0 of a decode lane is its resident token
            proposals = {l: d[: t - 1] for l, d in proposals.items()}
            if proposals:
                self._prepare_spec_blocks(proposals)
        self._ensure_decode_blocks()
        # backing may have preempted lanes (youngest first): re-derive every
        # role from the surviving lanes
        proposals = {
            l: d for l, d in proposals.items()
            if self._active.get(l) is not None and not self._active[l].prefilling
        }
        forced_lanes = sorted(l for l, r in self._active.items() if r.prefilling)
        decode_lanes = [l for l, r in self._active.items() if not r.prefilling]
        if not forced_lanes:
            return False
        self._chaos_device("mixed", forced_lanes + decode_lanes)
        self._flush_state()
        eng = self.engine
        rows = np.zeros((eng.max_batch, t), np.int32)
        row_start = np.zeros((eng.max_batch,), np.int32)
        row_len = np.zeros((eng.max_batch,), np.int32)
        forced = np.zeros((eng.max_batch,), np.int32)
        pieces: Dict[int, tuple] = {}  # lane -> (req, start, piece, final)
        for lane in forced_lanes:
            req = self._active[lane]
            seq = req.prompt + req.out
            start = req.prefill_pos
            piece = seq[start: start + t]
            pieces[lane] = (req, start, piece, start + len(piece) >= req.prefill_target)
            rows[lane, : len(piece)] = piece
            row_start[lane] = start
            row_len[lane] = len(piece)
            forced[lane] = 1
        # a tree's parents in node space (0 = the resident root); forced
        # lanes' rows are ignored: mixed_step puts them on the chain
        parents = np.zeros((eng.max_batch, t), np.int32)
        for lane, d in proposals.items():
            rows[lane, : len(d)] = d
            row_len[lane] = len(d)
            if self._spec_tree:
                parents[lane, 1 : 1 + len(d)] = tree_parents[lane][: len(d)]
        kv_need = max(
            max(start for _, start, _, _ in pieces.values()),
            max((int(self._positions[l]) for l in decode_lanes), default=0),
        ) + t
        kv_limit = self._kv_bucket(kv_need)
        key_ = ("pmixed", t, kv_limit, self._decode_cfg(), self._gather_shed(),
                self._check_logits)
        self.metrics.note_decode_dispatch(kv_limit, kv_need, *self._dispatch_cost(key_))
        smode = self._note_sampling_dispatch()
        t_d = time.perf_counter()
        inputs = self._family_inputs("pmixed")
        payload = dict(rows=rows, row_start=row_start, row_len=row_len, forced=forced)
        if self._spec_tree:
            payload["parents"] = parents
        for name, x in payload.items():
            self._upload_into(inputs[name], x)
        if self._check_logits:
            self._nan_mask("pmixed", forced_lanes + decode_lanes, "mixed")
        emitted_d, accept_d, *finite_d = self._program(key_)()
        self._trace_dispatch(
            t_d, key_, "mixed", smode, len(decode_lanes) + len(forced_lanes), kv_limit,
        )
        self._dispatch_count += 1
        self.metrics.mixed_dispatches += 1
        self._emit_action(
            ActionType.MIXED_DISPATCH,
            lanes=list(decode_lanes), prefill_lanes=list(forced_lanes),
            drafts=sum(len(d) for d in proposals.values()), kv=kv_limit,
        )
        if decode_lanes:
            self.metrics.decode_steps += 1
        if proposals:
            drafted = sum(len(d) for d in proposals.values())
            self.metrics.verify_steps += 1
            self.metrics.draft_tokens += drafted
            if self._spec_tree:
                self.metrics.tree_verify_steps += 1
                self.metrics.tree_draft_tokens += drafted
        emitted = self._read_tokens(emitted_d)      # (B, t)
        accept = self._read_tokens(accept_d)        # (B,)
        fin = self._read_tokens(*finite_d) if finite_d else None
        self._last_readback_lag = 0
        wall_ms = (time.perf_counter() - t_d) * 1e3
        bs = self.paged.block_size
        finishing: List[_PagedRequest] = []
        quarantined: List[_PagedRequest] = []
        for lane, (req, start, piece, final) in pieces.items():
            if fin is not None and not bool(fin[lane]):
                quarantined.append(req)
                continue
            req.prefill_pos = start + len(piece)
            req.prefill_ms += wall_ms
            self.metrics.prefill_tokens += len(piece)
            self.metrics.prefill_chunks += 1
            if not final:
                # the device resident moved to (a discarded draw, the next
                # chunk's start); the next forced dispatch keys off the
                # uploaded row_start, so the host mirror stays parked
                continue
            # final chunk: the step wrote the lane's resident (token,
            # position); mirror them, commit the first token, register the
            # prompt for prefix sharing
            tok = int(emitted[lane, len(piece) - 1])
            req.prefilling = False
            req.table_dev = None
            req.out.append(tok)
            req.position = req.prefill_target
            self._note_first_token(req)
            self.tracer.request_state(req.rid, "active")
            self._tokens[lane] = tok
            self._positions[lane] = req.position
            if self.paged.enable_prefix_caching:
                seq = req.prompt + req.out[:-1]
                n_full = len(seq) // bs
                if n_full:
                    self.index.insert(seq[: n_full * bs], req.table[:n_full])
            if self._finish_due(req):
                finishing.append(req)
        for lane in decode_lanes:
            if fin is not None and not bool(fin[lane]):
                quarantined.append(self._active[lane])
                continue
            self._commit_accepted(
                self._active[lane], lane, emitted, int(accept[lane]),
                int(row_len[lane]), finishing,
                tree_shape=f"t{t}" if self._spec_tree else "",
            )
        for req in finishing:
            self._maybe_finish(req)
        for req in quarantined:
            self._quarantine(req, "mixed")
        return True

    # -- serving loop -------------------------------------------------------

    _MAX_ACTIONS_PER_STEP = 64

    def _execute_action(self, act: StepAction) -> None:
        """Run one policy-scheduled action."""
        t = act.type
        if t is ActionType.READBACK:
            self._drain_pending()
        elif t is ActionType.ADMIT:
            # a policy may rank the waiting queue before the wave; the wave
            # itself stays strict head of line over the reordered queue
            order = act.meta.get("admit_order") if act.meta else None
            if order is not None:
                self._reorder_queue(order)
            self._admit()
        elif t is ActionType.PREFILL_CHUNK:
            if self._fused_step:
                # fused mode never runs the suffix prefill: the chunk walk
                # goes through the mixed step instead
                self._last_mixed_dispatched = self._mixed_phase()
            else:
                self._advance_prefills(
                    budget_tokens=act.meta.get("budget_tokens") if act.meta else None
                )
        elif t is ActionType.VERIFY:
            self._last_verify_drafted = self._verify_phase()
        elif t is ActionType.MIXED_DISPATCH:
            self._last_mixed_dispatched = self._mixed_phase()
        elif t is ActionType.DECODE_DISPATCH and act.mode == "async":
            if self._ensure_decode_blocks_async():
                self._last_async_fell_back = False
                self._step_async()
            else:
                # pool dry: preempting changes lane state, so the policy
                # reads this and drops to the synchronous sequence
                self._last_async_fell_back = True
                self.metrics.sync_fallbacks += 1
        elif t is ActionType.DECODE_DISPATCH and act.mode == "sync":
            self._dispatch_sync_decode()
        elif t is ActionType.AUDIT:
            self._audit(strict=False)
        else:
            raise NotImplementedError(
                f"step action {t.value}[{act.mode}] is not ported to the "
                "PyTorch package yet"
            )

    def _step_inner(self) -> bool:
        # the ladder's rungs 1 and 2 are the policy's (it reads
        # view.degrade_level); rung 3 is applied at program selection
        # (_step_model), rung 4 in _update_ladder
        n = 0
        for act in self.policy.actions(self._view):
            n += 1
            if n > self._MAX_ACTIONS_PER_STEP:
                raise RuntimeError(
                    f"step policy {self.policy.name!r} exceeded "
                    f"{self._MAX_ACTIONS_PER_STEP} actions in one step"
                )
            self._execute_action(act)
        return bool(self._active or self._queue)

    def step(self) -> bool:
        """Execute one step schedule of the step policy (FIFO's: admit
        waiting requests, prefilling each inline, then advance every active
        lane one token). Pool exhaustion preempts and requeues instead of
        raising. With ``PagedConfig.async_loop`` the steady state runs one
        step ahead of its readback, so request state trails the device by
        a step until the lookahead drains. Returns False when nothing is
        left to do.

        Failure domains: an injected device fault aborts only its victim
        lane (terminal ``failed`` status, blocks released; the survivors
        redispatch from untouched state); every ``audit_interval`` steps
        the invariant auditor runs; repeated faults or sustained pool
        pressure climb the degradation ladder; a ``stall_step_limit`` raises
        :class:`.faults.EngineStalledError` instead of letting
        :meth:`run_to_completion` spin on a wedged lane."""
        t0 = time.perf_counter()
        self._wait_ms = 0.0
        self._step_index += 1
        self.metrics.engine_steps += 1
        self._step_actions = []
        self.action_trace.append(
            (self._step_index, self._pending is not None, self._step_actions)
        )
        self.tracer.begin_step(self._step_index)
        if self.injector is not None:
            self.injector.begin_step(self._step_index)
        try:
            alive = self._step_inner()
        except InjectedFault as fault:
            alive = self._recover_fault(fault)
        if self._spill_pending:
            # commit this step's spill snapshots to the host tier; nothing
            # here dispatches or uploads
            self._drain_spills()
        if self.injector is not None:
            self.metrics.faults_injected = self.injector.total_fired
        total_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.device_wait_ms += self._wait_ms
        self.metrics.host_schedule_ms += max(total_ms - self._wait_ms, 0.0)
        self.metrics.hist_step_ms.observe(total_ms)
        self.metrics.hist_queue_depth.observe(len(self._queue))
        self.metrics.queued_requests = len(self._queue)
        if self._slo is not None:
            # the burn evaluation before the ladder's update, so that an
            # alert's event (slo_degrade) lands in this step's window
            self._slo.on_step(
                self._step_index, tracer=self.tracer, note_event=self._note_event,
            )
        self._update_ladder()
        if self.paged.audit_interval and self._step_index % self.paged.audit_interval == 0:
            self._audit(strict=False)
        every = self.paged.metrics_log_every
        steps = self.metrics.decode_steps
        if every and steps and steps % every == 0 and steps != self._last_log_step:
            self._last_log_step = steps
            self.metrics.log(logger, self.allocator, self.index)
        self._check_stall()
        self.tracer.end_step(
            queue=len(self._queue), active=len(self._active),
            wait_ms=round(self._wait_ms, 3),
        )
        return alive

    def export_trace(self, path: str, fmt: str = "chrome") -> str:
        """Write the flight recorder (the last ``trace_buffer_steps`` steps
        and every request span) to ``path``: ``fmt="chrome"`` for
        trace-event JSON, ``"jsonl"`` for one event a line. Needs
        ``PagedConfig.trace_enabled`` (the file is valid but empty
        otherwise)."""
        return self.tracer.export(path, fmt=fmt)

    def run_to_completion(self) -> Dict[int, List[int]]:
        """Step until idle. Requests that failed (cancelled, faulted,
        quarantined) are included with their partial output — check
        ``request_info(rid)["status"]``. Bounded by the stall watchdog when
        ``PagedConfig.stall_step_limit`` is set."""
        while self.step():
            pass
        return {rid: r.out for rid, r in sorted(self._finished.items())}

    @staticmethod
    def _status(req: _PagedRequest) -> str:
        """Lifecycle status ∈ {queued, prefilling, active, preempted,
        finished, failed}."""
        if req.failed:
            return "failed"
        if req.done:
            return "finished"
        if req.lane is None:
            return "preempted" if req.preemptions else "queued"
        return "prefilling" if req.prefilling else "active"

    def request_tokens(self, rid: int) -> List[int]:
        """Copy of the tokens generated so far for ``rid``, in any
        lifecycle state."""
        req = self._requests.get(rid)
        if req is None:
            raise KeyError(f"unknown request id {rid}")
        return list(req.out)

    def request_info(self, rid: int) -> dict:
        """Per-request serving stats (``cached_tokens`` is the per-request
        prefix-cache report), in any lifecycle state; fields not reached
        yet are None."""
        req = self._requests.get(rid)
        if req is None:
            raise KeyError(f"unknown request id {rid}")
        ttft_ms = None
        if req.first_token_at is not None:
            ttft_ms = round((req.first_token_at - req.submitted_at) * 1e3, 3)
        tpot_ms = None
        if (
            req.finished_at is not None
            and req.first_token_at is not None
            and len(req.out) > 1
        ):
            tpot_ms = round(
                (req.finished_at - req.first_token_at) * 1e3
                / (len(req.out) - 1), 3,
            )
        queue_ms = None
        if req.admitted_at is not None:
            queue_ms = round((req.admitted_at - req.submitted_at) * 1e3, 3)
        return {
            "rid": req.rid,
            "prompt_tokens": len(req.prompt),
            "generated_tokens": len(req.out),
            "cached_tokens": req.cached_tokens,
            "preemptions": req.preemptions,
            "prefilling": req.prefilling,
            "done": req.done,
            "status": self._status(req),
            "error": req.error,
            "service_class": req.service_class,
            "tenant": req.tenant,
            "submitted_at": req.submitted_at,
            "first_token_at": req.first_token_at,
            "finished_at": req.finished_at,
            "queue_ms": queue_ms,
            "prefill_ms": round(req.prefill_ms, 3),
            "ttft_ms": ttft_ms,
            "tpot_ms": tpot_ms,
        }


def make_serving_engine(
    engine: InferenceEngine,
    gen: GenerationConfig = GenerationConfig(),
    paged: Optional[PagedConfig] = None,
    drafter: Optional[Any] = None,
    injector: Optional[FaultInjector] = None,
) -> PagedServingEngine:
    """The serving-path config flag: a :class:`PagedConfig` selects the
    paged engine (``drafter`` overrides the n-gram proposer under
    speculation; ``injector`` hooks a :class:`.faults.FaultInjector` into
    its funnels). ``paged=None`` selects the dense slot-scheduled engine
    of the JAX package, which is not ported yet and raises (with an
    injector, the JAX package's ``ValueError``). The JAX
    package's ``precompile`` argument (its ``_warmup``) has no
    counterpart: ``PagedConfig.prewarm`` captures the prefill and
    decode-time programs ahead of traffic, and the state writes are eager
    calls."""
    if paged is None:
        if injector is not None:
            raise ValueError("fault injection requires the paged engine")
        raise NotImplementedError(
            "paged=None selects the dense ContinuousBatchingEngine, which "
            "comes with the dense-engine slice of the port"
        )
    return PagedServingEngine(
        engine, gen, paged, drafter=drafter, injector=injector,
    )
