"""Invariant auditor for the paged serving engine's host-side state.

Counterpart of ``neuronx_distributed_llama3_2_tpu/serving/invariants.py``
(:class:`InvariantViolation`, :func:`summarize_violations`,
:func:`audit_engine`). The engine's correctness rests on invariants that
span its structures (block refcounts conserved across request tables, the
radix index and the allocator's free / cached partition; the host mirrors
agreeing with request bookkeeping; decode frontiers inside the pool) that
no single module can check alone. :func:`audit_engine` walks them in one
pass and returns readable violation strings ([] = clean).

Host only: nothing here reads a device tensor, so an audit never syncs and
never disturbs the async lookahead (its depth-1 lag is modelled, not
drained). The engine runs it every ``PagedConfig.audit_interval`` steps
(counted in ``ServingMetrics.audit_violations``, never raising) and
strictly at finish / preempt / fail under ``PagedConfig.audit_debug``.

Invariants checked, each against the port's own structures:

1. Pool partition: every usable block id in exactly one of {free, active
   refcounts, cached LRU} (``BlockAllocator.leak_check``).
2. Refcount conservation: each block's refcount equals the number of
   active request tables holding it.
3. Table validity: in-range, non-null ids, no duplicate within a table,
   host mirror rows matching: installed tables for decode-ready lanes,
   all-null rows for free lanes and for mid-chunked-prefill lanes (live
   rows under ``fused_step``, whose parked resident row is the prompt's
   end).
4. Lane bookkeeping: active and free lanes partition the batch;
   ``req.lane`` round-trips.
5. Frontiers: ``req.position == len(prompt + out) - 1`` for decode-ready
   lanes; the dispatch-frontier mirror leads it by the lookahead depth
   (1 while a step is in flight, else 0) and stays inside the table.
6. Radix coherence: every indexed block is registered with the allocator
   and maps back to its node; parent / child links agree.
7. Scale arrays: the pool carries k / v scales iff
   ``PagedConfig.kv_cache_dtype`` is quantized.
8. On-device sampling residents: with ``PagedConfig.on_device_sampling``
   the four residents (``_d_temps``, ``_d_topks``, ``_d_topps``,
   ``_d_rng``) exist and the host mirrors have their shapes; free lanes
   sit at the greedy sentinel with a null key, active lanes carry the
   GenerationConfig's parameters and their request's base key. Without
   the knob the four residents are None.
9. Spilled residency: with ``PagedConfig.spill_enabled`` every node of
   the radix index's spilled set carries the ``SPILLED_BLOCK`` sentinel
   (never a live pool id), round-trips through its sid, keeps its parent
   link, and has its payload somewhere: in the host tier or still queued
   for the drain. The host tier holds no more than its budget. Without
   the knob the spilled set and the drain queue are empty and there is
   no host tier (pool conservation over all four residency states, free,
   active, cached and spilled, is checks 1 and 9 together).
"""

from __future__ import annotations

from typing import List

import numpy as np

from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import (
    GREEDY_TEMPERATURE,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.block_allocator import (
    NULL_BLOCK,
)
from neuronx_distributed_llama3_2_tpu_torch.serving.radix_index import SPILLED_BLOCK


class InvariantViolation(AssertionError):
    """Raised by the engine's strict (``audit_debug``) audits; carries the
    whole violation list."""

    def __init__(self, violations: List[str]):
        self.violations = list(violations)
        super().__init__(
            f"{len(self.violations)} serving invariant violation(s): "
            + "; ".join(self.violations)
        )


def summarize_violations(violations: List[str], limit: int = 3) -> str:
    """A one-line digest of an audit for trace instants and log lines: the
    first ``limit`` violations verbatim and a count of the rest."""
    head = "; ".join(violations[:limit])
    extra = len(violations) - limit
    return head + (f"; (+{extra} more)" if extra > 0 else "")


def audit_engine(engine) -> List[str]:
    """Audit one :class:`.engine.PagedServingEngine`. Returns violation
    strings, [] when every invariant holds. Never raises, never reads a
    device tensor."""
    v: List[str] = []
    alloc = engine.allocator
    index = engine.index
    nb = alloc.num_blocks

    # 1. pool partition
    for bid in alloc.leak_check():
        v.append(f"pool partition violated at block {bid}")

    # 2. refcount conservation against the active tables
    expected: dict = {}
    for req in engine._active.values():
        for b in req.table:
            expected[b] = expected.get(b, 0) + 1
    for b, n in expected.items():
        if alloc.refcount(b) != n:
            v.append(f"block {b}: refcount {alloc.refcount(b)} != {n} table refs")
    for b, n in alloc._ref.items():
        if b not in expected:
            v.append(f"block {b}: refcount {n} but no active table holds it")

    # 3 + 4 + 5. lanes, tables, frontiers; the lookahead's lanes are the
    # third entry of the pending tuple (_snapshot)
    pending_lanes = set(engine._pending[2]) if engine._pending else set()
    max_batch = engine.engine.max_batch
    active_lanes = set(engine._active.keys())
    free_lanes = set(engine._free_lanes)
    if active_lanes & free_lanes:
        v.append(f"lanes both active and free: {sorted(active_lanes & free_lanes)}")
    if active_lanes | free_lanes != set(range(max_batch)):
        v.append(
            f"lane partition broken: active {sorted(active_lanes)} + free "
            f"{sorted(free_lanes)} != 0..{max_batch - 1}"
        )
    for lane in free_lanes - engine._dirty_lanes:
        if (engine._tables[lane] != NULL_BLOCK).any():
            v.append(f"free lane {lane}: table mirror row not all-NULL")
    for lane, req in engine._active.items():
        if req.lane != lane:
            v.append(f"lane {lane}: request {req.rid} thinks it is on lane {req.lane}")
        if len(set(req.table)) != len(req.table):
            v.append(f"rid {req.rid}: duplicate block in table {req.table}")
        for b in req.table:
            if not 1 <= b < nb:
                v.append(f"rid {req.rid}: table holds invalid block id {b}")
        row = engine._tables[lane]
        if lane in engine._dirty_lanes:
            pass  # mirror queued for rewrite; skip the row checks
        elif req.prefilling:
            if engine._fused_step:
                # the fused step prefills through the mixed grid: the table
                # row is live and the resident write row parks at
                # prefill_target until the final chunk lands
                w = len(req.table)
                if list(row[:w]) != req.table:
                    v.append(
                        f"rid {req.rid}: fused mid-prefill mirror row "
                        f"{list(row[:w])} != table {req.table}"
                    )
                if (row[w:] != NULL_BLOCK).any():
                    v.append(f"rid {req.rid}: mirror row live past table end")
                if int(engine._positions[lane]) != req.prefill_target:
                    v.append(
                        f"rid {req.rid}: fused mid-prefill resident position "
                        f"{int(engine._positions[lane])} not parked at "
                        f"prefill_target {req.prefill_target}"
                    )
            elif (row != NULL_BLOCK).any():
                v.append(
                    f"rid {req.rid}: decode-visible table row live "
                    "mid-chunked-prefill"
                )
        else:
            w = len(req.table)
            if list(row[:w]) != req.table:
                v.append(
                    f"rid {req.rid}: table mirror row {list(row[:w])} != "
                    f"table {req.table}"
                )
            if (row[w:] != NULL_BLOCK).any():
                v.append(f"rid {req.rid}: mirror row live past table end")
            want = len(req.prompt) + len(req.out) - 1
            if req.position != want:
                v.append(
                    f"rid {req.rid}: position {req.position} != "
                    f"len(prompt + out) - 1 = {want}"
                )
            lag = int(engine._positions[lane]) - req.position
            want_lag = 1 if lane in pending_lanes else 0
            if lag != want_lag:
                v.append(f"rid {req.rid}: dispatch frontier lag {lag} != {want_lag}")
            if int(engine._positions[lane]) > engine._pos_cap:
                v.append(f"rid {req.rid}: frontier past the table's last row")
            if req.position >= engine.engine.max_seq_len:
                v.append(f"rid {req.rid}: position {req.position} past max_seq_len")

    # 6. radix coherence
    for bid, node in index._by_block.items():
        if node.block != bid:
            v.append(f"radix node for block {bid} claims block {node.block}")
        if not alloc.is_registered(bid):
            v.append(f"radix-indexed block {bid} not registered in allocator")
        if node.parent is not None and node.parent.children.get(node.key) is not node:
            v.append(f"radix node for block {bid}: broken parent link")

    # 7. scale arrays match the configured pool dtype
    quant = engine.paged.kv_cache_dtype != "bf16"
    has_k = getattr(engine.cache, "k_scale", None) is not None
    has_v = getattr(engine.cache, "v_scale", None) is not None
    if quant != has_k or quant != has_v:
        v.append(
            f"kv_cache_dtype={engine.paged.kv_cache_dtype!r} but cache scale "
            f"arrays present=(k={has_k}, v={has_v})"
        )

    # 9. spilled residency (checked before 8: that one returns early)
    tier = engine.host_tier
    spilled = index._spilled
    pending_sids = {e[0] for e in engine._spill_pending}
    if not engine._spill:
        if spilled:
            v.append(f"{len(spilled)} spilled radix node(s) without spill_enabled")
        if pending_sids:
            v.append("spill drain queue non-empty without spill_enabled")
        if tier is not None:
            v.append("host tier present without spill_enabled")
    else:
        for sid, node in spilled.items():
            if node.block != SPILLED_BLOCK:
                v.append(f"spilled node sid {sid}: block {node.block} != SPILLED_BLOCK sentinel")
            if node.sid != sid:
                v.append(f"spilled node sid {sid}: claims sid {node.sid}")
            if node.parent is not None and node.parent.children.get(node.key) is not node:
                v.append(f"spilled node sid {sid}: broken parent link")
            if not tier.has(sid) and sid not in pending_sids:
                v.append(
                    f"spilled node sid {sid}: payload neither resident in the host tier "
                    "nor queued for drain"
                )
        if tier.resident_bytes > tier.budget_bytes:
            v.append(
                f"host tier over budget: {tier.resident_bytes} > {tier.budget_bytes} bytes"
            )

    # 8. on-device sampling residents match the on_device_sampling knob
    residents = {
        "_d_temps": engine._d_temps, "_d_topks": engine._d_topks,
        "_d_topps": engine._d_topps, "_d_rng": engine._d_rng,
    }
    if not engine._fused:
        for name, arr in residents.items():
            if arr is not None:
                v.append(f"sampling resident {name} present without on_device_sampling")
        return v
    for name, arr in residents.items():
        if arr is None:
            v.append(f"on_device_sampling engine missing resident {name}")
    mirror_spec = (
        ("_temps", engine._temps, (max_batch,), np.float32),
        ("_topks", engine._topks, (max_batch,), np.int32),
        ("_topps", engine._topps, (max_batch,), np.float32),
        ("_rng", engine._rng, (max_batch, 2), np.uint32),
    )
    for name, arr, shape, dtype in mirror_spec:
        if arr.shape != shape or arr.dtype != dtype:
            v.append(
                f"sampling mirror {name}: shape {arr.shape}/{arr.dtype} != "
                f"{shape}/{np.dtype(dtype)}"
            )
    for lane in free_lanes:
        # a released lane parks at the greedy sentinel with a null key
        if (
            engine._temps[lane] > 0.0
            or engine._topks[lane] != 0
            or engine._topps[lane] != 1.0
            or engine._rng[lane].any()
        ):
            v.append(f"free lane {lane}: sampling mirror not parked")
    s = engine.gen.sampling
    for lane, req in engine._active.items():
        if s.greedy:
            ok = (
                engine._temps[lane] <= GREEDY_TEMPERATURE
                and engine._topks[lane] == 0
                and engine._topps[lane] == 1.0
            )
        else:
            ok = (
                engine._temps[lane] == np.float32(s.temperature)
                and engine._topks[lane] == s.top_k
                and engine._topps[lane] == np.float32(s.top_p)
            )
        if not ok:
            v.append(
                f"rid {req.rid}: lane {lane} sampling params do not match the "
                "GenerationConfig install"
            )
        if not s.greedy and not np.array_equal(engine._rng[lane], engine._lane_rng(req.rid)):
            v.append(
                f"rid {req.rid}: lane {lane} rng key != the request's "
                "SeedSequence base key (preempt-resume replay would diverge)"
            )
    return v
