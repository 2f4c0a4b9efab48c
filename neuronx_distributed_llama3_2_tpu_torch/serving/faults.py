"""Chaos injection and the typed failure taxonomy of the paged serving
engine.

Counterpart of ``neuronx_distributed_llama3_2_tpu/serving/faults.py``
(:data:`FAULT_KINDS`, :class:`InjectedFault`, :class:`EngineStalledError`,
:class:`FaultPlan`, :class:`FaultInjector`), numpy only, a copy of its
own: the port imports nothing of the JAX package. A seeded, deterministic
:class:`FaultInjector` is hooked at the engine's funnels (``_upload``,
``_read_tokens``, the prefill / decode / verify / mixed dispatches, the
drafter's proposals, ``BlockAllocator.alloc``), so that every recovery
path of :class:`.engine.PagedServingEngine` can be driven on the CPU. The
handling half (per-request failure domains, lane quarantine, the
invariant auditor, the stall watchdog) lives in ``engine.py`` and
``invariants.py``.

Fault classes:

- ``device``: a prefill / decode / verify / mixed dispatch raises. It
  fires at the funnel before the call, so the KV pool and the resident
  decode state are never half-mutated: the engine fails only the victim
  lane and the survivors redispatch next step.
- ``nan``: one lane's logits are poisoned to NaN on the device (the
  ``logit_poison`` argument of the model's steps,
  ``LlamaDecode.finite_logit_check``), which drives the real on-device
  finiteness check and the lane quarantine.
- ``drafter``: the draft proposer raises; drafting is advisory, so no
  request fails.
- ``alloc``: ``BlockAllocator.alloc`` reports transient exhaustion
  (returns None with blocks still free): admission back-off, draft
  trimming and preempt-requeue under a healthy pool.
- ``latency``: a host<->device transfer stalls (``time.sleep``), which the
  stall watchdog must tolerate.
- ``host_tier``: a spilled KV block's host payload is lost before its
  restore (tiered KV storage). The engine drops the spilled run inside its
  own failure domain and re-prefills it; every other request's tokens are
  unchanged.

Determinism: all randomness comes from one ``np.random.default_rng(seed)``
consumed in engine-call order, so a chaos run is reproducible from
``(workload seed, FaultPlan)``. The port's engine consults the injector at
the JAX engine's sites in the same order, except that its lane-set flush
uploads once for all dirty lanes where the JAX engine uploads per lane:
a plan with ``latency_rate > 0`` draws at other upload counts there, and
its fired sequence differs from the JAX engine's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("device", "nan", "drafter", "alloc", "latency", "host_tier")


class InjectedFault(RuntimeError):
    """A fault the :class:`FaultInjector` asked the engine to take.

    Carries the fault ``kind``, the funnel ``site`` it fired at, and the
    victim ``lanes`` whose requests the engine should fail — the failure
    domain is the lane, never the engine."""

    def __init__(self, kind: str, site: str, lanes: Sequence[int] = ()):
        self.kind = kind
        self.site = site
        self.lanes = tuple(lanes)
        super().__init__(
            f"injected {kind} fault at {site}"
            + (f" (lanes {list(self.lanes)})" if self.lanes else "")
        )


class EngineStalledError(RuntimeError):
    """``step()`` made no progress for ``PagedConfig.stall_step_limit``
    consecutive steps while work was outstanding — a wedged lane or a
    scheduling livelock. Raised instead of letting ``run_to_completion``
    spin forever; names the stuck work so the operator can act."""

    def __init__(self, limit: int, active: Dict[int, int], queued: Sequence[int]):
        # active: lane -> rid at the moment the watchdog fired
        self.limit = limit
        self.active = dict(active)
        self.queued = list(queued)
        super().__init__(
            f"engine made no progress for {limit} consecutive steps; "
            f"stuck lanes {self.active} (lane: rid), queued rids {self.queued}"
        )


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to inject and how often. Rates are per *opportunity* (one
    decode dispatch, one drafter call, one ``alloc()``, ...), drawn from
    the plan's seeded rng; ``schedule`` entries ``(step, kind)`` fire
    exactly once at the first opportunity at or after that step —
    deterministic coverage of every fault class regardless of rates."""

    seed: int = 0
    device_rate: float = 0.0   # per decode/verify/prefill program dispatch
    nan_rate: float = 0.0      # per decode/verify dispatch: poison one lane
    drafter_rate: float = 0.0  # per drafter.propose call
    alloc_rate: float = 0.0    # per BlockAllocator.alloc call
    latency_rate: float = 0.0  # per host<->device transfer funnel hit
    latency_ms: float = 1.0    # injected sleep per latency fault
    host_tier_rate: float = 0.0  # per tiered-KV restore attempt
    schedule: Tuple[Tuple[int, str], ...] = ()

    def __post_init__(self):
        for _, kind in self.schedule:
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; one of {FAULT_KINDS}"
                )


class FaultInjector:
    """Seeded chaos source the engine consults at its funnels.

    Construct with a :class:`FaultPlan` and pass to
    :class:`.engine.PagedServingEngine`; the engine calls
    :meth:`begin_step` once per ``step()`` and the site hooks below at
    each funnel. ``counts`` / ``fired`` record everything injected, and
    feed ``ServingMetrics.faults_injected``."""

    def __init__(self, plan: FaultPlan = FaultPlan()):
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self._step = 0
        self._due: List[Tuple[int, str]] = sorted(plan.schedule)
        self.counts: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        # (step, kind, site, lanes) in firing order — the chaos audit trail
        self.fired: List[tuple] = []
        # observer called as on_fire(step, kind, site, lanes) at the moment
        # a fault fires — the engine wires its tracer here so
        # chaos events land in the flight recorder as instants. Purely
        # observational: must never influence what fires.
        self.on_fire = None

    @property
    def total_fired(self) -> int:
        return sum(self.counts.values())

    def wants(self, kind: str) -> bool:
        """True when this plan can ever fire ``kind`` — the engine uses
        ``wants("nan")`` to decide whether to build the checked (finite-
        verified) program variants."""
        rate = getattr(self.plan, f"{kind}_rate", 0.0)
        return rate > 0 or any(k == kind for _, k in self.plan.schedule)

    def begin_step(self, step_index: int) -> None:
        self._step = step_index

    # -- internals ---------------------------------------------------------

    def _fires(self, kind: str, rate: float) -> bool:
        for i, (s, k) in enumerate(self._due):
            if k == kind and s <= self._step:
                del self._due[i]
                return True
        return rate > 0 and float(self._rng.random()) < rate

    def _record(self, kind: str, site: str, lanes: Sequence[int]) -> None:
        self.counts[kind] += 1
        self.fired.append((self._step, kind, site, tuple(lanes)))
        if self.on_fire is not None:
            self.on_fire(self._step, kind, site, tuple(lanes))

    # -- site hooks (called by the engine) ---------------------------------

    def device_fault(self, site: str, lanes: Sequence[int]) -> Optional[int]:
        """One victim lane to abort at a program-dispatch funnel, or None.
        Fires *before* the dispatch so no device state is half-mutated."""
        if not lanes:
            return None
        if self._fires("device", self.plan.device_rate):
            lane = int(self._rng.choice(np.asarray(list(lanes))))
            self._record("device", site, (lane,))
            return lane
        return None

    def nan_lanes(self, site: str, lanes: Sequence[int]) -> List[int]:
        """Lanes whose logits to poison to NaN on this dispatch."""
        if not lanes:
            return []
        if self._fires("nan", self.plan.nan_rate):
            lane = int(self._rng.choice(np.asarray(list(lanes))))
            self._record("nan", site, (lane,))
            return [lane]
        return []

    def drafter_fault(self) -> None:
        """Raises :class:`InjectedFault` in place of a drafter bug."""
        if self._fires("drafter", self.plan.drafter_rate):
            self._record("drafter", "draft", ())
            raise InjectedFault("drafter", "draft")

    def alloc_fault(self) -> bool:
        """``BlockAllocator.fault_hook``: True = this alloc() reports
        transient exhaustion (returns None with the pool untouched)."""
        if self._fires("alloc", self.plan.alloc_rate):
            self._record("alloc", "alloc", ())
            return True
        return False

    def maybe_latency(self, site: str) -> None:
        """Sleep at a transfer funnel (``_upload`` / ``_read_tokens``)."""
        if self._fires("latency", self.plan.latency_rate):
            self._record("latency", site, ())
            time.sleep(self.plan.latency_ms / 1e3)

    def host_tier_fault(self) -> bool:
        """True = corrupt/evict the spilled run this restore attempt was
        about to pull from the host tier. The engine invalidates the run
        (its own failure domain) and falls back to re-prefilling."""
        if self._fires("host_tier", self.plan.host_tier_rate):
            self._record("host_tier", "restore", ())
            return True
        return False
