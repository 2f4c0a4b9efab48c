"""SLO-aware step scheduling for the paged engine.

Counterpart of ``neuronx_distributed_llama3_2_tpu/serving/scheduler.py``:
:data:`CLASS_RANK`, :data:`BURN_BOOST`, :func:`rank_queue` and
:class:`SloPolicy`, registered as ``"slo"`` (``PagedConfig.step_policy``
or ``policy=SloPolicy(...)``). The policy keeps the FIFO schedule's shape,
arm for arm, and moves its authority into the two pieces of
``StepAction`` meta the engine honours:

- ``ADMIT meta["admit_order"]``: a ranking of the waiting queue. The
  admission wave is unchanged (strict head of line over the reordered
  queue, the same block accounting); the policy decides which request
  sits at the head, from three signals:

  1. **Service class**: ``interactive`` (TTFT-sensitive) ranks ahead of
     ``batch``. A request's class is declared at ``submit(service_class=)``
     and never reaches the device.
  2. **Burn-rate feedback**: the per-class burn gauges of the SLO monitor
     (``metrics.slo_burn_by_class``, :mod:`.slo`). A class burning its
     error budget is boosted by :data:`BURN_BOOST` ranks until its burn
     falls back under the threshold.
  3. **Tenant fairness**: inside a rank, requests interleave across
     tenants by weighted round robin (stride scheduling over
     ``tenant_weights``, weight 1 by default), first come first served
     within a tenant.

- ``PREFILL_CHUNK meta["budget_tokens"]``: a cap on the prefill tokens one
  step's chunk wave dispatches, a rung of the prefill bucket ladder (the
  largest whose observed pad fraction stays under ``pad_waste_ceiling``).
  TTFT burning doubles it (queued prefills drain faster); TPOT burning
  clamps it to the smallest rung (the decode cadence is protected). The
  engine advances at least one prefilling lane a wave, so a budget paces
  prefill and never starves it. A budget changes how many lanes advance,
  not the size of a chunk, so every chunk still lands on a catalog key.

``TablePolicy`` (``step_policy="table"``, ``PagedConfig.policy_table_path``)
reads certified tables of the analyzer ``analysis/graftplan.py`` and comes
with the analyzer slice of the port: :func:`.policy.make_policy` raises on
it.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional

from neuronx_distributed_llama3_2_tpu_torch.serving.policy import (
    ActionType,
    EngineView,
    QueuedRequest,
    StepAction,
    StepPolicy,
    register_policy,
)
from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger

__all__ = ["BURN_BOOST", "CLASS_RANK", "SloPolicy", "rank_queue"]

logger = get_logger()

#: Admission priority per service class (lower = admitted earlier).
CLASS_RANK: Dict[str, int] = {"interactive": 0, "batch": 1}

#: Rank subtraction for a class burning its SLO budget: 2 lifts a burning
#: ``batch`` class above an ``interactive`` class that is not burning.
BURN_BOOST = 2


def rank_queue(
    queued: List[QueuedRequest],
    rank_fn,
    tenant_weights: Optional[Mapping[str, float]] = None,
) -> List[int]:
    """The admission ranking: priority tiers from
    ``rank_fn(service_class)`` (lower admits earlier), weighted round robin
    across tenants inside a tier (stride scheduling: each pick charges the
    tenant 1 / weight), first come first served within a tenant.
    Deterministic: ties break on tenant name, then queue position."""
    weights = dict(tenant_weights or {})

    def weight(tenant: str) -> float:
        w = weights.get(tenant, 1.0)
        return w if w > 0 else 1.0

    tiers: Dict[float, Dict[str, List[QueuedRequest]]] = {}
    for q in queued:
        tiers.setdefault(rank_fn(q.service_class), {}).setdefault(q.tenant, []).append(q)
    order: List[int] = []
    for rank in sorted(tiers):
        by_tenant = tiers[rank]
        for reqs in by_tenant.values():
            reqs.sort(key=lambda q: q.position)  # FCFS within a tenant
        credit = {t: 0.0 for t in by_tenant}
        while by_tenant:
            tenant = min(by_tenant, key=lambda t: (credit[t] / weight(t), t))
            order.append(by_tenant[tenant].pop(0).rid)
            credit[tenant] += 1.0
            if not by_tenant[tenant]:
                del by_tenant[tenant]
    return order


@register_policy
class SloPolicy(StepPolicy):
    """SLO-aware scheduling over the policy seam (see the module
    docstring). Every knob is optional (``make_policy("slo")`` and
    ``PagedConfig(step_policy="slo")`` take the defaults):

    - ``tenant_weights``: tenant -> weight of the admission round robin
      (an unlisted tenant weighs 1.0; more weight, more admissions a wave);
    - ``burn_threshold``: the windowed burn at or above which a class
      counts as burning (the SLO monitor's alert default, 1.0);
    - ``pad_waste_ceiling``: the largest observed pad fraction a prefill
      rung may have and still be the step's budget."""

    name = "slo"

    def __init__(
        self,
        tenant_weights: Optional[Mapping[str, float]] = None,
        burn_threshold: float = 1.0,
        pad_waste_ceiling: float = 0.5,
    ) -> None:
        self._spec_pause = 0
        self.tenant_weights = dict(tenant_weights or {})
        self.burn_threshold = float(burn_threshold)
        self.pad_waste_ceiling = float(pad_waste_ceiling)
        self._logged_catalog = False

    def reset(self) -> None:
        self._spec_pause = 0
        self._logged_catalog = False

    # -- admission ranking -------------------------------------------------

    def _burning_classes(self, view: EngineView) -> frozenset:
        burning = set()
        for cls, row in view.slo_burn_by_class.items():
            if any(b >= self.burn_threshold for b in row.values()):
                burning.add(cls)
        return frozenset(burning)

    def _rank(self, cls: str, burning: frozenset) -> int:
        rank = CLASS_RANK.get(cls, max(CLASS_RANK.values()) + 1)
        if cls in burning:
            rank -= BURN_BOOST
        return rank

    def _admit_order(self, view: EngineView) -> List[int]:
        """The waiting queue ranked by :func:`rank_queue`: class rank with
        the burn boost, tenants in weighted round robin, FCFS within a
        tenant."""
        burning = self._burning_classes(view)
        return rank_queue(
            list(view.queued()), lambda cls: self._rank(cls, burning),
            tenant_weights=self.tenant_weights,
        )

    def _admit_meta(self, view: EngineView) -> dict:
        # a queue the wave cannot admit from is not ranked: behind full
        # lanes a deep queue would cost a sort every step for nothing
        if view.queue_depth <= 1 or view.free_lanes == 0:
            return {}
        return {"admit_order": self._admit_order(view)}

    # -- chunked-prefill budget --------------------------------------------

    def _prefill_budget(self, view: EngineView) -> Optional[int]:
        buckets = view.prefill_buckets
        if not buckets:
            return None
        if not self._logged_catalog:
            self._logged_catalog = True
            logger.debug("SloPolicy budget ladder:\n%s", view.catalog_description)
        pads = view.pad_by_rung("prefill")
        # the largest rung whose observed pad fraction stays under the
        # ceiling; a rung nothing was dispatched into yet counts as fine
        best = buckets[0]
        for rung in buckets:
            row = pads.get(rung)
            if row is None:
                best = rung
                continue
            total = row.get("need_tokens", 0) + row.get("pad_tokens", 0)
            if not total or row.get("pad_tokens", 0) / total <= self.pad_waste_ceiling:
                best = rung
        budget = int(best)
        ttft_burn, tpot_burn = view.slo_burn
        if ttft_burn >= self.burn_threshold:
            budget *= 2                 # TTFT burning: drain prefills faster
        elif tpot_burn >= self.burn_threshold:
            budget = int(buckets[0])    # TPOT burning: protect the decode cadence
        return budget

    def _prefill_meta(self, view: EngineView) -> dict:
        budget = self._prefill_budget(view)
        return {} if budget is None else {"budget_tokens": budget}

    # -- the schedule ------------------------------------------------------

    def actions(self, view: EngineView) -> Iterator[StepAction]:
        # arm for arm the FIFO policy's schedule; only the ADMIT and
        # PREFILL_CHUNK meta differ (under fused_step the engine routes a
        # PREFILL_CHUNK to the mixed step)
        cfg = view.config
        spec_on = view.spec_enabled and view.degrade_level < 1
        async_on = cfg.async_loop and view.degrade_level < 2
        if spec_on and self._spec_pause <= 0:
            yield StepAction(ActionType.READBACK)
            yield StepAction(ActionType.ADMIT, meta=self._admit_meta(view))
            yield StepAction(ActionType.PREFILL_CHUNK, meta=self._prefill_meta(view))
            yield StepAction(ActionType.VERIFY)
            if not view.last_verify_drafted:
                if async_on:
                    self._spec_pause = cfg.spec_retry_steps
                yield StepAction(ActionType.DECODE_DISPATCH, mode="sync")
            return
        if self._spec_pause > 0:
            self._spec_pause -= 1
        if async_on and view.async_eligible:
            yield StepAction(ActionType.DECODE_DISPATCH, mode="async")
            if not view.last_async_fell_back:
                return
        yield StepAction(ActionType.READBACK)
        yield StepAction(ActionType.ADMIT, meta=self._admit_meta(view))
        yield StepAction(ActionType.PREFILL_CHUNK, meta=self._prefill_meta(view))
        yield StepAction(ActionType.DECODE_DISPATCH, mode="sync")
