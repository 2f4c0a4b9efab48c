"""SLO burn-rate monitoring for the serving engine.

Counterpart of ``neuronx_distributed_llama3_2_tpu/serving/slo.py``
(:class:`SLOPolicy`, :class:`SLOMonitor`), a copy of its own. The
operator declares latency objectives, TTFT and / or TPOT p99 targets, on
:class:`.engine.PagedConfig`; the monitor computes a **burn rate** over
the histograms the engine already observes into (``hist_ttft_ms`` /
``hist_tpot_ms``), from host counter deltas alone:

    burn = (fraction of recent observations over target) / error budget

where a p99 objective's error budget is 1%. Burn 1.0 spends the budget
exactly; burn 100 means every observation missed. The fraction is taken
over a rolling window of the last ``window_evals`` evaluations (one every
``eval_steps`` engine steps), weighted by observation count, sized in
evaluations because the engine's clock is its step loop.

When the windowed burn of an objective reaches ``burn_threshold`` with a
full window, the monitor raises an alert: ``metrics.slo_alerts`` counts
it and the tracer records an ``slo_burn`` instant. Under ``PagedConfig.
slo_degrade`` the alert is also one degradation-ladder event: the engine
passes its ``_note_event`` to :meth:`SLOMonitor.on_step`, before the
ladder's update of the same step. Host ints and floats only; no device
work.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from neuronx_distributed_llama3_2_tpu_torch.serving.histogram import Histogram
from neuronx_distributed_llama3_2_tpu_torch.serving.metrics import ServingMetrics


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Declared latency objectives and the burn window's shape, built from
    the PagedConfig knobs by :meth:`from_paged`."""

    ttft_p99_ms: Optional[float] = None
    tpot_p99_ms: Optional[float] = None
    quantile: float = 0.99        # the objective quantile (budget = 1 - q)
    eval_steps: int = 16          # engine steps between burn evaluations
    window_evals: int = 4         # evaluations per rolling burn window
    burn_threshold: float = 1.0   # windowed burn rate that raises an alert
    degrade: bool = False         # alerts feed the degradation ladder

    @classmethod
    def from_paged(cls, paged: Any) -> "SLOPolicy":
        return cls(
            ttft_p99_ms=paged.slo_ttft_p99_ms,
            tpot_p99_ms=paged.slo_tpot_p99_ms,
            eval_steps=max(int(paged.slo_eval_steps), 1),
            window_evals=max(int(paged.slo_burn_window), 1),
            burn_threshold=float(paged.slo_burn_threshold),
            degrade=bool(paged.slo_degrade),
        )

    @property
    def active(self) -> bool:
        return self.ttft_p99_ms is not None or self.tpot_p99_ms is not None

    @property
    def budget(self) -> float:
        """The error budget: the fraction of observations allowed over
        target (0.01 for a p99 objective)."""
        return max(1.0 - self.quantile, 1e-9)


class _Objective:
    """Rolling burn state of one (name, target, histogram)."""

    __slots__ = ("name", "target_ms", "hist", "_last_count", "_last_over",
                 "window", "burn")

    def __init__(self, name: str, target_ms: float, hist: Histogram, window_evals: int):
        self.name = name
        self.target_ms = float(target_ms)
        self.hist = hist
        self._last_count = hist.count
        self._last_over = hist.count_over(self.target_ms)
        # (over delta, count delta) per evaluation
        self.window: deque = deque(maxlen=window_evals)
        self.burn = 0.0

    def evaluate(self, budget: float) -> float:
        count = self.hist.count
        over = self.hist.count_over(self.target_ms)
        d_count = max(count - self._last_count, 0)
        d_over = max(over - self._last_over, 0.0)
        self._last_count, self._last_over = count, over
        self.window.append((d_over, d_count))
        n = sum(c for _, c in self.window)
        frac = sum(o for o, _ in self.window) / n if n else 0.0
        self.burn = frac / budget
        return self.burn

    @property
    def window_full(self) -> bool:
        return len(self.window) == self.window.maxlen

    @property
    def window_observations(self) -> int:
        return sum(c for _, c in self.window)


class SLOMonitor:
    """Evaluates the declared objectives every ``eval_steps`` engine steps;
    owned by the engine and driven from ``step()``. Inert, one modulo
    test a step, when no objective is declared."""

    def __init__(self, policy: SLOPolicy, metrics: ServingMetrics):
        self.policy = policy
        self.metrics = metrics
        self.objectives: List[_Objective] = []
        if policy.ttft_p99_ms is not None:
            self.objectives.append(_Objective(
                "ttft", policy.ttft_p99_ms, metrics.hist_ttft_ms, policy.window_evals,
            ))
        if policy.tpot_p99_ms is not None:
            self.objectives.append(_Objective(
                "tpot", policy.tpot_p99_ms, metrics.hist_tpot_ms, policy.window_evals,
            ))
        # per-service-class burn gauges: advisory objectives against the
        # same targets, made as classes appear in the per-class
        # histograms; they update metrics.slo_burn_by_class and never alert
        self._class_objectives: Dict[Tuple[str, str], _Objective] = {}

    def _evaluate_classes(self, budget: float) -> None:
        for kind, target, hists in (
            ("ttft", self.policy.ttft_p99_ms, self.metrics.hist_ttft_by_class),
            ("tpot", self.policy.tpot_p99_ms, self.metrics.hist_tpot_by_class),
        ):
            if target is None:
                continue
            for cls, hist in hists.items():
                key = (kind, cls)
                obj = self._class_objectives.get(key)
                if obj is None:
                    obj = self._class_objectives[key] = _Objective(
                        f"{kind}/{cls}", target, hist, self.policy.window_evals,
                    )
                burn = obj.evaluate(budget)
                row = self.metrics.slo_burn_by_class.get(cls)
                if row is None:
                    row = self.metrics.slo_burn_by_class[cls] = {}
                row[kind] = round(burn, 4)

    def on_step(
        self,
        step_index: int,
        tracer: Any = None,
        note_event: Optional[Callable[[], None]] = None,
    ) -> bool:
        """Evaluate the burn at the policy's cadence. Returns True iff this
        call raised an alert (at most one an evaluation, however many
        objectives burn)."""
        if not self.objectives:
            return False
        if step_index % self.policy.eval_steps:
            return False
        burning = []
        budget = self.policy.budget
        self._evaluate_classes(budget)
        for obj in self.objectives:
            burn = obj.evaluate(budget)
            if obj.name == "ttft":
                self.metrics.slo_burn_ttft = round(burn, 4)
            else:
                self.metrics.slo_burn_tpot = round(burn, 4)
            # sustained: a full window with real observations; a cold or
            # idle window never alerts
            if (
                obj.window_full
                and obj.window_observations > 0
                and burn >= self.policy.burn_threshold
            ):
                burning.append(obj)
        if not burning:
            return False
        self.metrics.slo_alerts += 1
        if tracer is not None:
            tracer.instant(
                "slo_burn",
                objectives=[o.name for o in burning],
                ttft_burn=self.metrics.slo_burn_ttft,
                tpot_burn=self.metrics.slo_burn_tpot,
                threshold=self.policy.burn_threshold,
            )
        if self.policy.degrade and note_event is not None:
            note_event()
        return True
