"""Log-bucketed latency histograms for the serving metrics (graftscope).

A :class:`Histogram` is a fixed array of counters over geometrically
growing bucket edges — the standard scheme for latency distributions
(prometheus client histograms, HdrHistogram's coarse mode): relative
error is bounded by the growth factor at every scale, observation is two
adds and a bisect (pure host python, no allocation), and percentile
queries interpolate inside the winning bucket, so it is cheap enough to
run unconditionally on the engine's per-step / per-request paths.

The bucket layout is frozen at construction (``lo`` = first upper edge,
``growth`` = edge ratio, ``hi`` = last finite edge); a final overflow
bucket catches everything above ``hi`` and reports its percentile as the
observed max. docs/serving.md "Observability" records the per-metric
parameters the engine uses.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import List, Optional


class Histogram:
    """Fixed log-bucketed histogram: observe / percentile / snapshot.

    ``lo``/``hi``/``growth`` define upper bucket edges
    ``lo * growth**i`` for ``i = 0..n`` capped at ``hi``; values above
    ``hi`` land in an overflow bucket. Negative observations clamp to 0.
    """

    __slots__ = ("bounds", "counts", "count", "total", "max")

    def __init__(self, lo: float = 0.01, hi: float = 8e5, growth: float = 2.0):
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise ValueError(f"bad histogram spec lo={lo} hi={hi} growth={growth}")
        bounds: List[float] = []
        edge = float(lo)
        while edge < hi:
            bounds.append(edge)
            edge *= growth
        bounds.append(float(hi))
        self.bounds = bounds                    # finite upper edges, ascending
        self.counts = [0] * (len(bounds) + 1)   # +1 = overflow (+Inf) bucket
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        if v < 0.0 or math.isnan(v):
            v = 0.0
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v
        self.counts[bisect_left(self.bounds, v)] += 1

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Estimate the ``p``-quantile (``p`` in [0, 1]) by linear
        interpolation inside the bucket where the cumulative count
        crosses ``p * count`` (prometheus ``histogram_quantile`` rule);
        the overflow bucket reports the observed max."""
        if not self.count:
            return 0.0
        target = p * self.count
        cum = 0
        for i, n in enumerate(self.counts):
            if not n:
                continue
            if cum + n >= target:
                if i >= len(self.bounds):       # overflow bucket
                    return self.max
                lo_edge = self.bounds[i - 1] if i else 0.0
                hi_edge = self.bounds[i]
                frac = (target - cum) / n
                return min(lo_edge + (hi_edge - lo_edge) * frac, self.max)
            cum += n
        return self.max

    def count_over(self, threshold: float) -> float:
        """Estimated number of observations above ``threshold`` (linear
        interpolation inside the straddled bucket, the dual of
        :meth:`percentile`) — the SLO burn-rate monitor (serving/slo.py)
        differences this cumulative figure between evaluations. Overflow
        observations interpolate over ``(last_edge, max]``."""
        if not self.count:
            return 0.0
        t = max(float(threshold), 0.0)
        i = bisect_left(self.bounds, t)
        if i >= len(self.bounds):           # threshold in overflow range
            n = self.counts[-1]
            if not n or t >= self.max:
                return 0.0
            lo_edge = self.bounds[-1]
            span = max(self.max - lo_edge, 1e-12)
            return n * (self.max - t) / span
        over = float(sum(self.counts[i + 1:]))
        lo_edge = self.bounds[i - 1] if i else 0.0
        hi_edge = self.bounds[i]
        frac_above = (hi_edge - t) / max(hi_edge - lo_edge, 1e-12)
        return over + self.counts[i] * frac_above

    def snapshot(self) -> dict:
        """JSON-ready summary — the shape embedded in
        ``ServingMetrics.snapshot()`` (golden-keyed in tests)."""
        return {
            "count": self.count,
            "mean": round(self.mean(), 4),
            "max": round(self.max, 4),
            "p50": round(self.percentile(0.50), 4),
            "p90": round(self.percentile(0.90), 4),
            "p99": round(self.percentile(0.99), 4),
        }

    def prometheus_lines(self, name: str, help_text: Optional[str] = None) -> List[str]:
        """Render as a prometheus histogram exposition block: cumulative
        ``_bucket{le=...}`` counters ending at ``+Inf``, then ``_sum`` and
        ``_count``. Zero buckets are elided (the edges are static, so a
        scraper still sees a consistent cumulative series)."""
        lines = []
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} histogram")
        cum = 0
        for edge, n in zip(self.bounds, self.counts):
            cum += n
            if n:
                lines.append(f'{name}_bucket{{le="{edge:g}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {self.count}')
        lines.append(f"{name}_sum {self.total:g}")
        lines.append(f"{name}_count {self.count}")
        return lines
