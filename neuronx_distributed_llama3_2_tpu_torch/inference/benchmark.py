"""Latency collection and the percentile report.

Counterpart of ``neuronx_distributed_llama3_2_tpu/inference/benchmark.py``
(``LatencyCollector``, ``GenerationBenchmark``). The collectors hold host
wall-clock seconds around a program call and the readback of its tokens;
a readback from the card synchronizes, so each sample spans the device
work it waited for, which is what a serving client sees.
"""

from __future__ import annotations

import time
from typing import Dict, List


class LatencyCollector:
    """Accumulates latencies (seconds) and reports percentiles."""

    def __init__(self) -> None:
        self.samples: List[float] = []

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)

    def timed(self):
        return _Timer(self)

    def percentile(self, p: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        idx = min(len(s) - 1, int(round((p / 100.0) * (len(s) - 1))))
        return s[idx]

    def report(self) -> Dict[str, float]:
        """count, p50 / p90 / p99 and mean, in milliseconds."""
        return {
            "count": len(self.samples),
            "p50_ms": 1e3 * self.percentile(50),
            "p90_ms": 1e3 * self.percentile(90),
            "p99_ms": 1e3 * self.percentile(99),
            "mean_ms": 1e3 * (sum(self.samples) / max(len(self.samples), 1)),
        }


class _Timer:
    def __init__(self, collector: LatencyCollector) -> None:
        self._c = collector

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._c.record(time.perf_counter() - self._t0)
        return False


class GenerationBenchmark:
    """TTFT, per-token and end-to-end collectors of one generate() run."""

    def __init__(self) -> None:
        self.ttft = LatencyCollector()
        self.per_token = LatencyCollector()
        self.e2e = LatencyCollector()

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            "ttft": self.ttft.report(),
            "per_token": self.per_token.report(),
            "e2e": self.e2e.report(),
        }
