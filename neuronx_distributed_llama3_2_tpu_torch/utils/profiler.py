"""Profiling and timeline observability.

Counterpart of ``neuronx_distributed_llama3_2_tpu/utils/profiler.py``, two
layers:

1. :class:`Timeline`, a copy of the JAX package's: a host-side event
   timeline in Chrome trace format (the JSON array that
   ``chrome://tracing`` and Perfetto read), events on one lane per
   category (step / data / ckpt), buffered in memory and flushed on
   ``step_end`` / ``close`` into a file that stays a valid JSON array.

2. :func:`device_trace` / :func:`annotate` / :func:`step_annotation`, over
   ``torch.profiler``: a trace of host and CUDA activity written into a
   directory as a Chrome trace, with named regions
   (``torch.profiler.record_function``) that make the train step's parts
   attributable in it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger

logger = get_logger()


@dataclasses.dataclass
class _Event:
    name: str
    cat: str
    start_us: float
    dur_us: float
    args: Optional[Dict[str, Any]] = None


class Timeline:
    """Chrome-trace host-event timeline (reference Timeline, utils/timeline.py:14).

    Usage::

        tl = Timeline("/tmp/run/timeline.json")
        with tl.event("load_batch", cat="data"):
            ...
        tl.mark_event_start("step")       # explicit mark API, like the
        tl.mark_event_end("step")         # reference's (timeline.py:43-58)
        tl.step_end(step=i)               # flush, advance step counter
        tl.close()

    A ``trace_file_path`` of None disables all recording (reference
    timeline.py:36-38), so call sites need no guards.
    """

    def __init__(self, trace_file_path: Optional[str]):
        self.enabled = trace_file_path is not None
        self.path = trace_file_path
        self.step = 0
        self._open: Dict[str, float] = {}
        self._events: List[_Event] = []
        self._lanes: Dict[str, int] = {}  # category -> tid, stable across flushes
        self._lock = threading.Lock()
        self._t0 = time.perf_counter_ns()
        if self.enabled:
            os.makedirs(os.path.dirname(os.path.abspath(trace_file_path)), exist_ok=True)
            # timestamps are relative to this process's start: appending to a
            # previous run's file would interleave two runs on the same lanes
            if os.path.exists(trace_file_path):
                os.remove(trace_file_path)

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def mark_event_start(self, label: str, cat: str = "step") -> None:
        if not self.enabled:
            return
        with self._lock:
            if label in self._open:
                raise ValueError(f"event {label!r} already started")
            self._open[label] = self._now_us()

    def mark_event_end(self, label: str, cat: str = "step", **args) -> None:
        if not self.enabled:
            return
        with self._lock:
            start = self._open.pop(label, None)
            if start is None:
                raise ValueError(f"event {label!r} was never started")
            self._events.append(
                _Event(label, cat, start, self._now_us() - start, args or None)
            )

    @contextlib.contextmanager
    def event(self, label: str, cat: str = "step", **args):
        self.mark_event_start(label, cat)
        try:
            yield
        finally:
            self.mark_event_end(label, cat, **args)

    def step_end(self, step: Optional[int] = None, flush: bool = True) -> None:
        """Advance the step counter and (by default) flush to disk — the
        reference dumps per step too (mark_step_end, timeline.py:62)."""
        self.step = self.step + 1 if step is None else step + 1
        if flush:
            self.flush()

    def flush(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            events, self._events = self._events, []
        if not events:
            return
        # chrome trace "X" (complete) events; pid 0, tid = category lane
        records = []
        for e in events:
            tid = self._lanes.setdefault(e.cat, len(self._lanes))
            rec = {
                "name": e.name,
                "cat": e.cat,
                "ph": "X",
                "ts": round(e.start_us, 3),
                "dur": round(e.dur_us, 3),
                "pid": 0,
                "tid": tid,
            }
            if e.args:
                rec["args"] = e.args
            records.append(rec)
        new = ",\n".join(json.dumps(r) for r in records)
        # maintain a valid JSON array in-place across incremental flushes
        with self._lock:
            exists = os.path.exists(self.path) and os.path.getsize(self.path) > 2
            if not exists:
                with open(self.path, "w") as f:
                    f.write("[\n" + new + "\n]")
            else:
                with open(self.path, "rb+") as f:
                    f.seek(-2, os.SEEK_END)  # drop trailing "\n]"
                    f.truncate()
                    f.write((",\n" + new + "\n]").encode())

    def close(self) -> None:
        with self._lock:
            for label, start in list(self._open.items()):
                self._events.append(_Event(label, "step", start, self._now_us() - start))
            self._open.clear()
        self.flush()


# ---------------------------------------------------------------------------
# device-level (torch.profiler) tracing
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace host and CUDA activity inside the block and write it into
    ``logdir`` as a Chrome trace (``trace.<pid>.<n>.json``, Perfetto or
    ``chrome://tracing`` readable); CUDA activity is traced when a card is
    present. Wrap a handful of steady-state steps, not the whole run::

        with device_trace("/tmp/profile"):
            for _ in range(3):
                state, m = step(state, batch)
            float(m["loss"])
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    logger.info("profiling to %s", logdir)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        n = len([f for f in os.listdir(logdir) if f.startswith(f"trace.{os.getpid()}.")])
        path = os.path.join(logdir, f"trace.{os.getpid()}.{n}.json")
        prof.export_chrome_trace(path)
        logger.info("profile written to %s", path)


def annotate(name: str):
    """A named region in a device trace (``torch.profiler.record_function``);
    costs nearly nothing outside one, so call sites need no guards."""
    return torch.profiler.record_function(name)


def step_annotation(step: int):
    """Mark a train step in a device trace: a ``train_step#<step>`` region."""
    return torch.profiler.record_function(f"train_step#{step}")
