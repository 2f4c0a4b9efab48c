"""graftscope: the serving engine's flight recorder and span tracer.

Two recorders behind one object, both pure host-side python at the
engine's existing funnels (the same choke points the chaos layer hooks):

- a **ring-buffer step flight recorder** — each ``step()`` owns a list
  of phase events (admit wave, prefill chunk, decode/verify dispatch
  tagged with the ``ProgramRecord`` key, readback, lane_set/table_delta
  flushes) plus instant events (faults, degradation-ladder moves,
  invariant violations); only the last ``PagedConfig.trace_buffer_steps``
  steps are retained, so memory is bounded however long the engine runs;
- a **per-request span recorder** — monotonic ``(timestamp, state)``
  transitions through ``queued → prefilling → active → preempted →
  finished/failed``; terminal requests move to a bounded deque.

Everything exports as Chrome trace-event JSON (``chrome://tracing`` /
https://ui.perfetto.dev — pid 0 is the engine step timeline, pid 1 is
one thread per request) or as jsonl for ad-hoc grepping.

Zero-interference contract (asserted in tests/test_tracing.py and the
graftcheck gate): tracing records around device work, never in it — no
h2d uploads, no extra device syncs, no program-registry changes. When
``enabled`` is False every hook is a single attribute test returning a
shared no-op, so the always-constructed tracer costs nothing.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# request states that end a span and retire it to the done-deque
TERMINAL_STATES = ("finished", "failed")

# event tuple layout inside a step record: (ph, name, t0, t1, args)
# ph "X" = duration slice (t1 = end), ph "i" = instant (t1 unused)


def program_label(record: Any) -> str:
    """Human-readable dispatch tag for a ``ProgramRecord`` (PR 9's
    registry): kind plus the sorted meta dict, e.g.
    ``pdecode[gather=False,kv_limit=32]``. Takes any object with
    ``kind``/``meta`` attributes so tracing never imports the analysis
    layer."""
    kind = getattr(record, "kind", None) or record.__class__.__name__
    meta = getattr(record, "meta", None) or {}
    inner = ",".join(f"{k}={v}" for k, v in sorted(meta.items()))
    return f"{kind}[{inner}]" if inner else str(kind)


class _NullSpan:
    """Shared do-nothing context manager returned by ``phase`` when
    tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "EngineTracer", name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.complete(self._name, self._t0, time.perf_counter(),
                              **self._args)
        return False


class EngineTracer:
    """Flight recorder + request-span tracer (see module docstring)."""

    def __init__(self, enabled: bool = False, buffer_steps: int = 256,
                 max_requests: int = 4096):
        self.enabled = bool(enabled)
        self.buffer_steps = max(int(buffer_steps), 1)
        self._steps: deque = deque(maxlen=self.buffer_steps)
        self._cur: Optional[List[tuple]] = None
        self._step_idx = 0
        self._step_t0 = 0.0
        # rid -> [(ts, state), ...] for live requests; terminal spans
        # retire to _done so memory stays bounded under churn
        self._spans: Dict[int, List[Tuple[float, str]]] = {}
        self._done: deque = deque(maxlen=max(int(max_requests), 1))

    # ------------------------------------------------------------------
    # recording hooks (every one is a no-op unless enabled)
    # ------------------------------------------------------------------

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def begin_step(self, index: int) -> None:
        if not self.enabled:
            return
        self._cur = []
        self._step_idx = index
        self._step_t0 = time.perf_counter()

    def end_step(self, **args: Any) -> None:
        if not self.enabled or self._cur is None:
            return
        self._steps.append({
            "step": self._step_idx,
            "t0": self._step_t0,
            "t1": time.perf_counter(),
            "events": self._cur,
            "args": args,
        })
        self._cur = None

    def phase(self, name: str, **args: Any):
        """Context manager recording a duration slice for an engine phase
        inside the current step. Use :meth:`complete` instead at sites
        that already keep their own perf_counter pair."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def complete(self, name: str, t0: float, t1: Optional[float] = None,
                 **args: Any) -> None:
        if not self.enabled or self._cur is None:
            return
        self._cur.append(
            ("X", name, t0, time.perf_counter() if t1 is None else t1, args))

    def instant(self, name: str, **args: Any) -> None:
        """Point event (fault fired, ladder moved, invariant violated).
        Instants between steps (no step open) are dropped — every engine
        site that emits one runs inside ``step()``."""
        if not self.enabled or self._cur is None:
            return
        self._cur.append(("i", name, time.perf_counter(), None, args))

    def counter(self, name: str, **values: Any) -> None:
        """Chrome counter sample (ph "C"): a named set of numeric series
        the trace viewer plots as stacked graphs over the step timeline —
        graftmeter emits its cumulative pad/FLOP counters here once per
        traced step. Same drop rule as :meth:`instant`."""
        if not self.enabled or self._cur is None:
            return
        self._cur.append(("C", name, time.perf_counter(), None, values))

    def request_state(self, rid: int, state: str) -> None:
        if not self.enabled:
            return
        self._spans.setdefault(rid, []).append((time.perf_counter(), state))
        if state in TERMINAL_STATES:
            self._done.append((rid, self._spans.pop(rid)))

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------

    @staticmethod
    def _us(t: float) -> float:
        return round(t * 1e6, 1)

    def chrome_events(self) -> List[dict]:
        """Flatten both recorders into Chrome trace-event dicts: pid 0 =
        engine step timeline (one outer slice per step, phase slices and
        instants nested inside), pid 1 = requests (tid = rid, one slice
        per lifecycle state, instants at terminal transitions)."""
        evs: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": "engine steps"}},
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "args": {"name": "requests"}},
        ]
        for rec in self._steps:
            evs.append({
                "ph": "X", "name": f"step {rec['step']}", "cat": "step",
                "pid": 0, "tid": 0, "ts": self._us(rec["t0"]),
                "dur": self._us(rec["t1"] - rec["t0"]),
                "args": {"step": rec["step"], **rec["args"]},
            })
            for ph, name, t0, t1, args in rec["events"]:
                ev = {"ph": ph, "name": name, "cat": "phase", "pid": 0,
                      "tid": 0, "ts": self._us(t0), "args": args}
                if ph == "X":
                    ev["dur"] = self._us(t1 - t0)
                elif ph == "C":
                    ev["cat"] = "counter"
                else:
                    ev["cat"] = "event"
                    ev["s"] = "p"       # process-scoped instant
                evs.append(ev)
        live = [(rid, list(trans)) for rid, trans in self._spans.items()]
        for rid, trans in list(self._done) + live:
            evs.append({"ph": "M", "name": "thread_name", "pid": 1,
                        "tid": rid, "args": {"name": f"request {rid}"}})
            for i, (ts, state) in enumerate(trans):
                if state in TERMINAL_STATES:
                    evs.append({"ph": "i", "name": state, "cat": "request",
                                "pid": 1, "tid": rid, "ts": self._us(ts),
                                "s": "t", "args": {"rid": rid}})
                    continue
                # a state lasts until the next transition; a live request's
                # current state renders as a zero-width slice at its edge
                end = trans[i + 1][0] if i + 1 < len(trans) else ts
                evs.append({"ph": "X", "name": state, "cat": "request",
                            "pid": 1, "tid": rid, "ts": self._us(ts),
                            "dur": self._us(end - ts), "args": {"rid": rid}})
        return evs

    def export(self, path: str, fmt: str = "chrome") -> str:
        """Write the trace to ``path``; ``fmt`` is ``chrome`` (trace-event
        JSON, perfetto-viewable) or ``jsonl`` (one event per line).
        Returns ``path``."""
        events = self.chrome_events()
        if fmt == "chrome":
            with open(path, "w") as f:
                json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                          f, default=str)
        elif fmt == "jsonl":
            with open(path, "w") as f:
                for ev in events:
                    f.write(json.dumps(ev, default=str) + "\n")
        else:
            raise ValueError(f"unknown trace format {fmt!r}")
        return path
