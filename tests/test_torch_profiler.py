"""The port's profiler (utils/profiler.py) against the JAX package's: the
Chrome-trace ``Timeline`` (paired marks, per-step flush into a valid JSON
array, disabled without a path), the ``torch.profiler`` device trace and
its named regions, on the CPU."""

import json
import os

import pytest
import torch

from neuronx_distributed_llama3_2_tpu.utils import profiler as jprof
from neuronx_distributed_llama3_2_tpu_torch.utils.profiler import (
    Timeline,
    annotate,
    device_trace,
    step_annotation,
)


def _load(path):
    with open(path) as f:
        return json.load(f)


def _drive(tl):
    with tl.event("load_batch", cat="data"):
        pass
    tl.mark_event_start("train_step")
    tl.mark_event_end("train_step", loss=1.5)
    tl.step_end(0)
    with tl.event("save", cat="ckpt"):
        pass
    tl.close()


def test_timeline_chrome_trace_roundtrip(tmp_path):
    p = tmp_path / "tl.json"
    _drive(Timeline(str(p)))
    events = _load(p)
    assert [e["name"] for e in events] == ["load_batch", "train_step", "save"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert len({e["tid"] for e in events}) == 3
    assert events[1]["args"] == {"loss": 1.5}


def test_timeline_matches_jax_records(tmp_path):
    """Both packages' timelines write the same records, times aside."""
    _drive(Timeline(str(tmp_path / "port.json")))
    _drive(jprof.Timeline(str(tmp_path / "jax.json")))

    def shape(events):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events]

    assert shape(_load(tmp_path / "port.json")) == shape(_load(tmp_path / "jax.json"))


def test_timeline_incremental_flush_stays_valid_json(tmp_path):
    p = tmp_path / "tl.json"
    tl = Timeline(str(p))
    for i in range(3):
        with tl.event("step"):
            pass
        tl.step_end(i)
        assert len(_load(p)) == i + 1
    tl.close()


def test_timeline_disabled_without_path():
    tl = Timeline(None)
    with tl.event("x"):
        pass
    tl.mark_event_start("y")
    tl.mark_event_end("y")
    tl.step_end()
    tl.close()


def test_timeline_unbalanced_marks_raise(tmp_path):
    tl = Timeline(str(tmp_path / "t.json"))
    tl.mark_event_start("a")
    with pytest.raises(ValueError):
        tl.mark_event_start("a")
    with pytest.raises(ValueError):
        tl.mark_event_end("never-started")


def test_timeline_close_flushes_open_events(tmp_path):
    p = tmp_path / "t.json"
    tl = Timeline(str(p))
    tl.mark_event_start("dangling")
    tl.close()
    assert [e["name"] for e in _load(p)] == ["dangling"]


def test_annotate_usable_outside_a_trace():
    with annotate("region"):
        with step_annotation(3):
            pass


def test_device_trace_writes_a_chrome_trace_with_the_regions(tmp_path):
    x = torch.ones(64, 64)
    with device_trace(str(tmp_path)):
        for step in range(2):
            with step_annotation(step), annotate("matmul"):
                x = x @ x / 64
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    trace = _load(tmp_path / files[0])
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"train_step#0", "train_step#1", "matmul"} <= names
