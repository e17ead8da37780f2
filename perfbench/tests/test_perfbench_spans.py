"""The readers of the program's own spans, on traced tiny runs on the CPU:
each reads a finite value in the cells it lists, and None, without
raising, on a program that has no spans."""

import importlib.util
import json
import math
import time
from pathlib import Path

import pytest
import torch

from perfbench.harness import core
from perfbench.harness.core import run_cell
from tiny import tiny_cell

CPU = torch.device("cpu")
SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
READERS = [m["name"] for m in SPEC["per_layer"] if m["source"] in ("program_span", "program_counter")]
SPEC_WORKLOADS = {m["name"]: m["workloads"] for m in SPEC["per_layer"]}
FINITE = {"infore.bulk64": ["host_issue_ms_per_row.bulk", "kept_frame_pct.bulk", "checkpoint_load_s", "warmup_s"],
          "tacotron2.stream": ["checkpoint_load_s", "warmup_s"]}
_spec = importlib.util.spec_from_file_location("perfbench_metric_spans", core.METRICS_DIR / "_spans.py")
SPANS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SPANS)


@pytest.fixture
def contexts(monkeypatch):
    """The readers' contexts of the runs made under the fixture."""
    seen = []

    class Context(core.Context):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    monkeypatch.setattr(core, "Context", Context)
    return seen


@pytest.mark.parametrize("name", ["infore.bulk64", "tacotron2.stream"])
def test_span_readers_on_a_traced_run(name, contexts, monkeypatch):
    torch.manual_seed(0)
    res = run_cell(tiny_cell(name), 2**31 + 23, 1.5, True, CPU, time.perf_counter(), log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    for m in FINITE[name]:
        assert math.isfinite(res["metrics"][m]["value"]) and res["metrics"][m]["value"] > 0, m
    assert sorted(FINITE[name]) == sorted(m for m in READERS if name in SPEC_WORKLOADS[m])
    if name == "infore.bulk64":
        assert res["metrics"]["kept_frame_pct.bulk"]["value"] <= 100.0
    # a program without spans: every reader reads None
    from viettts_tpu_torch.utils import profiling

    (ctx,) = contexts
    monkeypatch.delattr(profiling, "spans")
    for m in READERS:
        assert core._reader(m)(ctx) is None, m


def test_call_spans_and_self_times(monkeypatch):
    """Made-up spans: only those wholly inside a call wholly inside the
    traced part are read, and a span's self time leaves out its children."""
    from perfbench.harness import drivers
    from perfbench.harness.trace import Trace
    from viettts_tpu_torch.utils import profiling

    base = 100 * 10 ** 9  # perf_counter ns of 100.0 s

    def rec(name, kind, i, parent, a, b):
        return profiling.SpanRecord(name, kind, 1, i, parent, 0, base + a, base + b, {})

    spans = [rec("synth.decode", "issue", 2, 1, 50_000, 500_000), rec("synth.wait", "wait", 3, 1, 600_000, 700_000),
             rec("synth.batch", "host", 1, None, 10_000, 800_000), rec("synth.batch", "host", 4, None, 950_000, 990_000)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    trace = Trace(window_s=1e-3, busy_s=2e-4, ops=[], host=[], span=(100.0, 100.001))
    record = drivers.Record()
    record.dispatches = [drivers.Dispatch("batch", ["x"], [], [1], {}, 100.0, 100.0009)]
    ctx = core.Context(trace, record, None, None, 256, None)
    assert [r.id for r in SPANS.call_spans(ctx)] == [2, 3, 1]
    assert SPANS.self_ns(spans[:3]) == {2: 450_000, 3: 100_000, 1: 240_000}
