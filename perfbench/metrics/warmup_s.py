"""Seconds the run's set-up spent in ``Synthesizer.warmup``: the summed
``setup.warmup`` spans between the last ``Synthesizer`` built before the
window and the window, everything inside them included (lead-graph
captures too)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("perfbench_metric_spans", Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(ctx):
    spans = _spans.setup_spans(ctx, "setup.warmup")
    return 1e-9 * sum(r.end - r.start for r in spans) if spans else None
