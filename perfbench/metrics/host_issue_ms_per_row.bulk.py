"""Host time spent queuing device work (ms) for each row the traced calls
returned: the summed self time of the program's ``issue`` spans inside the
harness's calls wholly inside the traced part, over those calls' rows.

The spans record only in the traced part, under the profiler, which adds
its own records to every launch: this reads well above what the same
calls spend issuing untraced (PERF.md, section 3, gives both), and falls
with the number of launches as well as with each launch's host cost."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("perfbench_metric_spans", Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(ctx):
    spans = _spans.call_spans(ctx)
    rows = sum(len(d.kept) for d in ctx.traced_dispatches())
    if not spans or not rows:
        return None
    own = _spans.self_ns(spans)
    return 1e-6 * sum(own[r.id] for r in spans if r.kind == "issue") / rows
