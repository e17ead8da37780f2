"""The share (%) of the decoded frames that rows keep: the summed
``kept_frames`` over the summed ``decoded_frames`` (rows times the frame
budget, pad rows included) of the ``synth.finalize`` spans inside the
harness's calls wholly inside the traced part; the rest is padding."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("perfbench_metric_spans", Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(ctx):
    spans = _spans.call_spans(ctx)
    fin = [r for r in spans or () if r.name == "synth.finalize"]
    decoded = sum(r.attrs["decoded_frames"] for r in fin)
    if not decoded:
        return None
    return 100.0 * sum(r.attrs["kept_frames"] for r in fin) / decoded
