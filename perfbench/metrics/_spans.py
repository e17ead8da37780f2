"""Shared by the readers of the program's own spans
(``viettts_tpu_torch.utils.profiling``): the spans of the harness's calls
wholly inside the traced part, those of the run's set-up, and self times.

A span's times are ``time.perf_counter_ns``, the clock of the harness's
calls (``Dispatch.t0``/``t1``).  Every function returns None where the
program records no spans (a checkout from before them): such a reader
reads null and does not raise."""

import bisect
from typing import Optional


def records() -> Optional[list]:
    """All the program's finished spans, or None where it has none."""
    try:
        from viettts_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def _ns(t: float) -> int:
    return round(t * 1e9)


def call_spans(ctx) -> Optional[list]:
    """The spans that lie wholly inside one of the harness's calls wholly
    inside the traced part (``Context.traced_dispatches``)."""
    recs = records()
    if recs is None or ctx.trace is None:
        return None
    calls = sorted((_ns(d.t0), _ns(d.t1)) for d in ctx.traced_dispatches())
    starts = [a for a, _ in calls]
    out = []
    for r in recs:
        i = bisect.bisect_right(starts, r.start) - 1
        if i >= 0 and r.end <= calls[i][1]:
            out.append(r)
    return out


def self_ns(spans) -> dict:
    """Each span's duration less its children's, by span id."""
    own = {r.id: r.end - r.start for r in spans}
    for r in spans:
        if r.parent in own:
            own[r.parent] -= r.end - r.start
    return own


def setup_spans(ctx, name: str) -> Optional[list]:
    """The run's own set-up spans called ``name``: the children of the last
    ``setup.synthesizer`` that ended before the window opened, or, for
    ``setup.warmup``, those between it and the window (a process that ran
    other cells before holds their set-ups too)."""
    recs = records()
    if recs is None:
        return None
    w0 = _ns(ctx.record.window[0])
    tops = [r for r in recs if r.name == "setup.synthesizer" and r.end <= w0]
    if not tops:
        return None
    top = max(tops, key=lambda r: r.start)
    if name == "setup.warmup":
        return [r for r in recs if r.name == name and r.start >= top.end and r.end <= w0]
    return [r for r in recs if r.name == name and r.parent == top.id]
