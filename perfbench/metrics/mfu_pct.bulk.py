"""The whole step's share of the card's peak (%): the duration, decode and
generator operations of the tokens and kept frames of the rows returned in
the traced part, over the traced window's length without the profiler's
cost (``Context.untraced_window_s``), against the bf16 peak (the serving
route's, as the program's own MFU report names it)."""

from perfbench.harness import flops
from perfbench.reference import frontend


def read(ctx):
    calls = ctx.traced_dispatches()
    window = ctx.untraced_window_s()
    if ctx.trace is None or ctx.peaks is None or not calls or window is None:
        return None
    tokens, frames = [], []
    for d in calls:
        tokens += [len(frontend.tokens(t)) for t in d.texts]
        frames += ctx.kept_frames(d)
    return 100.0 * flops.pipeline_flops(ctx.sizes, tokens, frames) / window / ctx.peaks.bf16
