"""The whole step's share of the card's peak (%): the duration, decode and
generator operations of the tokens and kept frames of the rows returned in
the traced part, over the traced window's length without the profiler's
cost (``Context.untraced_window_s``), against the bf16 peak (the serving
route's, as the program's own MFU report names it).  The counts are the
configuration's model modules'."""

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
    m, sizes = ctx.models, ctx.sizes
    flop = float(sum(m.duration.flops(sizes, t) + m.acoustic.decode_flops(sizes, t, f)
                     + m.vocoder.generator_flops(sizes, f) for t, f in zip(tokens, frames)))
    return 100.0 * flop / window / ctx.peaks.bf16
