"""The vocoder's share of its roofline (%): for each batch call in the
traced part, the least time the card needs for the generator stages of the
frames its rows keep (their operations at the bf16 peak, or their bytes at
the HBM rate: weights once a call, each stage's input and output once, in
bf16, whichever is larger), summed, over the summed device time of the
vocoder's kernels (names in ``kernels/vocoder*.json``).  conv_pre, a
library conv outside them, is left out of both.  The counts are the vocoder
model module's (``stage_counts``, ``weight_bytes``)."""

from perfbench.harness import cells, flops


def read(ctx):
    calls = ctx.traced_dispatches()
    if ctx.trace is None or ctx.peaks is None or not calls:
        return None
    seconds = ctx.trace.device_seconds(cells.kernel_patterns("vocoder"))
    if not seconds:
        return None
    bound = 0.0
    for d in calls:
        flop = bytes_ = 0.0
        for frames in ctx.kept_frames(d):
            f, b = ctx.models.vocoder.stage_counts(ctx.sizes, frames)
            flop, bytes_ = flop + f, bytes_ + b
        bytes_ += ctx.models.vocoder.weight_bytes(ctx.sizes)
        bound += flops.bound_seconds(flop, bytes_, ctx.peaks.bf16, ctx.peaks)
    return 100.0 * bound / seconds
