"""K1's share of its roofline (%): for each batch call in the traced part,
the least time the card needs for the frames its rows keep (K1's operations
at the float32 peak, or its bytes at the HBM rate, whichever is larger;
weights read once a call), summed, over the summed device time of the K1
kernels (names in ``kernels/k1*.json``).  Frames that padding decodes and no
row keeps are not counted as work.  The counts are the acoustic model
module's (``ar_decode_counts``)."""

from perfbench.harness import cells, flops


def read(ctx):
    calls = ctx.traced_dispatches()
    if ctx.trace is None or ctx.peaks is None or not calls:
        return None
    seconds = ctx.trace.device_seconds(cells.kernel_patterns("k1"))
    if not seconds:
        return None
    bound = 0.0
    for d in calls:
        flop, bytes_ = ctx.models.acoustic.ar_decode_counts(ctx.sizes, sum(ctx.kept_frames(d)))
        bound += flops.bound_seconds(flop, bytes_, ctx.peaks.fp32, ctx.peaks)
    return 100.0 * bound / seconds
