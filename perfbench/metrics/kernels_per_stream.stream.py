"""Device kernels launched in the traced part over the streams that ran
wholly inside it (the lead graph's replay counts its kernels one by one)."""


def read(ctx):
    streams = ctx.traced_dispatches()
    if ctx.trace is None or not ctx.trace.kernels() or not streams:
        return None
    return len(ctx.trace.kernels()) / len(streams)
