"""Device kernels launched in the traced part over the rows its batch calls
returned: the host-issued LSTMs' thousands of small kernels, per row."""


def read(ctx):
    calls = ctx.traced_dispatches()
    rows = sum(len(d.kept) for d in calls)
    if ctx.trace is None or not ctx.trace.kernels() or not rows:
        return None
    return len(ctx.trace.kernels()) / rows
