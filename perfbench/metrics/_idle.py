"""Shared by the ``device_idle_pct.*`` readers: the share of the traced
window in which no operation ran on the device, the window taken at the
length the same calls take untraced (``Context.untraced_window_s``)."""


def idle_pct(ctx):
    t = ctx.trace
    window = ctx.untraced_window_s()
    if t is None or not t.ops or window is None:
        return None
    return 100.0 * (1.0 - t.busy_s / window)
