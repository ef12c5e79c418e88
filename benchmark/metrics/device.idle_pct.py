"""device.idle_pct: the share of the profiled sub-window in which nothing ran on
the card (no kernel, copy or memset: the union of their intervals)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or ctx.trace.seconds <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_seconds() / ctx.trace.seconds)
