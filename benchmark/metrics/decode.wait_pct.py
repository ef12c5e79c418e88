"""decode.wait_pct: the share of the window the launching thread spent blocked
on the frame stream (the stage clock's ``decode`` seconds, ``VFT_METRICS=1``)."""


def read(ctx):
    waited = ctx.clock_delta("seconds", "decode")
    span = ctx.clock_seconds()
    if waited is None or not span:
        return None
    return 100.0 * waited / span
