"""packer.occupancy_pct: real over dispatched slots across the window (the
stage clock's ``packed_clips`` over ``packed_slots`` units)."""


def read(ctx):
    real = ctx.clock_delta("units", "packed_clips")
    slots = ctx.clock_delta("units", "packed_slots")
    if not slots:
        return None
    return 100.0 * real / slots
