"""host.launches_per_frame: kernel and graph launch calls the host made in the
profiled sub-window, over the input frames of the real slots the packer
dispatched in it (the stage clock's ``packed_clips`` units times the frames a
slot carries: 64 new frames an I3D stack at step 64, 1 a RAFT pair)."""


def read(ctx):
    if ctx.trace is None:
        return None
    launches = ctx.trace.launches()
    slots = ctx.clock_delta("units", "packed_clips", "sub_start", "sub_end")
    if not launches or not slots:
        return None
    return launches / (slots * ctx.model["frames_per_slot"])
