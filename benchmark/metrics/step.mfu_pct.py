"""step.mfu_pct: model FLOPs of the videos completed in the window over the
window's seconds and the compute dtype's published peak on one H100 SXM.

The FLOPs come from the configuration's plain reference
(``benchmark/reference/<config>.py`` ``video_flops``), counted from its shapes
on meta tensors: every real stack or pair of each completed video, none of the
padding the packer dispatched."""

from benchmark.harness.peaks import PEAK_FLOPS


def read(ctx):
    # a share of the card's peak; a rehearsal on the CPU has none
    if ctx.platform != "gpu" or not ctx.completed:
        return None
    flops = sum(ctx.reference.video_flops(v["frames"], v["height"], v["width"], ctx.model)
                for v in ctx.completed)
    if flops <= 0:
        return None
    return 100.0 * flops / (ctx.seconds * PEAK_FLOPS[ctx.config["compute_dtype"]])
