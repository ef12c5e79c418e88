"""corr81_roofline: the least time of the cost-volume work the profiled
sub-window launched, over the device time of the kernels that did it.

Kernels summed: those whose name matches ``KERNELS``: ``corr81_kernel``
(``csrc/corr81.cu``) and ``warp_corr81_kernel`` (``csrc/warp_corr81.cu``). Each PWC pass of these cells decodes one chunk of
``--flow_pair_chunk`` pairs and launches the cost volume once a level, levels
6 to 2, so a launch's work is a level's 81 taps over the chunk. The work of a
level for B pairs: 2·81·C·h·w·B operations, and (2·C + 81)·h·w·B float32 values
moved (both inputs read once, the volume written once). The pool's geometries,
weighted by their stacks, give the levels' (C, h, w)."""

from benchmark.harness.peaks import least_seconds

KERNELS = r"\b(warp_)?corr81_kernel\b"


def _chunk(flags):
    if "--flow_pair_chunk" not in flags:
        return None
    return int(flags[len(flags) - 1 - flags[::-1].index("--flow_pair_chunk") + 1])


def read(ctx):
    tw = ctx.trace
    chunk = _chunk(ctx.flags)
    if tw is None or not chunk:
        return None
    n, busy = tw.kernel_count(KERNELS), tw.kernel_seconds(KERNELS)
    if n == 0 or busy <= 0:
        return None
    levels = getattr(ctx.reference, "pwc_levels", None)
    resized = getattr(ctx.reference, "resized_hw", None)
    if levels is None or resized is None:
        return None
    per_chunk, weight = 0.0, 0
    for clip in ctx.pool["clips"]:
        h, w = resized(clip["height"], clip["width"], ctx.model["pre_crop_size"])
        t = sum(least_seconds((2 * c + 81) * lh * lw * chunk * 4,
                              2 * 81 * c * lh * lw * chunk)[0] for c, lh, lw in levels(h, w))
        per_chunk += clip["frames"] * t
        weight += clip["frames"]
    least = n / 5 * per_chunk / weight
    return 100.0 * least / busy
