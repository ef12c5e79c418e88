"""host.enqueue_syncs_per_step: synchronizing CUDA runtime calls the launching
thread made in the profiled sub-window while its innermost stage was
``enqueue`` (a stream's, the device's or an event's synchronize, or a
synchronous ``cudaMemcpy``), over the ``vft.stage.enqueue`` spans that opened
there. Each such call holds the thread until the card's queue drains: a round
trip from the model step to the host."""

import bisect
import re

from benchmark.metrics._spans import STAGE, innermost_stages

SYNC_RE = re.compile(r"^cuda(StreamSynchronize|DeviceSynchronize|EventSynchronize"
                     r"|Memcpy|Memcpy2D|Memcpy3D)$")


def read(ctx):
    tw = ctx.trace
    if tw is None:
        return None
    segments = innermost_stages(tw)
    steps = sum(1 for cat, name, _, _, tid in tw.host
                if tid == tw.host_tid and cat == "user_annotation" and name == STAGE + "enqueue")
    if segments is None or not steps:
        return None
    enqueue = [(s, e) for s, e, stage in segments if stage == "enqueue"]
    starts = [s for s, _ in enqueue]
    syncs = 0
    for cat, name, s, _, tid in tw.host:
        if tid == tw.host_tid and cat == "cuda_runtime" and SYNC_RE.match(name):
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < enqueue[i][1]:
                syncs += 1
    return syncs / steps
