"""``host.enqueue_syncs_per_step`` on a synthetic trace: the synchronizing
runtime calls of the launching thread while its innermost stage is
``enqueue``, over the ``enqueue`` spans of the sub-window."""

import pytest

from benchmark.harness import manifest
from benchmark.harness.cell import Context
from benchmark.harness.trace import END_MARK, START_MARK, TraceWindow

NAME = "host.enqueue_syncs_per_step"


def _ev(name, cat, ts, dur=5, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def _events(stages=True):
    """A 1000..2000 µs sub-window on the launching thread (tid 1): enqueue
    1050..1350 with a transfer 1150..1250 and a model span inside, a second
    enqueue 1600..1800, a device_wait 1450..1550."""
    events = [_ev(START_MARK, "user_annotation", 1000, 0),
              _ev(END_MARK, "user_annotation", 2000, 0),
              _ev("conv", "kernel", 1000, 900, tid=7)]
    if stages:
        events += [
            _ev("vft.stage.enqueue", "user_annotation", 1050, 300),
            _ev("vft.stage.transfer", "user_annotation", 1150, 100),
            _ev("vft.model.pwc.decoder", "user_annotation", 1260, 80),
            _ev("vft.stage.device_wait", "user_annotation", 1450, 100),
            _ev("vft.stage.enqueue", "user_annotation", 1600, 200),
        ]
    events += [
        # counted: in enqueue, under the model span too, and a synchronous copy
        _ev("cudaMemcpyAsync", "cuda_runtime", 1270),
        _ev("cudaStreamSynchronize", "cuda_runtime", 1280),
        _ev("cudaMemcpy", "cuda_runtime", 1610),
        _ev("cudaDeviceSynchronize", "cuda_runtime", 1700),
        # not counted: a launch, inside the transfer, in device_wait, in no
        # stage, on another thread, and before the sub-window
        _ev("cudaLaunchKernel", "cuda_runtime", 1060),
        _ev("cudaStreamSynchronize", "cuda_runtime", 1200),
        _ev("cudaEventSynchronize", "cuda_runtime", 1500),
        _ev("cudaStreamSynchronize", "cuda_runtime", 1900),
        _ev("cudaStreamSynchronize", "cuda_runtime", 1300, tid=2),
        _ev("cudaStreamSynchronize", "cuda_runtime", 990),
    ]
    return events


def _read(trace):
    ctx = Context(trace=trace, clocks={}, flags=[], platform="gpu", seconds=10.0,
                  completed=[])
    return manifest.metric_reader(NAME)(ctx)


def test_counts_the_syncs_inside_enqueue_per_enqueue_span():
    assert _read(TraceWindow(_events())) == pytest.approx(3 / 2)


def test_reads_nothing_without_stages_or_a_trace():
    assert _read(TraceWindow(_events(stages=False))) is None
    assert _read(None) is None


def test_is_in_the_manifest_for_both_cells():
    bench = manifest.load()
    for cell in ("i3d_pwc.kinetics_packed", "raft.ssv2_packed"):
        assert NAME in {m["name"] for m in manifest.per_layer_for(bench, cell)}
