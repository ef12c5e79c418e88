"""The metric arithmetic on synthetic inputs: interval unions, idle gaps,
launch counts, the roofline and the FLOP counts."""

import math

import pytest
import torch

from benchmark.harness import manifest, peaks
from benchmark.harness.cell import Context
from benchmark.harness.trace import END_MARK, START_MARK, TraceWindow, gaps, union_length
from benchmark.reference import i3d_pwc, raft


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def _trace():
    return TraceWindow([
        _ev(START_MARK, "user_annotation", 1000, 0), _ev(END_MARK, "user_annotation", 2000, 0),
        _ev("corr81_kernel<float>", "kernel", 900, 200, 7),       # clipped to 1000..1100
        _ev("corr81_kernel<float>", "kernel", 1050, 100, 7),      # overlaps the first
        _ev("Memcpy HtoD", "gpu_memcpy", 1300, 100, 8),
        _ev("conv", "kernel", 1500, 300, 7),
        _ev("conv", "kernel", 1950, 200, 7),                      # clipped to 1950..2000
        _ev("cudaLaunchKernel", "cuda_runtime", 1010, 5),
        _ev("cuLaunchKernel", "cuda_driver", 1020, 5),
        _ev("cudaGraphLaunch", "cuda_runtime", 1030, 5),
        _ev("cudaMemcpyAsync", "cuda_runtime", 1040, 5),
        _ev("cudaLaunchKernel", "cuda_runtime", 2500, 5),         # after the window
        _ev("cuLaunchKernel", "cuda_driver", 1011, 2),            # made by the runtime's
        _ev("aten::copy_", "cpu_op", 1150, 100),                  # in the 1150..1300 gap
        _ev("decode", "cpu_op", 1400, 95, tid=2),                 # another thread
    ])


def test_union_and_gaps():
    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert union_length([]) == 0
    assert gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    assert gaps([(0, 10)], 2, 5) == []


def test_trace_window_reads():
    tw = _trace()
    assert tw.seconds == pytest.approx(1e-3)
    busy = (1150 - 1000) + 100 + 300 + 50
    assert tw.busy_seconds() == pytest.approx(busy / 1e6)
    assert tw.kernel_count("^corr81") == 2
    assert tw.kernel_seconds("^corr81") == pytest.approx(200e-6)
    assert tw.launches() == 3
    top = tw.top_device_ops(2)
    assert top[0][0] == "conv" and top[0][1] == pytest.approx(350e-6)
    # 1150..1300 under the launching thread's copy; 1800..1950 under nothing;
    # 1400..1500 only under another thread's work
    assert [[n, round(s * 1e6)] for n, s in tw.idle_gaps(10)] == [
        ["aten::copy_", 150], ["host: no op recorded", 150], ["host: no op recorded", 100]]


def test_trace_without_markers_is_refused():
    with pytest.raises(ValueError):
        TraceWindow([_ev("k", "kernel", 0, 1)])


def _ctx(**kw):
    base = dict(trace=_trace(), clocks={}, flags=[], platform="gpu", model={"frames_per_slot": 64,
                                                             "pre_crop_size": 256},
                config={"compute_dtype": "float32"}, reference=i3d_pwc, seconds=10.0,
                completed=[], pool={"clips": []})
    base.update(kw)
    return Context(**base)


def test_idle_share_reader():
    read = manifest.metric_reader("device.idle_pct")
    busy = (150 + 100 + 300 + 50) / 1000
    assert read(_ctx()) == pytest.approx(100 * (1 - busy))
    assert read(_ctx(trace=None)) is None


def test_clock_readers():
    clocks = {"open": {"t": 0.0, "seconds": {"decode": 1.0}, "units": {"packed_clips": 10,
                                                                       "packed_slots": 12}},
              "sub_start": {"t": 6.0, "seconds": {}, "units": {"packed_clips": 20}},
              "sub_end": {"t": 9.0, "seconds": {}, "units": {"packed_clips": 26}},
              "close": {"t": 10.0, "seconds": {"decode": 3.0}, "units": {"packed_clips": 40,
                                                                         "packed_slots": 44}}}
    ctx = _ctx(clocks=clocks)
    assert manifest.metric_reader("decode.wait_pct")(ctx) == pytest.approx(20.0)
    assert manifest.metric_reader("packer.occupancy_pct")(ctx) == pytest.approx(30 / 32 * 100)
    assert manifest.metric_reader("host.launches_per_frame")(ctx) == pytest.approx(3 / (6 * 64))
    assert manifest.metric_reader("decode.wait_pct")(_ctx()) is None
    assert manifest.metric_reader("packer.occupancy_pct")(_ctx()) is None


def test_least_seconds():
    assert peaks.least_seconds(3.35e12, 1.0) == (pytest.approx(1.0), "bytes")
    assert peaks.least_seconds(1.0, 67e12) == (pytest.approx(1.0), "operations")


def test_roofline_reader_counts_each_level_once():
    pool = {"clips": [{"frames": 250, "height": 256, "width": 340}]}
    ctx = _ctx(pool=pool, flags=["--flow_pair_chunk", "16", "--flow_pair_chunk", "64"])
    levels = i3d_pwc.pwc_levels(256, 340)
    assert levels == [(196, 4, 6), (128, 8, 12), (96, 16, 24), (64, 32, 48), (32, 64, 96)]
    least = sum(max((2 * c + 81) * h * w * 64 * 4 / 3.35e12, 2 * 81 * c * h * w * 64 / 67e12)
                for c, h, w in levels)
    # two corr81 launches in the synthetic window: 2/5 of a chunk's five levels
    expected = 100 * (2 / 5 * least) / 200e-6
    assert manifest.metric_reader("corr81_roofline")(ctx) == pytest.approx(expected)
    assert manifest.metric_reader("corr81_roofline")(_ctx(pool=pool)) is None


def test_flop_counts_on_known_shapes():
    # one 3x3 convolution: 2 · out elements · cin · taps
    assert i3d_pwc._flops(lambda x: torch.nn.functional.conv2d(
        x, torch.empty(8, 4, 3, 3, device="meta"), padding=1), (2, 4, 10, 10)) == \
        2 * (2 * 8 * 10 * 10) * 4 * 9
    # I3D's stem on a 64×224×224 rgb stack: conv3d 7x7x7 stride 2, 3 → 64 channels
    stem = 2 * (64 * 32 * 112 * 112) * 3 * 343
    full = i3d_pwc._flops(lambda x: i3d_pwc.mirrors.i3d_forward(
        {k: torch.empty(s, device="meta") for k, s, _ in i3d_pwc.mirrors.i3d_leaf_specs("rgb")},
        x), (1, 3, 64, 224, 224))
    assert stem < full < 250e9  # ~108 GMAC, as published for Inception-v1 I3D
    assert i3d_pwc.resized_hw(720, 1280, 256) == (256, 455)
    assert i3d_pwc.resized_hw(340, 256, 256) == (340, 256)
    model = {"stack_size": 64, "step_size": 64, "pre_crop_size": 256, "crop_size": 224}
    assert i3d_pwc.video_flops(64, 256, 340, model) == 0.0
    assert i3d_pwc.video_flops(250, 256, 340, model) == pytest.approx(
        3 * i3d_pwc.stack_flops(256, 340, 64, 224))
    assert raft.video_flops(1, 240, 426, {"iters": 20}) == 0.0
    two = raft.video_flops(2, 240, 426, {"iters": 20})
    three = raft.video_flops(3, 240, 426, {"iters": 20})
    assert 1.0e11 < three - two < 4e11  # one more pair at 240×432
    assert not math.isnan(two)


def test_mfu_reader():
    model = {"stack_size": 64, "step_size": 64, "pre_crop_size": 256, "crop_size": 224,
             "frames_per_slot": 64}
    done = [{"frames": 250, "height": 256, "width": 340}] * 2
    ctx = _ctx(completed=done, model=model)
    expected = 100 * 6 * i3d_pwc.stack_flops(256, 340, 64, 224) / (10.0 * 67e12)
    assert manifest.metric_reader("step.mfu_pct")(ctx) == pytest.approx(expected)
    assert manifest.metric_reader("step.mfu_pct")(_ctx(model=model)) is None
    assert manifest.metric_reader("step.mfu_pct")(_ctx(completed=done, model=model,
                                                        platform="cpu")) is None
