"""A profiled sub-window of a run: device intervals, host launches, idle gaps.

The run starts ``torch.profiler`` (CPU and CUDA activity) on the launching
thread once the measured window has closed and stops it ``trace_seconds``
later; two zero-length ``record_function`` markers, ``bench.subwindow_start``
and ``bench.subwindow_end``, bound the sub-window on the trace's own clock.
Everything here reads the exported Chrome trace and clips it to those bounds.
"""

from __future__ import annotations

import bisect
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

START_MARK = "bench.subwindow_start"
END_MARK = "bench.subwindow_end"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_RE = re.compile(r"(LaunchKernel|GraphLaunch)")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

Interval = Tuple[float, float]


def union_length(intervals: Sequence[Interval]) -> float:
    """Total length covered by ``intervals`` (overlaps counted once)."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def gaps(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def clip(s: float, e: float, lo: float, hi: float) -> Optional[Interval]:
    s, e = max(s, lo), min(e, hi)
    return (s, e) if e > s else None


class TraceWindow:
    """The events of one exported trace inside its marked sub-window (times in
    microseconds, as the trace gives them)."""

    def __init__(self, events: List[Dict]):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        marks = {e["name"]: e for e in xs if e.get("name") in (START_MARK, END_MARK)}
        if START_MARK not in marks or END_MARK not in marks:
            raise ValueError("the trace lacks the sub-window markers")
        self.lo = float(marks[START_MARK]["ts"])
        self.hi = float(marks[END_MARK]["ts"])
        self.host_tid = marks[START_MARK].get("tid")
        self.device: List[Tuple[str, str, float, float]] = []  # (cat, name, s, e)
        self.host: List[Tuple[str, str, float, float, object]] = []  # (cat, name, s, e, tid)
        for e in xs:
            s, d = float(e["ts"]), float(e.get("dur", 0.0))
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                c = clip(s, s + d, self.lo, self.hi)
                if c:
                    self.device.append((cat, e.get("name", ""), *c))
            elif cat in HOST_CATS and e.get("name") not in (START_MARK, END_MARK):
                if self.lo <= s <= self.hi:
                    self.host.append((cat, e.get("name", ""), s, s + d, e.get("tid")))

    @classmethod
    def from_file(cls, path: str) -> "TraceWindow":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def seconds(self) -> float:
        return (self.hi - self.lo) / 1e6

    def busy_seconds(self) -> float:
        return union_length([(s, e) for _, _, s, e in self.device]) / 1e6

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for cat, name, s, e in self.device
                   if cat == "kernel" and rx.search(name)) / 1e6

    def kernel_count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for cat, name, _, _ in self.device if cat == "kernel" and rx.search(name))

    def launches(self) -> int:
        """Kernel and graph launch calls the host made in the sub-window: the
        runtime's, and the driver's that no runtime launch made (the
        program's own kernels link the runtime statically, and CUPTI sees
        their launches at the driver)."""
        runtime = [(s, e, tid) for cat, name, s, e, tid in self.host
                   if cat == "cuda_runtime" and LAUNCH_RE.search(name)]
        by_tid: Dict[object, List[Interval]] = {}
        for s, e, tid in runtime:
            by_tid.setdefault(tid, []).append((s, e))
        for spans in by_tid.values():
            spans.sort()
        n = len(runtime)
        for cat, name, s, e, tid in self.host:
            if cat == "cuda_driver" and LAUNCH_RE.search(name):
                spans = by_tid.get(tid, [])
                i = bisect.bisect_right(spans, (s, float("inf"))) - 1
                if not (i >= 0 and spans[i][0] <= s and e <= spans[i][1]):
                    n += 1
        return n

    def top_device_ops(self, n: int = 10) -> List[List]:
        by_name: Dict[str, float] = {}
        for _, name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest stretches with nothing on the device, each named by
        the launching thread's host event that overlapped it most (the
        shortest such event on a tie), or ``host: no op recorded``."""
        out = []
        host = [h for h in self.host if h[4] == self.host_tid] or self.host
        for s, e in sorted(gaps([(a, b) for _, _, a, b in self.device], self.lo, self.hi),
                           key=lambda g: g[0] - g[1])[:n]:
            best, key = "host: no op recorded", (0.0, 0.0)
            for _, name, hs, he, _ in host:
                ov = min(e, he) - max(s, hs)
                if ov > 0 and (ov, -(he - hs)) > key:
                    best, key = name, (ov, -(he - hs))
            out.append([best, (e - s) / 1e6])
        return out
