"""One run of one cell: set-up, the measured window, the comparison, the result.

The program is driven through its own entry: ``video_features_torch.cli.parse_args``
on the cell's flags, ``extractors.get_extractor``, then one ``Extractor.run(paths,
progress=...)`` over a stream of visits longer than warm-up plus window.

- Completion times come from the program's per-video success accounting,
  ``Extractor._mark_succeeded``, which fires once a video's outputs have been
  written (or handed to the print sink). The harness wraps that method on the
  instance and reads the clock at each call, on the launching thread; the
  ``progress`` callback fires at ingest, not at completion, and only steers.
- The window opens when every warm-up visit has completed: the stream opens
  with one visit of each geometry, so by then every shape the cell dispatches
  has run and cuDNN has timed it. It lasts ``seconds``. The first ``progress``
  call after it closes raises :class:`WindowClosed`, which ends ``run`` without
  draining the work in flight.
- The device's memory peak is reset when the window opens: it is the
  traffic's, not that of cuDNN's timing of new shapes in set-up.
- ``--trace 1`` turns the program's stage clock on (``VFT_METRICS=1``) and
  profiles ``trace_seconds`` that follow the window, marked on the trace's
  clock from the launching thread: the profiler's start and its cost on the
  launching thread stay out of the window. The profiler stops after ``run``
  has unwound.
- After the window the program's state is freed, and the configuration's plain
  reference recomputes a seeded sample of the videos completed in the window,
  the longest among them, from the same files and the same weights.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from . import corpus, manifest
from .trace import END_MARK, START_MARK, TraceWindow

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "video_features_tpu")
KERNEL_BUILD_DIR = os.path.join(manifest.BENCH_DIR, ".cache", "kernels")
# seconds from a run's start (a checkout's first builds included) by which
# the window must have opened, or the run is abandoned
OPEN_DEADLINE_S = 240.0


class WindowClosed(Exception):
    """Raised from the progress callback once the measured window has closed."""


class RunFailed(RuntimeError):
    """The run could not measure its window (it prints no result)."""


@dataclass
class Options:
    workload: str
    seed: int
    seconds: int
    trace: bool
    dry_run: bool = False
    control: bool = False
    # called with the extractor before the run: the tests plant faults here
    program_hook: Optional[Callable] = None
    # program flags appended after the cell's (``calibrate.py``'s sweeps only)
    extra_flags: tuple = ()


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``'s start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return time.clock_gettime(time.CLOCK_BOOTTIME) - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def _clock_snapshot(ex) -> Optional[Dict]:
    clock = getattr(ex, "clock", None)
    if clock is None:
        return None
    with clock._lock:
        return {"t": time.perf_counter(), "seconds": dict(clock.seconds),
                "units": dict(clock.units)}


class Recorder:
    """Completion times, the window's bounds and the outputs kept for the check."""

    def __init__(self, stream: List[Dict], warmup: int, seconds: float, keep: set):
        self.by_link = {v["link"]: v for v in stream}
        self.warmup = warmup
        self.seconds = seconds
        self.keep = keep
        self.warm_left = sum(1 for v in stream if v["visit"] < warmup)
        self.t_open: Optional[float] = None
        self.setup_s: Optional[float] = None
        # called once, when the window opens
        self.on_open: Optional[Callable] = None
        # the profiled sub-window's bounds (``--trace 1``), after the window
        self.t_sub: Optional[tuple] = None
        self.done: List[tuple] = []  # (visit, t)
        self.failed: List[tuple] = []  # (path, t)
        self.outputs: Dict[str, Dict[str, np.ndarray]] = {}
        self.clocks: Dict[str, Dict] = {}
        self.ex = None

    @property
    def t_close(self) -> float:
        return self.t_open + self.seconds

    def completed(self, path: str) -> None:
        t = time.perf_counter()
        visit = self.by_link.get(path)
        if visit is None:
            return
        self.done.append((visit, t))
        if self.t_open is None and visit["visit"] < self.warmup:
            self.warm_left -= 1
            if self.warm_left == 0:
                self.t_open = t
                self.setup_s = process_age()
                self.clocks["open"] = _clock_snapshot(self.ex)
                if self.on_open is not None:
                    self.on_open()

    def in_window(self) -> List[Dict]:
        return self.between(self.t_open, self.t_close)

    def between(self, lo: float, hi: float) -> List[Dict]:
        return [v for v, t in self.done if lo < t <= hi]


def _save_weights(sds: Dict, dirpath: str) -> Dict:
    """Each state dict to ``<dirpath>/<name>.pt``; returns host copies."""
    import torch

    os.makedirs(dirpath, exist_ok=True)
    host = {}
    for name, sd in sds.items():
        host[name] = {k: v.detach().cpu() for k, v in sd.items()}
        torch.save(host[name], os.path.join(dirpath, name + ".pt"))
    return host


@contextlib.contextmanager
def _stdout_to(path: str):
    """The process's standard output (file descriptor 1 and ``sys.stdout``)
    into ``path``: the program prints, and the result must stay the last line."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "ab") as log:
        os.dup2(log.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


class Context:
    """What a per-layer metric's reader gets (see ``benchmark/metrics/``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def clock_delta(self, kind: str, name: str, a: str = "open", b: str = "close"):
        """The change of stage-clock ``kind`` (``seconds`` or ``units``)
        ``name`` between snapshots ``a`` and ``b``; None without the clock."""
        sa, sb = self.clocks.get(a), self.clocks.get(b)
        if sa is None or sb is None:
            return None
        return sb[kind].get(name, 0) - sa[kind].get(name, 0)

    def clock_seconds(self, a: str = "open", b: str = "close"):
        sa, sb = self.clocks.get(a), self.clocks.get(b)
        return None if sa is None or sb is None else sb["t"] - sa["t"]


def run_cell(opt: Options) -> Dict:
    """One run of ``opt.workload``: the result line's object."""
    import torch

    bench = manifest.load()
    cellspec = manifest.cell(bench, opt.workload)
    config = manifest.load_json(manifest.config_path(cellspec["config"]))
    traffic = manifest.load_json(manifest.traffic_path(cellspec["traffic"]))
    if opt.dry_run:
        config = manifest.merged(config, config.get("dry_run"))
        traffic = manifest.merged(traffic, traffic.get("dry_run"))
    ref = manifest.reference_module(cellspec["config"])
    model = config["model"]
    device = "cpu" if opt.dry_run else "cuda"
    if not opt.dry_run:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cellspec["chips"]:
            raise RunFailed(f"{opt.workload} needs {cellspec['chips']} CUDA device(s); "
                            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    threads = torch.get_num_threads()
    if opt.dry_run:
        # one intra-op thread a rehearsal: rehearsals side by side on one CPU
        # otherwise spin against each other's thread pools for minutes
        torch.set_num_threads(1)
    rundir = tempfile.mkdtemp(prefix="vft-bench-")
    try:
        result = _run(opt, bench, cellspec, config, traffic, ref, model, device, rundir)
    finally:
        if opt.dry_run:
            torch.set_num_threads(threads)
        shutil.rmtree(rundir, ignore_errors=True)
    # again once the check and the metric readers have run
    found = forbidden_modules()
    if found:
        raise RunFailed(f"the process holds {', '.join(found)} at the end of the run")
    return result


def _run(opt, bench, cellspec, config, traffic, ref, model, device, rundir) -> Dict:
    import torch

    phases = {"start": process_age()}
    pool = corpus.build_pool(traffic["corpus"])
    phases["pool"] = process_age()
    warmup = int(traffic["warmup_visits"])
    mean_frames = sum(c["frames"] for c in pool["clips"]) / len(pool["clips"])
    visits = warmup + math.ceil(traffic["max_frames_per_s"] * (opt.seconds + 60) / mean_frames)
    stream = corpus.plan_stream(pool, opt.seed, warmup, visits)
    paths = corpus.link_stream(stream, os.path.join(rundir, "stream"))
    # outputs kept for the check: a seeded quarter of the visits, and every
    # visit of the pool's longest clips
    longest = max(c["frames"] for c in pool["clips"])
    rng = random.Random(opt.seed)
    keep = {v["link"] for v in stream if v["frames"] == longest or rng.random() < 0.25}

    weights = _save_weights(ref.make_weights(opt.seed, device), os.path.join(rundir, "ckpt"))
    phases["weights"] = process_age()
    os.environ["VFT_CHECKPOINT_DIR"] = os.path.join(rundir, "ckpt")
    os.environ.pop("VFT_ALLOW_RANDOM_WEIGHTS", None)
    if opt.trace:
        os.environ["VFT_METRICS"] = "1"
    else:
        os.environ.pop("VFT_METRICS", None)
    flags = (list(config["flags"]) + list(traffic["flags"])
             + (list(config["control_flags"]) if opt.control else []) + list(opt.extra_flags)
             + ["--on_extraction", traffic["sink"], "--output_path", os.path.join(rundir, "out"),
                "--tmp_path", os.path.join(rundir, "tmp"), "--compilation_cache", KERNEL_BUILD_DIR,
                "--video_paths", paths[0]]
             + (["--device", "cpu"] if opt.dry_run else []))

    rec = Recorder(stream, warmup, opt.seconds, keep)
    if device == "cuda":
        rec.on_open = torch.cuda.reset_peak_memory_stats
    prof = None
    log = os.path.join(rundir, "program.log")
    with _stdout_to(log):
        from video_features_torch.cli import parse_args
        from video_features_torch.extractors import get_extractor

        if opt.trace:
            # CUPTI's first start is slow; pay it in set-up, not in the window
            with _profiler(device):
                torch.zeros(1, device=device).add_(1)
        ex = get_extractor(parse_args(flags))
        phases["extractor"] = process_age()
        rec.ex = ex
        if opt.program_hook is not None:
            opt.program_hook(ex)
        mark, fail, submit = ex._mark_succeeded, ex._fail, ex._submit_outputs

        def marked(path):
            mark(path)
            rec.completed(path)

        def failed(path, e):
            rec.failed.append((path, time.perf_counter()))
            fail(path, e)

        def submitted(path, feats, *a, **kw):
            if path in rec.keep:
                rec.outputs[path] = {k: np.array(v, copy=True) for k, v in feats.items()}
            return submit(path, feats, *a, **kw)

        ex._mark_succeeded, ex._fail, ex._submit_outputs = marked, failed, submitted
        trace_s = float(traffic["trace_seconds"])

        def progress(_n, _total):
            nonlocal prof
            now = time.perf_counter()
            if rec.t_open is None:
                if process_age() - phases["start"] > OPEN_DEADLINE_S:
                    raise RunFailed("the window did not open: the warm-up visits did not "
                                    f"complete within {OPEN_DEADLINE_S:.0f} s of the run's start")
                return
            if now < rec.t_close:
                return
            if "close" not in rec.clocks:
                rec.clocks["close"] = _clock_snapshot(ex)
            if not opt.trace:
                raise WindowClosed()
            if prof is None:
                # the profiled sub-window follows the window
                prof = _profiler(device)
                prof.__enter__()
                with torch.profiler.record_function(START_MARK):
                    pass
                rec.clocks["sub_start"] = _clock_snapshot(ex)
                rec.t_sub = (time.perf_counter(), None)
            elif now >= rec.t_sub[0] + trace_s:
                # the sub-window ends here, before run() unwinds
                with torch.profiler.record_function(END_MARK):
                    pass
                rec.clocks["sub_end"] = _clock_snapshot(ex)
                rec.t_sub = (rec.t_sub[0], now)
                raise WindowClosed()

        closed = False
        phases["run"] = process_age()
        try:
            ex.run(paths, progress=progress)
        except WindowClosed:
            closed = True
        finally:
            if prof is not None:
                if device == "cuda":
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
        if not closed:
            raise RunFailed("the stream ended before the window closed")

        found = forbidden_modules()
        if found:
            raise RunFailed(f"the process holds {', '.join(found)} after the window")
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        in_window = rec.in_window()
        done_links = {v["link"] for v, _ in rec.done}
        failures = len(rec.failed)
        attempted = len(in_window) + sum(1 for _, t in rec.failed
                                         if rec.t_open < t <= rec.t_close)
        frames_per_s = sum(v["frames"] for v in in_window) / opt.seconds
        trace = None
        if prof is not None:
            trace_path = os.path.join(rundir, "trace.json")
            prof.export_chrome_trace(trace_path)
            trace = TraceWindow.from_file(trace_path)
            del prof
        # free the program's state before the reference runs
        del ex, mark, fail, submit
        rec.ex = None
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

    limits = manifest.load_json(manifest.limits_path(opt.workload))
    # the rehearsal's tiny sizes have limits of their own, read on the CPU
    rehearsal = limits.pop("dry_run", None)
    if opt.dry_run and rehearsal is not None:
        limits = rehearsal
    checks, checked = _check(ref, model, limits, rec, in_window, weights, device,
                             opt.seed, int(traffic["check_videos"]))
    correct = (failures == 0 and bool(checked) and len(done_links) > 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    result = {"correct": correct, "attempted": attempted, "failed": failures}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cellspec["chips"], "memory_peak_bytes": int(peak)}
    if opt.trace:
        ctx = Context(workload=opt.workload, platform=dev["platform"], config=config,
                      traffic=traffic, model=model,
                      reference=ref, seconds=float(opt.seconds), trace=trace,
                      clocks=rec.clocks, completed=in_window, pool=pool, flags=flags)
        metrics = {}
        for m in manifest.per_layer_for(bench, opt.workload):
            value = manifest.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if trace is not None:
            dev["busy_s"] = trace.busy_seconds()
            dev["window_s"] = trace.seconds
            breakdown = {"device_ops": trace.top_device_ops(10),
                         "idle_gaps": trace.idle_gaps(10)}
    else:
        values = {"frames_per_s": frames_per_s, "setup_s": rec.setup_s}
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in manifest.end_to_end_for(bench, opt.workload)}
    if device == "cuda":
        dev["power_limit"] = _power_limit()
    result["metrics"] = metrics
    result["device"] = dev
    if opt.trace and trace is not None:
        result["breakdown"] = breakdown
    result["window"] = {"completed": len(in_window), "frames": sum(v["frames"] for v in in_window),
                        "setup_s": rec.setup_s, "setup_phases": phases,
                        "checked_videos": checked}
    if rec.t_sub is not None and rec.t_sub[1] is not None:
        # the profiler's cost: frames completed in the profiled sub-window
        # against those in as long a stretch at the window's end
        lo, hi = rec.t_sub
        result["window"]["profiled"] = {
            "seconds": hi - lo,
            "frames_done": sum(v["frames"] for v in rec.between(lo, hi)),
            "frames_done_before": sum(v["frames"] for v in
                                      rec.between(rec.t_close - (hi - lo), rec.t_close))}
    result["checks"] = checks
    return result


def _profiler(device: str):
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    return torch.profiler.profile(activities=acts)


def _check(ref, model, limits, rec: Recorder, in_window, weights, device, seed, n):
    """The reference over a seeded sample of the window's completed videos
    whose outputs were kept, the longest first: each number's worst reading
    beside its limit."""
    import torch

    kept = [v for v in in_window if v["link"] in rec.outputs]
    rng = random.Random(seed ^ 0x5EED)
    kept.sort(key=lambda v: (-v["frames"], rng.random()))
    sample = kept[:1] + rng.sample(kept[1:], min(max(n - 1, 0), len(kept) - 1)) if kept else []
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_weights = {name: {k: v.to(device) for k, v in sd.items()} for name, sd in weights.items()}
    worst = {name: 0.0 for name in limits}
    for v in sample:
        errs = ref.errors(rec.outputs[v["link"]], ref.outputs(v["path"], dev_weights, model, device))
        for name in limits:
            value = errs.get(name, float("inf"))
            # a NaN on either side is no agreement
            worst[name] = max(worst[name], value if math.isfinite(value) else float("inf"))
    checks = {name: {"value": worst[name] if sample else float("inf"), "limit": limit}
              for name, limit in limits.items()}
    return checks, [v["link"].rsplit("/", 1)[-1] for v in sample]


def print_result(result: Dict) -> None:
    """The numbers compared on standard error, the result as the last line of
    standard output (its ``checks`` key last)."""
    for name, c in result["checks"].items():
        if not math.isfinite(c["value"]):
            c["value"] = None  # no reading (JSON has no infinity)
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
