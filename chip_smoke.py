#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port: build its kernels, check them, drive its main path.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It imports nothing of JAX or of ``video_features_tpu``; seeded weights come from
``tools/torch_mirrors.py`` (torch only), with the seeds of ``tools/make_goldens.py``
(i3d_rgb 6, i3d_flow 7, pwc 0). Phases, each printing one JSON line:

1. ``env``: card name and power limit (``nvidia-smi``), torch, CUDA, nvcc.
2. ``build``: the kernels of ``video_features_torch/csrc`` built from source,
   one ``nvcc`` each, in parallel, with the seconds it took.
3. ``kernels``: ``corr81`` and ``warp_corr81`` held against their plain PyTorch
   versions on the card with the tolerances of tests/test_pallas_corr.py (corr
   fp32 rtol 1e-5 / atol 1e-6, bf16 0.02; fused fp32 rtol 1e-4 / atol 1e-5, bf16
   0.03), in all four dtype pairs, on misaligned inputs (a ``[1:]`` slice, a
   view one element into a buffer) so that every copy width and the
   element-load path run, at every compiled tile width, and with each launch
   plan's shared memory held to the kernel's own layout. ``corr81``: the five
   main-path PWC levels (B=16) and the edge shapes of ``EDGE_SHAPES``.
   ``warp_corr81``: levels 5..2 and (3, 23, 37, 40); flows in U(-10, 10) reach
   out of the image, ``threshold_flow`` puts weight sums within ulps of the
   0.999 mask (the pixels zeroed must be the plain version's exactly), and
   zero flow must equal ``corr81`` bit for bit (``torch.equal``).
4. ``pwc``: ``pwc_forward_frames`` on a 65-frame 256×341 stack of the first
   sample video, kernel path against plain path, and the fused kernel
   (``VFT_FUSED_WARP_CORR=1``) against the default, timed after a warm-up in
   the order kernel, plain, fused, fused, plain, kernel. The warm-up records
   the scaled flow each decoder level hands the cost volume.
   Then ``kernel_times``: per level, fp32, the kernel's own time (``graph_ms``:
   launches captured in a CUDA graph), the eager call's (``cuda_ms``), the
   wrapper's host cost (``enqueue_ms``), ``torch.profiler``'s device time as a
   cross-check, and for ``warp_corr81`` the composition
   ``corr81_cuda(f1, warp_backward(f2, flow))`` beside it, with U(-10, 10) flows
   and with the flows recorded from PWC.
5. ``main_path``: ``video_features_torch.run.main`` exactly as the README's first
   command, on both sample videos, with seeded ``.pt`` checkpoints; outputs,
   shapes, finiteness, the done-manifest, and the kernels' launch counts (the
   counts are set to 0 just before and read just after). The opt-in fused path
   is driven the same way on one video, for ``warp_corr81``'s count.
6. ``breakdown``: the host seconds to decode and resize the first sample, and
   the device seconds of one stack's steps (rgb I3D, PWC, flow I3D, whole).
7. ``golden``: the port's ``ExtractI3D`` at the ``tests/goldens/i3d_v{1,2}.npz``
   settings against those files (rtol 1e-3, atol 1e-3·max|ref|), weight
   fingerprints checked first.

Then one JSON line of every kernel's numbers, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the script exits non-zero
without that last line. Without a card it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SAMPLES = [os.path.join(REPO, "sample", n) for n in ("v_GGSY1Qvo990.mp4", "v_ZNVhz7ctTq0.mp4")]
SEEDS = {"i3d_rgb": 6, "i3d_flow": 7, "pwc": 0}  # tools/make_goldens.py SEEDS
# NVIDIA H100 SXM data sheet: HBM rate and dense fp32 rate outside the tensor
# cores, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# main-path PWC levels at the sample videos' 256×341 frames (a 256×384 grid):
# (level, H, W, C), B = 16 pairs per decoder chunk
LEVELS = ((6, 4, 6, 196), (5, 8, 12, 128), (4, 16, 24, 96), (3, 32, 48, 64), (2, 64, 96, 32))
B = 16
TOL = {"corr81": {"float32": (1e-5, 1e-6), "bfloat16": (0.02, 0.02)},
       "warp_corr81": {"float32": (1e-4, 1e-5), "bfloat16": (0.03, 0.03)}}
NO_LIBRARY = ("no single PyTorch call computes the 81-tap cost volume "
              "(it would take 81 shifted products or an unfold of 81x the input)")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, after warm-up)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def enqueue_ms(fn, iters: int = 50) -> float:
    """Host milliseconds per call of ``fn`` to enqueue its work (no synchronize
    inside the timed loop): the wrapper's own cost, whatever the card does."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return host


def graph_ms(fn, launches: int = 50, replays: int = 5) -> float:
    """The kernel's own milliseconds per launch: ``launches`` calls of ``fn``
    captured into one CUDA graph and timed by CUDA events over ``replays``
    replays, so no host cost of the wrapper lies between two launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up off the capture: builds, loads, first allocations
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * launches)


def profiler_ms(fn, kernel: str, launches: int = 20):
    """Cross-check of ``graph_ms``: the mean self device time of the CUDA
    kernels whose name holds ``kernel`` (and not ``warp_`` unless asked) over
    ``launches`` eager calls, by ``torch.profiler``; None when the profiler
    reports no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        name = ev.key
        if kernel not in name or ("warp_" in name) != kernel.startswith("warp_"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        total, count = total + us, count + ev.count
    if count == 0 or total <= 0:
        return None
    return total / count / 1e3


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_env() -> dict:
    import torch

    from video_features_torch.ops.cuda_lib import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    info = {"nvidia_smi": nvidia_smi_line(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc": nvcc,
            "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    emit("env", **info)
    return info


def phase_build() -> None:
    from video_features_torch.ops import cuda_lib

    seconds = cuda_lib.build(["corr81", "warp_corr81"])
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in cuda_lib.BUILD_LOGS.items()}
    emit("build", seconds=seconds, ptxas=ptxas)


def _check(name, out, ref, dtype, what):
    import torch

    rtol, atol = TOL[name][dtype]
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    if not ok or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name} {what}: max |err| {err.max().item():.3g} exceeds "
                             f"rtol {rtol} / atol {atol}")
    return err.max().item()


# corr81's edge shapes: H or W of 1, just past a tile, C under the 8-channel
# chunk, bf16 at C=196 (8-byte copies), odd C (bf16: plain loads)
EDGE_SHAPES = ((2, 1, 37, 16), (2, 29, 1, 16), (1, 1, 1, 8), (2, 9, 33, 40), (1, 17, 17, 8),
               (2, 11, 13, 3), (2, 9, 10, 196), (2, 5, 7, 5))
# (f1, f2) dtype pairs the kernel takes; the composed warp path feeds (bf16, fp32)
PAIRS = (("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
         ("float32", "bfloat16"))


def threshold_flow(rng, b: int, h: int, w: int):
    """(b, h, w, 2) float32 flows whose warp samples sit just inside an image
    edge, so that each pixel's in-bounds weight sum lies within a few ulps of
    warp_backward's 0.999 keep-threshold, on both sides of it. Per pixel: an
    edge (left, right, top, bottom), a weight t on the in-image corners of
    0.999 moved by -6..6 ulps (``np.nextafter``), the sample coordinate across
    that edge at -1 + t (left, top) or size - t (right, bottom), the other
    coordinate the pixel's own. numpy only, from ``rng`` (a numpy Generator)."""
    import numpy as np

    steps = [np.float32(0.999)]
    for _ in range(6):
        steps = ([np.nextafter(steps[0], np.float32(0))] + steps
                 + [np.nextafter(steps[-1], np.float32(1))])
    t = np.array(steps, np.float32)[rng.integers(0, len(steps), (b, h, w))].astype(np.float64)
    edge = rng.integers(0, 4, (b, h, w))
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                         indexing="ij")
    flow = np.zeros((b, h, w, 2), np.float64)
    flow[..., 0] = np.where(edge == 0, t - 1 - gx, np.where(edge == 1, w - t - gx, 0.0))
    flow[..., 1] = np.where(edge == 2, t - 1 - gy, np.where(edge == 3, h - t - gy, 0.0))
    return flow.astype(np.float32)


def _pair_tol(pair) -> str:
    return "bfloat16" if "bfloat16" in pair else "float32"


def _corr_case(corr, lib, f1, f2, what, nx=None) -> dict:
    """corr81 on (f1, f2) against its plain version, with the launch plan's
    shared memory held to the kernel's own layout."""
    pair = (str(f1.dtype).split(".")[1], str(f2.dtype).split(".")[1])
    plan = corr.corr81_plan(*f1.shape, f1.dtype, f2.dtype, corr._alignment(f1),
                            corr._alignment(f2), nx)
    smem = lib.corr81_smem_bytes(plan.nx, plan.chunk, f1.shape[-1],
                                 corr._DTYPE_CODES[f1.dtype], corr._DTYPE_CODES[f2.dtype])
    if smem != plan.smem:
        raise AssertionError(f"corr81 {plan}: the kernel's layout needs {smem} B")
    err = _check("corr81", corr.corr81_cuda(f1, f2, nx), corr.corr81_plain(f1, f2),
                 _pair_tol(pair), f"{what} {pair} {plan}")
    return {"shape": list(f1.shape), "pair": pair, "what": what, "nx": plan.nx,
            "chunk": plan.chunk, "widths": [plan.width1, plan.width2], "corr81_err": err}


def phase_kernels() -> dict:
    import torch

    from video_features_torch.ops import corr
    from video_features_torch.ops.cuda_lib import load

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(shape, dtype="float32"):
        return torch.randn(shape, generator=gen, device=dev).to(dt[dtype])

    lib = load("corr81")
    corr_checks = []
    # corr81 at the main-path levels and the edge shapes, in every dtype pair;
    # misaligned inputs; every compiled tile width at the levels (fp32)
    for pair in PAIRS:
        for shape in [(B, h, w, c) for _, h, w, c in LEVELS] + list(EDGE_SHAPES):
            f1, f2 = randn(shape, pair[0]), randn(shape, pair[1])
            corr_checks.append(_corr_case(corr, lib, f1, f2, "level" if shape[0] == B else "edge"))
        big = (3, 5, 7, 6)
        f1, f2 = randn(big, pair[0]), randn(big, pair[1])
        corr_checks.append(_corr_case(corr, lib, f1[1:], f2[:2], "f1[1:] misaligned"))
        corr_checks.append(_corr_case(corr, lib, f1[:2], f2[1:], "f2[1:] misaligned"))
        # one element into a flat buffer: 4-byte (fp32) or 2-byte (bf16) aligned
        shape = (2, 9, 10, 8)
        n = math.prod(shape)
        flat1, flat2 = randn((n + 1,), pair[0]), randn((n + 1,), pair[1])
        corr_checks.append(_corr_case(corr, lib, flat1[1:].view(shape), flat2[:n].view(shape),
                                      "f1 offset by one element, misaligned"))
        corr_checks.append(_corr_case(corr, lib, flat1[:n].view(shape), flat2[1:].view(shape),
                                      "f2 offset by one element, misaligned"))
    for _, h, w, c in LEVELS:
        f1, f2 = randn((B, h, w, c)), randn((B, h, w, c))
        for nx in corr.CORR81_NX:
            corr_checks.append(_corr_case(corr, lib, f1, f2, "tile sweep", nx))
    if not any(0 in x["widths"] for x in corr_checks) or not any(
            8 in x["widths"] and "misaligned" in x["what"] for x in corr_checks):
        raise AssertionError("corr81 checks missed the plain-load or misaligned copy paths")

    warp_checks = _warp_checks(corr, randn, gen)
    emit("kernels", corr81_checks=corr_checks, warp_corr81_checks=warp_checks)
    return {"corr81_checks": corr_checks, "warp_corr81_checks": warp_checks}


def _warp_case(corr, lib, f1, f2, flow, what, nx=None, zero_equal=False,
               exact_zeros=False) -> dict:
    """warp_corr81 on (f1, f2, flow) against its plain version, with the plan's
    shared memory held to the kernel's own layout. A pixel whose 81 taps are
    all 0 on one side must be all 0 on the other; the tolerance holds
    everywhere, so a warped pixel that the 0.999 mask zeroes on one side only
    fails it at up to 81 taps. (Single taps may still be 0 on one side only: an
    fp32 sum can cancel to exactly 0 in one order of summation and not the
    other; they are counted, not failed.) ``exact_zeros``: inputs whose taps
    cannot cancel (all ones), so the taps that are 0 must be the same on both
    sides. ``zero_equal``: also compare zero flow with ``corr81`` bit for bit."""
    import torch

    from video_features_torch.ops.warp import warp_backward

    pair = (str(f1.dtype).split(".")[1], str(f2.dtype).split(".")[1])
    plan = corr.warp_corr81_plan(*f1.shape, f1.dtype, f2.dtype, corr._alignment(f1),
                                 corr._alignment(f2), nx)
    smem = lib.warp_corr81_smem_bytes(plan.nx, plan.chunk, f1.shape[-1],
                                      corr._DTYPE_CODES[f1.dtype], corr._DTYPE_CODES[f2.dtype])
    if smem != plan.smem:
        raise AssertionError(f"warp_corr81 {plan}: the kernel's layout needs {smem} B")
    out = corr.warp_corr81_cuda(f1, f2, flow, nx)
    ref = corr.warp_corr81_plain(f1, f2, flow)
    tag = f"{what} {tuple(f1.shape)} {pair} {plan}"
    err = _check("warp_corr81", out, ref, _pair_tol(pair), tag)
    zeroed, ref_zeroed = out == 0, ref == 0
    if not torch.equal(zeroed.all(-1), ref_zeroed.all(-1)):
        raise AssertionError(f"warp_corr81 {tag}: "
                             f"{int((zeroed.all(-1) != ref_zeroed.all(-1)).sum())} "
                             "pixels zeroed on one side only")
    if exact_zeros and not torch.equal(zeroed, ref_zeroed):
        raise AssertionError(f"warp_corr81 {tag}: {int((zeroed != ref_zeroed).sum())} "
                             "taps zeroed on one side only")
    masked = warp_backward(torch.ones_like(flow[..., :1]), flow) == 0
    row = {"shape": list(f1.shape), "pair": pair, "what": what, "nx": plan.nx,
           "chunk": plan.chunk, "widths": [plan.width1, plan.width2],
           "warp_corr81_err": err, "masked_pixels": int(masked.sum()),
           "zero_taps": int(zeroed.sum()),
           "one_sided_zero_taps": int((zeroed != ref_zeroed).sum())}
    if zero_equal:
        zero = corr.warp_corr81_cuda(f1, f2, torch.zeros_like(flow), nx)
        if not torch.equal(zero, corr.corr81_cuda(f1, f2)):
            raise AssertionError(f"warp_corr81 {tag}: zero flow differs from corr81")
        row["zero_flow_equals_corr81"] = True
    return row


def _warp_checks(corr, randn, gen) -> list:
    """warp_corr81 against its plain version: the main-path levels 5..2 and
    (3, 23, 37, 40) in all four dtype pairs, with flows in U(-10, 10) (which
    reach out of the image), zero flow (bit-equal to corr81) and
    ``threshold_flow`` (weight sums within ulps of 0.999); every compiled tile
    width at the levels; misaligned inputs, for every copy width and the
    element-load path."""
    import numpy as np
    import torch

    from video_features_torch.ops.cuda_lib import load

    lib = load("warp_corr81")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def flows(shape):
        uniform = torch.rand(shape[:3] + (2,), generator=gen, device=dev) * 20 - 10
        edge = torch.from_numpy(threshold_flow(rng, *shape[:3])).to(dev)
        return uniform, edge

    checks = []
    shapes = [(B, h, w, c) for level, h, w, c in LEVELS if level < 6] + [(3, 23, 37, 40)]
    for pair in PAIRS:
        for shape in shapes:
            f1, f2 = randn(shape, pair[0]), randn(shape, pair[1])
            uniform, edge = flows(shape)
            checks.append(_warp_case(corr, lib, f1, f2, uniform, "U(-10,10) flow",
                                     zero_equal=True))
            checks.append(_warp_case(corr, lib, f1, f2, edge, "threshold flow"))
            if not checks[-1]["masked_pixels"]:
                raise AssertionError(f"threshold flow masked no pixel at {shape} {pair}")
            # all ones: every tap is the kept weight sums of its warped pixel
            ones1, ones2 = (torch.ones(shape, dtype=dt, device=dev) for dt in (f1.dtype, f2.dtype))
            checks.append(_warp_case(corr, lib, ones1, ones2, edge, "threshold flow, ones",
                                     exact_zeros=True))
        big = (3, 5, 7, 6)
        f1, f2 = randn(big, pair[0]), randn(big, pair[1])
        flow = flows((2,) + big[1:])[0]
        checks.append(_warp_case(corr, lib, f1[1:], f2[:2], flow, "f1[1:] misaligned",
                                 zero_equal=True))
        checks.append(_warp_case(corr, lib, f1[:2], f2[1:], flow, "f2[1:] misaligned",
                                 zero_equal=True))
        shape = (2, 9, 10, 8)
        n = math.prod(shape)
        flat1, flat2 = randn((n + 1,), pair[0]), randn((n + 1,), pair[1])
        flow = flows(shape)[0]
        checks.append(_warp_case(corr, lib, flat1[1:].view(shape), flat2[:n].view(shape), flow,
                                 "f1 offset by one element, misaligned", zero_equal=True))
        checks.append(_warp_case(corr, lib, flat1[:n].view(shape), flat2[1:].view(shape), flow,
                                 "f2 offset by one element, misaligned", zero_equal=True))
    for shape in shapes[:-1]:
        f1, f2 = randn(shape), randn(shape)
        uniform, edge = flows(shape)
        for nx in corr.CORR81_NX:
            checks.append(_warp_case(corr, lib, f1, f2, uniform, "tile sweep", nx))
            checks.append(_warp_case(corr, lib, f1, f2, edge, "tile sweep, threshold flow", nx))
            checks.append(_warp_case(corr, lib, torch.ones_like(f1), torch.ones_like(f2), edge,
                                     "tile sweep, threshold flow, ones", nx, exact_zeros=True))
    widths = {(x["pair"][1], x["widths"][1]) for x in checks}
    want = {("float32", 16), ("float32", 8), ("float32", 4),
            ("bfloat16", 8), ("bfloat16", 4), ("bfloat16", 0)}
    if not want <= widths:
        raise AssertionError(f"warp_corr81 checks missed corner-read widths {want - widths}")
    return checks


def phase_kernel_times(pwc_flows: dict) -> dict:
    """Per level, fp32, B=16, warm L2: each kernel's own time (``graph_ms``:
    launches captured in a CUDA graph), the eager call's (``cuda_ms``), the
    wrapper's host cost (``enqueue_ms``), ``torch.profiler``'s device time as
    a cross-check, and the plain version's. ``corr81`` at every level;
    ``warp_corr81`` at levels 5..2, with flows in U(-10, 10) and with the
    level's scaled flow from the ``pwc`` phase (``pwc_flows``: level ->
    (16, h, w, 2)), each beside ``composition_ms``, the device time of
    ``corr81_cuda(f1, warp_backward(f2, flow))`` that the default path runs."""
    import torch

    from video_features_torch.ops import corr
    from video_features_torch.ops.warp import warp_backward

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    timing = {"corr81": [], "warp_corr81": []}
    for level, h, w, c in LEVELS:
        f1 = torch.randn((B, h, w, c), generator=gen, device=dev)
        f2 = torch.randn((B, h, w, c), generator=gen, device=dev)
        flow = torch.rand((B, h, w, 2), generator=gen, device=dev) * 20 - 10
        px = B * h * w
        cases = [("corr81", lambda: corr.corr81_cuda(f1, f2),
                  lambda: corr.corr81_plain(f1, f2),
                  px * (2 * c + 81) * 4, px * 81 * 2 * c)]
        if level < 6:
            cases.append(("warp_corr81", lambda: corr.warp_corr81_cuda(f1, f2, flow),
                          lambda: corr.warp_corr81_plain(f1, f2, flow),
                          px * (2 * c + 2 + 81) * 4, px * (81 * 2 * c + 7 * c)))
        for name, kern, plain, nbytes, flops in cases:
            call_ms = cuda_ms(kern, 50)
            host_ms = enqueue_ms(kern)
            device_ms = graph_ms(kern)
            prof_ms = profiler_ms(kern, name + "_kernel")
            plain_ms = cuda_ms(plain, 5)
            bms, by = bound(nbytes, flops)
            row = {"level": level, "shape": [B, h, w, c], "device_ms": device_ms,
                   "call_ms": call_ms, "enqueue_ms": host_ms, "profiler_ms": prof_ms,
                   "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                   "share_of_bound": bms / device_ms, "bytes": nbytes, "flops": flops}
            if name == "corr81":
                row["nx"] = corr.corr81_plan(B, h, w, c, f1.dtype, f2.dtype).nx
            else:
                p = corr.warp_corr81_plan(B, h, w, c, f1.dtype, f2.dtype)
                pflow = pwc_flows[level]
                ref = corr.warp_corr81_plain(f1, f2, pflow)
                _check("warp_corr81", corr.warp_corr81_cuda(f1, f2, pflow), ref, "float32",
                       f"L{level} pwc flow")
                row.update(
                    nx=p.nx, chunk=p.chunk,
                    composition_ms=graph_ms(lambda: corr.corr81_cuda(f1, warp_backward(f2, flow))),
                    pwc_flow_device_ms=graph_ms(lambda: corr.warp_corr81_cuda(f1, f2, pflow)),
                    pwc_flow_composition_ms=graph_ms(
                        lambda: corr.corr81_cuda(f1, warp_backward(f2, pflow))),
                    pwc_flow_max_abs=pflow.abs().max().item(),
                    pwc_flow_zeroed_share=(warp_backward(torch.ones_like(f2[..., :1]), pflow)
                                           == 0).float().mean().item())
            timing[name].append(row)
    emit("kernel_times", dtype="float32", warm_l2=True,
         device_ms="50 launches in one CUDA graph, events over 5 replays",
         call_ms="50 eager wrapper calls, events",
         enqueue_ms="host clock over 50 eager calls, no synchronize inside",
         profiler_ms="torch.profiler "
         "self device time per launch, 20 eager calls (null: no device time seen)",
         composition_ms="corr81_cuda(f1, warp_backward(f2, flow)) as device_ms",
         pwc_flow="the level's scaled flow of the pwc phase's first decoder chunk",
         **timing)
    return timing


def _stack_frames(n: int):
    """The first ``n`` frames of the first sample video, PIL-resized to the 256 edge."""
    import numpy as np

    from video_features_torch.io.video import open_video
    from video_features_torch.ops.image import pil_edge_resize

    _, frames = open_video(SAMPLES[0], transform=lambda f: pil_edge_resize(f, 256))
    out = []
    for rgb, _pos in frames:
        out.append(rgb)
        if len(out) == n:
            break
    return np.stack(out)


def _median_seconds(fn, order) -> dict:
    """Host seconds of ``fn(name)`` per name, each run ending in a synchronize,
    taken in the given order (e.g. ABCCBA) so drift falls on all names alike."""
    import statistics

    import torch

    runs: dict = {}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(name)
        torch.cuda.synchronize()
        runs.setdefault(name, []).append(time.perf_counter() - t0)
    return {n: {"median_s": statistics.median(r), "runs_s": r} for n, r in runs.items()}


def phase_pwc(pwc_net) -> dict:
    """Returns each decoder level's scaled flow (level -> (16, h, w, 2))."""
    import torch

    from video_features_torch.extractors.i3d import auto_pair_chunk
    from video_features_torch.models import pwc as pwc_mod
    from video_features_torch.models.pwc import pwc_forward_frames

    frames = torch.from_numpy(_stack_frames(65)).cuda().float()
    chunk = auto_pair_chunk(64, *frames.shape[1:3])
    paths = {"kernel": ("auto", "0"), "plain": ("xla", "0"), "fused": ("auto", "1")}
    flows = {}

    def run(name):
        impl, fused = paths[name]
        os.environ["VFT_FUSED_WARP_CORR"] = fused
        flows[name] = pwc_forward_frames(pwc_net, frames, corr_impl=impl, pair_chunk=chunk)

    # warm-up (cuDNN handles and first-call allocations), recording the scaled
    # flow that each decoder level hands the cost volume in the first chunk
    level_flows = {}
    warp_corr81 = pwc_mod.warp_corr81

    def recorder(f1, f2, flow, impl="auto"):
        level = {h: lv for lv, h, _, _ in LEVELS}[f1.shape[1]]
        level_flows.setdefault(level, flow.detach().clone())
        return warp_corr81(f1, f2, flow, impl)

    pwc_mod.warp_corr81 = recorder
    try:
        run("kernel")
    finally:
        pwc_mod.warp_corr81 = warp_corr81
    secs = _median_seconds(run, ["kernel", "plain", "fused", "fused", "plain", "kernel"])
    os.environ.pop("VFT_FUSED_WARP_CORR")
    ref = flows["plain"]
    errs = {}
    for name in ("kernel", "fused"):
        err = (flows[name] - ref).abs()
        errs[name] = err.max().item()
        # the frozen-golden tolerance: rtol 1e-3, atol 1e-3·max|ref|
        if not bool((err <= 1e-3 * ref.abs().max() + 1e-3 * ref.abs()).all()):
            raise AssertionError(f"pwc {name} path: max flow error {errs[name]:.3g}")
    emit("pwc", frames=list(frames.shape), pair_chunk=chunk,
         shape=list(ref.shape), max_abs_flow=ref.abs().max().item(),
         max_err_kernel_vs_plain=errs["kernel"], max_err_fused_vs_plain=errs["fused"],
         seconds=secs)
    if sorted(level_flows) != [2, 3, 4, 5] or any(
            f.shape != (B, h, w, 2) for lv, h, w, _ in LEVELS if lv < 6
            for f in [level_flows[lv]]):
        raise AssertionError(f"pwc flows captured at {[tuple(f.shape) for f in level_flows.values()]}")
    return level_flows


def phase_breakdown() -> None:
    """Where a default stack's time goes: the host decode + 256-edge resize of
    the first sample video, and the device steps of one 65-frame stack."""
    import torch

    from video_features_torch.config import ExtractionConfig
    from video_features_torch.extractors.i3d import (
        ExtractI3D,
        _center_crop_nhwc,
        auto_pair_chunk,
    )
    from video_features_torch.models.i3d import i3d_preprocess_flow
    from video_features_torch.models.pwc import pwc_forward_frames

    ex = ExtractI3D(ExtractionConfig(feature_type="i3d"))
    t0 = time.perf_counter()
    _, frames = ex._open_video(SAMPLES[0])
    n_frames = sum(1 for _ in frames)
    decode_s = time.perf_counter() - t0
    stack = torch.from_numpy(_stack_frames(65)[None]).cuda()
    chunk = auto_pair_chunk(64, stack.shape[2], stack.shape[3])
    with torch.inference_mode():
        flow = pwc_forward_frames(ex.pwc, stack.float(), pair_chunk=chunk)
        x_flow = i3d_preprocess_flow(_center_crop_nhwc(flow, ex.crop_size))
        steps = {
            "rgb_i3d": lambda: ex._rgb_forward(stack),
            "pwc": lambda: pwc_forward_frames(ex.pwc, stack.float(), pair_chunk=chunk),
            "flow_i3d": lambda: ex.i3d["flow"](x_flow),
            "whole_stack": lambda: (ex._rgb_forward(stack), ex._flow_forward(stack)),
        }
        secs = _median_seconds(lambda name: steps[name](), list(steps) * 3)
    emit("breakdown", video=os.path.basename(SAMPLES[0]), frames=n_frames,
         host_decode_resize_s=decode_s, stack_device_s=secs)


def _fingerprint(sd):
    import numpy as np

    tot, atot, n = np.float64(0), np.float64(0), 0
    for v in sd.values():
        a = v.detach().cpu().numpy().astype(np.float64)
        tot += a.sum()
        atot += np.abs(a).sum()
        n += a.size
    return np.array([tot, atot, n], np.float64)


def _checkpoints(dirpath: str) -> dict:
    import torch

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_mirrors as tm

    sds = {"i3d_rgb": tm.i3d_random_state_dict("rgb", seed=SEEDS["i3d_rgb"]),
           "i3d_flow": tm.i3d_random_state_dict("flow", seed=SEEDS["i3d_flow"]),
           "pwc-sintel": tm.pwc_random_state_dict(seed=SEEDS["pwc"])}
    for name, sd in sds.items():
        torch.save(sd, os.path.join(dirpath, name + ".pt"))
    return sds


def _run_main(out_dir: str, videos) -> float:
    from video_features_torch import run

    argv = ["--feature_type", "i3d", "--video_paths", *videos,
            "--on_extraction", "save_numpy", "--output_path", out_dir]
    t0 = time.perf_counter()
    rc = run.main(argv)
    if rc != 0:
        raise AssertionError(f"run.main({argv}) exited {rc}")
    return time.perf_counter() - t0


def phase_main_path(tmp: str) -> dict:
    import numpy as np
    import torch

    from video_features_torch.ops import corr

    out_dir = os.path.join(tmp, "output")
    torch.cuda.reset_peak_memory_stats()
    corr.corr81_cuda.launches = 0
    corr.warp_corr81_cuda.launches = 0
    seconds = _run_main(out_dir, SAMPLES)
    launches = {"corr81": corr.corr81_cuda.launches,
                "warp_corr81": corr.warp_corr81_cuda.launches}
    peak = torch.cuda.max_memory_allocated()

    feat_dir = os.path.join(out_dir, "i3d")
    stacks, feats = 0, {}
    for video, n_expected in zip(SAMPLES, (5, 6)):
        stem = os.path.splitext(os.path.basename(video))[0]
        for stream in ("rgb", "flow"):
            a = np.load(os.path.join(feat_dir, f"{stem}_{stream}.npy"))
            if a.shape != (n_expected, 1024) or not np.isfinite(a).all():
                raise AssertionError(f"{stem} {stream}: shape {a.shape}, finite "
                                     f"{np.isfinite(a).all()}")
            feats[(stem, stream)] = a
        ts = np.load(os.path.join(feat_dir, f"{stem}_timestamps_ms.npy"))
        if ts.shape != (n_expected,):
            raise AssertionError(f"{stem}: {ts.shape[0]} timestamps")
        stacks += n_expected
    with open(os.path.join(feat_dir, ".done_manifest.jsonl")) as f:
        done = [json.loads(line)["video"] for line in f]
    if sorted(done) != sorted(os.path.abspath(v) for v in SAMPLES):
        raise AssertionError(f"done-manifest holds {done}")
    if launches["corr81"] != 20 * stacks or launches["warp_corr81"] != 0:
        raise AssertionError(f"expected {20 * stacks} corr81 and 0 warp_corr81 launches, "
                             f"got {launches}")

    # the opt-in fused path through the same entry point, one video
    fused_dir = os.path.join(tmp, "output_fused")
    os.environ["VFT_FUSED_WARP_CORR"] = "1"
    corr.corr81_cuda.launches = 0
    corr.warp_corr81_cuda.launches = 0
    fused_seconds = _run_main(fused_dir, SAMPLES[:1])
    fused_launches = {"corr81": corr.corr81_cuda.launches,
                      "warp_corr81": corr.warp_corr81_cuda.launches}
    os.environ.pop("VFT_FUSED_WARP_CORR")
    if fused_launches != {"corr81": 4 * 5, "warp_corr81": 16 * 5}:
        raise AssertionError(f"fused path launches {fused_launches}")
    stem = os.path.splitext(os.path.basename(SAMPLES[0]))[0]
    fused_err = {}
    for stream in ("rgb", "flow"):
        a = np.load(os.path.join(fused_dir, "i3d", f"{stem}_{stream}.npy"))
        ref = feats[(stem, stream)]
        fused_err[stream] = float(np.abs(a - ref).max())
        np.testing.assert_allclose(a, ref, rtol=1e-3, atol=1e-3 * np.abs(ref).max())
    info = {"seconds": seconds, "videos": len(SAMPLES), "stacks": stacks,
            "seconds_per_video": seconds / len(SAMPLES), "stacks_per_s": stacks / seconds,
            "max_memory_allocated": peak, "launches": launches,
            "fused_path": {"seconds": fused_seconds, "stacks": 5,
                           "launches": fused_launches, "max_err_vs_default": fused_err}}
    emit("main_path", **info)
    return info


def phase_golden(tmp: str, sds: dict) -> None:
    import numpy as np

    from video_features_torch.config import ExtractionConfig
    from video_features_torch.extractors.i3d import ExtractI3D

    errs = {}
    for tag, video in zip(("v1", "v2"), SAMPLES):
        g = dict(np.load(os.path.join(REPO, "tests", "goldens", f"i3d_{tag}.npz")))
        for key, model in (("fp_rgb", "i3d_rgb"), ("fp_flow", "i3d_flow"),
                           ("fp_pwc", "pwc-sintel")):
            if not np.allclose(_fingerprint(sds[model]), g[key], rtol=1e-10):
                raise AssertionError(f"stale golden: {model} weights differ from {key}")
        ex = ExtractI3D(ExtractionConfig(
            feature_type="i3d", stack_size=16, step_size=16, flow_type="pwc",
            extraction_fps=int(g["cfg_extraction_fps"]), use_ffmpeg="never",
            output_path=os.path.join(tmp, "golden_out"), tmp_path=os.path.join(tmp, "gt")))
        out = ex.extract(video)
        for stream in ("rgb", "flow"):
            ref = g[stream]
            if out[stream].shape != ref.shape:
                raise AssertionError(f"{tag} {stream}: {out[stream].shape} vs {ref.shape}")
            np.testing.assert_allclose(out[stream], ref, rtol=1e-3,
                                       atol=1e-3 * np.abs(ref).max(),
                                       err_msg=f"{tag} {stream} vs golden")
            errs[f"{tag}_{stream}"] = {"max_abs_err": float(np.abs(out[stream] - ref).max()),
                                       "max_abs_ref": float(np.abs(ref).max())}
    emit("golden", tolerance="rtol 1e-3, atol 1e-3*max|ref|", errors=errs)


def kernel_summary(kern: dict, timing: dict, main: dict) -> dict:
    """Per kernel, the main path's launches and the sums over the main-path
    shapes of one launch each (corr81: levels 6..2, warp_corr81: levels 5..2)."""
    rows = []
    replaces = {"corr81": ("video_features_tpu/ops/pallas_corr.py:85",
                           "video_features_tpu/ops/pallas_corr.py:138"),
                "warp_corr81": ("video_features_tpu/ops/pallas_corr.py:325",)}
    launches = {"corr81": main["launches"]["corr81"],
                "warp_corr81": main["fused_path"]["launches"]["warp_corr81"]}
    for name in ("corr81", "warp_corr81"):
        t = timing[name]
        b = sum(x["bytes"] for x in t) / PEAK_BYTES_PER_S
        o = sum(x["flops"] for x in t) / PEAK_FP32_FLOPS
        rows.append({
            "name": name, "route": "cuda", "source": f"video_features_torch/csrc/{name}.cu",
            "replaces": replaces[name][0], "also_replaces": list(replaces[name][1:]),
            "launches": launches[name],
            "launches_from": ("default main path, both videos" if name == "corr81" else
                              "main path with VFT_FUSED_WARP_CORR=1, first video"),
            "max_abs_err": max(c[f"{name}_err"] for c in kern[f"{name}_checks"]),
            "ms": sum(x["device_ms"] for x in t),
            "device_ms": sum(x["device_ms"] for x in t),
            "call_ms": sum(x["call_ms"] for x in t),
            "plain_ms": sum(x["plain_ms"] for x in t),
            "bound_ms": max(b, o) * 1e3, "bound_by": "bytes" if b >= o else "operations",
            "library_ms": None, "library_note": NO_LIBRARY,
            "shapes": [x["shape"] for x in t],
        })
        if name == "warp_corr81":
            rows[-1].update({k: sum(x[k] for x in t) for k in (
                "composition_ms", "pwc_flow_device_ms", "pwc_flow_composition_ms")})
    return {"kernels": rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from video_features_torch.device import select_device
    from video_features_torch.models.pwc import PWCNet

    select_device("cuda")  # fp32 stays fp32: TF32 off for cuDNN and cuBLAS
    info = phase_env()
    phase_build()
    kern = phase_kernels()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ckpt = os.path.join(tmp, "ckpt")
        os.makedirs(ckpt)
        sds = _checkpoints(ckpt)
        os.environ["VFT_CHECKPOINT_DIR"] = ckpt
        os.environ.pop("VFT_ALLOW_RANDOM_WEIGHTS", None)
        pwc_net = PWCNet()
        pwc_net.load_state_dict(sds["pwc-sintel"])
        level_flows = phase_pwc(pwc_net.cuda().eval())
        timing = phase_kernel_times(level_flows)
        main_info = phase_main_path(tmp)
        phase_breakdown()
        phase_golden(tmp, sds)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(kernel_summary(kern, timing, main_info)))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                              "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
