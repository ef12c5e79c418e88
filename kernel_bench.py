#!/usr/bin/env python3
"""Time the port's cost-volume kernels (``corr81``, ``warp_corr81``) per PWC level on the card.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 kernel_bench.py                  # corr81 of this checkout, default plans
    python3 kernel_bench.py --kernel warp_corr81   # the fused warp + cost volume
    python3 kernel_bench.py --repo DIR       # another checkout's kernel (e.g. a parent
                                             # commit unpacked with git archive), same timers
    python3 kernel_bench.py --sweep          # every compiled tile width × channel chunk
    python3 kernel_bench.py --phases         # the kernel with one phase taken out at a time

Times are fp32 at the main-path levels of ``chip_smoke.LEVELS`` (B=16, warm L2;
``warp_corr81`` at levels 5..2 with flows in U(-10, 10)): ``device_ms`` by
``chip_smoke.graph_ms`` (50 launches in one CUDA graph), ``call_ms`` by
``chip_smoke.cuda_ms`` (eager calls) and ``enqueue_ms`` by ``chip_smoke.enqueue_ms``
(the wrapper's host cost). ``--phases`` builds copies of ``csrc/<kernel>.cu`` (with
``csrc/corr81_tile.cuh`` inlined) with phases removed by text substitutions, and prints
each build's ptxas registers and spills; their outputs are wrong by design and are not
checked. ``corr81``: loads only, arithmetic only, stores only, and without stores.
``warp_corr81``: without the gather (the corner reads and the blend; the corner tables
stay), without the arithmetic, and without the stores. Every other run is held to the
plain version (``corr81_plain`` at rtol 1e-5 / atol 1e-6, ``warp_corr81_plain`` at
rtol 1e-4 / atol 1e-5). One JSON object per line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
HEADER = "corr81_tile.cuh"

# a phase of a kernel taken out, by substituting the lines that run it; a
# runtime-false condition (W < 0, cc < 0) keeps the compiler from removing the rest
_NO_LOADS = [("if (s < nchunks) load_chunk(s);",
              "if (s < nchunks && W < 0) load_chunk(s);"),
             ("if (k + STAGES - 1 < nchunks) load_chunk(",
              "if (k + STAGES - 1 < nchunks && W < 0) load_chunk(")]
_NO_MATH = [("for (int q = 0; q < cn; q += VEC) {",
             "for (int q = 0; q < cn * (cc < 0); q += VEC) {")]
_NO_STORES = [("for (int i = tid; i < nx * K; i += NTHREADS) o[i]",
               "if (W < 0) for (int i = tid; i < nx * K; i += NTHREADS) o[i]")]
_NO_GATHER = [("    gather<T2>(w2, raw,", "    if (W < 0) gather<T2>(w2, raw,"),
              ("    blend<HX, T2>(ring0", "    if (W < 0) blend<HX, T2>(ring0")]
PHASES = {
    "corr81": {"loads_only": _NO_MATH + _NO_STORES, "math_only": _NO_LOADS + _NO_STORES,
               "stores_only": _NO_LOADS + _NO_MATH, "no_stores": _NO_STORES},
    "warp_corr81": {"no_gather": _NO_GATHER, "no_math": _NO_MATH, "no_stores": _NO_STORES},
}
TOL = {"corr81": (1e-5, 1e-6), "warp_corr81": (1e-4, 1e-5)}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def build_variant(repo: str, kernel: str, name: str, subs) -> ctypes.CDLL:
    """Compile ``csrc/<kernel>.cu`` of ``repo``, its shared header inlined, with
    ``subs`` applied; print ptxas."""
    from video_features_torch.ops import cuda_lib

    csrc = os.path.join(repo, "video_features_torch", "csrc")
    with open(os.path.join(csrc, kernel + ".cu")) as f:
        src = f.read()
    include = f'#include "{HEADER}"'
    if include in src:
        with open(os.path.join(csrc, HEADER)) as f:
            src = src.replace(include, f.read())
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} is not in {kernel}.cu")
        src = src.replace(old, new)
    out_dir = os.path.join(cuda_lib.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"{kernel}-{name}.cu")
    so = os.path.join(out_dir, f"{kernel}-{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    log = subprocess.run([cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-o", so, cu],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         check=True, timeout=600).stdout
    emit(variant=name, ptxas=[ln.strip() for ln in log.splitlines()
                              if "registers" in ln or "spill" in ln])
    lib = ctypes.CDLL(so)
    lib.vft_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vft_cuda_error_string.restype = ctypes.c_char_p
    for fn, argtypes in cuda_lib.SIGNATURES[kernel].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _plans(corr, kernel: str, shape, sweep: bool):
    """The default plan's overrides first, then (``sweep``) every other tile width
    and chunk the plan accepts; ``[{}]`` for a checkout without a plan."""
    import torch

    plan_fn = getattr(corr, kernel + "_plan", None)
    if plan_fn is None:
        return [{}]
    f32 = torch.float32
    d = plan_fn(*shape, f32, f32)
    plans = [{"nx": d.nx, "chunk": d.chunk}]
    if sweep:
        for n in corr.CORR81_NX:
            for k in corr._chunks(shape[-1]):
                try:  # a chunk whose shared memory does not fit is refused
                    plan_fn(*shape, f32, f32, nx=n, chunk=k)
                except ValueError:
                    continue
                if (n, k) != (d.nx, d.chunk):
                    plans.append({"nx": n, "chunk": k})
    return plans


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(PHASES), default="corr81")
    ap.add_argument("--repo", default=HERE, help="checkout whose kernel to time")
    ap.add_argument("--sweep", action="store_true", help="every tile width and chunk")
    ap.add_argument("--phases", action="store_true", help="time the kernel's phases apart")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # the timers; it imports nothing of the package at import

    sys.path.insert(0, repo)
    from video_features_torch.device import select_device
    from video_features_torch.ops import corr, cuda_lib

    select_device("cuda")
    kernel = args.kernel
    fused = kernel == "warp_corr81"
    emit(repo=repo, kernel=kernel, nvidia_smi=cs.nvidia_smi_line(),
         kind=torch.cuda.get_device_name(0))
    libs = {"kernel": None}
    if args.phases:
        libs.update({n: build_variant(repo, kernel, n, subs)
                     for n, subs in PHASES[kernel].items()})
    kernel_lib = cuda_lib.load(kernel)
    rtol, atol = TOL[kernel]

    gen = torch.Generator(device="cuda").manual_seed(0)
    for level, h, w, c in cs.LEVELS:
        if fused and level == 6:  # level 6 has no flow to warp by
            continue
        shape = (cs.B, h, w, c)
        f1 = torch.randn(shape, generator=gen, device="cuda")
        f2 = torch.randn(shape, generator=gen, device="cuda")
        flow = torch.rand((cs.B, h, w, 2), generator=gen, device="cuda") * 20 - 10
        if fused:
            ref = corr.warp_corr81_plain(f1, f2, flow)
            wrapper = corr.warp_corr81_cuda
            args_in = (f1, f2, flow)
        else:
            ref = corr.corr81_plain(f1, f2)
            wrapper = corr.corr81_cuda
            args_in = (f1, f2)
        for name, lib in libs.items():
            cuda_lib._LIBS[kernel] = kernel_lib if lib is None else lib  # load()'s cache
            plans = _plans(corr, kernel, shape, args.sweep and lib is None)
            for plan in plans:
                def fn(plan=plan):
                    return wrapper(*args_in, **plan)

                out = fn()
                err = (out - ref).abs().max().item()
                if name == "kernel" and not bool(
                        ((out - ref).abs() <= atol + rtol * ref.abs()).all()):
                    raise AssertionError(f"{kernel} L{level} {plan}: max |err| {err:.3g}")
                row = {"kernel": kernel, "source": name, "level": level, "shape": list(shape),
                       **plan, "default": plan == plans[0], "device_ms": cs.graph_ms(fn),
                       "max_abs_err": err}
                if name == "kernel" and row["default"]:
                    row.update(call_ms=cs.cuda_ms(fn, 50), enqueue_ms=cs.enqueue_ms(fn))
                emit(**row)
    emit(nvidia_smi=cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
