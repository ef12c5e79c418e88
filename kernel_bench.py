#!/usr/bin/env python3
"""Time the port's ``corr81`` cost-volume kernel per PWC level on the card.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 kernel_bench.py                  # this checkout's kernel, default plans
    python3 kernel_bench.py --repo DIR       # another checkout's kernel (e.g. a parent
                                             # commit unpacked with git archive), same timers
    python3 kernel_bench.py --sweep          # every compiled tile width × channel chunk
    python3 kernel_bench.py --phases         # the kernel with its global loads, its
                                             # arithmetic or its output stores taken out

Times are fp32 at the main-path levels of ``chip_smoke.LEVELS`` (B=16, warm L2):
``device_ms`` by ``chip_smoke.graph_ms`` (50 launches in one CUDA graph), ``call_ms``
by ``chip_smoke.cuda_ms`` (eager calls) and ``enqueue_ms`` by ``chip_smoke.enqueue_ms``
(the wrapper's host cost). ``--phases`` builds copies of ``csrc/corr81.cu`` with one
phase removed by a text substitution (their outputs are wrong by design and are not
checked), and prints each build's ptxas registers and spills. Every other run is
held to ``corr81_plain`` at rtol 1e-5 / atol 1e-6. One JSON object per line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# a phase of the kernel taken out, by substituting the lines that run it; a
# runtime-false condition (W < 0) keeps the compiler from removing the rest
_NO_LOADS = [("if (s < nchunks) load_chunk(s);",
              "if (s < nchunks && W < 0) load_chunk(s);"),
             ("if (k + STAGES - 1 < nchunks) load_chunk(",
              "if (k + STAGES - 1 < nchunks && W < 0) load_chunk(")]
_NO_MATH = [("for (int q = 0; q < cn; q += VEC) {",
             "for (int q = 0; q < cn * (W < 0); q += VEC) {")]
_NO_STORES = [("for (int i = tid; i < nx * K; i += NTHREADS) o[i]",
               "if (W < 0) for (int i = tid; i < nx * K; i += NTHREADS) o[i]")]
PHASES = {"loads_only": _NO_MATH + _NO_STORES, "math_only": _NO_LOADS + _NO_STORES,
          "stores_only": _NO_LOADS + _NO_MATH, "no_stores": _NO_STORES}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def build_variant(repo: str, name: str, subs) -> ctypes.CDLL:
    """Compile ``csrc/corr81.cu`` of ``repo`` with ``subs`` applied; print ptxas."""
    from video_features_torch.ops import cuda_lib

    with open(os.path.join(repo, "video_features_torch", "csrc", "corr81.cu")) as f:
        src = f.read()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} is not in corr81.cu")
        src = src.replace(old, new)
    out_dir = os.path.join(cuda_lib.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, name + ".cu"), os.path.join(out_dir, name + ".so")
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
    for fn, argtypes in cuda_lib.SIGNATURES["corr81"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    emit(repo=repo, nvidia_smi=cs.nvidia_smi_line(), kind=torch.cuda.get_device_name(0))
    libs = {"kernel": None}
    if args.phases:
        libs.update({n: build_variant(repo, n, subs) for n, subs in PHASES.items()})
    kernel_lib = cuda_lib.load("corr81")

    gen = torch.Generator(device="cuda").manual_seed(0)
    for level, h, w, c in cs.LEVELS:
        f1 = torch.randn((cs.B, h, w, c), generator=gen, device="cuda")
        f2 = torch.randn((cs.B, h, w, c), generator=gen, device="cuda")
        ref = corr.corr81_plain(f1, f2)
        for name, lib in libs.items():
            cuda_lib._LIBS["corr81"] = kernel_lib if lib is None else lib  # load()'s cache
            plans = [{}]
            if hasattr(corr, "corr81_plan"):
                d = corr.corr81_plan(cs.B, h, w, c, f1.dtype, f2.dtype)
                plans = [{"nx": d.nx, "chunk": d.chunk}]
                if args.sweep and lib is None:
                    for n in corr.CORR81_NX:
                        for k in corr._chunks(c):
                            try:  # a chunk whose ring does not fit is refused
                                corr.corr81_plan(cs.B, h, w, c, f1.dtype, f2.dtype, nx=n,
                                                 chunk=k)
                            except ValueError:
                                continue
                            if (n, k) != (d.nx, d.chunk):
                                plans.append({"nx": n, "chunk": k})
            for plan in plans:
                def fn(plan=plan):
                    return corr.corr81_cuda(f1, f2, **plan)

                out = fn()
                err = (out - ref).abs().max().item()
                if name == "kernel" and not bool(
                        ((out - ref).abs() <= 1e-6 + 1e-5 * ref.abs()).all()):
                    raise AssertionError(f"corr81 L{level} {plan}: max |err| {err:.3g}")
                row = {"source": name, "level": level, "shape": [cs.B, h, w, c], **plan,
                       "default": plan == plans[0], "device_ms": cs.graph_ms(fn),
                       "max_abs_err": err}
                if name == "kernel" and row["default"]:
                    row.update(call_ms=cs.cuda_ms(fn, 50), enqueue_ms=cs.enqueue_ms(fn))
                emit(**row)
    emit(nvidia_smi=cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
