"""Build and load the hand-written CUDA kernels of ``video_features_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes``. A build happens at first
use, from the package's sources only, into ``video_features_torch/_build/``;
the library's file name carries a hash of its source, the headers beside it
and the flags, so an edited source or header is rebuilt and an unchanged one
is reused. :func:`build` compiles several sources at once, one ``nvcc``
process each, started together.

Nothing here runs at import: the CPU tests import every module, and this host
may have neither ``nvcc`` nor a card. A missing compiler or a failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from typing import Dict, Iterable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entry points of csrc/*.cu: (argtypes), all returning an int CUDA error
SIGNATURES = {
    "corr81": {"corr81_launch": [_P, _P, _P, _P, _P],  # f1, f2, out, int plan[14], stream
               "corr81_smem_bytes": [_I] * 5},
    # f1, f2, flow, out, int plan[14], stream
    "warp_corr81": {"warp_corr81_launch": [_P, _P, _P, _P, _P, _P],
                    "warp_corr81_smem_bytes": [_I] * 5},
}

# name -> loaded library; filled on first use, never at import
_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> the compiler's report (ptxas registers / shared memory / spills)
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no nvcc on "
                           "PATH): the port's kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> str:
    """The library of ``csrc/<name>.cu``, named by a hash of that source, every
    ``csrc/*.cuh`` header (a source may include any of them) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> float:
    """Compile every listed source that has no current library, in parallel.

    Returns the seconds the build took (0 when all were current). Raises
    ``RuntimeError`` with the compiler's output when any build fails.
    """
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        lib.vft_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vft_cuda_error_string.restype = ctypes.c_char_p
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, kernel: str, rc: int) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.vft_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")
