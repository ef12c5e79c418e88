"""PWC's 81-tap cost volume: CUDA kernels, their plain versions, and the dispatch.

Counterpart of the JAX ``ops/pallas_corr.py``. Channel ``k = (dy+4)·9 + (dx+4)``
of the volume is the channel mean of ``f1[y, x] · f2[y+dy, x+dx]`` over the 9×9
window, f2 zero-padded by 4 (reference ``correlation.py:44-112``).

- :func:`corr81_cuda` launches ``csrc/corr81.cu``, the port of the Pallas
  ``corr81_pallas`` and ``corr81_pallas_tiled`` kernels (one kernel covers
  both; Hopper has no 16² cap and no VMEM gate).
- :func:`warp_corr81_cuda` launches ``csrc/warp_corr81.cu``, the port of
  ``warp_corr81_pallas``: ``corr81(f1, warp_backward(f2, flow))`` without
  writing the warped f2 out.
- :func:`corr81_plain` and :func:`warp_corr81_plain` are plain PyTorch
  versions of the same functions. The CPU tests use them, and the card's
  checks hold the kernels against them.
- :func:`corr81` and :func:`warp_corr81` dispatch as ``pallas_corr.py:413-472``
  does: ``impl`` ``auto``/``pallas`` launches the kernel for a CUDA tensor,
  ``xla`` takes the plain version (the user's explicit choice), and a CPU
  tensor always takes the plain version. The fused kernel is opt-in, as in
  the JAX package: ``VFT_FUSED_WARP_CORR=1`` launches it (at any size);
  otherwise the plain warp feeds the ``corr81`` kernel. There is no fallback:
  a kernel that fails to build or launch raises.

Each kernel wrapper counts its launches in a plain integer attribute
(``corr81_cuda.launches``), raised by one per launch and nowhere else.

:func:`corr81_plan` and :func:`warp_corr81_plan` are the two kernels' launch
plans (tile, channel chunk, grid, block, dynamic shared memory, copy width of
each input): pure functions of the shapes, dtypes and pointer alignments, so
the CPU tests can hold their choices to the kernels' limits.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .warp import warp_backward

CORR_RADIUS = 4
CORR_CHANNELS = (2 * CORR_RADIUS + 1) ** 2  # 81
IMPLS = ("auto", "pallas", "xla")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def corr81_plain(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """81 shifted products, summed over channels in fp32 and scaled by 1/C.

    f1, f2 (B, H, W, C) → (B, H, W, 81) in f1's dtype.
    """
    b, h, w, c = f1.shape
    r = CORR_RADIUS
    f2p = F.pad(f2, (0, 0, r, r, r, r))
    f1f = f1.float()
    taps = []
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            shifted = f2p[:, dy : dy + h, dx : dx + w, :].float()
            taps.append((f1f * shifted).sum(-1) * (1.0 / c))
    return torch.stack(taps, dim=-1).to(f1.dtype)


def warp_corr81_plain(f1: torch.Tensor, f2: torch.Tensor,
                      flow: torch.Tensor) -> torch.Tensor:
    """``corr81_plain(f1, warp_backward(f2, flow))`` — flow already level-scaled."""
    return corr81_plain(f1, warp_backward(f2, flow))


def _check_features(name: str, f1: torch.Tensor, f2: torch.Tensor) -> None:
    for t in (f1, f2):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must lie on a CUDA device, got {t.device}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name}: dtype must be float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous (B, H, W, C)")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"{name}: f1 and f2 must share one (B, H, W, C) shape, got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    if f1.device != f2.device:
        raise ValueError(f"{name}: f1 on {f1.device}, f2 on {f2.device}")
    if f1.shape[-1] < 1:
        raise ValueError(f"{name}: C must be >= 1")
    if max(f1.numel(), f1.shape[0] * f1.shape[1] * f1.shape[2] * CORR_CHANNELS) >= 2 ** 31:
        raise ValueError(f"{name}: tensors too large for the kernel's int32 sizes")


# csrc/corr81.cu's fixed geometry: 8-row tiles of 4 x-groups of NX pixels, one
# thread per (row, x-group, dy), a ring of up to 3 stages of one channel chunk
_TILE_ROWS, _X_GROUPS, _STAGES = 8, 4, 3
_THREADS = _TILE_ROWS * _X_GROUPS * (2 * CORR_RADIUS + 1)  # 288
CORR81_NX = (4, 3, 1)  # the compiled tile widths: 8×16, 8×12, 8×4
_SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232_448  # shared memory one block may use on Hopper
_TWO_BLOCKS_SMEM = 233_472 // 2 - 1024  # each of two blocks on one SM (1 KB reserved each)
_MAX_GRID_Z = 65_535
_WARP_STAGES = 2  # csrc/warp_corr81.cu's ring of fp32 warped windows


class Corr81Plan(NamedTuple):
    """A launch of either kernel (``corr81`` or ``warp_corr81``)."""

    nx: int                       # consecutive output x per thread
    tile: Tuple[int, int]         # output rows × columns per block
    chunk: int                    # channels per ring stage (a power of two, >= 8)
    grid: Tuple[int, int, int]    # blocks along x tiles, y tiles, batch
    block: int                    # threads per block
    smem: int                     # dynamic shared-memory bytes
    width1: int                   # bytes per copy of f1 (16, 8, 4; 0 = plain loads)
    width2: int                   # the same for f2 (warp_corr81: per corner read)


def _stage_bytes(tx: int, cc: int, s1: int, s2: int) -> int:
    """corr81_tile.cuh's ``ring(...).stage_bytes``: the (8+8)×(tx+8) window of
    s2-byte values and the 8×tx f1 tile, rows padded to odd 16-byte units."""
    r = CORR_RADIUS
    ru1 = (tx * cc * s1 // 16) | 1
    ru2 = ((tx + 2 * r) * cc * s2 // 16) | 1
    return ((_TILE_ROWS + 2 * r) * ru2 + _TILE_ROWS * ru1) * 16


def _window_positions(nx: int) -> int:
    r = CORR_RADIUS
    return (_TILE_ROWS + 2 * r) * (_X_GROUPS * nx + 2 * r)


def _smem_bytes(nx: int, cc: int, c: int, s1: int, s2: int) -> int:
    """corr81.cu's ``smem_bytes``: min(3, chunks) ring stages, or the fp32
    output tile that reuses them, whichever is larger."""
    tx = _X_GROUPS * nx
    return max(min(_STAGES, -(-c // cc)) * _stage_bytes(tx, cc, s1, s2),
               _TILE_ROWS * tx * CORR_CHANNELS * 4)


def _warp_smem_bytes(nx: int, cc: int, c: int, s1: int, s2: int) -> int:
    """warp_corr81.cu's ``smem_bytes``: the corner tables (32 B a window
    position), the staging of the four corners' reads, and min(2, chunks)
    ring stages of an fp32 window; or the output tile, whichever is larger."""
    tx, npos = _X_GROUPS * nx, _window_positions(nx)
    used = (npos * 32 + 4 * npos * cc * s2
            + min(_WARP_STAGES, -(-c // cc)) * _stage_bytes(tx, cc, s1, 4))
    return max(used, _TILE_ROWS * tx * CORR_CHANNELS * 4)


def _chunks(c: int):
    """The channel chunks the kernel takes for ``c`` channels: powers of two
    from 8 up to the first that holds all of them."""
    cc = 8
    while True:
        yield cc
        if cc >= c:
            return
        cc *= 2


def _copy_width(c: int, itemsize: int, align: int) -> int:
    """The widest copy (16, 8 or 4 bytes) dividing both a pixel's ``c·itemsize``
    bytes and the pointer's alignment; 0 when even 4 does not (plain loads)."""
    width = 16
    while width >= 4 and ((c * itemsize) % width or align % width):
        width //= 2
    return width if width >= 4 else 0


def _gather_width(c: int, itemsize: int, align: int) -> int:
    """warp_corr81's corner read: the copy width, at most one corner's 4
    channels (16 bytes fp32, 8 bf16); 0 = element loads."""
    return min(_copy_width(c, itemsize, align), 4 * itemsize)


def _grid(b: int, h: int, w: int, nx: int) -> Tuple[int, int, int]:
    return (math.ceil(w / (_X_GROUPS * nx)), math.ceil(h / _TILE_ROWS), b)


def _nx_cost(b: int, h: int, w: int, nx: int) -> int:
    """Shared-memory cycles of the busiest SM, up to a common factor: blocks per
    SM times one block's 16-byte loads per 4 channels (NX of f1, NX+8 of f2)."""
    return math.ceil(math.prod(_grid(b, h, w, nx)) / _SMS) * (2 * nx + 2 * CORR_RADIUS)


def _warp_nx_cost(b: int, h: int, w: int, nx: int) -> int:
    """The busiest SM's shared-memory work, up to a common factor: waves of
    two blocks per SM (the plan keeps two per SM whenever the grid has more
    blocks than SMs) times one block's work per 4 channels, :func:`_nx_cost`'s
    16-byte loads plus the gather's: about 6 16-byte accesses per window
    position (4 corner copies in, 4 reads, 1 store; over 288 threads: /48)."""
    return math.ceil(math.prod(_grid(b, h, w, nx)) / (2 * _SMS)) * (
        (2 * nx + 2 * CORR_RADIUS) * 48 + _window_positions(nx))


def _plan(fused: bool, b: int, h: int, w: int, c: int, dtype1: torch.dtype,
          dtype2: torch.dtype, align1: int, align2: int, nx: Optional[int],
          chunk: Optional[int]) -> Corr81Plan:
    name = "warp_corr81" if fused else "corr81"
    if dtype1 not in _DTYPE_CODES or dtype2 not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtypes must be float32 or bfloat16, got {dtype1}, {dtype2}")
    if b > _MAX_GRID_Z:
        raise ValueError(f"{name}: batch {b} exceeds the grid's {_MAX_GRID_Z}")
    cost, smem_of = (_warp_nx_cost, _warp_smem_bytes) if fused else (_nx_cost, _smem_bytes)
    if nx is None:
        nx = min(CORR81_NX, key=lambda n: (cost(b, h, w, n), -n))
    elif nx not in CORR81_NX:
        raise ValueError(f"{name}: nx must be one of {CORR81_NX}, got {nx}")
    s1, s2 = dtype1.itemsize, dtype2.itemsize
    grid = _grid(b, h, w, nx)
    fits = [cc for cc in _chunks(c) if smem_of(nx, cc, c, s1, s2) <= MAX_SMEM]
    if chunk is None:
        blocks = math.prod(grid)
        budget = MAX_SMEM if blocks <= _SMS else _TWO_BLOCKS_SMEM
        fit = [cc for cc in fits if smem_of(nx, cc, c, s1, s2) <= budget] or [8]
        # the fused kernel overlaps each chunk's gather with the previous chunk's
        # arithmetic, so it always wants two chunks or more; corr81 only when the
        # grid runs in more than one wave
        if fused or blocks > 2 * 2 * _SMS:
            fit = [cc for cc in fit if 2 * cc <= c] or fit[:1]
        chunk = max(fit)
    elif chunk not in fits:
        raise ValueError(f"{name}: chunk must be one of {fits}, got {chunk}")
    width2 = _gather_width(c, s2, align2) if fused else _copy_width(c, s2, align2)
    return Corr81Plan(nx=nx, tile=(_TILE_ROWS, _X_GROUPS * nx), chunk=chunk, grid=grid,
                      block=_THREADS, smem=smem_of(nx, chunk, c, s1, s2),
                      width1=_copy_width(c, s1, align1), width2=width2)


@functools.lru_cache(maxsize=None)
def corr81_plan(b: int, h: int, w: int, c: int, dtype1: torch.dtype, dtype2: torch.dtype,
                align1: int = 16, align2: int = 16, nx: Optional[int] = None,
                chunk: Optional[int] = None) -> Corr81Plan:
    """The ``corr81`` kernel's launch plan for (b, h, w, c) inputs of the given
    dtypes whose data pointers are aligned to ``align1``/``align2`` bytes.

    The tile width comes from :data:`CORR81_NX` by the least :func:`_nx_cost`
    (ties to the wider tile). The channel chunk is the largest whose ring fits
    the shared memory of as many blocks per SM as the grid needs (up to two),
    and, when the grid needs more than one wave of two blocks per SM, one that
    splits the channels in two or more so that each block's copies overlap
    its arithmetic. ``nx`` or ``chunk`` override either choice.
    """
    return _plan(False, b, h, w, c, dtype1, dtype2, align1, align2, nx, chunk)


@functools.lru_cache(maxsize=None)
def warp_corr81_plan(b: int, h: int, w: int, c: int, dtype1: torch.dtype,
                     dtype2: torch.dtype, align1: int = 16, align2: int = 16,
                     nx: Optional[int] = None, chunk: Optional[int] = None) -> Corr81Plan:
    """The fused ``warp_corr81`` kernel's launch plan, as :func:`corr81_plan`
    picks it, with three differences: the tile width's cost counts the gather
    (:func:`_warp_nx_cost`); the shared memory counts the corner tables and the
    staging of the corner reads (:func:`_warp_smem_bytes`); and the chunk is
    at most C/2 wherever C allows, so that each chunk's gather overlaps the
    previous chunk's arithmetic. ``width2`` is the corner reads' copy width.
    """
    return _plan(True, b, h, w, c, dtype1, dtype2, align1, align2, nx, chunk)


def _alignment(t: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides ``t``'s data pointer."""
    p = t.data_ptr()
    return min(16, p & -p) if p else 16


def _on_device(dev: torch.device):
    """``torch.cuda.device(dev)``, entered only when ``dev`` is not current."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


@functools.lru_cache(maxsize=None)
def _packed_plan(b: int, h: int, w: int, c: int, dtype1: torch.dtype, dtype2: torch.dtype,
                 align1: int, align2: int, nx: Optional[int], chunk: Optional[int],
                 fused: bool = False):
    """The plan as the C entry points take it: 14 packed ints, built once per plan."""
    p = _plan(fused, b, h, w, c, dtype1, dtype2, align1, align2, nx, chunk)
    return (ctypes.c_int * 14)(b, h, w, c, _DTYPE_CODES[dtype1], _DTYPE_CODES[dtype2],
                               p.nx, p.chunk, p.width1, p.width2, p.grid[0], p.grid[1],
                               p.block, p.smem)


def corr81_cuda(f1: torch.Tensor, f2: torch.Tensor, nx: Optional[int] = None,
                chunk: Optional[int] = None) -> torch.Tensor:
    """Launch the ``corr81`` kernel. f1, f2 contiguous (B, H, W, C) CUDA tensors,
    fp32 or bf16 (they may differ) → (B, H, W, 81) in f1's dtype. ``nx`` and
    ``chunk`` force a tile width and channel chunk (:func:`corr81_plan` picks
    them otherwise)."""
    from .cuda_lib import check, load

    _check_features("corr81", f1, f2)
    b, h, w, c = f1.shape
    plan = _packed_plan(b, h, w, c, f1.dtype, f2.dtype, _alignment(f1), _alignment(f2),
                        nx, chunk)
    out = torch.empty((b, h, w, CORR_CHANNELS), dtype=f1.dtype, device=f1.device)
    lib = load("corr81")
    with _on_device(f1.device):
        rc = lib.corr81_launch(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), plan,
                               torch.cuda.current_stream().cuda_stream)
    check(lib, "corr81", rc)
    corr81_cuda.launches += 1
    return out


corr81_cuda.launches = 0


def warp_corr81_cuda(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                     nx: Optional[int] = None, chunk: Optional[int] = None) -> torch.Tensor:
    """Launch the fused ``warp_corr81`` kernel. f1, f2 as for :func:`corr81_cuda`;
    flow contiguous (B, H, W, 2) float32 on the same device. ``nx`` and
    ``chunk`` force a tile width and channel chunk (:func:`warp_corr81_plan`
    picks them otherwise)."""
    from .cuda_lib import check, load

    _check_features("warp_corr81", f1, f2)
    if (flow.device != f1.device or flow.dtype != torch.float32
            or not flow.is_contiguous() or flow.shape != f1.shape[:3] + (2,)):
        raise ValueError("warp_corr81: flow must be a contiguous float32 (B, H, W, 2) "
                         f"tensor on {f1.device}, got {flow.dtype} "
                         f"{tuple(flow.shape)} on {flow.device}")
    b, h, w, c = f1.shape
    plan = _packed_plan(b, h, w, c, f1.dtype, f2.dtype, _alignment(f1), _alignment(f2),
                        nx, chunk, fused=True)
    out = torch.empty((b, h, w, CORR_CHANNELS), dtype=f1.dtype, device=f1.device)
    lib = load("warp_corr81")
    with _on_device(f1.device):
        rc = lib.warp_corr81_launch(f1.data_ptr(), f2.data_ptr(), flow.data_ptr(),
                                    out.data_ptr(), plan,
                                    torch.cuda.current_stream().cuda_stream)
    check(lib, "warp_corr81", rc)
    warp_corr81_cuda.launches += 1
    return out


warp_corr81_cuda.launches = 0


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown corr impl {impl!r}; expected one of {IMPLS}")


def corr81(f1: torch.Tensor, f2: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Cost volume: the CUDA kernel for a CUDA tensor under ``auto``/``pallas``,
    the plain version under ``xla`` or for a CPU tensor."""
    _check_impl(impl)
    if impl == "xla" or f1.device.type == "cpu":
        return corr81_plain(f1, f2)
    return corr81_cuda(f1.contiguous(), f2.contiguous())


def warp_corr81(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                impl: str = "auto") -> torch.Tensor:
    """Backward-warp ``f2`` by ``flow`` (already level-scaled) and correlate."""
    _check_impl(impl)
    if impl == "xla" or f1.device.type == "cpu":
        return warp_corr81_plain(f1, f2, flow)
    if os.environ.get("VFT_FUSED_WARP_CORR") == "1":
        return warp_corr81_cuda(f1.contiguous(), f2.contiguous(), flow.contiguous())
    return corr81_cuda(f1.contiguous(), warp_backward(f2, flow))
