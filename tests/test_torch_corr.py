"""The port's cost volume (video_features_torch/ops/corr.py) against the JAX
package's Pallas kernels, run as the JAX tests run them on the CPU (interpret
mode), and against its XLA formulation.

Tolerances are those of tests/test_pallas_corr.py: corr fp32 rtol 1e-5 /
atol 1e-6, bf16 0.02; fused warp+corr fp32 rtol 1e-4 / atol 1e-5 (fp32 sums
taken in another order). The CUDA kernels themselves run only on a card: the
one case here that needs one skips when torch.cuda.is_available() is false,
and chip_smoke.py holds them against the plain versions on the H100. What the
CPU can check of the kernels is their launch plans (``corr81_plan``,
``warp_corr81_plan``): that their tiles cover the image once, that they fit the
card's limits, and that their copy widths suit the rows and pointers they are
given; and that the build cache sees the shared header.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import threshold_flow
from video_features_tpu.ops.pallas_corr import (
    corr81_pallas,
    corr81_pallas_tiled,
    corr81_xla,
    warp_corr81_pallas,
)
from video_features_tpu.ops.warp import warp_backward as jax_warp_backward
from video_features_torch.ops import corr as tcorr
from video_features_torch.ops import cuda_lib
from video_features_torch.ops.warp import bilinear_sample, warp_backward

JAX_CORR = {
    "pallas": lambda a, b: corr81_pallas(a, b, interpret=True),
    "pallas_tiled": lambda a, b: corr81_pallas_tiled(a, b, interpret=True),
    "xla": corr81_xla,
}
SHAPES = {"pallas": (2, 12, 16, 32), "pallas_tiled": (2, 20, 24, 16), "xla": (2, 12, 16, 32)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=0.02, atol=0.02)}


def _pair(rng, shape):
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_fn", ["pallas", "pallas_tiled", "xla"])
def test_corr81_plain_matches_jax(rng, jax_fn, dtype):
    f1, f2 = _pair(rng, SHAPES[jax_fn])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = JAX_CORR[jax_fn](jnp.asarray(f1).astype(jdt), jnp.asarray(f2).astype(jdt))
    out = tcorr.corr81_plain(torch.from_numpy(f1).to(tdt), torch.from_numpy(f2).to(tdt))
    assert out.dtype == tdt and tuple(out.shape) == SHAPES[jax_fn][:3] + (81,)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               **TOL[dtype])


def test_warp_corr81_plain_matches_fused_pallas(rng):
    """Flows in U(-10, 10) reach out of the image (partial-tap zeroing) at a
    size that is not a multiple of the 16×16 tile."""
    f1, f2 = _pair(rng, (2, 20, 24, 16))
    flow = rng.uniform(-10, 10, (2, 20, 24, 2)).astype(np.float32)
    ref = np.asarray(warp_corr81_pallas(jnp.asarray(f1), jnp.asarray(f2),
                                        jnp.asarray(flow), interpret=True))
    out = tcorr.warp_corr81_plain(torch.from_numpy(f1), torch.from_numpy(f2),
                                  torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_warp_corr81_zero_flow_is_plain_corr(rng):
    f1, f2 = (torch.from_numpy(a) for a in _pair(rng, (2, 20, 24, 16)))
    zero = torch.zeros((2, 20, 24, 2), dtype=torch.float32)
    np.testing.assert_allclose(tcorr.warp_corr81_plain(f1, f2, zero).numpy(),
                               tcorr.corr81_plain(f1, f2).numpy(), rtol=1e-5, atol=1e-6)


def _keep_margin_ulps(flow: torch.Tensor) -> torch.Tensor:
    """Each pixel's sampled in-bounds weight sum minus 0.999, in ulps of 0.999."""
    b, h, w, _ = flow.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    coords = torch.stack([xs, ys], -1)[None] + flow
    mask = bilinear_sample(torch.ones((b, h, w, 1)), coords)[..., 0].double()
    t = np.float32(0.999)
    return (mask - float(t)) / float(np.spacing(t))


def test_threshold_flows_straddle_the_keep_threshold(rng):
    """The flows of the threshold tests put many pixels within 3 ulps of 0.999,
    on both sides (kept: sum > 0.999; zeroed: sum <= 0.999)."""
    margin = _keep_margin_ulps(torch.from_numpy(threshold_flow(rng, 2, 20, 24)))
    near = margin.abs() <= 3
    assert int((near & (margin > 0)).sum()) >= 20
    assert int((near & (margin <= 0)).sum()) >= 20
    assert float(margin.abs().max()) <= 16


@pytest.mark.parametrize("shape", [(2, 20, 24, 16), (1, 9, 37, 8)])
def test_warp_zeroes_the_pixels_jax_zeroes_at_the_threshold(rng, shape):
    """Weight sums within ulps of 0.999: the port's warp_backward zeroes exactly
    the pixels the JAX gather warp zeroes, and the values match."""
    f2 = rng.normal(size=shape).astype(np.float32)
    flow = threshold_flow(rng, *shape[:3])
    ref = np.asarray(jax_warp_backward(jnp.asarray(f2), jnp.asarray(flow), impl="gather"))
    out = warp_backward(torch.from_numpy(f2), torch.from_numpy(flow)).numpy()
    zeroed = (out == 0).all(-1)
    assert 0 < zeroed.sum() < zeroed.size
    np.testing.assert_array_equal(zeroed, (ref == 0).all(-1))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_warp_corr81_zeroes_the_taps_pallas_zeroes_at_the_threshold(rng):
    """The same flows through the fused function: every tap that reads a zeroed
    (or out-of-image) warped pixel is 0 in both, the rest within tolerance."""
    f1, f2 = _pair(rng, (2, 20, 24, 16))
    flow = threshold_flow(rng, 2, 20, 24)
    ref = np.asarray(warp_corr81_pallas(jnp.asarray(f1), jnp.asarray(f2),
                                        jnp.asarray(flow), interpret=True))
    out = tcorr.warp_corr81_plain(torch.from_numpy(f1), torch.from_numpy(f2),
                                  torch.from_numpy(flow)).numpy()
    np.testing.assert_array_equal(out == 0, ref == 0)
    np.testing.assert_array_equal((out == 0).all(-1), (ref == 0).all(-1))
    assert 0 < (out == 0).sum() < out.size
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_cpu_dispatch_takes_plain_and_launches_nothing(rng, impl, monkeypatch):
    monkeypatch.setenv("VFT_FUSED_WARP_CORR", "1")
    f1, f2 = (torch.from_numpy(a) for a in _pair(rng, (1, 9, 11, 8)))
    flow = torch.from_numpy(rng.uniform(-3, 3, (1, 9, 11, 2)).astype(np.float32))
    before = (tcorr.corr81_cuda.launches, tcorr.warp_corr81_cuda.launches)
    assert torch.equal(tcorr.corr81(f1, f2, impl), tcorr.corr81_plain(f1, f2))
    assert torch.equal(tcorr.warp_corr81(f1, f2, flow, impl),
                       tcorr.warp_corr81_plain(f1, f2, flow))
    assert (tcorr.corr81_cuda.launches, tcorr.warp_corr81_cuda.launches) == before


def test_dispatch_rejects_unknown_impl(rng):
    f1, f2 = (torch.from_numpy(a) for a in _pair(rng, (1, 4, 4, 2)))
    with pytest.raises(ValueError):
        tcorr.corr81(f1, f2, "cuda")


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    """A kernel wrapper launches or raises: it never computes on the CPU."""
    f1, f2 = (torch.from_numpy(a) for a in _pair(rng, (1, 4, 4, 2)))
    with pytest.raises(ValueError, match="CUDA"):
        tcorr.corr81_cuda(f1, f2)
    with pytest.raises(ValueError, match="CUDA"):
        tcorr.warp_corr81_cuda(f1, f2, torch.zeros((1, 4, 4, 2)))


@pytest.mark.cuda
def test_kernels_match_plain_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    f1, f2 = (torch.from_numpy(a).cuda() for a in _pair(rng, (2, 20, 24, 16)))
    flow = torch.from_numpy(rng.uniform(-10, 10, (2, 20, 24, 2)).astype(np.float32)).cuda()
    np.testing.assert_allclose(tcorr.corr81_cuda(f1, f2).cpu().numpy(),
                               tcorr.corr81_plain(f1, f2).cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tcorr.warp_corr81_cuda(f1, f2, flow).cpu().numpy(),
                               tcorr.warp_corr81_plain(f1, f2, flow).cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    # an edge shape just past a tile, f1 one element into its buffer (4-byte copies)
    a, b = _pair(rng, (1, 17, 17, 8))
    e1 = torch.from_numpy(np.concatenate([[0.0], a.ravel()]).astype(np.float32)).cuda()[1:]
    e1, e2 = e1.view(a.shape), torch.from_numpy(b).cuda()
    np.testing.assert_allclose(tcorr.corr81_cuda(e1, e2).cpu().numpy(),
                               tcorr.corr81_plain(e1, e2).cpu().numpy(),
                               rtol=1e-5, atol=1e-6)


# ---- the corr81 kernel's launch plan (pure Python; the kernel checks it too) ----

PLAN_SHAPES = [(16, 4, 6, 196), (16, 8, 12, 128), (16, 16, 24, 96), (16, 32, 48, 64),
               (16, 64, 96, 32), (2, 1, 37, 16), (2, 29, 1, 16), (1, 1, 1, 8),
               (2, 9, 33, 40), (1, 17, 17, 8), (2, 11, 13, 3), (2, 9, 10, 196),
               (2, 5, 7, 5)]
PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("nx", [None] + list(tcorr.CORR81_NX))
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_corr81_plan_tiles_cover_every_pixel_once(shape, nx):
    b, h, w, c = shape
    plan = tcorr.corr81_plan(b, h, w, c, torch.float32, torch.float32, nx=nx)
    ty, tx = plan.tile
    assert plan.grid[2] == b
    cover = np.zeros((h, w), np.int32)
    for by in range(plan.grid[1]):
        for bx in range(plan.grid[0]):
            tile = cover[by * ty:(by + 1) * ty, bx * tx:(bx + 1) * tx]
            assert tile.size > 0, "a block with no output pixel"
            tile += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: str(p).replace("torch.", ""))
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_corr81_plan_fits_the_card(shape, pair):
    for nx in tcorr.CORR81_NX:
        plan = tcorr.corr81_plan(*shape, *pair, nx=nx)
        assert 0 < plan.smem <= tcorr.MAX_SMEM
        assert plan.block <= 1024 and plan.block % 32 == 0
        assert plan.grid[0] < 2 ** 31 and plan.grid[1] <= 65535 and plan.grid[2] <= 65535
        # the ring of three 8-channel stages or the output tile, whichever is larger
        assert plan.smem >= plan.tile[0] * plan.tile[1] * 81 * 4


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: str(p).replace("torch.", ""))
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_corr81_plan_copy_widths_divide_row_and_pointer(shape, pair):
    c = shape[-1]
    for align1, align2 in ((16, 16), (8, 16), (16, 4), (4, 8), (2, 2)):
        align1, align2 = max(align1, pair[0].itemsize), max(align2, pair[1].itemsize)
        plan = tcorr.corr81_plan(*shape, *pair, align1, align2)
        for width, dtype, al in ((plan.width1, pair[0], align1),
                                 (plan.width2, pair[1], align2)):
            assert width in (0, 4, 8, 16)
            if width:
                assert (c * dtype.itemsize) % width == 0 and al % width == 0
            else:  # plain loads only where even a 4-byte copy is impossible
                assert (c * dtype.itemsize) % 4 or al % 4
            if al < 16:
                assert width != 16


def test_corr81_plan_narrows_copies_where_16_bytes_cannot_go():
    bf, f32 = torch.bfloat16, torch.float32
    # bf16 at C=196: 392-byte rows take 8-byte copies
    assert tcorr.corr81_plan(16, 4, 6, 196, bf, bf)[6:] == (8, 8)
    # the main path's fp32 levels all take 16-byte copies
    for c in (196, 128, 96, 64, 32):
        assert tcorr.corr81_plan(16, 8, 8, c, f32, f32)[6:] == (16, 16)
    # bf16 with an odd C: plain loads in the kernel (width 0), never the plain version
    assert tcorr.corr81_plan(2, 5, 7, 5, bf, f32)[6:] == (0, 4)
    # a [1:] slice is contiguous but its pointer is offset by H·W·C·itemsize bytes;
    # a view one element into a flat buffer is offset by the itemsize alone
    base = torch.zeros((3, 5, 7, 6), dtype=f32)
    flat = torch.zeros(2 * 9 * 10 * 8 + 1, dtype=f32)
    if tcorr._alignment(base) == 16 and tcorr._alignment(flat) == 16:
        sliced = base[1:]
        assert sliced.is_contiguous() and tcorr._alignment(sliced) == 8
        assert tcorr.corr81_plan(*sliced.shape, f32, f32, 8, 16)[6:] == (8, 8)
        view = flat[1:].view(2, 9, 10, 8)
        assert view.is_contiguous() and tcorr._alignment(view) == 4
        assert tcorr.corr81_plan(*view.shape, f32, f32, 4, 16)[6:] == (4, 16)
        assert tcorr.corr81_plan(*view.shape, bf, bf, 2, 16)[6:] == (0, 16)


@pytest.mark.parametrize("shape", PLAN_SHAPES[:5])
def test_corr81_plan_picks_the_cheapest_tile(shape):
    b, h, w, _ = shape
    plan = tcorr.corr81_plan(*shape, torch.float32, torch.float32)
    costs = {nx: tcorr._nx_cost(b, h, w, nx) for nx in tcorr.CORR81_NX}
    assert plan.nx in tcorr.CORR81_NX and costs[plan.nx] == min(costs.values())


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: str(p).replace("torch.", ""))
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_corr81_plan_chunk_is_the_largest_that_fits(shape, pair):
    b, h, w, c = shape
    plan = tcorr.corr81_plan(*shape, *pair)
    cc = plan.chunk
    assert cc >= 8 and cc & (cc - 1) == 0 and (cc // 2 < c or cc == 8)
    s1, s2 = pair[0].itemsize, pair[1].itemsize
    assert plan.smem == tcorr._smem_bytes(plan.nx, cc, c, s1, s2)
    blocks = math.prod(plan.grid)
    if blocks > 4 * tcorr._SMS:  # several waves: every block pipelines its channels
        assert 2 * cc <= c or cc == 8
    elif 2 * cc < 2 * c:  # a larger chunk would not fit the shared memory
        budget = tcorr.MAX_SMEM if blocks <= tcorr._SMS else tcorr._TWO_BLOCKS_SMEM
        assert tcorr._smem_bytes(plan.nx, 2 * cc, c, s1, s2) > budget


def test_corr81_plan_at_the_main_path_levels():
    """The tile widths and chunks the card measurements in PERF.md were taken with."""
    f32 = torch.float32
    got = {shape: tcorr.corr81_plan(*shape, f32, f32)[:3:2] for shape in PLAN_SHAPES[:5]}
    assert got == {(16, 4, 6, 196): (1, 256), (16, 8, 12, 128): (1, 128),
                   (16, 16, 24, 96): (3, 128), (16, 32, 48, 64): (3, 64),
                   (16, 64, 96, 32): (4, 16)}
    # level 2: 8×16 tiles; the ring is two 16-channel stages of 33,152 B each, more
    # than the 41,472 B output tile that reuses it
    assert tcorr.corr81_plan(16, 64, 96, 32, f32, f32).smem == 66_304


def test_corr81_packed_plan_is_the_plan():
    f32, bf = torch.float32, torch.bfloat16
    p = tcorr.corr81_plan(2, 9, 33, 40, bf, f32, 16, 8)
    packed = list(tcorr._packed_plan(2, 9, 33, 40, bf, f32, 16, 8, None, None))
    assert packed == [2, 9, 33, 40, 1, 0, p.nx, p.chunk, p.width1, p.width2, p.grid[0],
                      p.grid[1], p.block, p.smem]


def test_corr81_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        tcorr.corr81_plan(1, 8, 8, 8, torch.float32, torch.float32, nx=5)
    with pytest.raises(ValueError):
        tcorr.corr81_plan(70000, 1, 1, 8, torch.float32, torch.float32)
    with pytest.raises(TypeError):
        tcorr.corr81_plan(1, 8, 8, 8, torch.float16, torch.float32)
    with pytest.raises(ValueError):  # not a power of two
        tcorr.corr81_plan(1, 8, 8, 64, torch.float32, torch.float32, chunk=24)
    with pytest.raises(ValueError):  # a ring that does not fit a block's shared memory
        tcorr.corr81_plan(1, 8, 64, 512, torch.float32, torch.float32, nx=4, chunk=512)


# ---- the fused warp_corr81 kernel's launch plan ----

WARP_SHAPES = [(16, 8, 12, 128), (16, 16, 24, 96), (16, 32, 48, 64), (16, 64, 96, 32),
               (3, 23, 37, 40)]


@pytest.mark.parametrize("align", [16, 8, 4, 2])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: str(p).replace("torch.", ""))
@pytest.mark.parametrize("shape", WARP_SHAPES)
def test_warp_corr81_plan_fits_the_card(shape, pair, align):
    """At every main-path level and an edge shape, in every dtype pair and
    pointer alignment: the plan fits a block (two a SM when the grid needs
    more than one block a SM), takes a compiled tile, a power-of-two chunk of
    8 or more, and copies that divide the rows and the pointers."""
    c = shape[-1]
    align1, align2 = max(align, pair[0].itemsize), max(align, pair[1].itemsize)
    plan = tcorr.warp_corr81_plan(*shape, *pair, align1, align2)
    assert 0 < plan.smem <= tcorr.MAX_SMEM
    assert plan.smem == tcorr._warp_smem_bytes(plan.nx, plan.chunk, c, pair[0].itemsize,
                                               pair[1].itemsize)
    if math.prod(plan.grid) > tcorr._SMS:
        assert plan.smem <= tcorr._TWO_BLOCKS_SMEM
    assert plan.nx in tcorr.CORR81_NX and plan.tile == (8, 4 * plan.nx)
    assert plan.block == 288 and plan.grid[2] == shape[0]
    assert plan.grid[0] * plan.tile[1] >= shape[2] > (plan.grid[0] - 1) * plan.tile[1]
    assert plan.grid[1] * plan.tile[0] >= shape[1] > (plan.grid[1] - 1) * plan.tile[0]
    assert plan.chunk >= 8 and plan.chunk & (plan.chunk - 1) == 0
    assert 2 * plan.chunk <= c or plan.chunk == 8
    for width, dtype, al, most in ((plan.width1, pair[0], align1, 16),
                                   (plan.width2, pair[1], align2, 4 * pair[1].itemsize)):
        assert width in (0, 4, 8, 16) and width <= most
        if width:
            assert (c * dtype.itemsize) % width == 0 and al % width == 0
        else:  # element loads only where even a 4-byte copy is impossible
            assert (c * dtype.itemsize) % 4 or al % 4


def test_warp_corr81_plan_at_the_main_path_levels():
    """The tile widths and chunks the card measurements in PERF.md were taken with."""
    f32 = torch.float32
    got = {shape: tcorr.warp_corr81_plan(*shape, f32, f32)[:3:2] for shape in WARP_SHAPES[:4]}
    assert got == {(16, 8, 12, 128): (1, 32), (16, 16, 24, 96): (1, 16),
                   (16, 32, 48, 64): (3, 8), (16, 64, 96, 32): (4, 8)}
    # level 2: the corner tables (384 positions × 32 B), the staging of four corners'
    # 8-channel reads and two ring stages of 16,768 B
    assert tcorr.warp_corr81_plan(16, 64, 96, 32, f32, f32).smem == (
        384 * 32 + 4 * 384 * 8 * 4 + 2 * 16_768)


def test_warp_corr81_packed_plan_is_the_plan():
    f32, bf = torch.float32, torch.bfloat16
    p = tcorr.warp_corr81_plan(3, 23, 37, 40, f32, bf, 8, 16, nx=3, chunk=8)
    packed = list(tcorr._packed_plan(3, 23, 37, 40, f32, bf, 8, 16, 3, 8, fused=True))
    assert packed == [3, 23, 37, 40, 0, 1, 3, 8, p.width1, p.width2, p.grid[0], p.grid[1],
                      288, p.smem]
    assert (p.width1, p.width2) == (8, 8)


@pytest.mark.parametrize("override", [dict(nx=2), dict(nx=5), dict(chunk=4), dict(chunk=24),
                                      dict(nx=4, chunk=512)])
def test_warp_corr81_plan_refuses_overrides_outside_the_compiled_set(override):
    with pytest.raises(ValueError):
        tcorr.warp_corr81_plan(1, 8, 64, 512, torch.float32, torch.float32, **override)


def test_library_path_sees_every_header(tmp_path, monkeypatch):
    """An edited shared header gives the library a new name, so a stale build
    is never loaded; an unrelated source does not."""
    for name, text in (("a.cu", '#include "tile.cuh"\n'), ("b.cu", "// b\n"),
                       ("tile.cuh", "// v1\n")):
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", str(tmp_path))
    before = cuda_lib.library_path("a")
    assert cuda_lib.library_path("a") == before
    (tmp_path / "b.cu").write_text("// b, edited\n")
    assert cuda_lib.library_path("a") == before
    (tmp_path / "tile.cuh").write_text("// v2\n")
    after = cuda_lib.library_path("a")
    assert after != before and os.path.basename(after).startswith("a-")
