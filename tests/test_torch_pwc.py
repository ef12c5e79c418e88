"""The port's PWC-Net (video_features_torch/models/pwc.py and the ops under it)
against the JAX package's, on the same numpy-seeded inputs and the same weights:
tools/torch_mirrors.py's seeded state dict → the JAX ``convert_pwc`` → the
port's ``convert_jax.convert_pwc``. Tolerance rtol 1e-4 / atol 1e-4 (the JAX
package's own PWC parity bound, tests/test_pallas_corr.py:133-145); the
gathers are held tighter, since the port repeats their arithmetic exactly.

The step's round trips to the host: no forward builds a tensor from host data,
the output scale is the old tensor multiply bit for bit, and on a card a packed
I3D+PWC step runs under ``torch.cuda.set_sync_debug_mode("error")``. A machine
with a card and no JAX runs that last test alone
(``python -m pytest tests/test_torch_pwc.py --noconftest -m cuda``).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import torch_mirrors as tm  # noqa: E402

try:  # the reference; absent where only the cuda-marked test runs
    import jax
    import jax.numpy as jnp

    from video_features_tpu.models import pwc as jpwc
    from video_features_tpu.ops import nnf as jnnf
    from video_features_tpu.ops import warp as jwarp
    from video_features_tpu.weights.convert_torch import convert_pwc as jax_convert_pwc
except ImportError:
    pass
from video_features_torch.models import pwc as tpwc  # noqa: E402
from video_features_torch.ops import nnf as tnnf  # noqa: E402
from video_features_torch.ops import warp as twarp  # noqa: E402
from video_features_torch.weights.convert_jax import convert_pwc  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def nets():
    params = jax_convert_pwc(tm.pwc_random_state_dict(seed=0))
    net = tpwc.PWCNet()
    net.load_state_dict(convert_pwc(params))
    return params, net.eval()


def test_warp_backward_matches_jax(rng):
    """Out-of-image flows exercise the 0.999 keep-mask; the port repeats the
    gather path's arithmetic in its order, so every pixel keeps or drops alike."""
    img = rng.normal(size=(2, 20, 24, 16)).astype(np.float32)
    flow = rng.uniform(-10, 10, (2, 20, 24, 2)).astype(np.float32)
    ref = np.asarray(jwarp.warp_backward(jnp.asarray(img), jnp.asarray(flow), "gather"))
    out = twarp.warp_backward(torch.from_numpy(img), torch.from_numpy(flow)).numpy()
    assert ((ref == 0).all(-1) == (out == 0).all(-1)).all()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("out_hw", [(24, 40), (5, 7), (256 // 8, 384 // 8)])
def test_resize_bilinear_matches_jax(rng, out_hw):
    img = rng.uniform(0, 1, (2, 12, 17, 3)).astype(np.float32)
    ref = np.asarray(jwarp.resize_bilinear_torch(jnp.asarray(img), *out_hw))
    out = twarp.resize_bilinear_torch(torch.from_numpy(img), *out_hw).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_conv2d_transpose_matches_jax(rng, nets):
    """The upsampling ConvTranspose: the JAX op flips an HWIO kernel, the port
    calls F.conv_transpose2d on the (in, out, kh, kw) weight carried back by
    convert_jax — both layout and flip must be inverted to match."""
    params, net = nets
    for name in ("moduleFiv", "moduleTwo"):
        p = params[name]["moduleUpfeat"]
        cin = p["kernel"].shape[2]
        x = rng.normal(size=(2, 6, 8, cin)).astype(np.float32)
        ref = np.asarray(jnnf.conv2d_transpose(p, jnp.asarray(x)))
        mod = getattr(net, name).moduleUpfeat
        with torch.no_grad():
            out = tnnf.conv2d_transpose(torch.from_numpy(x), mod.weight, mod.bias).numpy()
        assert out.shape == (2, 12, 16, 2)
        np.testing.assert_allclose(out, ref, **TOL)


def test_pwc_forward_matches_jax(rng, nets):
    params, net = nets
    im1 = rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
    im2 = rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jpwc.pwc_forward)(params, jnp.asarray(im1), jnp.asarray(im2)))
    out = tpwc.pwc_forward(net, torch.from_numpy(im1), torch.from_numpy(im2)).numpy()
    assert out.shape == (1, 64, 64, 2)
    np.testing.assert_allclose(out, ref, **TOL)


def test_pwc_forward_frames_padded_chunks_match_jax(rng, nets):
    """5 frames → 4 pairs decoded 3 at a time: the last chunk is zero-padded."""
    params, net = nets
    frames = rng.uniform(0, 255, (5, 64, 80, 3)).astype(np.float32)
    fwd = jax.jit(functools.partial(jpwc.pwc_forward_frames, pair_chunk=3))
    ref = np.asarray(fwd(params, jnp.asarray(frames)))
    out = tpwc.pwc_forward_frames(net, torch.from_numpy(frames), pair_chunk=3).numpy()
    assert out.shape == (4, 64, 80, 2)
    np.testing.assert_allclose(out, ref, **TOL)


# ---- the step's round trips to the host ---------------------------------------

class _HostTensors(TorchDispatchMode):
    """Records every tensor built from host data (``torch.tensor`` lifts it
    through ``aten.lift_fresh``); on the card each is a copy from pageable
    memory that waits for the stream to drain."""

    def __init__(self):
        super().__init__()
        self.lifted = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.lift_fresh, torch.ops.aten.lift_fresh_copy):
            self.lifted.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def random_net():
    torch.manual_seed(0)
    return tpwc.PWCNet().eval()


@pytest.mark.parametrize("forward", ["pair", "frames", "frames_chunked"])
def test_pwc_forwards_build_no_tensor_from_host_data(random_net, forward):
    """Per pair, every pair at once, and 5 pairs decoded 2 at a time (an odd
    count: the last chunk zero-padded)."""
    frames = torch.from_numpy(
        np.random.default_rng(0).uniform(0, 255, (6, 64, 80, 3)).astype(np.float32))
    with _HostTensors() as rec:
        if forward == "pair":
            out = tpwc.pwc_forward(random_net, frames[:-1], frames[1:])
        else:
            chunk = 2 if forward == "frames_chunked" else None
            out = tpwc.pwc_forward_frames(random_net, frames, pair_chunk=chunk)
    assert out.shape == (5, 64, 80, 2)
    assert rec.lifted == []


@pytest.mark.parametrize("hw", [(256, 340), (340, 256), (240, 426)])
def test_output_scale_equals_the_tensor_multiply(hw):
    """The in-place scalar scale gives the products of the multiply by a
    ``(w / w64, h / h64)`` float32 tensor it replaced, bit for bit."""
    h, w = hw
    h64, w64 = tpwc._grid64(h, w)
    gen = torch.Generator().manual_seed(h * w)
    flow = 20.0 * (torch.randn((2, h, w, 2), generator=gen) * 7.0)
    ref = flow * torch.tensor([w / w64, h / h64], dtype=torch.float32)
    out = tpwc._to_input_pixels(flow.clone(), h, w, h64, w64)
    assert (h64, w64) != (h, w) and torch.equal(out, ref)


@pytest.mark.cuda
def test_packed_i3d_pwc_step_makes_no_host_round_trip(tmp_path, monkeypatch):
    """One page of the main path's packed step (both streams, PWC decoding
    the page's 256 pairs in one pass, as the benchmark's kinetics cell runs
    it), after a warm-up page, under ``set_sync_debug_mode("error")``: any
    synchronizing call inside it raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from video_features_torch.cli import parse_args
    from video_features_torch.extractors import get_extractor

    monkeypatch.setenv("VFT_ALLOW_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("VFT_CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    ex = get_extractor(parse_args([
        "--feature_type", "i3d", "--flow_type", "pwc", "--streams", "rgb", "flow",
        "--stack_size", "64", "--step_size", "64", "--pack_corpus", "--clips_per_batch", "8",
        "--flow_pair_chunk", "256", "--device", "cuda", "--output_path", str(tmp_path)]))
    spec = ex.pack_spec()
    rows = spec.page_rows
    rng = np.random.default_rng(0)
    outs = []
    with torch.inference_mode():
        for checked in (False, True):
            page = ex._staging.acquire((rows, 65, 256, 340, 3), np.uint8)
            page[:] = rng.integers(0, 256, page.shape, dtype=np.uint8)
            table = ex._staging.acquire((rows, 3), np.int32)
            table[:] = [(0, i, 1) for i in range(rows)]
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error" if checked else "default")
            try:
                outs.append(spec.paged_step(page, table)[0])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    assert rows == 4 and outs[1].shape == (rows, 2, 1024)
    assert torch.isfinite(outs[1]).all()
