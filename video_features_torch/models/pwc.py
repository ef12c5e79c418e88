"""PWC-Net optical flow in PyTorch, NHWC (counterpart of the JAX ``models/pwc.py``).

Behavioral spec — reference ``models/pwc/pwc_src/pwc_net.py``:
- Input RGB in [0, 255]; the net flips to BGR and scales /255 (``:229-231``).
- Bilinear resize (align_corners=False) to /64-multiple sizes (``:241-245``).
- 6-level feature pyramid, 3 convs per level, LeakyReLU 0.1 (``:44-110``).
- Coarse-to-fine decoders at levels 6→2 (``:112-187``): 81-channel cost volume,
  LeakyReLU'd; below level 6 the second feature map is backward-warped by the
  upsampled flow scaled per level (0.625/1.25/2.5/5.0), with the partial-tap
  zeroing mask (``:23-41``); DenseNet-style conv block (new features in front).
- Dilated refiner on the level-2 feature tail (``:189-210``).
- Output: 20 × bilinear resize of (flow₂ + refinement) to the *original* size,
  u scaled by W/W₆₄, v by H/H₆₄ (``:256-261``).

:class:`PWCNet` holds the weights under the reference checkpoint's names
(``moduleExtractor.moduleOne.0.weight``, ``moduleTwo.moduleUpflow.weight``, ...);
its submodules exist for those names, and the forward functions below walk them
on NHWC tensors through :mod:`..ops.nnf`. The cost volume is
:mod:`..ops.corr`: the hand-written CUDA kernels on the card, their plain
versions on the CPU.

``dtype`` (``--flow_dtype``) is the convolutions' dtype, as in the JAX
package: the input is preprocessed in fp32 and cast; each level's flow times
its ``DEC_BACKWARD`` scale stays in ``dtype`` and the warp adds it to fp32
coordinates; the level-6 volume correlates (``dtype``, ``dtype``) and levels
5..2 (``dtype`` f1, the warp's fp32 output), accumulating in fp32 and
returning f1's dtype; the flow goes to fp32 before the final resize.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.corr import corr81, warp_corr81
from ..ops.nnf import conv2d, conv2d_transpose, leaky_relu
from ..ops.warp import resize_bilinear_torch
from ..utils.metrics import device_span

# pyramid level channel counts (level 1..6)
PYR_CHANNELS = (16, 32, 64, 96, 128, 196)
PYR_NAMES = ("moduleOne", "moduleTwo", "moduleThr", "moduleFou", "moduleFiv", "moduleSix")
# decoder input channels per level: 81 + fmap + 2 flow + 2 upfeat (level 6: corr only)
DEC_CURRENT = {6: 81, 5: 81 + 128 + 4, 4: 81 + 96 + 4, 3: 81 + 64 + 4, 2: 81 + 32 + 4}
DEC_BACKWARD = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
DENSE_OUT = (128, 128, 96, 64, 32)  # moduleOne..moduleFiv
DENSE_NAMES = PYR_NAMES[:5]
LEVEL_NAMES = {2: "moduleTwo", 3: "moduleThr", 4: "moduleFou", 5: "moduleFiv", 6: "moduleSix"}
REFINER = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))  # (out, dilation)


def _conv(cin: int, cout: int, stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, padding=dilation, dilation=dilation)


class _Decoder(nn.Module):
    def __init__(self, level: int):
        super().__init__()
        if level < 6:
            prev = DEC_CURRENT[level + 1] + sum(DENSE_OUT)
            self.moduleUpflow = nn.ConvTranspose2d(2, 2, 4, 2, 1)
            self.moduleUpfeat = nn.ConvTranspose2d(prev, 2, 4, 2, 1)
        ch = DEC_CURRENT[level]
        for name, cout in zip(DENSE_NAMES, DENSE_OUT):
            self.add_module(name, nn.Sequential(_conv(ch, cout), nn.LeakyReLU(0.1)))
            ch += cout
        self.moduleSix = nn.Sequential(_conv(ch, 2))


class PWCNet(nn.Module):
    """PWC-Net's weights under the reference names (no ``forward``: see
    :func:`pwc_forward` / :func:`pwc_forward_frames`)."""

    def __init__(self):
        super().__init__()
        self.moduleExtractor = nn.Module()
        cin = 3
        for name, cout in zip(PYR_NAMES, PYR_CHANNELS):
            self.moduleExtractor.add_module(name, nn.Sequential(
                _conv(cin, cout, 2), nn.LeakyReLU(0.1), _conv(cout, cout),
                nn.LeakyReLU(0.1), _conv(cout, cout), nn.LeakyReLU(0.1)))
            cin = cout
        for level, name in LEVEL_NAMES.items():
            self.add_module(name, _Decoder(level))
        layers: List[nn.Module] = []
        ch = DEC_CURRENT[2] + sum(DENSE_OUT)
        for cout, d in REFINER:
            layers += [_conv(ch, cout, dilation=d), nn.LeakyReLU(0.1)]
            ch = cout
        layers.append(_conv(ch, 2))
        self.moduleRefiner = nn.Module()
        self.moduleRefiner.moduleMain = nn.Sequential(*layers)


def _conv_of(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an ``nn.Conv2d`` (or the conv heading an ``nn.Sequential``) to NHWC ``x``."""
    conv = module if isinstance(module, nn.Conv2d) else module[0]
    return conv2d(x, conv.weight, conv.bias, conv.stride[0], conv.padding[0],
                  conv.dilation[0])


def _pyramid(extractor: nn.Module, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """6-level feature pyramid (pwc_net.py:44-110); 3 convs per level."""
    feats = []
    for name in PYR_NAMES:
        lvl = getattr(extractor, name)
        x = leaky_relu(_conv_of(lvl[0], x))
        x = leaky_relu(_conv_of(lvl[2], x))
        x = leaky_relu(_conv_of(lvl[4], x))
        feats.append(x)
    return tuple(feats)


def _decoder(dec: _Decoder, level: int, f1: torch.Tensor, f2: torch.Tensor,
             prev: Optional[Dict[str, torch.Tensor]], corr_impl: str = "auto"):
    """One coarse-to-fine stage (pwc_net.py:152-187)."""
    if prev is None:
        volume = leaky_relu(corr81(f1, f2, corr_impl))
        feat = volume
    else:
        up, upf = dec.moduleUpflow, dec.moduleUpfeat
        flow = conv2d_transpose(prev["flow"], up.weight, up.bias)
        upfeat = conv2d_transpose(prev["feat"], upf.weight, upf.bias)
        volume = leaky_relu(warp_corr81(f1, f2, flow * DEC_BACKWARD[level], corr_impl))
        feat = torch.cat([volume, f1, flow, upfeat], dim=-1)
    for name in DENSE_NAMES:
        feat = torch.cat([leaky_relu(_conv_of(getattr(dec, name), feat)), feat], dim=-1)
    flow = _conv_of(dec.moduleSix, feat)
    return {"flow": flow, "feat": feat}


def _refiner(main: nn.Sequential, feat: torch.Tensor) -> torch.Tensor:
    """Dilated context network (pwc_net.py:189-210)."""
    x = feat
    for i in range(len(REFINER)):
        x = leaky_relu(_conv_of(main[2 * i], x))
    return _conv_of(main[2 * len(REFINER)], x)


def _preprocess(image: torch.Tensor, h64: int, w64: int) -> torch.Tensor:
    """RGB [0,255] → BGR /255 (pwc_net.py:230) resized to the /64 grid."""
    x = image.flip(-1).float() / 255.0
    if (h64, w64) != tuple(image.shape[-3:-1]):
        x = resize_bilinear_torch(x, h64, w64)
    return x


def _decode(net: PWCNet, pyr1, pyr2, h: int, w: int, h64: int, w64: int,
            corr_impl: str) -> torch.Tensor:
    """Coarse-to-fine decoders + refiner + output scaling (pwc_net.py:241-261)."""
    est = None
    for level in (6, 5, 4, 3, 2):
        est = _decoder(getattr(net, LEVEL_NAMES[level]), level,
                       pyr1[level - 1], pyr2[level - 1], est, corr_impl)
    flow = est["flow"] + _refiner(net.moduleRefiner.moduleMain, est["feat"])
    return _to_input_pixels(20.0 * resize_bilinear_torch(flow.float(), h, w), h, w, h64, w64)


def _to_input_pixels(flow: torch.Tensor, h: int, w: int, h64: int, w64: int) -> torch.Tensor:
    """Scale a fresh (B, H, W, 2) flow from the /64 grid's pixels to the
    input's, in place: u by w / w64, v by h / h64. Python scalars give the
    same fp32 products as a multiply by a ``(w / w64, h / h64)`` tensor, and
    no host tensor is copied to the device (a copy from pageable memory waits
    for the stream to drain, with the launching thread blocked behind it)."""
    flow[..., 0].mul_(w / w64)
    flow[..., 1].mul_(h / h64)
    return flow


def _grid64(h: int, w: int) -> Tuple[int, int]:
    return (int(math.floor(math.ceil(h / 64.0) * 64.0)),
            int(math.floor(math.ceil(w / 64.0) * 64.0)))


@torch.inference_mode()
def pwc_forward(net: PWCNet, image1: torch.Tensor, image2: torch.Tensor,
                corr_impl: str = "auto", dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flow frame1→frame2. Inputs (B, H, W, 3) RGB [0, 255], uint8 or float, any
    size. Returns (B, H, W, 2) float32 flow in input-resolution pixels.
    ``dtype``: the convolutions' dtype (see the module's docstring)."""
    _, h, w, _ = image1.shape
    h64, w64 = _grid64(h, w)
    pyr1 = _pyramid(net.moduleExtractor, _preprocess(image1, h64, w64).to(dtype))
    pyr2 = _pyramid(net.moduleExtractor, _preprocess(image2, h64, w64).to(dtype))
    return _decode(net, pyr1, pyr2, h, w, h64, w64, corr_impl)


@torch.inference_mode()
def pwc_forward_frames(net: PWCNet, frames: torch.Tensor, corr_impl: str = "auto",
                       pair_chunk: Optional[int] = None,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Flow for all consecutive frame pairs, sharing per-frame features.

    ``frames``: (F, H, W, 3) → (F−1, H, W, 2), or a clip batch (N, F, H, W, 3)
    → (N, F−1, H, W, 2) — pairs never cross clip boundaries.

    Each frame is encoded ONCE and pairs are formed by slicing the shared
    per-frame pyramid. ``pair_chunk`` bounds decoder memory: the pairs are
    decoded ``pair_chunk`` at a time, the last chunk zero-padded to full size
    (its padded rows decode to garbage and are sliced off), so the bound never
    disengages on an odd pair count. ``dtype``: as for :func:`pwc_forward`.
    """
    lead = tuple(frames.shape[:-3])  # (F,) or (N, F)
    n = math.prod(lead[:-1]) if len(lead) > 1 else 1
    f = lead[-1]
    h, w = frames.shape[-3:-1]
    h64, w64 = _grid64(h, w)
    with device_span("pwc.pyramid"):
        pyr = _pyramid(net.moduleExtractor,
                       _preprocess(frames.reshape((n * f, h, w, 3)), h64, w64).to(dtype))

    def pairs(p: torch.Tensor, keep_first: bool) -> torch.Tensor:
        _, ph, pw, c = p.shape
        p = p.reshape(n, f, ph, pw, c)
        p = p[:, :-1] if keep_first else p[:, 1:]
        return p.reshape(n * (f - 1), ph, pw, c)

    pyr1 = tuple(pairs(p, True) for p in pyr)
    pyr2 = tuple(pairs(p, False) for p in pyr)
    total = n * (f - 1)
    chunk = min(pair_chunk, total) if pair_chunk else 0
    with device_span("pwc.decoder"):
        if 0 < chunk < total:
            nch = -(-total // chunk)

            def piece(p: torch.Tensor, i: int) -> torch.Tensor:
                part = p[i * chunk : (i + 1) * chunk]
                if part.shape[0] < chunk:
                    pad = part.new_zeros((chunk - part.shape[0],) + tuple(part.shape[1:]))
                    part = torch.cat([part, pad], dim=0)
                return part

            flow = torch.cat([
                _decode(net, tuple(piece(p, i) for p in pyr1),
                        tuple(piece(p, i) for p in pyr2), h, w, h64, w64, corr_impl)
                for i in range(nch)], dim=0)[:total]
        else:
            flow = _decode(net, pyr1, pyr2, h, w, h64, w64, corr_impl)
    return flow.reshape(lead[:-1] + (f - 1, h, w, 2))


def _frame_shards(runner, frames, frame_last):
    """(per-shard source frames, the final frame on the last shard's device,
    mesh size) for a frame-sharded forward, after checking that the pair
    count divides over the mesh: ``frames`` a :class:`..parallel.mesh.Sharded`
    or a batch to shard; ``frame_last`` a tensor or a replicated
    :class:`..parallel.mesh.Sharded`."""
    from ..ops.halo import frame_axis_mesh
    from ..parallel.mesh import Sharded, shard_batch

    sharded = isinstance(frames, Sharded)
    n_dev = frame_axis_mesh(runner, sum(int(f.shape[0]) for f in frames) if sharded
                            else int(frames.shape[0]))
    if not sharded:
        frames = shard_batch(frames, runner.mesh)
    if isinstance(frame_last, Sharded):
        frame_last = frame_last[-1]
    return frames, frame_last.to(frames[-1].device, non_blocking=True), n_dev


@torch.inference_mode()
def pwc_forward_frames_sharded(net: PWCNet, frames, frame_last, runner,
                               corr_impl: str = "auto",
                               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Encode-once flow over a mesh, frame axis sharded (the JAX package's
    ``pwc_forward_frames_sharded``).

    ``frames``: the window's B source frames (B, H, W, 3), sharded on axis 0
    over ``runner``'s mesh (B divisible by the mesh size); ``frame_last``: the
    window's final frame (1, H, W, 3). Returns the (B, H, W, 2) flow of the
    pairs ``frames[i] → frames[i+1]`` with ``frames[B] := frame_last``,
    gathered onto the mesh's first device in pair order.

    Each shard runs the 6-level pyramid once on its own frames (the final
    frame once, on the last shard); at every level the next shard's first
    feature map is copied in as the boundary (:func:`..ops.halo.
    boundary_from_next`), and each shard decodes its B/N pairs in one piece.
    Numerics match :func:`pwc_forward_frames` up to the convolutions'
    algorithm choice by batch size."""
    from ..ops.halo import boundary_from_next
    from ..parallel.mesh import gather

    shards, last, n_dev = _frame_shards(runner, frames, frame_last)
    h, w = shards[0].shape[-3:-1]
    h64, w64 = _grid64(h, w)

    def encode(i):
        ext = runner.replica(net, shards[i].device).moduleExtractor
        pyr = _pyramid(ext, _preprocess(shards[i], h64, w64).to(dtype))
        pyr_last = (_pyramid(ext, _preprocess(last, h64, w64).to(dtype))
                    if i == n_dev - 1 else None)
        return pyr, pyr_last

    encoded = runner.run_shards(encode)
    pyr_last = encoded[-1][1]
    bounds = [boundary_from_next([pyr[lvl][:1] for pyr, _ in encoded], pyr_last[lvl])
              for lvl in range(len(pyr_last))]

    def decode(i):
        pyr1 = encoded[i][0]
        pyr2 = tuple(torch.cat([p[1:], bounds[lvl][i]], dim=0) for lvl, p in enumerate(pyr1))
        return _decode(runner.replica(net, shards[i].device), pyr1, pyr2, h, w, h64, w64,
                       corr_impl)

    return gather(runner.run_shards(decode), runner.device)
