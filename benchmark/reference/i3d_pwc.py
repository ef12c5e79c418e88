"""Plain reference of configuration ``i3d_pwc``: two-stream I3D with PWC-Net flow.

The original extractor's path (``models/i3d/extract_i3d.py``): decode, resize
the smaller edge to ``pre_crop_size``, stacks of ``stack_size + 1`` frames at
``step_size``; the rgb stream crops the first ``stack_size`` frames and scales
them to [−1, 1]; the flow stream runs PWC-Net on the consecutive pairs of the
uncropped stack, crops the flow, clamps, quantizes and scales it; each stream
through its own I3D to a 1024-d feature a stack. Float32 throughout, TF32 off.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch

from . import mirrors, video

CHECKPOINTS = ("i3d_rgb", "i3d_flow", "pwc-sintel")


def make_weights(seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The checkpoints the program loads, by its names, from ``seed``."""
    return {"i3d_rgb": mirrors.seeded_state_dict(mirrors.i3d_leaf_specs("rgb"), 3 * seed, device),
            "i3d_flow": mirrors.seeded_state_dict(mirrors.i3d_leaf_specs("flow"), 3 * seed + 1,
                                                  device),
            "pwc-sintel": mirrors.seeded_state_dict(mirrors.pwc_leaf_specs(), 3 * seed + 2,
                                                    device)}


def outputs(path: str, weights, model: Dict, device) -> Dict[str, np.ndarray]:
    """``{"rgb": (n, 1024), "flow": (n, 1024)}`` of the video at ``path``."""
    frames = video.resize_smaller_edge(video.decode_rgb(path), model["pre_crop_size"])
    crop, chunk = model["crop_size"], model["reference_pair_chunk"]
    feats = {"rgb": [], "flow": []}
    with torch.no_grad():
        for start, end in video.stacks(len(frames), model["stack_size"], model["step_size"]):
            stack = torch.from_numpy(frames[start:end]).to(device).float()  # (S+1, H, W, 3)
            rgb = video.rgb_to_pm1(torch.from_numpy(
                video.center_crop(frames[start:end - 1], crop).copy()).to(device).float())
            x = rgb.permute(3, 0, 1, 2)[None]  # (1, 3, S, crop, crop)
            feats["rgb"].append(mirrors.i3d_forward(weights["i3d_rgb"], x)[0])
            nchw = stack.permute(0, 3, 1, 2)
            pairs = len(nchw) - 1
            flow = torch.cat([mirrors.pwc_torch_forward(weights["pwc-sintel"],
                                                        nchw[i:min(i + chunk, pairs)],
                                                        nchw[i + 1:min(i + chunk, pairs) + 1])
                              for i in range(0, pairs, chunk)])  # (S, 2, H, W)
            flow = video.center_crop(flow.permute(0, 2, 3, 1), crop)  # (S, crop, crop, 2)
            x = video.flow_to_pm1(flow).permute(3, 0, 1, 2)[None]
            feats["flow"].append(mirrors.i3d_forward(weights["i3d_flow"], x)[0])
    return {k: (torch.stack(v).cpu().numpy() if v else np.zeros((0, 1024), np.float32))
            for k, v in feats.items()}


def errors(port: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Per stream, max |port − reference| over max |reference|; a missing key
    or a different number of stacks reads infinite."""
    out = {}
    for key in ("rgb", "flow"):
        p, r = port.get(key), ref[key]
        if p is None or np.shape(p) != r.shape or r.size == 0:
            out[f"{key}_err"] = float("inf")
            continue
        out[f"{key}_err"] = float(np.abs(np.asarray(p, np.float64) - r).max()
                                  / max(np.abs(r).max(), 1e-12))
    return out


def _flops(fn, *shapes) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    args = [torch.empty(s, device="meta") for s in shapes]
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def pwc_levels(h: int, w: int):
    """(channels, height, width) of the features each decoder level (6 down to
    2) correlates, at PWC-Net's /64 grid of an ``h``×``w`` frame."""
    gh, gw = int(math.ceil(h / 64.0) * 64), int(math.ceil(w / 64.0) * 64)
    chans = dict(zip(range(1, 7), mirrors._PWC_EXTRACTOR_CH))
    return [(chans[lv], gh >> lv, gw >> lv) for lv in (6, 5, 4, 3, 2)]


@functools.lru_cache(maxsize=16)
def stack_flops(h: int, w: int, stack_size: int, crop_size: int) -> float:
    """Model FLOPs of one stack of a video resized to ``h``×``w``: both I3D
    streams, PWC-Net's pyramid once a frame and its decoders and 81-tap cost
    volumes once a pair (convolutions, transposed convolutions and products
    counted from their shapes; the warps' sampling not counted)."""
    s, c = stack_size, crop_size
    i3d = {m: {k: torch.empty(shape, device="meta") for k, shape, _ in mirrors.i3d_leaf_specs(m)}
           for m in ("rgb", "flow")}
    pwc = {k: torch.empty(shape, device="meta") for k, shape, _ in mirrors.pwc_leaf_specs()}
    gh, gw = int(math.ceil(h / 64.0) * 64), int(math.ceil(w / 64.0) * 64)
    pyramid = _flops(lambda x: mirrors._pwc_pyramid(pwc, x), (1, 3, gh, gw))
    pair = _flops(lambda a, b: mirrors.pwc_torch_forward(pwc, a, b), (1, 3, h, w), (1, 3, h, w))
    volume = sum(2 * 81 * ch * lh * lw for ch, lh, lw in pwc_levels(h, w))
    return (_flops(lambda x: mirrors.i3d_forward(i3d["rgb"], x), (1, 3, s, c, c))
            + _flops(lambda x: mirrors.i3d_forward(i3d["flow"], x), (1, 2, s, c, c))
            + (s + 1) * pyramid + s * (pair - 2 * pyramid + volume))


def resized_hw(h: int, w: int, size: int):
    """(H, W) after the smaller-edge resize to ``size``."""
    if min(h, w) == size:
        return h, w
    return (int(size * h / w), size) if w < h else (size, int(size * w / h))


def video_flops(frames: int, h: int, w: int, model: Dict) -> float:
    """Model FLOPs of a decoded ``frames``×``h``×``w`` video: its stacks."""
    n = len(video.stacks(frames, model["stack_size"], model["step_size"]))
    if n == 0:
        return 0.0
    rh, rw = resized_hw(h, w, model["pre_crop_size"])
    return n * stack_flops(rh, rw, model["stack_size"], model["crop_size"])
