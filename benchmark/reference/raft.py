"""Plain reference of configuration ``raft``: RAFT dense flow of every frame pair.

The original extractor's path (``models/raft/extract_raft.py``): every decoded
frame at its native size, replicate-padded to multiples of 8 with the centered
(sintel) split, RAFT with 20 refinement iterations on each consecutive pair,
the convex ×8 upsample, and the pad cut off again: ``(T − 1, 2, H, W)`` a
video. Float32 throughout, TF32 off.

With random weights RAFT's refinement is not contractive (the flow grows to
hundreds of pixels and rounding decides it), so the flow head's last
convolution is scaled by 0.02, as the repository's golden fixtures do; a
trained checkpoint is contractive by itself.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from . import mirrors, video

CHECKPOINTS = ("raft-sintel",)
FLOW_HEAD_DAMPING = 0.02


def make_weights(seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    sd = mirrors.seeded_state_dict(mirrors.raft_leaf_specs(), seed, device)
    for leaf in ("weight", "bias"):
        sd[f"update_block.flow_head.conv2.{leaf}"] *= FLOW_HEAD_DAMPING
    return {"raft-sintel": sd}


def outputs(path: str, weights, model: Dict, device) -> Dict[str, np.ndarray]:
    """``{"raft": (T − 1, 2, H, W)}`` of the video at ``path``."""
    frames = torch.from_numpy(video.decode_rgb(path)).to(device).float().permute(0, 3, 1, 2)
    h, w = frames.shape[-2:]
    pads = video.sintel_pad(h, w)
    x = video.replicate_pad(frames, pads)
    chunk, sd = model["reference_pair_chunk"], weights["raft-sintel"]
    with torch.no_grad():
        pairs = len(x) - 1
        flow = torch.cat([mirrors.raft_torch_forward(sd, x[i:min(i + chunk, pairs)],
                                                     x[i + 1:min(i + chunk, pairs) + 1],
                                                     iters=model["iters"])
                          for i in range(0, pairs, chunk)])
    top, bottom, left, right = pads
    flow = flow[..., top:flow.shape[-2] - bottom, left:flow.shape[-1] - right]
    return {"raft": flow.cpu().numpy()}


def errors(port: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """max |port − reference| over max |reference| of the video's flow; a
    missing key or another shape reads infinite."""
    p, r = port.get("raft"), ref["raft"]
    if p is None or np.shape(p) != r.shape or r.size == 0:
        return {"flow_err": float("inf")}
    return {"flow_err": float(np.abs(np.asarray(p, np.float64) - r).max()
                              / max(np.abs(r).max(), 1e-12))}


def _flops(fn, *shapes) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    args = [torch.empty(s, device="meta") for s in shapes]
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


@functools.lru_cache(maxsize=16)
def _pair_and_encoder_flops(h: int, w: int, iters: int):
    sd = {k: torch.empty(shape, device="meta") for k, shape, _ in mirrors.raft_leaf_specs()}
    fnet = _flops(lambda x: mirrors._raft_encoder(sd, "fnet", x, "instance"), (1, 3, h, w))
    pair = _flops(lambda a, b: mirrors.raft_torch_forward(sd, a, b, iters=iters),
                  (1, 3, h, w), (1, 3, h, w))
    return pair, fnet


def video_flops(frames: int, h: int, w: int, model: Dict) -> float:
    """Model FLOPs of a decoded ``frames``×``h``×``w`` video at its /8 pad:
    the feature encoder once a frame; the context encoder, the all-pairs
    product and the refinement once a pair (convolutions and products from
    their shapes; the lookup's sampling and the upsample not counted)."""
    if frames < 2:
        return 0.0
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    pair, fnet = _pair_and_encoder_flops(ph, pw, model["iters"])
    return frames * fnet + (frames - 1) * (pair - 2 * fnet)
