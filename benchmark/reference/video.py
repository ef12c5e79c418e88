"""Decode, resize, crop and flow post-processing as the original extractor does them.

Written from the original reference (yhZhai/video_features): frames read with
OpenCV and turned to RGB (``utils/utils.py``), the aspect-preserving PIL
bilinear resize of the smaller edge with int truncation of the other
(``models/i3d/transforms/transforms.py`` ``ResizeImproved``), the floor-offset
center crop (``TensorCenterCrop``), the flow clamp to ±20 and uint8
quantization (``Clamp``, ``ToUInt8``: round half to even, not clipped), the
[−1, 1] scale (``ScaleTo1_1``), and RAFT's centered replicate pad to multiples
of 8 (``InputPadder``, sintel mode). Nothing here comes from the program.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def decode_rgb(path: str) -> np.ndarray:
    """Every frame of ``path`` as (T, H, W, 3) uint8 RGB."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise RuntimeError(f"no frames decoded from {path}")
    return np.stack(frames)


def resize_smaller_edge(frames: np.ndarray, size: int) -> np.ndarray:
    """PIL bilinear resize so the smaller edge is ``size``, the other edge
    ``int(size * other / smaller)``; frames already at that size pass."""
    from PIL import Image

    h, w = frames.shape[1:3]
    if min(h, w) == size:
        return frames
    ow, oh = (size, int(size * h / w)) if w < h else (int(size * w / h), size)
    return np.stack([np.asarray(Image.fromarray(f).resize((ow, oh), Image.BILINEAR))
                     for f in frames])


def center_crop(x: np.ndarray, size: int) -> np.ndarray:
    """Center crop of the (..., H, W, C) axes, floor offsets."""
    h, w = x.shape[-3], x.shape[-2]
    top, left = (h - size) // 2, (w - size) // 2
    return x[..., top:top + size, left:left + size, :]


def stacks(n_frames: int, stack_size: int, step_size: int) -> List[Tuple[int, int]]:
    """[start, end) of each stack of ``stack_size + 1`` frames at ``step_size``;
    a trailing partial stack is dropped."""
    out, start = [], 0
    while start + stack_size + 1 <= n_frames:
        out.append((start, start + stack_size + 1))
        start += step_size
    return out


def flow_to_pm1(flow: torch.Tensor) -> torch.Tensor:
    """Clamp ±20 → round(128 + 255/40·f), half to even, unclipped → [−1, 1]."""
    q = torch.round(128.0 + 255.0 / 40.0 * flow.clamp(-20.0, 20.0))
    return 2.0 * q / 255.0 - 1.0


def rgb_to_pm1(rgb: torch.Tensor) -> torch.Tensor:
    return 2.0 * rgb / 255.0 - 1.0


def sintel_pad(h: int, w: int, m: int = 8) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) of the centered pad to multiples of ``m``."""
    ph, pw = (-h) % m, (-w) % m
    return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2


def replicate_pad(x: torch.Tensor, pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """(N, C, H, W) replicate-padded by (top, bottom, left, right)."""
    top, bottom, left, right = pads
    if not any(pads):
        return x
    return F.pad(x, (left, right, top, bottom), mode="replicate")
