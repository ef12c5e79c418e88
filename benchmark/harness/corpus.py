"""Clip pools made from a traffic file's recipe, and the seeded stream of visits.

A recipe (the ``corpus`` object of ``benchmark/traffic/<mix>.json``) names source
videos under ``benchmark/corpus_sources/``, a clip count, a frame rate, a range
of lengths and weighted geometries. :func:`build_pool` cuts, resamples, scales
(cover, then center crop), and for ``rotate`` geometries turns the clip 90°,
writing each clip with cv2's ``mp4v``. The pool is cached inside the checkout
at a fixed path keyed by the recipe's hash, so only a checkout's first run of a
cell writes it.

:func:`plan_stream` lays out the visits of one run: passes over the pool in one
fixed sequence of geometries, the seed choosing which clip fills each place.
Each visit is a symlink of its own name, since the program's done-manifest skips
paths it has seen and its outputs are keyed by file stem.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import random
import shutil
from typing import Dict, List

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES_DIR = os.path.join(BENCH_DIR, "corpus_sources")
CACHE_DIR = os.path.join(BENCH_DIR, ".cache", "corpus")
# bumped when the generator's arithmetic changes, so old pools are not reused
GENERATOR_VERSION = 1


def recipe_key(recipe: Dict) -> str:
    blob = json.dumps({"v": GENERATOR_VERSION, "recipe": recipe}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def clip_plan(recipe: Dict) -> List[Dict]:
    """The pool's clips as data: source, start second, frames, size, rotation.

    Geometries are dealt by largest remaining deficit against their weights, so
    a pool of n clips holds each geometry in its weighted share; lengths are
    spread evenly over ``frames`` [min, max], dealt in a fixed shuffled order
    (``layout_seed``) so that length and geometry do not go together."""
    n = int(recipe["clips"])
    geoms = recipe["geometries"]
    total_w = sum(g["weight"] for g in geoms)
    dealt = [0] * len(geoms)
    lo, hi = recipe["frames"]
    lengths = [lo + round((hi - lo) * i / max(n - 1, 1)) for i in range(n)]
    random.Random(recipe.get("layout_seed", 0)).shuffle(lengths)
    plan = []
    for i in range(n):
        k = max(range(len(geoms)), key=lambda j: (geoms[j]["weight"] * (i + 1) / total_w
                                                  - dealt[j], -j))
        dealt[k] += 1
        src = recipe["sources"][i % len(recipe["sources"])]
        plan.append({"name": f"clip{i:03d}", "source": src, "frames": lengths[i],
                     "size": list(geoms[k]["size"]), "rotate": bool(geoms[k].get("rotate")),
                     "geometry": k, "phase": (i * 0.6180339887498949) % 1.0})
    return plan


def _read_all(path: str):
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(bgr)
    cap.release()
    if not frames:
        raise RuntimeError(f"no frames decoded from {path}")
    return fps, frames


def _cover_crop(bgr: np.ndarray, w: int, h: int) -> np.ndarray:
    """Scale so the frame covers ``w``×``h``, then center crop."""
    import cv2

    sh, sw = bgr.shape[:2]
    s = max(w / sw, h / sh)
    rw, rh = max(w, int(math.ceil(sw * s))), max(h, int(math.ceil(sh * s)))
    big = cv2.resize(bgr, (rw, rh), interpolation=cv2.INTER_AREA if s < 1 else cv2.INTER_LINEAR)
    y, x = (rh - h) // 2, (rw - w) // 2
    return big[y:y + h, x:x + w]


def _write_clip(spec: Dict, fps: float, src_fps: float, src_frames, path: str) -> None:
    import cv2

    w, h = spec["size"]
    # a rotated clip is the landscape cut turned 90°: its content rotates too
    cw, ch = (h, w) if spec["rotate"] else (w, h)
    dur = spec["frames"] / fps
    span = max(len(src_frames) / src_fps - dur, 0.0)
    start = spec["phase"] * span
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2 cannot write {path} with mp4v")
    for j in range(spec["frames"]):
        idx = min(int((start + j / fps) * src_fps), len(src_frames) - 1)
        frame = _cover_crop(src_frames[idx], cw, ch)
        if spec["rotate"]:
            frame = cv2.rotate(frame, cv2.ROTATE_90_CLOCKWISE)
        writer.write(np.ascontiguousarray(frame))
    writer.release()


def _count(path: str):
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    while cap.grab():
        n += 1
    w, h = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    return n, w, h


def build_pool(recipe: Dict, sources_dir: str = SOURCES_DIR,
               cache_dir: str = CACHE_DIR) -> Dict:
    """The pool of ``recipe`` (built once into ``cache_dir``): its manifest
    ``{"dir", "clips": [{name, path, frames, width, height, geometry}]}``,
    frames as the decoder counts them."""
    root = os.path.join(cache_dir, recipe_key(recipe))
    manifest_path = os.path.join(root, "manifest.json")
    if not os.path.exists(manifest_path):
        tmp = root + ".partial"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        sources = {}
        clips = []
        for spec in clip_plan(recipe):
            if spec["source"] not in sources:
                sources[spec["source"]] = _read_all(os.path.join(sources_dir, spec["source"]))
            src_fps, src_frames = sources[spec["source"]]
            path = os.path.join(tmp, spec["name"] + ".mp4")
            _write_clip(spec, float(recipe["fps"]), src_fps, src_frames, path)
            frames, w, h = _count(path)
            if [w, h] != spec["size"]:
                raise RuntimeError(f"{spec['name']}: written as {w}x{h}, not "
                                   f"{spec['size'][0]}x{spec['size'][1]} (mp4v wants even sizes)")
            clips.append({"name": spec["name"], "frames": frames, "width": w, "height": h,
                          "geometry": spec["geometry"]})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"recipe": recipe, "clips": clips}, f, indent=1)
        shutil.rmtree(root, ignore_errors=True)
        os.replace(tmp, root)
    with open(manifest_path) as f:
        manifest = json.load(f)
    for clip in manifest["clips"]:
        clip["path"] = os.path.join(root, clip["name"] + ".mp4")
    manifest["dir"] = root
    return manifest


def geometry_pattern(counts: Dict[int, int]) -> List[int]:
    """One pass's sequence of geometries: each geometry as often as the pool
    holds it, spread evenly by largest remaining deficit (ties to the lower
    index), the same for every seed."""
    total = sum(counts.values())
    dealt = {g: 0 for g in counts}
    out = []
    for i in range(total):
        g = max(sorted(counts), key=lambda k: counts[k] * (i + 1) / total - dealt[k])
        dealt[g] += 1
        out.append(g)
    return out


def plan_stream(pool: Dict, seed: int, warmup: int, visits: int) -> List[Dict]:
    """``visits`` visits of the pool's clips in passes: every pass follows the
    same sequence of geometries (:func:`geometry_pattern`), and the seed picks
    which clip of each geometry fills each place. So every seed offers the
    same sizes and arrivals, in another order. The first ``warmup`` visits are
    the warm-up and must hold every geometry."""
    by_geom: Dict[int, List[Dict]] = {}
    for c in pool["clips"]:
        by_geom.setdefault(c["geometry"], []).append(c)
    pattern = geometry_pattern({g: len(cs) for g, cs in by_geom.items()})
    if len(set(pattern[:warmup])) < len(by_geom):
        raise ValueError(f"the first {warmup} visits do not hold every geometry")
    rng = random.Random(seed)
    order: List[Dict] = []
    n = max(visits, warmup)
    while len(order) < n:
        queues = {g: rng.sample(cs, len(cs)) for g, cs in sorted(by_geom.items())}
        order += [queues[g].pop() for g in pattern]
    return [{"visit": i, **c} for i, c in enumerate(order[:n])]


def link_stream(stream: List[Dict], dirpath: str) -> List[str]:
    """One symlink a visit, ``v<index>_<clip>.mp4``, in ``dirpath``."""
    os.makedirs(dirpath, exist_ok=True)
    paths = []
    for v in stream:
        link = os.path.join(dirpath, f"v{v['visit']:05d}_{v['name']}.mp4")
        os.symlink(v["path"], link)
        v["link"] = link
        paths.append(link)
    return paths
