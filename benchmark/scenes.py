"""The benchmark's inputs: one-object pose scenes drawn from the seed.

A painted cuboid of one class under a random pose, cropped by a DZI
affine to the network's input, with its instance mask and pose (frozen copy
of the rendering in `kd6d_pose_adlp_tpu_torch/data/synthetic.py`; the
program's synthetic set is not used, so a change to it cannot change what
the benchmark feeds). LINEMOD is not in the repository, so these stand for
its crops: class 0 (ape) for training, as `configs/ape.yaml` trains it,
and every class for serving.

Scene `index` of stream `stream` under `seed` comes from its own numpy
generator, so the same seed gives the same inputs, whatever else a run
draws.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

K_INTERNAL = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]],
                      np.float32)
WH = (640, 480)
PIXEL_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
PIXEL_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
FACES = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4), (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5)]


def box_corners(n_fg: int, base: float = 40.0) -> np.ndarray:
    """(n_fg, 8, 3) axis-aligned box corners a class (mm); corner index
    4 (x > 0) + 2 (y > 0) + (z > 0)."""
    out = []
    for c in range(n_fg):
        h = np.array([base * (1.0 + 0.07 * c), base * (0.8 + 0.05 * c),
                      base * (1.2 - 0.03 * c)])
        out.append([[sx * h[0], sy * h[1], sz * h[2]]
                    for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    return np.asarray(out, np.float32)


def consts(n_fg: int) -> Dict[str, np.ndarray]:
    """K, inv_K, kp3d and diameters of the task."""
    kp3d = box_corners(n_fg)
    diam = np.linalg.norm(kp3d.max(1) - kp3d.min(1), axis=1).astype(np.float32)
    return dict(K=K_INTERNAL, inv_K=np.linalg.inv(K_INTERNAL).astype(np.float32),
                kp3d=kp3d, diameters=diam)


def _rotation(q: np.ndarray) -> np.ndarray:
    a, b, c, d = q / np.linalg.norm(q)
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d]])


def _dzi(center, scale: float, res: int) -> np.ndarray:
    r = res / scale
    t = np.array([res / 2.0, res / 2.0]) - r * np.asarray(center, np.float64)
    return np.array([[r, 0.0, t[0]], [0.0, r, t[1]]], np.float32)


def _hull(pts: np.ndarray) -> np.ndarray:
    """Convex hull of a few 2D points, counter-clockwise (x right, y up),
    by the monotone chain; fewer than 3 distinct corners give an empty one."""
    p = sorted(map(tuple, np.asarray(pts, np.float64)))
    cross = lambda o, a, b: (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])
    lower, upper = [], []
    for q in p:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], q) <= 0:
            lower.pop()
        lower.append(q)
    for q in reversed(p):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], q) <= 0:
            upper.pop()
        upper.append(q)
    return np.asarray(lower[:-1] + upper[:-1])


def _fill_convex(mask: np.ndarray, pts: np.ndarray, value: int):
    poly = _hull(pts)
    if len(poly) < 3:
        return
    H, W = mask.shape
    x0, x1 = max(int(np.floor(poly[:, 0].min())), 0), min(int(np.ceil(poly[:, 0].max())) + 1, W)
    y0, y1 = max(int(np.floor(poly[:, 1].min())), 0), min(int(np.ceil(poly[:, 1].max())) + 1, H)
    if x1 <= x0 or y1 <= y0:
        return
    xs, ys = np.meshgrid(np.arange(x0, x1) + 0.5, np.arange(y0, y1) + 0.5)
    inside = np.ones(xs.shape, bool)
    for i in range(len(poly)):
        (ax, ay), (bx, by) = poly[i], poly[(i + 1) % len(poly)]
        inside &= (bx - ax) * (ys - ay) - (by - ay) * (xs - ax) >= 0
    mask[y0:y1, x0:x1][inside] = value


def render(seed: int, stream: int, index: int, res: int, kp3d: np.ndarray,
           cls: int, train: bool):
    """One scene -> (image (res, res, 3) RGB in [0, 1], mask (res, res)
    int32, R, T, crop affine (2, 3))."""
    rng = np.random.default_rng([seed, stream, index])
    W, H = WH
    R = _rotation(rng.normal(size=4)).astype(np.float32)
    z = rng.uniform(650, 1100)
    x = rng.uniform(-0.25, 0.25) * z * W / K_INTERNAL[0, 0] / 2
    y = rng.uniform(-0.25, 0.25) * z * H / K_INTERNAL[1, 1] / 2
    T = np.array([x + rng.uniform(-30, 30), y + rng.uniform(-30, 30), z], np.float32)
    corners = kp3d[cls]
    cam = (R @ corners.T + T[:, None]).T
    uv = (K_INTERNAL @ cam.T).T
    kp = uv[:, :2] / (uv[:, 2:3] + 1e-8)
    lo, hi = kp.min(0), kp.max(0)
    center = (lo + hi) / 2
    size = max(hi - lo)
    if train:
        shift = 0.25 * (2 * rng.random(2) - 1)
        center = center + (hi - lo) * shift
        scale = size * (1 + 0.25 * (2 * rng.random() - 1)) * 1.5
    else:
        scale = max(size, 1) * 1.5
    M = _dzi(center, min(scale, max(H, W)), res)
    kp_crop = kp @ M[:, :2].T + M[:, 2]
    mask = np.zeros((res, res), np.int32)
    _fill_convex(mask, kp_crop, 1)
    img = rng.uniform(0, 0.15, size=(res, res, 3)).astype(np.float32)
    base = np.array([0.25 + 0.045 * cls, 0.85 - 0.04 * cls, 0.5], np.float32)
    colors = np.stack([np.roll(base, k) * (0.45 + 0.11 * k) for k in range(6)])
    depth = [cam[list(f), 2].mean() for f in FACES]
    faces = np.zeros((res, res), np.int32)
    for fi in np.argsort(depth)[::-1]:
        _fill_convex(faces, kp_crop[list(FACES[fi])], fi + 1)
    painted = faces > 0
    img[painted] = colors[faces[painted] - 1]
    img = np.clip(img + rng.normal(0, 0.02, img.shape).astype(np.float32), 0, 1)
    return img, mask, R, T, M


def train_batches(seed: int, n: int, batch: int, res: int, n_fg: int, cls: int = 0,
                  max_objs: int = 8) -> Dict[str, np.ndarray]:
    """n training batches of `batch` scenes of class `cls`: a dict of
    (n, batch, ...) arrays, the fields of the program's `Batch`."""
    kp3d = box_corners(n_fg)
    scenes = [render(seed, 0, i, res, kp3d, cls, train=True) for i in range(n * batch)]
    G = max_objs
    out = dict(images=np.stack([(s[0] - PIXEL_MEAN) / PIXEL_STD for s in scenes]),
               mask=np.stack([s[1] for s in scenes]),
               class_ids=np.full((n * batch, G), -1, np.int32),
               rotations=np.zeros((n * batch, G, 3, 3), np.float32),
               translations=np.zeros((n * batch, G, 3), np.float32),
               bbox_trans=np.stack([s[4] for s in scenes]))
    out["class_ids"][:, 0] = cls
    out["rotations"][:, 0] = [s[2] for s in scenes]
    out["translations"][:, 0] = [s[3] for s in scenes]
    return {k: v.reshape((n, batch) + v.shape[1:]) for k, v in out.items()}


def requests(seed: int, n: int, batch: int, res: int, n_fg: int,
             classes: Sequence[int]) -> Dict[str, np.ndarray]:
    """n serving requests of `batch` uint8 BGR crops, each scene's class
    drawn from `classes`: images (n, batch, res, res, 3), bbox_trans (n,
    batch, 2, 3)."""
    kp3d = box_corners(n_fg)
    pick = np.random.default_rng([seed, 1]).integers(0, len(classes), n * batch)
    scenes = [render(seed, 1, i, res, kp3d, int(classes[pick[i]]), train=False)
              for i in range(n * batch)]
    crops = np.stack([np.rint(s[0] * 255.0)[..., ::-1] for s in scenes]).astype(np.uint8)
    bt = np.stack([s[4] for s in scenes]).astype(np.float32)
    return dict(images=crops.reshape((n, batch) + crops.shape[1:]),
                bbox_trans=bt.reshape(n, batch, 2, 3))

