"""Visualization: the KD point-cloud scatters, the accuracy-per-depth
curves and the pose overlays (port of `kd6d_pose_adlp_tpu/tools/
visualizer.py`), drawn with numpy alone and written through `data/png.py`.

The JAX module draws with matplotlib and cv2, and returns None without
matplotlib; the port needs neither. Its rasterizer has what the figures
and overlays use: 8-connected lines with a thickness, filled discs
blended at an alpha, a monotone-chain convex hull, a plain axes frame with
a grid. A figure holds the content of JAX's (the same points, sizes,
colours, curves, axis directions and file names), not matplotlib's pixels:
it has no text (title, legend, tick labels). Images are (H, W, 3) uint8 in
BGR order, as cv2's, and colours are given in that order.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data import png
from ..utils import geometry as geo

DPI = 120                         # JAX's savefig dpi
# matplotlib's named colours and its default colour cycle, in BGR
GREEN, RED = (0, 128, 0), (0, 0, 255)
CYCLE = tuple((int(h[4:6], 16), int(h[2:4], 16), int(h[0:2], 16)) for h in (
    "1f77b4", "ff7f0e", "2ca02c", "d62728", "9467bd",
    "8c564b", "e377c2", "7f7f7f", "bcbd22", "17becf"))
BLACK, GRID = (0, 0, 0), (222, 222, 222)
# the scatter's canvas (JAX's figsize 6 x 5 in) and the axes box in it
# (left, top, right, bottom pixel, inclusive)
CLOUD_SIZE = (5 * DPI, 6 * DPI)
CLOUD_BOX = (60, 30, 6 * DPI - 21, 5 * DPI - 41)
# the depth figure: two panels of 4.5 x 4 in side by side (JAX's 9 x 4)
DEPTH_SIZE = (4 * DPI, 9 * DPI)
MARGIN = 0.05                     # matplotlib's default data margin


# ---------------------------------------------------------------------------
# rasterizer
# ---------------------------------------------------------------------------

def _clip_segment(p0, p1, lo, hi) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Liang-Barsky: the part of p0 -> p1 inside the box [lo, hi] (float
    (2,) each), or None."""
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    d = p1 - p0
    t0, t1 = 0.0, 1.0
    for q, r in ((-d[0], p0[0] - lo[0]), (d[0], hi[0] - p0[0]),
                 (-d[1], p0[1] - lo[1]), (d[1], hi[1] - p0[1])):
        if q == 0:
            if r < 0:
                return None
            continue
        t = r / q
        if q < 0:
            t0 = max(t0, t)
        else:
            t1 = min(t1, t)
        if t0 > t1:
            return None
    return p0 + t0 * d, p0 + t1 * d


def line_pixels(p0, p1, shape: Tuple[int, int], thickness: int = 1) -> np.ndarray:
    """(n, 2) int (x, y) pixels of the segment p0 -> p1 inside an image of
    `shape` (H, W): the 8-connected line (one pixel a step along the major
    axis, the minor coordinate rounded) between the rounded end points,
    clipped to the image, each pixel widened to a disc of diameter
    `thickness` (cv2.line's LINE_8 and its round thick lines)."""
    H, W = shape
    r = max(thickness, 1) / 2.0
    seg = _clip_segment(p0, p1, (-r, -r), (W - 1 + r, H - 1 + r))
    if seg is None:
        return np.zeros((0, 2), np.int64)
    a, b = np.rint(seg[0]).astype(np.int64), np.rint(seg[1]).astype(np.int64)
    n = int(np.abs(b - a).max())
    t = np.arange(n + 1)
    pts = a[None] if n == 0 else a[None] + np.rint(
        (b - a)[None] * t[:, None] / n).astype(np.int64)
    if thickness > 1:
        pts = (pts[:, None] + disc_offsets(r)[None]).reshape(-1, 2)
    keep = (pts[:, 0] >= 0) & (pts[:, 0] < W) & (pts[:, 1] >= 0) & (pts[:, 1] < H)
    return pts[keep]


def disc_offsets(radius: float) -> np.ndarray:
    """(n, 2) int offsets (dx, dy) with dx² + dy² <= radius²."""
    k = int(np.floor(radius))
    d = np.arange(-k, k + 1)
    dx, dy = np.meshgrid(d, d)
    m = dx * dx + dy * dy <= radius * radius
    return np.stack([dx[m], dy[m]], axis=1)


def _paint(img: np.ndarray, pts: np.ndarray, color, alpha: float = 1.0) -> None:
    if len(pts) == 0:
        return
    c = np.asarray(color, np.float64)
    if alpha >= 1.0:
        img[pts[:, 1], pts[:, 0]] = c.astype(img.dtype)
        return
    pts = np.unique(pts, axis=0)
    old = img[pts[:, 1], pts[:, 0]].astype(np.float64)
    img[pts[:, 1], pts[:, 0]] = np.rint(alpha * c + (1 - alpha) * old).astype(img.dtype)


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    _paint(img, line_pixels(p0, p1, img.shape[:2], thickness), color)


def disc_pixels(center, radius: float, shape: Tuple[int, int]) -> np.ndarray:
    """(n, 2) int pixels of the filled disc of `radius` about `center`
    (rounded to a pixel) inside an image of `shape` (H, W)."""
    H, W = shape
    c = np.rint(np.asarray(center, np.float64)).astype(np.int64)
    pts = c[None] + disc_offsets(radius)
    keep = (pts[:, 0] >= 0) & (pts[:, 0] < W) & (pts[:, 1] >= 0) & (pts[:, 1] < H)
    return pts[keep]


def draw_disc(img: np.ndarray, center, radius: float, color, alpha: float = 1.0) -> None:
    _paint(img, disc_pixels(center, radius, img.shape[:2]), color, alpha)


def draw_polyline(img: np.ndarray, pts, closed: bool, color, thickness: int = 1) -> None:
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    n = len(pts)
    for i in range(n if closed else n - 1):
        draw_line(img, pts[i], pts[(i + 1) % n], color, thickness)


def convex_hull(points) -> np.ndarray:
    """Andrew's monotone chain: the hull's vertices (collinear points left
    out), counter-clockwise in (x, y) from the lowest x (then y)."""
    p = np.unique(np.asarray(points, np.float64).reshape(-1, 2), axis=0)
    if len(p) < 3:
        return p

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def chain(seq):
        out: List[np.ndarray] = []
        for q in seq:
            while len(out) >= 2 and cross(out[-2], out[-1], q) <= 0:
                out.pop()
            out.append(q)
        return out

    lower, upper = chain(p), chain(p[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def data_limits(values, margin: float = MARGIN) -> Tuple[float, float]:
    """(lo, hi) of the finite `values` widened by `margin` of their span
    on each side (matplotlib's autoscale), (v - 0.5, v + 0.5) for one value
    and (0, 1) for none."""
    v = np.asarray(values, np.float64).reshape(-1)
    v = v[np.isfinite(v)]
    if len(v) == 0:
        return 0.0, 1.0
    lo, hi = float(v.min()), float(v.max())
    if hi == lo:
        return lo - 0.5, hi + 0.5
    pad = margin * (hi - lo)
    return lo - pad, hi + pad


def to_pixels(xy, xlim, ylim, box, invert_y: bool = False) -> np.ndarray:
    """Data (n, 2) -> float pixel (x, y) in `box` = (left, top, right,
    bottom): xlim[0] at the left edge, ylim[0] at the bottom edge, or at
    the top with `invert_y` (matplotlib's invert_yaxis)."""
    xy = np.asarray(xy, np.float64).reshape(-1, 2)
    left, top, right, bottom = box
    u = (xy[:, 0] - xlim[0]) / (xlim[1] - xlim[0])
    v = (xy[:, 1] - ylim[0]) / (ylim[1] - ylim[0])
    px = left + u * (right - left)
    py = top + v * (bottom - top) if invert_y else bottom - v * (bottom - top)
    return np.stack([px, py], axis=1)


def _frame(img: np.ndarray, box, grid: int = 0) -> None:
    left, top, right, bottom = box
    for i in range(1, grid):
        x = left + i * (right - left) / grid
        y = top + i * (bottom - top) / grid
        draw_line(img, (x, top), (x, bottom), GRID)
        draw_line(img, (left, y), (right, y), GRID)
    draw_polyline(img, [(left, top), (right, top), (right, bottom), (left, bottom)],
                  True, BLACK)


def marker_radius(area_pt2) -> np.ndarray:
    """Pixel radius of a matplotlib scatter marker of `area_pt2` points²
    (its diameter is sqrt(area) points) at DPI."""
    return 0.5 * np.sqrt(np.asarray(area_pt2, np.float64)) * DPI / 72.0


def _write(path: str, img: np.ndarray) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    png.write(path, img)
    return path


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------

def cloud_series(student_xy, teacher_xy, student_w, teacher_w):
    """What `vis_kd_clouds` plots: (s (n, 2), t (m, 2), the student's and
    the teacher's marker areas in points², 10 + 200 w / (max w + 1e-9), as
    JAX's, and the axes' (xlim, ylim))."""
    s = np.asarray(student_xy, np.float64).reshape(-1, 2)
    t = np.asarray(teacher_xy, np.float64).reshape(-1, 2)
    sw = (np.asarray(student_w, np.float64).reshape(-1) if student_w is not None
          else np.ones(len(s)))
    tw = (np.asarray(teacher_w, np.float64).reshape(-1) if teacher_w is not None
          else np.ones(len(t)))
    both = np.concatenate([s, t])
    return (s, t, 10 + 200 * sw / (sw.max() + 1e-9), 10 + 200 * tw / (tw.max() + 1e-9),
            data_limits(both[:, 0]), data_limits(both[:, 1]))


def vis_kd_clouds(student_xy, teacher_xy, student_w, teacher_w, step: int,
                  save_dir: str, loss: Optional[float] = None) -> str:
    """Scatter of the student's (green) and the teacher's (red) keypoint
    clouds of one image at alpha 0.5, marker area growing with the OT
    weight, the y axis pointing down (reference tools/visualizer.py:5-100);
    writes `save_dir/{step}_img_2d.png` and returns its path. `loss` is
    JAX's title text, which the port does not draw."""
    s, t, s_area, t_area, xlim, ylim = cloud_series(student_xy, teacher_xy,
                                                    student_w, teacher_w)
    img = np.full(CLOUD_SIZE + (3,), 255, np.uint8)
    _frame(img, CLOUD_BOX)
    for pts, area, color in ((s, s_area, GREEN), (t, t_area, RED)):
        for p, r in zip(to_pixels(pts, xlim, ylim, CLOUD_BOX, invert_y=True),
                        marker_radius(area)):
            if np.isfinite(p).all():
                draw_disc(img, p, r, color, alpha=0.5)
    return _write(os.path.join(save_dir, f"{step}_img_2d.png"), img)


def per_depth_series(results: dict) -> Tuple[np.ndarray, Dict[str, List[float]],
                                              Dict[str, List[float]]]:
    """What `vis_accuracy_per_depth` plots: the bins' depths `xs` (JAX
    visualizer.py:62-64: arange(lo, hi, (hi - lo) / bins)[:bins] over the
    results' depth_range; 0, 1, ... when that range is not finite, as after
    an evaluation without ground truth) and, per metric name, the success
    rate (%) of each bin, 0 where a bin has none: 2D (REP) and 3D (ADI)."""
    adi = results.get("adi_per_depth", [])
    rep = results.get("rep_per_depth", [])
    lo, hi = results.get("depth_range", [0, 1])
    bins = max(len(adi), 1)
    if np.isfinite(lo) and np.isfinite(hi) and hi != lo:
        xs = np.arange(lo, hi, (hi - lo) / bins)[:bins]
    else:
        xs = np.arange(bins, dtype=np.float64)
    curves = [{k: [d.get(k, 0.0) for d in per] for k in sorted({k for d in per for k in d})}
              for per in (rep, adi)]
    return xs, curves[0], curves[1]


def vis_accuracy_per_depth(results: dict, save_path: str) -> str:
    """The 2D (left) and 3D (right) success rate against depth, a curve
    with round markers per metric in matplotlib's colour cycle, on a grid
    (reference libs/utils.py:565-618); writes `save_path`."""
    xs, rep, adi = per_depth_series(results)
    H, W = DEPTH_SIZE
    img = np.full((H, W, 3), 255, np.uint8)
    half = W // 2
    for i, curves in enumerate((rep, adi)):
        box = (i * half + 60, 30, (i + 1) * half - 21, H - 41)
        _frame(img, box, grid=5)
        vals = [v for c in curves.values() for v in c]
        xlim, ylim = data_limits(xs), data_limits(vals)
        for j, (_, ys) in enumerate(curves.items()):
            n = min(len(xs), len(ys))
            pts = to_pixels(np.stack([xs[:n], np.asarray(ys[:n], np.float64)], 1),
                            xlim, ylim, box)
            color = CYCLE[j % len(CYCLE)]
            draw_polyline(img, pts, False, color, thickness=2)
            for p in pts:
                draw_disc(img, p, marker_radius(36.0), color)   # markersize 6 pt
    return _write(save_path, img)


# ---------------------------------------------------------------------------
# overlays (cv2 images, BGR)
# ---------------------------------------------------------------------------

BOX_EDGES = ((0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
             (0, 4), (1, 5), (2, 6), (3, 7))


def _project(R, T, K, pts3d, bbox_trans=None) -> np.ndarray:
    pts = geo.project_points(np.asarray(K), np.asarray(R), np.asarray(T),
                             np.asarray(pts3d))
    if bbox_trans is not None:
        pts = geo.apply_affine(np.asarray(bbox_trans), pts)
    return pts


def draw_bounding_box(img: np.ndarray, R, T, corners3d, K, color=(0, 255, 0),
                      bbox_trans=None) -> np.ndarray:
    """The projected 3D box's wireframe, 2 px wide (corner order binary
    over (x, y, z)); a copy of `img`."""
    pts = _project(R, T, K, corners3d, bbox_trans).astype(int)
    out = img.copy()
    for a, b in BOX_EDGES:
        draw_line(out, pts[a], pts[b], color, 2)
    return out


def draw_pose_axes(img: np.ndarray, R, T, K, length: float = 50.0,
                   bbox_trans=None) -> np.ndarray:
    """The object's axes from its origin, x red, y green, z blue, 2 px
    wide; a copy of `img`."""
    pts3d = np.array([[0, 0, 0], [length, 0, 0], [0, length, 0], [0, 0, length]],
                     np.float32)
    pts = _project(R, T, K, pts3d, bbox_trans).astype(int)
    out = img.copy()
    for i, color in ((1, (0, 0, 255)), (2, (0, 255, 0)), (3, (255, 0, 0))):
        draw_line(out, pts[0], pts[i], color, 2)
    return out


def draw_2d_keypoints(img: np.ndarray, kp2d, color=(0, 255, 255), radius: int = 2,
                      scores=None) -> np.ndarray:
    """Keypoints as filled discs; with `scores`, the radius grows with the
    score (reference libs/utils.py:555-563); points off the image by more
    than its size, or not finite, are skipped. A copy of `img`."""
    out = img.copy()
    pts = np.asarray(kp2d, np.float64).reshape(-1, 2)
    sc = (np.asarray(scores, np.float64).reshape(-1) if scores is not None
          else np.ones(len(pts)))
    smax = sc.max() + 1e-9
    h, w = out.shape[:2]
    for (x, y), s in zip(pts, sc):
        if not (np.isfinite(x) and np.isfinite(y)):
            continue
        if -w < x < 2 * w and -h < y < 2 * h:
            r = max(1, int(round(radius * (0.5 + s / smax))))
            draw_disc(out, (int(round(x)), int(round(y))), r, color)
    return out


def draw_mesh_contour(img: np.ndarray, R, T, K, vertices, color=(255, 0, 255),
                      thickness: int = 2, max_vertices: int = 1000) -> np.ndarray:
    """The silhouette as the convex hull of the projected mesh vertices
    (at most `max_vertices`, evenly subsampled), the renderer-free
    stand-in for the reference's pyrender contour (libs/utils.py:655-713).
    A copy of `img`."""
    v = np.asarray(vertices, np.float64)
    if len(v) > max_vertices:
        v = v[np.linspace(0, len(v) - 1, max_vertices).astype(int)]
    pts = geo.project_points(np.asarray(K), np.asarray(R), np.asarray(T), v)
    pts = pts[np.isfinite(pts).all(-1)]
    out = img.copy()
    if len(pts) < 3:
        return out
    hull = convex_hull(pts.astype(np.float32))
    draw_polyline(out, hull.astype(np.int32), True, color, thickness)
    return out

