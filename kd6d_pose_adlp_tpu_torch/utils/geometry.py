"""Host-side NumPy geometry helpers (copy of the parts of
`kd6d_pose_adlp_tpu/utils/geometry.py` that synthetic scenes and the tests
need): projection, 2x3 affines, quaternions, the DZI crop affine and
corner boxes."""
from __future__ import annotations

import math

import numpy as np


def project_points(K, R, T, pts3d):
    """Project 3D model points to pixels: x = K (R p + T).
    K (3,3), R (3,3), T (3,) or (3,1), pts3d (N,3) -> (N,2)."""
    T = T.reshape(3, 1)
    cam = R @ pts3d.T + T                      # (3, N)
    uv = K @ cam                               # (3, N)
    return (uv[:2] / (uv[2:3] + 1e-8)).T       # (N, 2)


def apply_affine(M, pts):
    """Apply a 2x3 (or 3x3) affine to (N,2) points."""
    A = M[:2, :2]
    t = M[:2, 2]
    return pts @ A.T + t


def quaternion2rotation(quat: np.ndarray) -> np.ndarray:
    q = np.asarray(quat, dtype=np.float64)
    q = q / np.linalg.norm(q)
    a, b, c, d = q
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d],
    ])


def dzi_affine(center: np.ndarray, scale: float, output_size: int,
               rot_deg: float = 0.0) -> np.ndarray:
    """2x3 affine mapping the square window (center, scale) to output_size²
    (reference libs/dzi_libs.py:157-198, closed form)."""
    cx, cy = float(center[0]), float(center[1])
    s = float(scale)
    r = output_size / s
    a = math.radians(rot_deg)
    ca, sa = math.cos(a), math.sin(a)
    # maps src point p to: R_rot(p - c) * r + out/2
    A = np.array([[ca, sa], [-sa, ca]]) * r
    t = np.array([output_size / 2.0, output_size / 2.0]) - A @ np.array([cx, cy])
    return np.concatenate([A, t.reshape(2, 1)], axis=1).astype(np.float32)


def corners_bbox_xyxy(pts2d) -> np.ndarray:
    """Axis-aligned bbox of projected corners: (x1,y1,x2,y2)."""
    xs, ys = pts2d[..., 0], pts2d[..., 1]
    return np.stack([xs.min(-1), ys.min(-1), xs.max(-1), ys.max(-1)], axis=-1)
