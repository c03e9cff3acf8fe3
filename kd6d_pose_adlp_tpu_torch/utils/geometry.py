"""Host-side NumPy geometry helpers (copy of the parts of
`kd6d_pose_adlp_tpu/utils/geometry.py` that synthetic scenes, the evaluators
and the tests need): projection, 2x3 affines, quaternions, general Euler
angles and symmetry canonicalization, the augmentation and DZI crop
affines and corner boxes."""
from __future__ import annotations

import math
from typing import Sequence, Tuple

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


def rotation2quaternion(M: np.ndarray) -> np.ndarray:
    m = np.asarray(M, dtype=np.float64).reshape(-1)
    tr = m[0] + m[4] + m[8]
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        w, x, y, z = 0.25 * s, (m[7] - m[5]) / s, (m[2] - m[6]) / s, (m[3] - m[1]) / s
    elif m[0] > m[4] and m[0] > m[8]:
        s = math.sqrt(1.0 + m[0] - m[4] - m[8]) * 2
        w, x, y, z = (m[7] - m[5]) / s, 0.25 * s, (m[1] + m[3]) / s, (m[2] + m[6]) / s
    elif m[4] > m[8]:
        s = math.sqrt(1.0 + m[4] - m[0] - m[8]) * 2
        w, x, y, z = (m[2] - m[6]) / s, (m[1] + m[3]) / s, 0.25 * s, (m[5] + m[7]) / s
    else:
        s = math.sqrt(1.0 + m[8] - m[0] - m[4]) * 2
        w, x, y, z = (m[3] - m[1]) / s, (m[2] + m[6]) / s, (m[5] + m[7]) / s, 0.25 * s
    return np.array([w, x, y, z])


# =========================================================================
# General Euler angles (replaces the reference's transforms3d dependency,
# used by pose_symmetry_handling — reference libs/utils.py:528-553).
# Standard axis-sequence algebra (Shoemake convention).
# =========================================================================

_NEXT_AXIS = [1, 2, 0, 1]
_AXES2TUPLE = {
    "sxyz": (0, 0, 0, 0), "sxyx": (0, 0, 1, 0), "sxzy": (0, 1, 0, 0),
    "sxzx": (0, 1, 1, 0), "syzx": (1, 0, 0, 0), "syzy": (1, 0, 1, 0),
    "syxz": (1, 1, 0, 0), "syxy": (1, 1, 1, 0), "szxy": (2, 0, 0, 0),
    "szxz": (2, 0, 1, 0), "szyx": (2, 1, 0, 0), "szyz": (2, 1, 1, 0),
}
_EPS4 = np.finfo(float).eps * 4.0


def euler2mat(ai: float, aj: float, ak: float, axes: str = "sxyz") -> np.ndarray:
    firstaxis, parity, repetition, frame = _AXES2TUPLE[axes]
    i = firstaxis
    j = _NEXT_AXIS[i + parity]
    k = _NEXT_AXIS[i - parity + 1]
    if frame:
        ai, ak = ak, ai
    if parity:
        ai, aj, ak = -ai, -aj, -ak
    si, sj, sk = math.sin(ai), math.sin(aj), math.sin(ak)
    ci, cj, ck = math.cos(ai), math.cos(aj), math.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    M = np.eye(3)
    if repetition:
        M[i, i] = cj
        M[i, j] = sj * si
        M[i, k] = sj * ci
        M[j, i] = sj * sk
        M[j, j] = -cj * ss + cc
        M[j, k] = -cj * cs - sc
        M[k, i] = -sj * ck
        M[k, j] = cj * sc + cs
        M[k, k] = cj * cc - ss
    else:
        M[i, i] = cj * ck
        M[i, j] = sj * sc - cs
        M[i, k] = sj * cc + ss
        M[j, i] = cj * sk
        M[j, j] = sj * ss + cc
        M[j, k] = sj * cs - sc
        M[k, i] = -sj
        M[k, j] = cj * si
        M[k, k] = cj * ci
    return M


def mat2euler(M: np.ndarray, axes: str = "sxyz") -> Tuple[float, float, float]:
    firstaxis, parity, repetition, frame = _AXES2TUPLE[axes]
    i = firstaxis
    j = _NEXT_AXIS[i + parity]
    k = _NEXT_AXIS[i - parity + 1]
    M = np.asarray(M, dtype=np.float64)
    if repetition:
        sy = math.sqrt(M[i, j] * M[i, j] + M[i, k] * M[i, k])
        if sy > _EPS4:
            ax = math.atan2(M[i, j], M[i, k])
            ay = math.atan2(sy, M[i, i])
            az = math.atan2(M[j, i], -M[k, i])
        else:
            ax = math.atan2(-M[j, k], M[j, j])
            ay = math.atan2(sy, M[i, i])
            az = 0.0
    else:
        cy = math.sqrt(M[i, i] * M[i, i] + M[j, i] * M[j, i])
        if cy > _EPS4:
            ax = math.atan2(M[k, j], M[k, k])
            ay = math.atan2(-M[k, i], cy)
            az = math.atan2(M[j, i], M[i, i])
        else:
            ax = math.atan2(-M[j, k], M[j, j])
            ay = math.atan2(-M[k, i], cy)
            az = 0.0
    if parity:
        ax, ay, az = -ax, -ay, -az
    if frame:
        ax, az = az, ax
    return ax, ay, az


def pose_symmetry_handling(R: np.ndarray, sym_spec: Sequence) -> np.ndarray:
    """Canonicalize a rotation w.r.t. discrete object symmetries.

    `sym_spec` is a flat list of (axis, mod-degrees) pairs, e.g.
    ['X',180,'Y',180,'Z',180]. For each pair, the Euler angle about the given
    axis (in the axis-specific sequence) is reduced modulo `mod`
    (reference libs/utils.py:528-553).
    """
    if len(sym_spec) == 0:
        return np.asarray(R, dtype=np.float32)
    assert len(sym_spec) % 2 == 0
    R = np.asarray(R, dtype=np.float64)
    for idx in range(len(sym_spec) // 2):
        axis = sym_spec[2 * idx]
        mod = float(sym_spec[2 * idx + 1]) * np.pi / 180.0
        seq = {"X": "sxyz", "Y": "syzx", "Z": "szyx"}[axis]
        ai, aj, ak = mat2euler(R, axes=seq)
        ai = 0.0 if mod == 0 else math.fmod(ai, mod)
        R = euler2mat(ai, aj, ak, axes=seq)
    return R.astype(np.float32)


def rotation_matrix_2d(center: Tuple[float, float], angle_deg: float, scale: float) -> np.ndarray:
    """2x3 rotation+scale about a center (same convention as cv2.getRotationMatrix2D)."""
    a = math.radians(angle_deg)
    alpha = scale * math.cos(a)
    beta = scale * math.sin(a)
    cx, cy = center
    return np.array([
        [alpha, beta, (1 - alpha) * cx - beta * cy],
        [-beta, alpha, beta * cx + (1 - alpha) * cy],
    ], dtype=np.float64)


def shift_scale_rotate_matrix(shift_x: float, shift_y: float, angle_deg: float,
                              scale: float, width: int, height: int) -> np.ndarray:
    """3x3 combined shift -> (rotate+scale about image center) matrix
    (reference libs/utils.py:161-179; randomness is supplied by the caller)."""
    shiftM = np.array([[1.0, 0.0, -shift_x], [0.0, 1.0, -shift_y], [0.0, 0.0, 1.0]])
    rs = rotation_matrix_2d((width / 2.0, height / 2.0), angle_deg, scale)
    rsM = np.concatenate([rs, [[0.0, 0.0, 1.0]]], axis=0)
    return (rsM @ shiftM).astype(np.float32)


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
