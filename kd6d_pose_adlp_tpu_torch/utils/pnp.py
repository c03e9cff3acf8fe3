"""Float64 EPnP on the host, following OpenCV's `SOLVEPNP_EPNP`
(Lepetit, Moreno-Noguer and Fua, "EPnP: An Accurate O(n) Solution to the
PnP Problem", IJCV 2009; OpenCV's `calib3d/src/epnp.cpp`).

The data pipeline re-fits each ground-truth pose after a 2D affine of the
image (`data/transforms.remap_poses`), and the streaming evaluator re-fits a
prediction to an image's own K (`engine/evaluator.remap_pose_host`). The
JAX package calls `cv2.solvePnP(..., SOLVEPNP_EPNP)` for both; the port
solves the same problem with the same algorithm and no image library:

- four control points, the centroid and one step along each PCA axis of
  the object points, the axes from OpenCV's one-sided Jacobi SVD, so they
  carry its signs (the result depends on them when the points are not an
  exact projection, as after a shift / scale / rotate augmentation);
- the 2n x 12 system M, the four right singular vectors of its smallest
  singular values, the 6 x 10 matrix L of the control points' distances;
- the three beta approximations, each refined by five Gauss-Newton steps,
  and the pose of least mean reprojection error.

The other decompositions (the null space of M'M, the least-squares solves,
the SVD of the cross-covariance) have unique answers, so numpy's own stand
in for OpenCV's and the result agrees with cv2's to float64 rounding.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

# pairs (a, b) of control points in the order of OpenCV's L and rho rows
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def jacobi_svd_ut(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(singular values descending, U transposed) of a square float64 matrix
    by OpenCV's one-sided Jacobi SVD (`JacobiSVDImpl_`, `core/src/lapack.cpp`)
    as `cv::SVD` runs it: the columns of A rotated pairwise until orthogonal,
    then normalized. The rows are the left singular vectors with OpenCV's
    signs."""
    at = np.array(a, np.float64).T.tolist()        # rows of At = columns of A
    n = len(at)
    eps = np.finfo(np.float64).eps * 10
    dot = lambda u, v: sum(x * y for x, y in zip(u, v))  # noqa: E731
    w = [dot(r, r) for r in at]
    for _ in range(max(len(at[0]), 30)):
        changed = False
        for i in range(n - 1):
            for j in range(i + 1, n):
                p = dot(at[i], at[j])
                if abs(p) <= eps * math.sqrt(w[i] * w[j]):
                    continue
                p *= 2.0
                beta = w[i] - w[j]
                gamma = math.hypot(p, beta)
                if beta < 0:
                    s = math.sqrt((gamma - beta) * 0.5 / gamma)
                    c = p / (gamma * s * 2.0)
                else:
                    c = math.sqrt((gamma + beta) / (gamma * 2.0))
                    s = p / (gamma * c * 2.0)
                at[i], at[j] = ([c * x + s * y for x, y in zip(at[i], at[j])],
                                [-s * x + c * y for x, y in zip(at[i], at[j])])
                w[i], w[j] = dot(at[i], at[i]), dot(at[j], at[j])
                changed = True
        if not changed:
            break
    at = np.array(at)
    w = np.sqrt(np.einsum("ij,ij->i", at, at))
    for i in range(n - 1):                          # selection sort, descending
        j = i + int(np.argmax(w[i:]))
        if j != i:
            w[[i, j]] = w[[j, i]]
            at[[i, j]] = at[[j, i]]
    return w, at / np.where(w > 0, w, 1.0)[:, None]


def _control_points(pw: np.ndarray) -> np.ndarray:
    """(4, 3) world control points: the centroid, then one step of
    sqrt(eigenvalue / n) along each principal axis."""
    c0 = pw.mean(0)
    d = pw - c0
    dc, uct = jacobi_svd_ut(d.T @ d)
    k = np.sqrt(dc / len(pw))
    return np.concatenate([c0[None], c0 + k[:, None] * uct], 0)


def _betas_approx(L: np.ndarray, rho: np.ndarray, which: int) -> np.ndarray:
    """OpenCV's find_betas_approx_1, _2, _3 (L's columns: B11 B12 B22 B13
    B23 B33 B14 B24 B34 B44)."""
    cols = {1: [0, 1, 3, 6], 2: [0, 1, 2], 3: [0, 1, 2, 3, 4]}[which]
    b = np.linalg.lstsq(L[:, cols], rho, rcond=None)[0]
    betas = np.zeros(4)
    if which == 1:
        betas[0] = np.sqrt(abs(b[0]))
        sign = -1.0 if b[0] < 0 else 1.0
        betas[1:] = sign * b[1:] / betas[0]
        return betas
    if b[0] < 0:
        betas[0] = np.sqrt(-b[0])
        betas[1] = np.sqrt(-b[2]) if b[2] < 0 else 0.0
    else:
        betas[0] = np.sqrt(b[0])
        betas[1] = np.sqrt(b[2]) if b[2] > 0 else 0.0
    if b[1] < 0:
        betas[0] = -betas[0]
    if which == 3:
        betas[2] = b[3] / betas[0]
    return betas


# (i, j) index of each L column into the betas
_IJ = ((0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
_I, _J = (np.array(x) for x in zip(*_IJ))


def _gauss_newton(L: np.ndarray, rho: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """Five Gauss-Newton steps on rho = L @ (products of the betas), each
    step's 6 x 4 least-squares system solved through its normal equations
    (OpenCV solves it by QR; the step converges to the same betas)."""
    betas = betas.copy()
    for _ in range(5):
        # d(L @ prods)/d(beta_k): column k gathers L[:, c] * beta_j for the
        # columns c = (k, j) and L[:, c] * beta_i for c = (i, k)
        A = np.zeros((6, 4))
        np.add.at(A.T, _I, (L * betas[_J]).T)
        np.add.at(A.T, _J, (L * betas[_I]).T)
        b = rho - L @ (betas[_I] * betas[_J])
        betas += np.linalg.solve(A.T @ A, A.T @ b)
    return betas


def solve_pnp_epnp(pt3d, xy2d, K) -> Tuple[np.ndarray, np.ndarray]:
    """(R (3, 3), T (3,)) float64 of the object points `pt3d` (n, 3) seen at
    the pixels `xy2d` (n, 2) through the pinhole `K` (3, 3), n >= 4: the
    camera-frame pose of least reprojection error among EPnP's three beta
    approximations (OpenCV `epnp::compute_pose`)."""
    pw = np.asarray(pt3d, np.float64).reshape(-1, 3)
    us = np.asarray(xy2d, np.float64).reshape(-1, 2)
    K = np.asarray(K, np.float64)
    n = len(pw)
    if n < 4 or len(us) != n:
        raise ValueError(f"EPnP needs n >= 4 matching 3D / 2D points, got {n} and {len(us)}")
    fu, fv, uc, vc = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    cws = _control_points(pw)
    cc = (cws[1:] - cws[0]).T                       # columns: control point offsets
    alphas = np.empty((n, 4))
    alphas[:, 1:] = (pw - cws[0]) @ np.linalg.inv(cc).T
    alphas[:, 0] = 1.0 - alphas[:, 1:].sum(1)

    M = np.zeros((2 * n, 12))
    M[0::2, 0::3] = alphas * fu
    M[0::2, 2::3] = alphas * (uc - us[:, :1])
    M[1::2, 1::3] = alphas * fv
    M[1::2, 2::3] = alphas * (vc - us[:, 1:])
    _, vecs = np.linalg.eigh(M.T @ M)               # ascending eigenvalues
    v = vecs[:, :4].T.reshape(4, 4, 3)              # v[i]: i-th smallest, 4 points x 3

    dv = np.stack([v[:, a] - v[:, b] for a, b in _PAIRS], 1)     # (4, 6, 3)
    L = np.empty((6, 10))
    col = 0
    for j in range(4):
        for i in range(j + 1):
            L[:, col] = (1.0 if i == j else 2.0) * np.einsum("pk,pk->p", dv[i], dv[j])
            col += 1
    # column order B11 B12 B22 B13 B23 B33 B14 B24 B34 B44
    rho = np.array([np.sum((cws[a] - cws[b]) ** 2) for a, b in _PAIRS])

    best = None
    for which in (1, 2, 3):
        betas = _gauss_newton(L, rho, _betas_approx(L, rho, which))
        ccs = np.einsum("i,ipk->pk", betas, v)
        pcs = alphas @ ccs
        if pcs[0, 2] < 0:
            pcs = -pcs
        R, T = _absolute_orientation(pcs, pw)
        cam = pw @ R.T + T
        err = np.mean(np.hypot(us[:, 0] - (uc + fu * cam[:, 0] / cam[:, 2]),
                               us[:, 1] - (vc + fv * cam[:, 1] / cam[:, 2])))
        if best is None or err < best[0]:
            best = (err, R, T)
    return best[1], best[2]


def _absolute_orientation(pcs: np.ndarray, pws: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(R, T) with pcs ~ R pws + T (OpenCV `epnp::estimate_R_and_t`: the SVD
    of the centred cross-covariance, the third row negated on a
    reflection)."""
    pc0, pw0 = pcs.mean(0), pws.mean(0)
    abt = (pcs - pc0).T @ (pws - pw0)
    u, _, vt = np.linalg.svd(abt)
    R = u @ vt
    if np.linalg.det(R) < 0:
        R[2] = -R[2]
    return R, pc0 - R @ pw0
