"""Fixed-size linear algebra in plain tensor ops, batched over leading dims
(frozen copy of
`kd6d_pose_adlp_tpu_torch/ops/smallalg.py`, all of it).

The port keeps the JAX package's straight-line algorithms — adjugate
inverses, unrolled Cholesky, analytic 3x3 eigh, cyclic-Jacobi 4x4 eigh,
inverse subspace iteration from a fixed init, Horn's quaternion by power
iteration — rather than `torch.linalg`, so that null spaces, eigenvector
signs and iteration counts are the reference's. Every function takes
(..., n, n) / (..., n) and treats the leading dims as a batch. fp32; the
matmuls must not run in TF32 (see `utils/precision.full_fp32`).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# inverses / solves
# ---------------------------------------------------------------------------

def inv3(A: torch.Tensor) -> torch.Tensor:
    """Adjugate-based inverse of (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    adj = torch.stack([torch.stack([A00, A01, A02], dim=-1),
                       torch.stack([A10, A11, A12], dim=-1),
                       torch.stack([A20, A21, A22], dim=-1)], dim=-2)
    return adj / det[..., None, None]


def inv4(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) via the cofactor (adjugate) expansion."""
    m = lambda r, c: A[..., r, c]
    s0 = m(0, 0) * m(1, 1) - m(1, 0) * m(0, 1)
    s1 = m(0, 0) * m(1, 2) - m(1, 0) * m(0, 2)
    s2 = m(0, 0) * m(1, 3) - m(1, 0) * m(0, 3)
    s3 = m(0, 1) * m(1, 2) - m(1, 1) * m(0, 2)
    s4 = m(0, 1) * m(1, 3) - m(1, 1) * m(0, 3)
    s5 = m(0, 2) * m(1, 3) - m(1, 2) * m(0, 3)
    c5 = m(2, 2) * m(3, 3) - m(3, 2) * m(2, 3)
    c4 = m(2, 1) * m(3, 3) - m(3, 1) * m(2, 3)
    c3 = m(2, 1) * m(3, 2) - m(3, 1) * m(2, 2)
    c2 = m(2, 0) * m(3, 3) - m(3, 0) * m(2, 3)
    c1 = m(2, 0) * m(3, 2) - m(3, 0) * m(2, 2)
    c0 = m(2, 0) * m(3, 1) - m(3, 0) * m(2, 1)
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    rows = [
        [m(1, 1) * c5 - m(1, 2) * c4 + m(1, 3) * c3,
         -m(0, 1) * c5 + m(0, 2) * c4 - m(0, 3) * c3,
         m(3, 1) * s5 - m(3, 2) * s4 + m(3, 3) * s3,
         -m(2, 1) * s5 + m(2, 2) * s4 - m(2, 3) * s3],
        [-m(1, 0) * c5 + m(1, 2) * c2 - m(1, 3) * c1,
         m(0, 0) * c5 - m(0, 2) * c2 + m(0, 3) * c1,
         -m(3, 0) * s5 + m(3, 2) * s2 - m(3, 3) * s1,
         m(2, 0) * s5 - m(2, 2) * s2 + m(2, 3) * s1],
        [m(1, 0) * c4 - m(1, 1) * c2 + m(1, 3) * c0,
         -m(0, 0) * c4 + m(0, 1) * c2 - m(0, 3) * c0,
         m(3, 0) * s4 - m(3, 1) * s2 + m(3, 3) * s0,
         -m(2, 0) * s4 + m(2, 1) * s2 - m(2, 3) * s0],
        [-m(1, 0) * c3 + m(1, 1) * c1 - m(1, 2) * c0,
         m(0, 0) * c3 - m(0, 1) * c1 + m(0, 2) * c0,
         -m(3, 0) * s3 + m(3, 1) * s1 - m(3, 2) * s0,
         m(2, 0) * s3 - m(2, 1) * s1 + m(2, 2) * s0],
    ]
    inv = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    return inv / det[..., None, None]


def cholesky_fixed(A: torch.Tensor, n: int) -> torch.Tensor:
    """Unrolled Cholesky A = L L^T of SPD (..., n, n), n column steps."""
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[..., j, j] - (L[..., j, :j] ** 2).sum(-1) if j else A[..., j, j]
        d = torch.sqrt(s.clamp_min(1e-20))
        L[..., j, j] = d
        if j + 1 < n:
            if j:
                off = A[..., j + 1:, j] - torch.matmul(
                    L[..., j + 1:, :j], L[..., j, :j, None])[..., 0]
            else:
                off = A[..., j + 1:, j]
            L[..., j + 1:, j] = off / d[..., None]
    return L


def chol_solve_fixed(L: torch.Tensor, B: torch.Tensor, n: int) -> torch.Tensor:
    """Solve (L L^T) X = B by unrolled substitution; B (..., n, k)."""
    Y = torch.zeros_like(B)
    for i in range(n):
        r = B[..., i, :]
        if i:
            r = r - torch.matmul(L[..., i:i + 1, :i], Y[..., :i, :])[..., 0, :]
        Y[..., i, :] = r / L[..., i, i, None]
    X = torch.zeros_like(B)
    for i in range(n - 1, -1, -1):
        r = Y[..., i, :]
        if i + 1 < n:
            r = r - torch.matmul(L[..., i + 1:, i][..., None, :],
                                 X[..., i + 1:, :])[..., 0, :]
        X[..., i, :] = r / L[..., i, i, None]
    return X


def solve_spd(A: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """SPD solve via the unrolled Cholesky; b (..., n)."""
    return chol_solve_fixed(cholesky_fixed(A, n), b[..., None], n)[..., 0]


# ---------------------------------------------------------------------------
# symmetric 3x3 eigendecomposition (analytic)
# ---------------------------------------------------------------------------

def _largest_eigvec3(S: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector of symmetric S for eigenvalue lam: the largest cross
    product of rows of (S - lam I); e_z when all are degenerate."""
    M = S - lam[..., None, None] * _eye(3, S)
    cands = torch.stack([_cross(M[..., 0, :], M[..., 1, :]),
                         _cross(M[..., 0, :], M[..., 2, :]),
                         _cross(M[..., 1, :], M[..., 2, :])], dim=-2)
    n2 = (cands * cands).sum(-1)                         # (..., 3)
    idx = torch.argmax(n2, dim=-1)
    v = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 3)))[..., 0, :]
    ok = n2.amax(-1) > 1e-24
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=S.dtype, device=S.device)
    v = torch.where(ok[..., None], v, ez)
    return v / torch.sqrt((v * v).sum(-1, keepdim=True).clamp_min(1e-30))


def eigh3(S: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic symmetric 3x3 eigendecomposition, ascending:
    (w (..., 3), V (..., 3, 3) eigenvector columns)."""
    scale = S.abs().amax(dim=(-2, -1)).clamp_min(1e-20)
    B = S / scale[..., None, None]
    q = (B[..., 0, 0] + B[..., 1, 1] + B[..., 2, 2]) / 3.0
    Bq = B - q[..., None, None] * _eye(3, S)
    p2 = (Bq * Bq).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(p2.clamp_min(1e-30))
    C = Bq / p[..., None, None]
    detC = (C[..., 0, 0] * (C[..., 1, 1] * C[..., 2, 2] - C[..., 1, 2] * C[..., 2, 1])
            - C[..., 0, 1] * (C[..., 1, 0] * C[..., 2, 2] - C[..., 1, 2] * C[..., 2, 0])
            + C[..., 0, 2] * (C[..., 1, 0] * C[..., 2, 1] - C[..., 1, 1] * C[..., 2, 0]))
    r = (detC / 2.0).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    w2 = q + 2.0 * p * torch.cos(phi)                          # largest
    w0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)    # smallest
    w1 = 3.0 * q - w0 - w2
    spherical = p2 < 1e-18
    w0 = torch.where(spherical, q, w0)
    w1 = torch.where(spherical, q, w1)
    w2 = torch.where(spherical, q, w2)

    v2 = _largest_eigvec3(B, w2)
    v0 = _largest_eigvec3(B, w0)
    v0 = v0 - (v0 * v2).sum(-1, keepdim=True) * v2
    n0 = torch.sqrt((v0 * v0).sum(-1, keepdim=True))
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=S.dtype, device=S.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=S.dtype, device=S.device)
    alt = _cross(v2, ex.expand_as(v2))
    alt2 = _cross(v2, ey.expand_as(v2))
    alt = torch.where((alt * alt).sum(-1, keepdim=True) > 0.1, alt, alt2)
    v0 = torch.where(n0 > 1e-6, v0 / n0.clamp_min(1e-30),
                     alt / torch.sqrt((alt * alt).sum(-1, keepdim=True)
                                      .clamp_min(1e-30)))
    v1 = _cross(v2, v0)
    w = torch.stack([w0, w1, w2], dim=-1) * scale[..., None]
    V = torch.stack([v0, v1, v2], dim=-1)
    return w, V


# ---------------------------------------------------------------------------
# symmetric 4x4 eigendecomposition (cyclic Jacobi, unrolled)
# ---------------------------------------------------------------------------

_J4_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def eigh4(S: torch.Tensor, sweeps: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric (..., 4, 4) eigendecomposition by unrolled cyclic Jacobi
    sweeps, ascending eigenvalues (stable order on ties)."""
    A = S.clone()
    V = _eye(4, S).expand(S.shape).clone()
    for _ in range(sweeps):
        for (p, q) in _J4_PAIRS:
            apq = A[..., p, q]
            app, aqq = A[..., p, p], A[..., q, q]
            tiny = apq.abs() < 1e-30
            tau = (aqq - app) / (2.0 * torch.where(tiny, torch.full_like(apq, 1e-30), apq))
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(tiny, torch.zeros_like(t), t)
            c = (1.0 / torch.sqrt(1.0 + t * t))[..., None]
            s = t[..., None] * c
            rp = c * A[..., p, :] - s * A[..., q, :]
            rq = s * A[..., p, :] + c * A[..., q, :]
            A[..., p, :] = rp
            A[..., q, :] = rq
            cp = c * A[..., :, p] - s * A[..., :, q]
            cq = s * A[..., :, p] + c * A[..., :, q]
            A[..., :, p] = cp
            A[..., :, q] = cq
            vp = c * V[..., :, p] - s * V[..., :, q]
            vq = s * V[..., :, p] + c * V[..., :, q]
            V[..., :, p] = vp
            V[..., :, q] = vq
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    w, order = torch.sort(w, dim=-1, stable=True)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


# ---------------------------------------------------------------------------
# smallest-k eigenvectors of a PSD 12x12 (inverse subspace iteration)
# ---------------------------------------------------------------------------

def _orthonormalize_cols(X: torch.Tensor) -> torch.Tensor:
    """Modified Gram-Schmidt over the columns of (..., n, k)."""
    cols = []
    for j in range(X.shape[-1]):
        v = X[..., :, j]
        for u in cols:
            v = v - (u * v).sum(-1, keepdim=True) * u
        v = v / torch.sqrt((v * v).sum(-1, keepdim=True).clamp_min(1e-30))
        cols.append(v)
    return torch.stack(cols, dim=-1)


@functools.lru_cache(maxsize=None)
def _subspace_init(n: int, k: int) -> np.ndarray:
    """The JAX package's fixed generic init: QR of RandomState(12345)."""
    rs = np.random.RandomState(12345)
    return np.linalg.qr(rs.randn(n, k))[0].astype(np.float32)


def smallest_eigvecs(A: torch.Tensor, k: int = 4, iters: int = 8
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvectors of the k smallest eigenvalues of PSD (..., n, n),
    ascending: shifted inverse subspace iteration + a Rayleigh-Ritz step.
    Same contract as the JAX version: the span, not each vector, is what
    converges; EPnP's Gauss-Newton + LHM absorb the rest."""
    if k != 4:
        raise NotImplementedError("the Rayleigh-Ritz step is the 4x4 Jacobi")
    n = A.shape[-1]
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    ridge = 1e-7 * tr / n + 1e-12
    L = cholesky_fixed(A + ridge[..., None, None] * _eye(n, A), n)
    X = torch.as_tensor(_subspace_init(n, k), device=A.device)
    X = X.expand(A.shape[:-2] + (n, k))
    for _ in range(iters):
        X = chol_solve_fixed(L, X, n)
        X = _orthonormalize_cols(X)
    B = torch.matmul(X.transpose(-1, -2), torch.matmul(A, X))
    B = 0.5 * (B + B.transpose(-1, -2))
    w, W = eigh4(B)
    return w, torch.matmul(X, W)


# ---------------------------------------------------------------------------
# optimal weighted rotation (Horn quaternion via power iteration)
# ---------------------------------------------------------------------------

_Q_INITS = np.asarray([[1.0, 0.0103, 0.0211, 0.0317],
                       [-0.0103, 1.0, 0.0317, -0.0211]], np.float32)


def rotation_horn(X: torch.Tensor, Y: torch.Tensor, w: torch.Tensor,
                  iters: int = 60) -> torch.Tensor:
    """Proper rotation R minimizing sum_i w_i |y_i - R x_i|^2 for CENTERED
    X, Y (..., N, 3) and w (..., N): the top eigenvector of Horn's 4x4 by
    shifted power iteration from the reference's two orthogonal inits
    (run together as the two columns of one (4, 2) iterate), keeping the one
    with the larger Rayleigh quotient."""
    S = torch.matmul((w[..., None] * X).transpose(-1, -2), Y)  # S_ab = sum w x_a y_b
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], dim=-1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], dim=-1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], dim=-1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], dim=-1),
    ], dim=-2)
    sigma = torch.sqrt((N * N).sum(dim=(-2, -1))) + 1e-12
    Ns = N + sigma[..., None, None] * _eye(4, N)

    q0 = torch.as_tensor(_Q_INITS, device=N.device)
    q0 = q0 / torch.sqrt((q0 * q0).sum(-1, keepdim=True))
    Q = q0.T.expand(N.shape[:-2] + (4, 2))                     # columns qa, qb
    for _ in range(iters):
        Q = torch.matmul(Ns, Q)
        Q = Q / torch.sqrt((Q * Q).sum(-2, keepdim=True).clamp_min(1e-30))
    rq = (Q * torch.matmul(N, Q)).sum(-2)                      # (..., 2)
    q = torch.where((rq[..., 0] >= rq[..., 1])[..., None], Q[..., 0], Q[..., 1])
    return quat_to_rot(q)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) (w, x, y, z) -> rotation matrix (..., 3, 3)."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
                     2 * (qx * qz + qw * qy)], dim=-1),
        torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qw * qx)], dim=-1),
        torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
                     1 - 2 * (qx * qx + qy * qy)], dim=-1),
    ], dim=-2)
