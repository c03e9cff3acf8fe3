"""Weighted EPnP, LHM refinement and fixed-iteration RANSAC on device,
batched over leading dims (frozen copy of
`kd6d_pose_adlp_tpu_torch/ops/epnp.py`).

Every routine takes a per-correspondence weight vector, so RANSAC
hypotheses are one-hot weight rows and the whole hypothesis batch is one
batched call. Algorithm, constants and iteration counts are the JAX
package's: control points from the weighted principal axes (relative
eigenvalue floor 1e-4), the 12x12 null space by inverse subspace iteration,
beta cases N=1 and N=2 + 8 Gauss-Newton steps, Horn-quaternion Umeyama, a
12-iteration LHM polish, and the >=6-inlier refit fallback.

All of it runs in full fp32 (the JAX `_hp` rule): wrap calls on the card in
`full_fp32()` (`utils/precision.py`), which turns TF32 off for the duration.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .smallalg import eigh3, inv3, inv4, rotation_horn, smallest_eigvecs, solve_spd

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_I0 = [p[0] for p in _PAIRS]
_I1 = [p[1] for p in _PAIRS]


def _T(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _wnorm(w: torch.Tensor) -> torch.Tensor:
    return w / w.sum(-1, keepdim=True).clamp_min(1e-12)


def umeyama(X: torch.Tensor, Y: torch.Tensor, w: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted rigid alignment Y ~ R X + T. X, Y (..., N, 3); w (..., N)."""
    wn = _wnorm(w)
    mx = (wn[..., None] * X).sum(-2)
    my = (wn[..., None] * Y).sum(-2)
    R = rotation_horn(X - mx[..., None, :], Y - my[..., None, :], wn)
    T = my - torch.matmul(R, mx[..., None])[..., 0]
    return R, T


def _control_points(pts3d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) control points: centroid + scaled principal axes."""
    wn = _wnorm(w)
    c0 = (wn[..., None] * pts3d).sum(-2)
    d = pts3d - c0[..., None, :]
    cov = torch.matmul(_T(wn[..., None] * d), d)
    lam, vec = eigh3(cov)                                   # ascending
    # floor RELATIVE to the largest axis (conditions near-planar sets)
    lam = torch.maximum(lam, 1e-4 * lam[..., 2:3].clamp_min(1e-2))
    axes = _T(vec) * torch.sqrt(lam)[..., :, None]          # rows
    return torch.cat([c0[..., None, :], c0[..., None, :] + axes], dim=-2)


def _barycentric(pts3d: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """alphas (..., N, 4) with pts = alphas @ ctrl, sum(alphas) = 1."""
    Chom = torch.cat([_T(ctrl), torch.ones_like(ctrl[..., :1, :1]).expand(
        ctrl.shape[:-2] + (1, 4))], dim=-2)                 # (..., 4, 4)
    Phom = torch.cat([_T(pts3d), torch.ones_like(pts3d[..., :1, :1]).expand(
        pts3d.shape[:-2] + (1, pts3d.shape[-2]))], dim=-2)  # (..., 4, N)
    return _T(torch.matmul(inv4(Chom), Phom))


def _build_MtM(alphas, pts2n, w):
    """Weighted M^T M (..., 12, 12) of the 2N projection constraints, in
    normalized image coordinates (K = I)."""
    N = alphas.shape[-2]
    lead = alphas.shape[:-2]
    zeros = torch.zeros_like(alphas)
    du = -pts2n[..., 0]
    dv = -pts2n[..., 1]
    ru = torch.stack([alphas, zeros, alphas * du[..., None]], dim=-1).reshape(lead + (N, 12))
    rv = torch.stack([zeros, alphas, alphas * dv[..., None]], dim=-1).reshape(lead + (N, 12))
    M = torch.cat([ru, rv], dim=-2)                         # (..., 2N, 12)
    ws = torch.sqrt(torch.cat([w, w], dim=-1).clamp_min(0.0))[..., None]
    Mw = M * ws
    return torch.matmul(_T(Mw), Mw)


def _pairwise_d2(c: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) -> (..., 6) squared distances of the control-point pairs."""
    d = c[..., _I0, :] - c[..., _I1, :]
    return (d * d).sum(-1)


def _gauss_newton_betas(betas, V, d2_world, iters: int = 8):
    Vc = V.reshape(V.shape[:-2] + (4, 4, 3))                # kernel k, ctrl i, xyz
    dV = Vc[..., :, _I0, :] - Vc[..., :, _I1, :]            # (..., 4, 6, 3)
    eye4 = torch.eye(4, dtype=V.dtype, device=V.device)
    for _ in range(iters):
        c = (betas[..., :, None, None] * Vc).sum(-3)        # (..., 4, 3)
        diff = c[..., _I0, :] - c[..., _I1, :]              # (..., 6, 3)
        r = (diff * diff).sum(-1) - d2_world                # (..., 6)
        J = 2.0 * (diff[..., None, :, :] * dV).sum(-1)      # (..., 4, 6) = J^T
        JtJ = torch.matmul(J, _T(J)) + 1e-9 * eye4
        step = solve_spd(JtJ, torch.matmul(J, r[..., None])[..., 0], 4)
        betas = betas - step
    return betas


def lhm_refine(pts3s: torch.Tensor, rays: torch.Tensor, w: torch.Tensor,
               R0: torch.Tensor, T0: torch.Tensor, iters: int = 10
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LHM (Lu-Hager-Mjolsness) object-space refinement from (R0, T0).
    pts3s (..., N, 3) object points; rays (..., N, 3) = K^-1 [u v 1];
    w (..., N) weights."""
    wn = _wnorm(w)
    denom = (rays * rays).sum(-1, keepdim=True)
    sumP = torch.matmul(_T(wn[..., None] * rays / denom), rays)
    eye3 = torch.eye(3, dtype=rays.dtype, device=rays.device)
    Cmat = inv3(eye3 - sumP)

    def proj(x):  # P_i x_i
        return rays * ((rays * x).sum(-1, keepdim=True) / denom)

    def translation(R):
        Ra = torch.matmul(pts3s, _T(R))
        return torch.matmul(Cmat, (wn[..., None] * (proj(Ra) - Ra)).sum(-2)[..., None])[..., 0]

    R, T = R0, translation(R0)
    for _ in range(iters):
        q = proj(torch.matmul(pts3s, _T(R)) + T[..., None, :])
        R, _ = umeyama(pts3s, q, w)
        T = translation(R)
    return R, T


def reprojection_errors(pts3d, pts2d, K, R, T) -> torch.Tensor:
    """(..., N) pixel reprojection error."""
    cam = torch.matmul(pts3d, _T(R)) + T[..., None, :]
    uv = torch.matmul(cam, _T(K))
    xy = uv[..., :2] / (uv[..., 2:3] + 1e-8)
    return torch.sqrt(((xy - pts2d) ** 2).sum(-1) + 1e-12)


def _wsum(wn, e):
    return (wn * e).sum(-1)


def epnp(pts3d: torch.Tensor, pts2d: torch.Tensor, K: torch.Tensor,
         w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted EPnP. pts3d (..., N, 3), pts2d (..., N, 2), K (3, 3) or one
    per problem (..., 3, 3), w (..., N) >= 0 -> (R (..., 3, 3), T (..., 3)).
    Leading dims broadcast.

    Image coords are normalized by K and world coords by their RMS spread
    so every stage works on O(1) numbers in fp32."""
    ctr = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)[..., None, :]
    foc = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)[..., None, :]
    pts2n = (pts2d - ctr) / foc
    wn = _wnorm(w)
    centroid = (wn[..., None] * pts3d).sum(-2)
    scale = torch.sqrt(_wsum(wn, ((pts3d - centroid[..., None, :]) ** 2).sum(-1))
                       .clamp_min(1e-12))
    pts3s = pts3d / scale[..., None, None]

    ctrl_w = _control_points(pts3s, w)
    alphas = _barycentric(pts3s, ctrl_w)
    MtM = _build_MtM(alphas, pts2n, w)
    _, vecs = smallest_eigvecs(MtM, k=4)
    V = _T(vecs)                                            # (..., 4, 12) kernel rows
    d2_world = _pairwise_d2(ctrl_w)

    # case N=1: beta from the distance ratio
    c1 = V[..., 0, :].reshape(V.shape[:-2] + (4, 3))
    d2_c1 = _pairwise_d2(c1)
    b1 = (torch.sqrt(d2_world) * torch.sqrt(d2_c1.clamp_min(1e-12))).sum(-1) / \
        d2_c1.sum(-1).clamp_min(1e-12)
    # case N=2: least squares on (b11, b12, b22) by ridged normal equations
    c2 = V[..., 1, :].reshape(V.shape[:-2] + (4, 3))
    dv1 = c1[..., _I0, :] - c1[..., _I1, :]
    dv2 = c2[..., _I0, :] - c2[..., _I1, :]
    L = torch.stack([(dv1 * dv1).sum(-1), 2 * (dv1 * dv2).sum(-1),
                     (dv2 * dv2).sum(-1)], dim=-1)          # (..., 6, 3)
    LtL = torch.matmul(_T(L), L)
    tr = torch.diagonal(LtL, dim1=-2, dim2=-1).sum(-1)
    LtL = LtL + (1e-9 * tr + 1e-20)[..., None, None] * torch.eye(
        3, dtype=L.dtype, device=L.device)
    sol = torch.matmul(inv3(LtL), torch.matmul(_T(L), d2_world[..., None]))[..., 0]
    b11, b12, b22 = sol[..., 0], sol[..., 1], sol[..., 2]
    b1_2 = torch.sqrt(b11.abs().clamp_min(1e-12))
    b2_2 = torch.sqrt(b22.abs().clamp_min(1e-12)) * torch.sign(b12) * torch.sign(b11)
    zero = torch.zeros_like(b1)
    inits = torch.stack([torch.stack([b1, zero, zero, zero], dim=-1),
                         torch.stack([b1_2, b2_2, zero, zero], dim=-1)],
                        dim=-2)                             # (..., 2, 4)

    # both initializations solved as one batch of 2
    betas = _gauss_newton_betas(inits, V[..., None, :, :], d2_world[..., None, :])
    cc = torch.matmul(betas[..., None, :], V[..., None, :, :])[..., 0, :]
    cc = cc.reshape(cc.shape[:-1] + (4, 3))                 # (..., 2, 4, 3)
    x_cam = torch.matmul(alphas[..., None, :, :], cc)       # (..., 2, N, 3)
    sgn = torch.sign((w[..., None, :] * x_cam[..., 2]).sum(-1))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    x_cam = x_cam * sgn[..., None, None]
    Rs, Ts = umeyama(pts3s[..., None, :, :], x_cam, w[..., None, :])
    Ts = Ts * scale[..., None, None]
    Kc = K if K.dim() == 2 else K[..., None, :, :]          # per beta case
    es = reprojection_errors(pts3d[..., None, :, :], pts2d[..., None, :, :], Kc,
                             Rs, Ts)                        # (..., 2, N)
    e1 = _wsum(wn, es[..., 0, :])
    e2 = _wsum(wn, es[..., 1, :])
    use2 = e2 < e1
    R = torch.where(use2[..., None, None], Rs[..., 1, :, :], Rs[..., 0, :, :])
    T = torch.where(use2[..., None], Ts[..., 1, :], Ts[..., 0, :])

    # polish with the well-conditioned LHM
    rays = torch.cat([pts2n, torch.ones_like(pts2n[..., :1])], dim=-1)
    Rr, Tr = lhm_refine(pts3s, rays, w, R, T / scale[..., None], iters=12)
    Tr = Tr * scale[..., None]
    er = _wsum(wn, reprojection_errors(pts3d, pts2d, K, Rr, Tr))
    better = er < torch.minimum(e1, e2)
    R = torch.where(better[..., None, None], Rr, R)
    T = torch.where(better[..., None], Tr, T)
    return R, T


def sample_gumbel(shape, generator: Optional[torch.Generator],
                  device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def ransac_epnp(pts3d: torch.Tensor,   # (B, N, 3)
                pts2d: torch.Tensor,   # (B, N, 2)
                valid: torch.Tensor,   # (B, N) bool
                K: torch.Tensor,       # (3, 3)
                *, iters: int = 128, reproj_err: float = 5.0,
                min_sample: int = 6,
                gumbel: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-iteration RANSAC-EPnP per batch row -> (R, T, inlier_count).

    Hypotheses: Gumbel top-k over valid correspondences (uniform without
    replacement). `gumbel` (B, iters, N) injects the draws (the tests hand
    in JAX's); otherwise they come from `generator`. Each hypothesis runs
    weighted EPnP on a one-hot weight row; the best (most inliers) is refit
    on its inliers, falling back to all valid ones below min_sample."""
    B, N, _ = pts3d.shape
    dev = pts3d.device
    vmask = valid.to(torch.float32)
    if gumbel is None:
        gumbel = sample_gumbel((B, iters, N), generator, dev)
    if gumbel.shape != (B, iters, N):
        raise ValueError(f"gumbel {tuple(gumbel.shape)} != {(B, iters, N)}")
    logits = torch.where(valid, torch.zeros_like(vmask),
                         torch.full_like(vmask, float("-inf")))
    g = gumbel.to(dev, torch.float32) + logits[:, None]
    top_idx = torch.sort(g, dim=-1, descending=True, stable=True).indices[..., :min_sample]
    hyp_w = torch.zeros((B, iters, N), device=dev).scatter_(-1, top_idx, 1.0)
    hyp_w = hyp_w * vmask[:, None]

    Rs, Ts = epnp(pts3d[:, None], pts2d[:, None], K, hyp_w)      # (B, iters, ...)
    errs = reprojection_errors(pts3d[:, None], pts2d[:, None], K, Rs, Ts)
    inliers = (errs < reproj_err) & valid[:, None]               # (B, iters, N)
    counts = inliers.sum(-1)
    best = torch.argmax(counts, dim=-1)                          # first max
    rows = torch.arange(B, device=dev)
    best_in = inliers[rows, best]
    enough = best_in.sum(-1) >= min_sample
    refit_w = torch.where(enough[:, None], best_in.to(torch.float32), vmask)
    R, T = epnp(pts3d, pts2d, K, refit_w)

    err_refit = reprojection_errors(pts3d, pts2d, K, R, T)
    cnt_refit = ((err_refit < reproj_err) & valid).sum(-1)
    cnt_best = counts[rows, best]
    use_refit = cnt_refit >= cnt_best
    R = torch.where(use_refit[:, None, None], R, Rs[rows, best])
    T = torch.where(use_refit[:, None], T, Ts[rows, best])
    n_in = torch.maximum(cnt_refit, cnt_best).to(torch.int32)
    return R, T, n_in
