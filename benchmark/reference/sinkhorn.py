"""Batched entropic optimal transport for weighted 2D point clouds (frozen copy of
`kd6d_pose_adlp_tpu_torch/ops/sinkhorn.py`).

geomloss's debiased, unbalanced Sinkhorn divergence with epsilon-scaling:

    cost      C(x,y) = |x-y|^p / p
    epsilon   = blur^p,  rho = reach^p (None => balanced)
    schedule  eps: diameter^p -> blur^p, times scaling^p each step
    damping   lambda = 1 / (1 + eps/rho)
    softmin   f(x) = -eps * logsumexp_y [ log beta(y) + g(y)/eps - C(x,y)/eps ]
    updates   symmetric (Jacobi + 0.5-averaging); the potentials are solved
              without gradient, then ONE differentiable extrapolation at the
              last eps carries the gradient (envelope theorem)

Every function takes leading batch dimensions: clouds (..., N, D), weights
(..., N). Zero-weight points are exact padding (log-weight -1e30).

The potential solve is passed in by the caller (`solve=`); the reference
passes `solve_potentials_plain` (end of this file), the annealing loop in
torch ops. The extrapolation takes a_y from the freshly extrapolated b_x.

"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

_NEG_BIG = -1e30

# the potential solve: (x, y, a_log, b_log, *, p, blur, scaling, reach,
# diameter, debias) -> (a_x, b_y, a_y, b_x), gradient-free
Solve = Callable[..., Tuple[torch.Tensor, ...]]


def cost_matrix(x: torch.Tensor, y: torch.Tensor, p: float) -> torch.Tensor:
    """(..., N, D), (..., M, D) -> (..., N, M) with C = |x-y|^p / p."""
    d2 = ((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(-1)
    if p == 2:
        return d2 / 2.0
    d = torch.sqrt(torch.clamp(d2, min=1e-20))
    if p == 1:
        return d
    return (d ** p) / p


def epsilon_schedule(p: float, diameter: float, blur: float,
                     scaling: float) -> Tuple[float, ...]:
    """geomloss-style annealing: eps from diameter^p down to blur^p."""
    eps_list = [diameter ** p]
    e = math.log(diameter)
    target = math.log(blur)
    step = math.log(scaling)  # negative
    while e + step > target:
        e += step
        eps_list.append(math.exp(p * e))
    eps_list.append(blur ** p)
    return tuple(eps_list)


def _safe_log_weights(w: torch.Tensor) -> torch.Tensor:
    """log(w), exactly-zero weights -> -1e30 with a zero (not NaN) gradient
    (the double-where pattern)."""
    pos = w > 0
    return torch.where(pos, torch.log(torch.where(pos, w, torch.ones_like(w))),
                       torch.full_like(w, _NEG_BIG))


def _softmin(eps: float, C: torch.Tensor, h_log: torch.Tensor) -> torch.Tensor:
    """f_i = -eps * logsumexp_j (h_log_j - C_ij / eps); C (..., M, N),
    h_log (..., N) -> (..., M). A row whose entries are all -1e30 gives
    -eps * (-1e30 + log N) through the max-subtract, as in JAX."""
    return -eps * torch.logsumexp(h_log[..., None, :] - C / eps, dim=-1)


def _damp(eps: float, rho: Optional[float]) -> float:
    return 1.0 if rho is None else 1.0 / (1.0 + eps / rho)


def schedule(p: float, blur: float, scaling: float, reach: Optional[float],
             diameter: float) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """(eps list, damping list) of the annealing loop; rho = reach^p."""
    rho = None if reach is None else float(reach) ** p
    eps_list = epsilon_schedule(p, diameter, blur, scaling)
    return eps_list, tuple(_damp(e, rho) for e in eps_list)


def sinkhorn_value(x, y, a, b, potentials: Sequence[torch.Tensor], *,
                   p: float = 2.0, blur: float = 1e-3, scaling: float = 0.5,
                   reach: Optional[float] = 0.5, diameter: float = 2.0,
                   debias: bool = True) -> torch.Tensor:
    """The differentiable half: one extrapolation at the last eps from the
    solved (gradient-free) potentials (a_x, b_y, a_y, b_x), and the
    divergence value. x (..., P, D), y (..., T, D), a (..., P), b (..., T)
    -> (...)."""
    a_x0, b_y0, a_y0, b_x0 = (t.detach() for t in potentials)
    del b_x0  # the default path extrapolates a_y from the NEW b_x
    rho = None if reach is None else float(reach) ** p
    eps_list, lams = schedule(p, blur, scaling, reach, diameter)
    eps, lam = eps_list[-1], lams[-1]
    a_log = _safe_log_weights(a)
    b_log = _safe_log_weights(b)

    C_xy = cost_matrix(x, y, p)
    b_x = lam * _softmin(eps, C_xy, b_log + a_y0 / eps)
    a_y = lam * _softmin(eps, C_xy.transpose(-1, -2), a_log + b_x.detach() / eps)
    if debias:
        a_x = lam * _softmin(eps, cost_matrix(x, x, p), a_log + a_x0 / eps)
        b_y = lam * _softmin(eps, cost_matrix(y, y, p), b_log + b_y0 / eps)

    if rho is None:
        if debias:
            return (a * (b_x - a_x)).sum(-1) + (b * (a_y - b_y)).sum(-1)
        return (a * b_x).sum(-1) + (b * a_y).sum(-1)
    w = rho + eps / 2.0
    if debias:
        fx = torch.exp(-a_x / rho) - torch.exp(-b_x / rho)
        fy = torch.exp(-b_y / rho) - torch.exp(-a_y / rho)
    else:
        fx = 1.0 - torch.exp(-b_x / rho)
        fy = 1.0 - torch.exp(-a_y / rho)
    return w * ((a * fx).sum(-1) + (b * fy).sum(-1))


def sinkhorn_divergence(x, y, a, b, *, solve: Solve, p: float = 2.0,
                        blur: float = 1e-3, scaling: float = 0.5,
                        reach: Optional[float] = 0.5, diameter: float = 2.0,
                        debias: bool = True) -> torch.Tensor:
    """Debiased Sinkhorn divergence S(alpha, beta) per problem.

    x (..., P, D), y (..., T, D); a (..., P), b (..., T) nonnegative masses
    (0 = padding) -> (...). Differentiable w.r.t. x, y, a, b. The potentials
    come from `solve` (K1's wrapper or its plain version) on the flattened
    (N, P, D) problems."""
    batch = x.shape[:-2]
    P, T, D = x.shape[-2], y.shape[-2], x.shape[-1]
    pots = solve(
        x.detach().reshape(-1, P, D), y.detach().reshape(-1, T, D),
        _safe_log_weights(a.detach()).reshape(-1, P),
        _safe_log_weights(b.detach()).reshape(-1, T),
        p=p, blur=blur, scaling=scaling, reach=reach, diameter=diameter,
        debias=debias)
    pots = [t.reshape(batch + t.shape[-1:]) for t in pots]
    return sinkhorn_value(x, y, a, b, pots, p=p, blur=blur, scaling=scaling,
                          reach=reach, diameter=diameter, debias=debias)



def solve_potentials_plain(x, y, a_log, b_log, *, p: float, blur: float,
                           scaling: float, reach: Optional[float],
                           diameter: float, debias: bool):
    """The annealing loop in torch ops, without gradient (frozen copy of
    `kd6d_pose_adlp_tpu_torch/ops/sinkhorn_fused.solve_potentials_plain`):
    x (N, P, 2), y (N, T, 2), a_log (N, P), b_log (N, T) -> (a_x, b_y,
    a_y, b_x)."""
    with torch.no_grad():
        eps_list, lams = schedule(p, blur, scaling, reach, diameter)
        C_xy = cost_matrix(x, y, p)
        C_yx = C_xy.transpose(-1, -2)
        C_xx = cost_matrix(x, x, p)
        C_yy = cost_matrix(y, y, p)

        eps, lam = eps_list[0], lams[0]
        b_x = lam * _softmin(eps, C_xy, b_log)
        a_y = lam * _softmin(eps, C_yx, a_log)
        a_x = lam * _softmin(eps, C_xx, a_log) if debias else torch.zeros_like(b_x)
        b_y = lam * _softmin(eps, C_yy, b_log) if debias else torch.zeros_like(a_y)
        for eps, lam in zip(eps_list[1:], lams[1:]):
            bt_x = lam * _softmin(eps, C_xy, b_log + a_y / eps)
            at_y = lam * _softmin(eps, C_yx, a_log + b_x / eps)
            b_x = 0.5 * (b_x + bt_x)
            a_y = 0.5 * (a_y + at_y)
            if debias:
                at_x = lam * _softmin(eps, C_xx, a_log + a_x / eps)
                bt_y = lam * _softmin(eps, C_yy, b_log + b_y / eps)
                a_x = 0.5 * (a_x + at_x)
                b_y = 0.5 * (b_y + bt_y)
        return a_x, b_y, a_y, b_x
