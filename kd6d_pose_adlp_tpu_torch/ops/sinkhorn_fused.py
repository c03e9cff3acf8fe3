"""The Sinkhorn potential solve, kernel K1 (port of
`kd6d_pose_adlp_tpu/ops/sinkhorn_pallas.py:128` `_solve_potentials`).

For N independent weighted clouds x (N, P, 2), y (N, T, 2) with
log-weights (N, P) / (N, T), K1 returns the four dual potentials
(a_x, b_y, a_y, b_x) of the debiased (unbalanced) Sinkhorn divergence after
the whole eps-annealing loop: 4 log-sum-exp softmins per eps, damping
lambda = 1 / (1 + eps / rho), Jacobi 0.5-averaging. It is gradient-free:
the wrapper runs on detached tensors under `no_grad`, and the gradient
flows through the plain-torch extrapolation of `ops/sinkhorn.sinkhorn_value`.

`solve_potentials` launches the hand-written CUDA kernel
(`csrc/sinkhorn_potentials.cu`) for CUDA tensors and counts the launch in
`launches` under (kernel name, P, T). For CPU tensors, and only for them,
it runs `solve_potentials_plain` beside it, the same loop in torch ops.
There is no fallback: a build or launch error propagates.

The eps list and the damping factors are computed on the host by
`ops/sinkhorn.schedule`, in double precision; the kernel reads them, with
1 / eps rounded once, as float32 from one device array per schedule and
device, copied at the first call that uses it (so a step that has run once
copies nothing and can be captured in a CUDA graph); rho enters only
through lambda. As in the JAX package, P, T >= 1 and the schedule's length
are unbounded: past 128 points the kernel runs each problem on a
thread-block cluster in one launch (`route` names the route, `cluster_plan`
its plan), and where the clouds pass one block's shared memory (P + T past
~9,685) it launches once per eps on a device workspace that the wrapper
allocates. Padding semantics are JAX's: log-weight -1e30, and a row whose
entries are all -1e30 gives log(T) through the max-subtract.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..utils import cuda_build
from .sinkhorn import _softmin, cost_matrix, schedule

# kernel launches since the last reset, keyed (kernel name, P, T)
launches: collections.Counter = collections.Counter()


def reset_launch_counts():
    launches.clear()


def solve_potentials_plain(x, y, a_log, b_log, *, p: float, blur: float,
                           scaling: float, reach: Optional[float],
                           diameter: float, debias: bool):
    """The annealing loop in torch ops (the JAX default path's solve)."""
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


@functools.lru_cache(maxsize=None)
def _lib():
    """The built kernel with its C signature declared."""
    lib = cuda_build.load("sinkhorn_potentials")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sinkhorn_potentials.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                        i, i, i, vp, i, f, i, vp, vp]
    lib.sinkhorn_potentials.restype = i
    lib.sinkhorn_potentials_workspace.argtypes = [i, i, i]
    lib.sinkhorn_potentials_workspace.restype = ctypes.c_longlong
    lib.sinkhorn_potentials_route.argtypes = [i, i, i]
    lib.sinkhorn_potentials_route.restype = i
    lib.sinkhorn_potentials_plan.argtypes = [i, i, i, i, f, vp]
    lib.sinkhorn_potentials_plan.restype = i
    return lib


# the kernel's routes, by the code sinkhorn_potentials_route returns
ROUTES = ("small", "shared", "global", "cluster")


def route(N: int, P: int, T: int) -> str:
    """The route the kernel takes for N problems of P and T points on the
    current CUDA device: small (P, T <= 128), cluster or global."""
    return ROUTES[_lib().sinkhorn_potentials_route(N, P, T)]


def cluster_plan(N: int, P: int, T: int, debias: bool = True, p: float = 2.0):
    """The cluster route's plan on the current CUDA device (None on any
    other route): blocks a cluster, clusters launched, whether the costs
    stay in registers, potential registers a lane, shared memory bytes."""
    out = (ctypes.c_int * 5)()
    if _lib().sinkhorn_potentials_plan(N, P, T, int(debias), p, out) != 0:
        return None
    return dict(zip(("cluster", "clusters", "kept", "pot_regs", "smem_bytes"), out))


def schedule_values(eps_list, lams) -> np.ndarray:
    """The schedule as the kernel reads it: eps, lam and 1 / eps, 3 n
    float32 (1 / eps divided once in float32 from the float32 eps, as the
    plain version's division by a host scalar rounds it)."""
    eps = np.asarray(eps_list, np.float32)
    return np.concatenate([eps, np.asarray(lams, np.float32), np.float32(1.0) / eps])


@functools.lru_cache(maxsize=None)
def device_schedule(p: float, blur: float, scaling: float, reach: Optional[float],
                    diameter: float, device: torch.device) -> torch.Tensor:
    """schedule_values of one schedule on `device`, copied once."""
    return torch.from_numpy(schedule_values(*schedule(p, blur, scaling, reach,
                                                      diameter))).to(device)


def _check(x, y, a_log, b_log):
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0] \
            or x.shape[2] != 2 or y.shape[2] != 2:
        raise ValueError(f"x {tuple(x.shape)}, y {tuple(y.shape)} are not "
                         "(N, P, 2), (N, T, 2)")
    N, P, T = x.shape[0], x.shape[1], y.shape[1]
    if a_log.shape != (N, P) or b_log.shape != (N, T):
        raise ValueError(f"log-weights {tuple(a_log.shape)}, {tuple(b_log.shape)}"
                         f" are not ({N}, {P}), ({N}, {T})")
    for name, t in (("x", x), ("y", y), ("a_log", a_log), ("b_log", b_log)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def solve_potentials(x, y, a_log, b_log, *, p: float = 2.0, blur: float = 1e-3,
                     scaling: float = 0.5, reach: Optional[float] = 0.5,
                     diameter: float = 2.0, debias: bool = True):
    """K1: x (N, P, 2), y (N, T, 2), a_log (N, P), b_log (N, T) float32
    -> (a_x (N, P), b_y (N, T), a_y (N, T), b_x (N, P)), no gradient.
    With debias=False a_x and b_y are zeros."""
    _check(x, y, a_log, b_log)
    x, y, a_log, b_log = (t.detach() for t in (x, y, a_log, b_log))
    kw = dict(p=p, blur=blur, scaling=scaling, reach=reach, diameter=diameter)
    if x.device.type == "cpu":
        with torch.no_grad():
            return solve_potentials_plain(x, y, a_log, b_log, debias=debias, **kw)

    N, P, T = x.shape[0], x.shape[1], y.shape[1]
    x, y, a_log, b_log = (t.contiguous() for t in (x, y, a_log, b_log))
    a_x, b_x = (torch.empty((N, P), device=x.device) for _ in range(2))
    b_y, a_y = (torch.empty((N, T), device=x.device) for _ in range(2))
    if N == 0:
        return a_x, b_y, a_y, b_x
    with torch.cuda.device(x.device):
        sched = device_schedule(p, blur, scaling, reach, diameter, x.device)
        n_ws = _lib().sinkhorn_potentials_workspace(N, P, T)
        ws = torch.empty(n_ws, device=x.device) if n_ws else None
        err = _lib().sinkhorn_potentials(
            x.data_ptr(), y.data_ptr(), a_log.data_ptr(), b_log.data_ptr(),
            a_x.data_ptr(), b_y.data_ptr(), a_y.data_ptr(), b_x.data_ptr(),
            N, P, T, sched.data_ptr(), sched.numel() // 3, p, int(debias),
            None if ws is None else ws.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sinkhorn_potentials: CUDA error {err} at launch")
    launches[("sinkhorn_potentials", P, T)] += 1
    return a_x, b_y, a_y, b_x
