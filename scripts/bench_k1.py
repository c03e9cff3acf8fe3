#!/usr/bin/env python3
"""Time K1, the port's Sinkhorn potential solve, on one NVIDIA card, and
split its time into a fixed part and a part per eps step.

    python3 scripts/bench_k1.py                       # the committed source
    python3 scripts/bench_k1.py --sources a.cu b.cu   # versions side by side
    python3 scripts/bench_k1.py --scaling 0.9 --shape 8 1000 1000   # 74 eps steps
    python3 scripts/bench_k1.py --pin_routes --shape 64 256 256     # the three wide routes

Each source (default: kd6d_pose_adlp_tpu_torch/csrc/sinkhorn_potentials.cu)
is built with the port's nvcc flags and called through the same C interface
as `ops/sinkhorn_fused.solve_potentials`. Inputs are those of chip_smoke's
K1 check: N = 128 problems of P = T = 64 points in [0, 1]^2, a quarter of
the weights zero, KDConfig's schedule (p = 2, blur 1e-3, reach 0.5; scaling
0.5, 12 eps steps, unless --scaling or --blur say otherwise), and P = T =
128; each --shape N P T adds a shape (any P, T: past 128 points the kernel
takes its wide routes; --pin_routes also builds each source with the
shared, the global and the cluster route pinned (-DK1_WIDE_ROUTE=1, 2, 3;
the shared one where it fits, and a source that has no cluster route
takes its global one there), so the three are timed on the same inputs).
Each build prints its cluster plan at every shape (sources that have
one), is held against the plain version with chip_smoke's per-potential
gate, then timed by CUDA-graph replay at every shape, the builds in turn
and back (a, b, b, a), and at 1 to 74 eps steps (the schedule repeated)
at the main shape or --fit's; a least-squares line through those times
gives the fixed and the per-step time. The sources share the C interface
of the committed one (the schedule in device memory). Prints one JSON
line; runs only on the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from _bench import build  # noqa: E402

EPS_STEPS = (1, 2, 4, 8, 12, 24, 36, 74)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sources", nargs="+", default=[os.path.join(
        ROOT, "kd6d_pose_adlp_tpu_torch", "csrc", "sinkhorn_potentials.cu")])
    ap.add_argument("--scaling", type=float, default=None,
                    help="the schedule's scaling (default: KDConfig's)")
    ap.add_argument("--blur", type=float, default=None,
                    help="the schedule's blur (default: KDConfig's)")
    ap.add_argument("--shape", nargs=3, type=int, action="append", default=[],
                    metavar=("N", "P", "T"), help="another shape to time")
    ap.add_argument("--fit", nargs=3, type=int, default=None, metavar=("N", "P", "T"),
                    help="the shape of the eps-steps fit (default: the main shape)")
    ap.add_argument("--pin_routes", action="store_true",
                    help="time each source with the shared, the global and the cluster "
                         "route pinned too")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("bench_k1: no CUDA device", file=sys.stderr)
        return 2
    from kd6d_pose_adlp_tpu_torch.config import Config
    from kd6d_pose_adlp_tpu_torch.ops import sinkhorn as sk
    from kd6d_pose_adlp_tpu_torch.ops import sinkhorn_fused as sf

    dev = torch.device("cuda", 0)
    kd = Config().kd
    blur = kd.blur if args.blur is None else args.blur
    scaling = kd.scaling if args.scaling is None else args.scaling
    kw = dict(p=kd.p, blur=blur, scaling=scaling, reach=kd.reach, diameter=2.0,
              debias=True)
    eps_list, lams = sk.schedule(kd.p, blur, scaling, kd.reach, 2.0)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    variants = (("", ()),) + ((("_shared", ("-DK1_WIDE_ROUTE=1",)),
                               ("_global", ("-DK1_WIDE_ROUTE=2",)),
                               ("_cluster", ("-DK1_WIDE_ROUTE=3",))) if args.pin_routes else ())
    libs = build(args.sources, {"sinkhorn_potentials": [vp] * 8 + [i, i, i, vp, i, f, i, vp, vp],
                                "sinkhorn_potentials_workspace": [i, i, i]}, variants)
    for lib in libs.values():
        lib.sinkhorn_potentials_workspace.restype = ctypes.c_longlong
        if hasattr(lib, "sinkhorn_potentials_plan"):   # sources with a cluster route
            lib.sinkhorn_potentials_plan.argtypes = [i, i, i, i, f, vp]

    def solver(lib, steps=len(eps_list)):
        # the schedule repeated to `steps`, as the kernel reads it
        sched = torch.from_numpy(sf.schedule_values(
            np.resize(eps_list, steps), np.resize(lams, steps))).to(dev)

        def run(x, y, a_log, b_log):
            N, P, T = x.shape[0], x.shape[1], y.shape[1]
            a_x, b_x = (torch.empty((N, P), device=dev) for _ in range(2))
            b_y, a_y = (torch.empty((N, T), device=dev) for _ in range(2))
            n_ws = lib.sinkhorn_potentials_workspace(N, P, T)
            ws = torch.empty(n_ws, device=dev) if n_ws else None
            err = lib.sinkhorn_potentials(
                x.data_ptr(), y.data_ptr(), a_log.data_ptr(), b_log.data_ptr(),
                a_x.data_ptr(), b_y.data_ptr(), a_y.data_ptr(), b_x.data_ptr(), N, P, T,
                sched.data_ptr(), steps, kd.p, 1, None if ws is None else ws.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return a_x, b_y, a_y, b_x
        return run

    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def problems(n, p_, t_):
        x = torch.rand((n, p_, 2), generator=g, device=dev)
        y = torch.rand((n, t_, 2), generator=g, device=dev)

        def w(*s):
            keep = torch.rand(s, generator=g, device=dev) >= 0.25
            keep[:, 0] = True
            return (0.1 + 0.9 * torch.rand(s, generator=g, device=dev)) * keep
        a, b = w(n, p_), w(n, t_)
        return (x, y, sk._safe_log_weights(a), sk._safe_log_weights(b)), a, b

    shapes = {"main": (128, 64, 64), "P=T=128": (128, 128, 128)}
    shapes.update({f"N={n} P={p_} T={t_}": (n, p_, t_) for n, p_, t_ in args.shape})
    fit = "main" if args.fit is None else f"N={args.fit[0]} P={args.fit[1]} T={args.fit[2]}"
    shapes.setdefault(fit, tuple(args.fit or ()))
    inputs = {k: problems(*v) for k, v in shapes.items()}
    result = {"card": cs.gpu_name_and_power(), "shapes": shapes, "eps_steps": len(eps_list),
              "sources": {}}
    for name, lib in libs.items():
        if hasattr(lib, "sinkhorn_potentials_plan"):
            plans = {}
            for shape, (n, p_, t_) in shapes.items():
                out = (ctypes.c_int * 5)()
                if lib.sinkhorn_potentials_plan(n, p_, t_, 1, kd.p, out) == 0:
                    plans[shape] = dict(zip(("cluster", "clusters", "kept", "pot_regs",
                                             "smem_bytes"), out))
            print(f"[plan] {name}: {plans}", flush=True)
        gate = {}
        for shape, (t, a, b) in inputs.items():
            got = solver(lib)(*t)
            torch.cuda.synchronize()
            with torch.no_grad():
                want = sf.solve_potentials_plain(*t, **kw)
            pots = cs.potential_errors(got, want, a, b)
            gate[shape] = dict(agrees=cs.potentials_agree(pots), worst=max(
                r for e in pots.values() for k, r in e.items() if k != "max_abs_err"))
        result["sources"][name] = dict(gate=gate, ms={k: [] for k in shapes})
        print(f"[gate] {name}: {gate}", flush=True)

    def copies(t):
        return [tuple(u.clone() for u in t) for _ in range(cs.n_copies(4 * sum(u.numel() for u in t)))]

    order = list(libs) + list(libs)[::-1]
    for name in order:
        for shape, (t, _, _) in inputs.items():
            ms = cs.time_cuda(torch, solver(libs[name]), copies(t), iters=100)
            result["sources"][name]["ms"][shape].append(ms)
            print(f"[time] {name} {shape}: {ms * 1e3:.2f} us", flush=True)
    fit_copies = copies(inputs[fit][0])
    for name, lib in libs.items():
        pts = [(n, cs.time_cuda(torch, solver(lib, n), fit_copies, iters=100))
               for n in EPS_STEPS]
        mx = sum(n for n, _ in pts) / len(pts)
        my = sum(t for _, t in pts) / len(pts)
        slope = (sum((n - mx) * (t - my) for n, t in pts)
                 / sum((n - mx) ** 2 for n, _ in pts))
        line = dict(per_eps_ms=slope, fixed_ms=my - slope * mx, points=pts)
        result["sources"][name]["eps_steps"] = dict(line, shape=fit)
        print(f"[steps] {name} {fit}: {slope * 1e3:.3f} us per eps step + "
              f"{line['fixed_ms'] * 1e3:.2f} us fixed; "
              f"{[(n, round(t * 1e3, 2)) for n, t in pts]}", flush=True)
    print(json.dumps(result), flush=True)
    print(result["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
