"""Training traffic: k steps a call over a device pool, the program's
`engine/steps.build_multi_step`, from one process.

Parameters (`traffic/<name>.json`): `batch` images a step, a `pool` of
that many batches rendered from the seed and cycled, `steps_per_call` (k),
the scenes' `class`. A configuration with a `teacher` and a KD weight
distils from it live (teacher forward and votes in every step, K1 for the
Sinkhorn term); one without trains its network alone.

Set-up makes the weights and SSC's draws from the seed on the card, builds
the program's train state once, and drives it through its first 1 + k
steps with the window's own call and feed: step 1 alone (a call of one
step), reading its loss and the first gradient as AdamW holds it (its
first moment over 1 - beta1); then one call of k steps, as the window
makes them, reading its mean loss and, after it, the parameters' change.
The window hands that same state on, call after call, with no host sync;
it ends with a synchronize. `train_images_per_s` = batch x steps in the
window / its seconds.

The check runs the plain reference's 1 + k steps from the same weights,
pool slots and draws, after the program's state is freed, and compares
step 1's loss, each leaf's first-gradient norm, the call's mean loss and
each leaf's change norm after the 1 + k steps (`compare`); the cell's
workload file gives each number's limit.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

import flops
import harness
import scenes
import tracing
from reference import train as rtrain
from reference.config import Cfg
from reference.net import PoseNet as RefNet
from weights import make_state

TRACED_CALLS = 2       # calls in each profiled stretch of the traced run
BETA1 = 0.9            # AdamW's, to read the first gradient off its moment
EXCLUDE_BELOW = 1e-3   # leaves whose first gradient is under this share of
#                        the median leaf's move by round-off alone under Adam


def _distills(raw: dict) -> bool:
    return "teacher" in raw and raw["kd"]["weight"] > 0


def leaf_norms(names: List[str], tensors) -> Dict[str, float]:
    return dict(zip(names, rtrain.leaf_norms(list(tensors))))


def make_inputs(run):
    """The weights, the pool and SSC's draws from the seed, on the device:
    `run.inputs`, handed alike to the program and to the reference."""
    t, raw, dev = run.traffic, run.config, run.device
    B, P = t["batch"], t["pool"]
    distill = _distills(raw)
    rcfg = Cfg(raw, "student")
    rcfg_t = Cfg(raw, "teacher") if distill else None
    n_fg, res, G = rcfg.n_fg, rcfg.model.input_res, raw["solver"]["max_objs"]
    g = torch.Generator(device=dev)
    g.manual_seed(run.seed)
    with torch.device("meta"):
        meta_s = RefNet(rcfg.model, n_fg)
        meta_t = RefNet(rcfg_t.model, n_fg) if distill else None
    s_state = make_state(meta_s, rcfg.model.prior, g, dev)
    t_state = make_state(meta_t, rcfg_t.model.prior, g, dev) if distill else None
    run.mark("weights made")
    arrays = scenes.train_batches(run.seed, P, B, res, n_fg, cls=t["class"], max_objs=G)
    pool_d = {key: torch.from_numpy(v).to(dev) for key, v in arrays.items()}
    U = torch.rand((P, B, rcfg.model.num_cells, G), generator=g, device=dev)
    c = scenes.consts(n_fg)
    run.inputs = dict(s_state=s_state, t_state=t_state, pool=pool_d, U=U, rcfg=rcfg,
                      rcfg_t=rcfg_t, consts_np=c,
                      consts={key: torch.from_numpy(v).to(dev) for key, v in c.items()})


def setup(run):
    from kd6d_pose_adlp_tpu_torch.data.batch import Batch, TaskConsts
    from kd6d_pose_adlp_tpu_torch.engine import steps
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
    from kd6d_pose_adlp_tpu_torch.utils import cuda_build
    from kd6d_pose_adlp_tpu_torch.utils.fold_bn import fold_batchnorm

    t, raw, dev = run.traffic, run.config, run.device
    B, P, k = t["batch"], t["pool"], t["steps_per_call"]
    distill = _distills(raw)
    if dev.type == "cuda":
        cuda_build.build_all(["sinkhorn_potentials", "conv3x3_bn_act"])
    run.mark("program imported, kernels built")
    make_inputs(run)
    inp = run.inputs
    s_state, t_state, pool_d, U, c = (inp[key] for key in ("s_state", "t_state", "pool", "U",
                                                           "consts_np"))
    rcfg, rcfg_t = inp["rcfg"], inp["rcfg_t"]
    n_fg = rcfg.n_fg

    run.mark("inputs rendered and on the device")
    cfg = harness.port_config(raw, "student")
    cfg_t = harness.port_config(raw, "teacher") if distill else None
    net = PoseNet(cfg.model, n_fg=n_fg).to(dev)
    net.load_state_dict(s_state, strict=True)
    teacher = None
    if distill:
        teacher = PoseNet(cfg_t.model, n_fg=n_fg).to(dev)
        teacher.load_state_dict(fold_batchnorm(t_state) if cfg_t.model.bn_folded else t_state,
                                strict=True)
        teacher.eval()
    consts = TaskConsts.create(c["K"], c["kp3d"], c["diameters"], device=dev)
    pool = Batch(**pool_d)
    opt = steps.make_optimizer(cfg)
    state = steps.create_train_state(cfg, net, opt)
    multi = steps.build_multi_step(cfg, cfg_t, consts, net, teacher, opt, distill=distill,
                                   pool_size=P)
    idx = {s: (s + torch.arange(k, device=dev)) % P for s in range(P)}

    def call(state, start, kk=k):
        """Steps start .. start + kk - 1 on pool slots (start + i) % P, each
        with the draws of its slot: the window's call."""
        return multi(state, None, pool, start, kk, uniforms=U.index_select(0, idx[start % P][:kk]))

    run.mark("program built")
    names = [n for n, _ in net.named_parameters()]
    state, m = call(state, 0, 1)
    loss = float(m["loss_total"])
    grad = leaf_norms(names, (mu / (1 - BETA1) for mu in state.opt_state.mu))
    run.mark("first step")
    state, m = call(state, 1)
    call_loss = float(m["loss_total"])
    change = leaf_norms(names, (p.detach() - s_state[n] for n, p in net.named_parameters()))
    run.numbers = dict(loss=loss, call_loss=call_loss, grad=grad, change=change)
    run.mark("one call of k steps")
    run.prog = dict(state=state, call=call, start=1 + k, net=net, teacher=teacher,
                    multi=multi, cfg=cfg, cfg_t=cfg_t, pool=pool)
    run.layer.update(kind="train", batch=B, dtype=raw["student"]["model"]["compute_dtype"])
    if distill:
        run.layer["k1_problem"] = dict(N=B * 8, kd=raw["kd"])


def _loop(run, seconds: float, on_call=None) -> tuple:
    """Calls back to back until `seconds` have passed on the host clock,
    then a synchronize: (steps, seconds)."""
    p = run.prog
    k = run.traffic["steps_per_call"]
    state, start, n = p["state"], p["start"], 0
    t0 = time.perf_counter()
    while True:
        ta = time.perf_counter()
        state, _ = p["call"](state, start)
        if on_call:
            on_call(time.perf_counter() - ta)
        start, n = start + k, n + k
        if time.perf_counter() - t0 >= seconds:
            break
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    p["state"], p["start"] = state, start
    return n, time.perf_counter() - t0


def window(run):
    calls: List[float] = []
    n, secs = _loop(run, run.seconds, calls.append)
    q = statistics.quantiles(calls, n=4) if len(calls) > 1 else calls * 3
    run.notes.append(f"window: {len(calls)} calls, host seconds a call: quartiles "
                     f"{q[0]:.4f} {q[1]:.4f} {q[2]:.4f}, first {calls[0]:.4f}, last {calls[-1]:.4f}")
    run.attempted = n
    run.e2e["train_images_per_s"] = (run.traffic["batch"] * n / secs, "images/s")


def traced(run):
    """The window timed call by call (the host's enqueue time of each call
    before any sync), then the profiled stretches of TRACED_CALLS calls
    each (`tracing.profiled`), then the teacher's forward and votes alone
    on each pool batch (CUDA events)."""
    from kd6d_pose_adlp_tpu_torch.engine import steps
    from kd6d_pose_adlp_tpu_torch.ops import sinkhorn_fused
    from kd6d_pose_adlp_tpu_torch.utils.precision import full_fp32

    enqueue: List[float] = []
    n, secs = _loop(run, run.seconds, enqueue.append)
    run.attempted = n
    k = run.traffic["steps_per_call"]
    inp = run.inputs
    run.layer.update(steps=n, timed_s=secs, enqueue_s_per_step=sum(enqueue) / n,
                     flops_per_step=flops.train_step_flops(
                         inp["rcfg"].model, inp["rcfg"].n_fg, run.traffic["batch"],
                         inp["rcfg_t"].model if inp["rcfg_t"] else None))
    if run.device.type != "cuda":
        return
    sinkhorn_fused.reset_launch_counts()
    p = run.prog

    def body():
        for _ in range(TRACED_CALLS):
            p["state"], _ = p["call"](p["state"], p["start"])
            p["start"] += k

    run.layer["trace"] = tracing.profiled(body, run.tmpdir, counters=lambda: {
        f"{name}:{P}x{T}": c for (name, P, T), c in sinkhorn_fused.launches.items()})
    run.layer["traced_steps"] = TRACED_CALLS * k
    run.layer["k1_launches"] = run.layer["trace"]["counters"]
    if p["teacher"] is not None:
        pool, times = p["pool"], []
        for i in range(run.traffic["pool"]):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            with full_fp32():
                a.record()
                steps.teacher_votes(p["cfg"], p["cfg_t"], p["teacher"], pool.take(i))
                b.record()
            torch.cuda.synchronize(run.device)
            times.append(a.elapsed_time(b))
        run.layer["teacher_ms"] = statistics.fmean(times)


def release(run):
    del run.prog


def reference_numbers(run, tf32: bool = False, keep_half: bool = False,
                      first_slot: bool = False, frozen: bool = False) -> Dict:
    """The reference's 1 + k steps from the run's weights, on the slots
    and draws the program's set-up took: step 1's loss, the mean loss of
    steps 2 .. 1 + k, each leaf's clipped first gradient norm, each leaf's
    change norm after the 1 + k steps. The faults the control reads:
    `keep_half` (half of each batch left out, the mean over the rest),
    `first_slot` (each step of the call fed the call's first slot and
    draws), `frozen` (each step returns the parameters unchanged)."""
    inp, P = run.inputs, run.traffic["pool"]
    harness.set_reference_precision(torch, tf32)
    net, teacher, opt = rtrain.build(inp["rcfg"], inp["s_state"], run.device,
                                     inp["rcfg_t"], inp["t_state"])
    names = [n for n, _ in net.named_parameters()]
    losses = []
    for i in range(1 + run.traffic["steps_per_call"]):
        j = min(i, 1) if first_slot else i % P
        batch = {key: v[j] for key, v in inp["pool"].items()}
        before = [p.detach().clone() for p in net.parameters()] if frozen else None
        loss, clipped = rtrain.step(inp["rcfg"], inp["rcfg_t"], net, teacher, opt, batch,
                                    inp["consts"], inp["U"][j], keep_half=keep_half)
        if frozen:
            with torch.no_grad():
                for p, b in zip(net.parameters(), before):
                    p.copy_(b)
        losses.append(loss)
        if i == 0:
            grad = leaf_norms(names, clipped)
    change = leaf_norms(names, (p.detach() - inp["s_state"][n] for n, p in net.named_parameters()))
    harness.set_reference_precision(torch, False)
    return dict(loss=losses[0], call_loss=statistics.fmean(losses[1:]), grad=grad,
                change=change)


def compare(prog: Dict, ref: Dict) -> Dict[str, tuple]:
    """{number: (value, where)}: the relative gaps of step 1's loss and of
    the k-step call's mean loss; the widest gap of a leaf's first-gradient
    norm and of a leaf's change norm after the 1 + k steps, each against
    the reference's norm of that leaf or of the median leaf, whichever is
    larger, and the median leaf's change gap. Leaves whose reference first
    gradient is under EXCLUDE_BELOW of the median leaf's are left out of
    the change."""
    gr, cr = ref["grad"], ref["change"]
    med_g = statistics.median(gr.values())
    g_gap = {n: abs(prog["grad"][n] - gr[n]) / max(gr[n], med_g) for n in gr}
    keep = [n for n in gr if gr[n] >= EXCLUDE_BELOW * med_g]
    med_c = statistics.median(cr[n] for n in keep)
    c_gap = {n: abs(prog["change"][n] - cr[n]) / max(cr[n], med_c) for n in keep}
    gw, cw = max(g_gap, key=g_gap.get), max(c_gap, key=c_gap.get)
    cm = statistics.median_low(sorted(c_gap.values()))
    rel = lambda key: abs(prog[key] - ref[key]) / abs(ref[key])
    return {"loss_gap": (rel("loss"), f"step 1: {prog['loss']!r} against {ref['loss']!r}"),
            "call_loss_gap": (rel("call_loss"),
                              f"the call's mean: {prog['call_loss']!r} against {ref['call_loss']!r}"),
            "grad_gap": (g_gap[gw], gw),
            "change_gap": (c_gap[cw], f"{cw}; {len(gr) - len(keep)} leaves left out"),
            "change_gap_median": (cm, f"the median of {len(keep)} leaves' gaps")}


def check(run):
    ref = reference_numbers(run)
    for name, (value, where) in compare(run.numbers, ref).items():
        run.check(name, value)
        run.notes.append(f"{name}: {where}")
