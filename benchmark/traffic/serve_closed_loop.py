"""Serving traffic: one client in a closed loop, the next request sent when
the last is answered, through the program's `engine/serving.build_infer_fn`.

Parameters (`traffic/<name>.json`): `batch` uint8 BGR crops a request, a
`pool` of that many requests rendered from the seed (every class) and
cycled, the endpoint's `mode` ("multi": every foreground class of every
crop), `sample_requests` the check compares. The workload file gives the
network (`network`, a model of the configuration) and its head's prior
(`head_prior`).

Set-up makes the weights and each pool request's RANSAC draws (Gumbel
noise, injected as `gumbel=`) from the seed on the card, builds the
endpoint and answers two requests to warm it. In the window the client
sends request after request, each answered when the card has finished it
(a synchronize); `serve_images_per_s` = crops posed in the window / its
seconds, a request that raised adding nothing.

The check, after the window: for `sample_requests` pool requests drawn
from the seed, the last answer the window gave to each, against the plain
reference, in two stages. The network: the reference network on the same
crops against what the program's network returned inside that request
(read by a forward hook on the served network). The postprocess: the
reference postprocess (voting, RANSAC-EPnP, LHM) run on that same network
output with the same draws, against the request's answers: the share of
answers that are off, their class, validity or inlier count flipped or
their pose or score off by more than POSE_RTOL (`answer_gaps`).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

import flops
import harness
import scenes
import tracing
from reference.config import Cfg
from reference.net import PoseNet as RefNet
from reference.pose import KEYS, postprocess_multi
from weights import make_state

TRACED_REQUESTS = 2    # requests in each profiled stretch of the traced run


def gumbel(shape, generator, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) with U uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def make_inputs(run):
    """The weights, the pool of requests and their RANSAC draws from the
    seed, on the device: `run.inputs`, handed alike to the program and to
    the reference."""
    t, raw, dev, cell = run.traffic, run.config, run.device, run.cell
    B, P = t["batch"], t["pool"]
    rcfg = Cfg(raw, cell.get("network", "student"))
    n_fg, m = rcfg.n_fg, rcfg.model
    g = torch.Generator(device=dev)
    g.manual_seed(run.seed)
    with torch.device("meta"):
        meta = RefNet(m, n_fg)
    state = make_state(meta, cell.get("head_prior", m.prior), g, dev)
    run.mark("weights made")
    req = scenes.requests(run.seed, P, B, m.input_res, n_fg, range(n_fg))
    c = scenes.consts(n_fg)
    run.inputs = dict(
        state=state, rcfg=rcfg, consts_np=c, last={},
        images=torch.from_numpy(req["images"]).to(dev),
        bbox=torch.from_numpy(req["bbox_trans"]).to(dev),
        draws=gumbel((P, n_fg, B, rcfg.test.ransac_iters, rcfg.test.max_votes * 8), g, dev),
        K=torch.from_numpy(c["K"]).to(dev), kp3d=torch.from_numpy(c["kp3d"]).to(dev))
    run.mark("inputs rendered, draws made")


def setup(run):
    from kd6d_pose_adlp_tpu_torch.data.batch import TaskConsts
    from kd6d_pose_adlp_tpu_torch.engine.serving import build_infer_fn
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
    from kd6d_pose_adlp_tpu_torch.utils import cuda_build

    t, raw, dev = run.traffic, run.config, run.device
    B, P = t["batch"], t["pool"]
    which = run.cell.get("network", "student")
    if dev.type == "cuda":
        cuda_build.build_all(["sinkhorn_potentials", "conv3x3_bn_act"])
    run.mark("program imported, kernels built")
    make_inputs(run)
    inp = run.inputs
    state, images, bbox, draws, c, last = (inp[k] for k in ("state", "images", "bbox", "draws",
                                                           "consts_np", "last"))
    n_fg, m = inp["rcfg"].n_fg, inp["rcfg"].model

    cfg = harness.port_config(raw, which)
    net = PoseNet(cfg.model, n_fg=n_fg).to(dev)
    net.load_state_dict(state, strict=True)
    consts = TaskConsts.create(c["K"], c["kp3d"], c["diameters"], device=dev)
    infer = build_infer_fn(cfg, consts, net, mode=t["mode"], device=dev)
    seen = {}
    hook = infer.model.register_forward_hook(lambda mod, inp, out: seen.__setitem__("net", out))
    class_ids = torch.zeros(B, dtype=torch.int32, device=dev)

    def request(i: int, timings=None):
        slot = i % P
        out = infer(images[slot], bbox[slot], class_ids, gumbel=draws[slot], timings=timings)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        last[slot] = (seen.pop("net"), out)

    run.mark("endpoint built")
    for i in range(2):
        request(i)
    last.clear()
    run.mark("two requests")
    run.prog = dict(request=request, infer=infer, hook=hook, net=net)
    run.layer.update(kind="serve", batch=B, dtype=cfg.model.compute_dtype, res=m.input_res)


def _loop(run, seconds: float, timings=None) -> tuple:
    """Requests back to back for `seconds`: (answered, seconds)."""
    request, i, done = run.prog["request"], 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        run.attempted += 1
        try:
            tm = {} if timings is not None else None
            request(i, tm)
            done += 1
            if tm is not None:
                timings.append(tm)
        except Exception as e:  # a failed request adds nothing
            run.failed += 1
            run.notes.append(f"request {i} failed: {e!r}"[:300])
        i += 1
    return done, time.perf_counter() - t0


def window(run):
    done, secs = _loop(run, run.seconds)
    run.e2e["serve_images_per_s"] = (run.traffic["batch"] * done / secs, "images/s")


def traced(run):
    """The window with the endpoint's own timings (a synchronize after its
    network and after its postprocess), then the profiled stretches of
    TRACED_REQUESTS requests each (`tracing.profiled`), K2's launches
    counted in the first."""
    from kd6d_pose_adlp_tpu_torch.ops import conv_fused

    tms = []
    done, secs = _loop(run, run.seconds, tms)
    rcfg = run.inputs["rcfg"]
    run.layer.update(requests=done, timed_s=secs,
                     flops_per_request=flops.forward_flops(rcfg.model, rcfg.n_fg,
                                                           run.traffic["batch"]),
                     network_s=[t["network_s"] for t in tms],
                     postprocess_s=[t["postprocess_s"] for t in tms])
    if run.device.type != "cuda":
        return
    conv_fused.reset_launch_counts()

    def body():
        for i in range(TRACED_REQUESTS):
            run.prog["request"](i)

    run.layer["trace"] = tracing.profiled(body, run.tmpdir, counters=lambda: {
        f"{name}:{C}x{O}:{dt}": c for (name, C, O, dt), c in conv_fused.launches.items()})
    run.layer["traced_requests"] = TRACED_REQUESTS
    run.layer["k2_launches"] = run.layer["trace"]["counters"]


def release(run):
    run.prog["hook"].remove()
    del run.prog


def sample_slots(run, slots=None) -> list:
    """`sample_requests` of the pool slots (by default those the window
    answered), drawn from the seed."""
    slots = sorted(run.inputs["last"] if slots is None else slots)
    rng = np.random.default_rng([run.seed, 2])
    n = min(run.traffic["sample_requests"], len(slots))
    return sorted(rng.choice(slots, size=n, replace=False).tolist())


def network_gap(got, want) -> float:
    """The widest gap of the network's outputs, each output against its
    own largest magnitude."""
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(got, want))


DISCRETE = ("cls", "valid", "n_inliers")
POSE_RTOL = 1e-3   # an answer's R, T or score this far off, relative, is off


def answer_gaps(got: Dict, want: Dict) -> Dict[str, float]:
    """`answers_off`: the share of answers (a crop's class) that are off
    the reference's: class, validity or RANSAC inlier count differ, or the
    score (against itself) or, valid on both sides, R (entries) or T
    (against |T|) differ by more than POSE_RTOL; 1 where the shapes
    differ. `pose_gap`: the widest of those relative gaps among the valid
    answers whose class, validity and inlier count agree (printed, not
    compared: a near tie between two RANSAC hypotheses, which any change
    of rounding can tip, moves one answer far)."""
    if any(got[k].shape != want[k].shape for k in KEYS):
        return {"answers_off": 1.0, "pose_gap": float("inf")}
    same = torch.stack([got[k] == want[k] for k in DISCRETE]).all(0)
    v = same & want["valid"]
    dR = (got["R"] - want["R"]).abs().amax((-1, -2))
    dT = (got["T"] - want["T"]).norm(dim=-1) / want["T"].norm(dim=-1).clamp_min(1e-6)
    ds = (got["score"] - want["score"]).abs() / want["score"].abs().clamp_min(1e-30)
    gap = torch.stack([dR, dT]).amax(0).nan_to_num(float("inf"))
    ok = same & (ds.nan_to_num(float("inf")) <= POSE_RTOL) & (~want["valid"] | (gap <= POSE_RTOL))
    return {"answers_off": 1.0 - float(ok.float().mean()),
            "pose_gap": float(gap[v].max()) if bool(v.any()) else 0.0}


def reference_outputs(run, slot: int, tf32: bool = False, net_out=None):
    """The reference on one pool request: its network's outputs and its
    answers (on `net_out` where given, else on its own network's)."""
    inp = run.inputs
    rcfg = inp["rcfg"]
    harness.set_reference_precision(torch, tf32)
    try:
        ref = inp.get("ref_net")
        if ref is None:
            ref = RefNet(rcfg.model, rcfg.n_fg).to(run.device).eval()
            ref.load_state_dict(inp["state"], strict=True)
            inp["ref_net"] = ref
        with torch.no_grad():
            ref_out = ref(inp["images"][slot])
            cls, reg = ref_out if net_out is None else net_out
            ans = postprocess_multi(rcfg, inp["K"], inp["kp3d"], cls, reg,
                                    inp["bbox"][slot], inp["draws"][slot])
    finally:
        harness.set_reference_precision(torch, False)
    return ref_out, ans


def compare(run) -> Dict[str, float]:
    """The check's numbers over the sampled requests: the widest network
    gap, and the share of all their answers that are off."""
    net_gaps, off, poses = [], [], []
    for slot in sample_slots(run):
        net_out, answers = run.inputs["last"][slot]
        ref_out, ref_ans = reference_outputs(run, slot, net_out=net_out)
        net_gaps.append(network_gap(net_out, ref_out))
        a = answer_gaps(answers, ref_ans)
        off.append(a["answers_off"])
        poses.append(a["pose_gap"])
    run.notes.append(f"requests compared: {len(net_gaps)}; network gaps {net_gaps}; "
                     f"answers off {off}; pose gaps of the agreeing answers {poses}")
    if not net_gaps:
        return dict.fromkeys(("network_gap", "answers_off"), float("inf"))
    return {"network_gap": max(net_gaps), "answers_off": sum(off) / len(off)}


def check(run):
    for name, value in compare(run).items():
        run.check(name, value)
