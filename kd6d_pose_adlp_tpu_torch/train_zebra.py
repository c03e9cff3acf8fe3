"""Train and evaluate the dense binary-code (zebra) head on synthetic data,
the port's counterpart of the JAX package's `scripts/train_zebra.py`:

    python -m kd6d_pose_adlp_tpu_torch.train_zebra --steps 2000
    python -m kd6d_pose_adlp_tpu_torch.train_zebra --cpu --steps 4 --batches 2 \\
        --batch_size 2 --input_res 128 --eval_n 4 --code_bits 8

It takes that script's flags with the same defaults and meanings. A pool of
`--batches` synthetic batches is rendered on the host and moved to the
device, and `engine/zebra.build_zebra_multi_step` runs
`--steps_per_dispatch` steps a call over it. `--weight_file_t` (a zebra
checkpoint with the same code_bits, a `torch.save`d state_dict or a JAX
msgpack file) with `--kd_weight` > 0 distills the teacher's per-cell code
probabilities into the student; `--backbone_init` warm-starts the student's
backbone from either format. The student is saved as `final.ckpt`
(`utils/checkpoint.save_params`), then `--eval_n` held-out images are
decoded into dense correspondences and solved (`build_zebra_postprocess`),
and the ADD/REP summary is printed as one JSON line.

Runs on the card, in bfloat16; `--cpu` runs it on the host in float32, as
the JAX script does. With no card and no `--cpu` it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--schedule_steps", type=int, default=0,
                    help="OneCycle length (default: --steps)")
    ap.add_argument("--batches", type=int, default=64)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--working_dir", type=str, default="outputs/zebra/")
    ap.add_argument("--eval_n", type=int, default=64)
    ap.add_argument("--input_res", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--backbone", type=str, default="darknet_tiny_h")
    ap.add_argument("--code_bits", type=int, default=16)
    ap.add_argument("--verts_per_axis", type=int, default=6)
    ap.add_argument("--classes", type=str, default="",
                    help="class subset, '3,5,7' or '0-14'; empty = single class 0")
    ap.add_argument("--kd_weight", type=float, default=0.0)
    ap.add_argument("--weight_file_t", type=str, default="",
                    help="zebra teacher final.ckpt (same code_bits); with "
                         "kd_weight>0 enables dense code distillation")
    ap.add_argument("--backbone_t", type=str, default="darknet53")
    ap.add_argument("--backbone_init", type=str, default="",
                    help="warm-start the student backbone from a (corner- "
                         "or zebra-) checkpoint; head/FPN stay fresh")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps_per_dispatch", type=int, default=50)
    ap.add_argument("--log_every", type=int, default=100)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def parse_classes(spec: str):
    """'' -> None; 'lo-hi' -> (lo, ..., hi); 'a,b,c' -> (a, b, c)."""
    if not spec:
        return None
    if "-" in spec and "," not in spec:
        lo, hi = spec.split("-")
        return tuple(range(int(lo), int(hi) + 1))
    return tuple(int(c) for c in spec.split(","))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    out = run(build_parser().parse_args(argv))
    print(json.dumps(out), flush=True)
    return out


def run(args: argparse.Namespace) -> dict:
    import numpy as np
    import torch

    from .config import Config, KDConfig, ModelConfig, SolverConfig
    from .data.batch import Batch
    from .data.synthetic import SyntheticPoseDataset
    from .engine.serving import network_fn
    from .engine.steps import create_train_state, make_optimizer
    from .engine.zebra import build_zebra_multi_step, build_zebra_postprocess
    from .models.pose_net import PoseNet, init_pose_net
    from .utils import metrics as M
    from .utils.checkpoint import load_backbone_init, load_params_loose, save_params

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("train_zebra: no CUDA device; pass --cpu to run on the host")
    device = torch.device("cpu" if args.cpu else "cuda")
    dtype = "float32" if args.cpu else "bfloat16"
    cfg = Config(
        model=ModelConfig(backbone=args.backbone, compute_dtype=dtype,
                          input_res=args.input_res, code_bits=args.code_bits),
        solver=SolverConfig(ims_per_batch=args.batch_size,
                            max_iter=args.schedule_steps or args.steps,
                            base_lr=args.lr, seed=args.seed),
        kd=KDConfig(weight=args.kd_weight))
    classes = parse_classes(args.classes)
    n_fg = cfg.data.n_fg
    ds = SyntheticPoseDataset(n_fg=n_fg, input_res=cfg.model.input_res,
                              max_objs=cfg.solver.max_objs,
                              single_class=None if classes else 0, classes=classes, seed=0)
    consts = ds.consts(device=device, code_bits=args.code_bits,
                       verts_per_axis=args.verts_per_axis)
    print(f"verts/class: {consts.verts.shape[1]}, code bits: {args.code_bits}", flush=True)

    net = init_pose_net(PoseNet(cfg.model, n_fg=n_fg),
                        torch.Generator().manual_seed(args.seed))
    if args.backbone_init:
        n = load_backbone_init(args.backbone_init, net)
        print(f"student backbone warm-started: {n} tensors", flush=True)
    optimizer = make_optimizer(cfg)
    state = create_train_state(cfg, net.to(device), optimizer)

    teacher_net, distill = None, False
    if args.weight_file_t and args.kd_weight > 0:
        t_model = ModelConfig(backbone=args.backbone_t, compute_dtype=dtype,
                              input_res=args.input_res, code_bits=args.code_bits)
        teacher_net = init_pose_net(PoseNet(t_model, n_fg=n_fg),
                                    torch.Generator().manual_seed(1))
        n = load_params_loose(args.weight_file_t, teacher_net)
        teacher_net = teacher_net.to(device).eval()
        distill = True
        print(f"zebra teacher: loaded {n} tensors", flush=True)

    print("pre-rendering train pool...", flush=True)
    t0 = time.time()
    pool = Batch.stack([ds.batch(range(1000 + b * args.batch_size,
                                       1000 + (b + 1) * args.batch_size), train=True)
                        for b in range(args.batches)]).to(device)
    print(f"pool of {args.batches} batches in {time.time() - t0:.0f}s", flush=True)

    k = max(1, min(args.steps_per_dispatch or 1, args.steps))
    multi = build_zebra_multi_step(cfg, consts, net, teacher_net, optimizer, n_fg,
                                   pool_size=args.batches, distill=distill)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 17)
    done, t0, imgs = 0, time.time(), 0
    while done < args.steps:
        kk = min(k, args.steps - done)
        state, m = multi(state, pool, done % args.batches, kk, generator=gen)
        done += kk
        imgs += kk * args.batch_size
        if done % max(args.log_every, kk) == 0 or done >= args.steps:
            m = {key: float(v) for key, v in m.items()}
            print(f"step {done}/{args.steps} cls {m['loss_cls']:.4f} "
                  f"code {m['loss_code']:.3f} off {m['loss_off']:.3f} "
                  f"kd {m['loss_kd']:.3f} npos {int(m['num_pos'])} "
                  f"ips {imgs / (time.time() - t0):.1f}", flush=True)

    os.makedirs(args.working_dir, exist_ok=True)
    save_params(os.path.join(args.working_dir, "final.ckpt"), net.state_dict())

    # held-out eval: decode dense correspondences -> poses -> ADD / REP
    postprocess = build_zebra_postprocess(cfg, consts, n_fg)
    network = network_fn(net)
    K_host = consts.K.cpu().numpy()
    verts_host = consts.verts.cpu().numpy()
    errs3, errs2, gt_cls_all, valid_all = [], [], [], []
    tb = cfg.test.ims_per_batch
    erng = torch.Generator(device=device)
    erng.manual_seed(123)
    for start in range(0, args.eval_n, tb):
        idx = [min(start + j, args.eval_n - 1) for j in range(tb)]
        batch = ds.batch(idx, train=False).to(device)
        cls_l, _, code_p = network(batch.images)
        out = postprocess(cls_l, code_p, batch.class_ids[:, 0], batch.bbox_trans,
                          generator=erng)
        out = {key: v.cpu().numpy() for key, v in out.items()}
        host = batch.to("cpu")
        take = len(set(idx))  # the last batch pads by repeating the final index
        for i in range(take):
            ci = int(host.class_ids[i, 0])
            e3, e2 = M.compute_pose_diff(
                verts_host[ci], K_host, host.rotations[i, 0].numpy(),
                host.translations[i, 0].numpy().reshape(3, 1),
                out["R"][i], out["T"][i].reshape(3, 1))
            errs3.append(e3)
            errs2.append(e2)
            gt_cls_all.append(ci)
            valid_all.append(bool(out["valid"][i]))

    errs3, errs2 = np.asarray(errs3), np.asarray(errs2)
    valid = np.asarray(valid_all)
    diam = consts.diameters.cpu().numpy()[np.asarray(gt_cls_all)]
    ok = valid & np.isfinite(errs3)
    res = {
        "ADD.10d": round(100.0 * float(np.mean(ok & (errs3 <= 0.1 * diam))), 2),
        "ADD.20d": round(100.0 * float(np.mean(ok & (errs3 <= 0.2 * diam))), 2),
        "REP05px": round(100.0 * float(np.mean(ok & (errs2 <= 5.0))), 2),
        "REP10px": round(100.0 * float(np.mean(ok & (errs2 <= 10.0))), 2),
        "mean_err3d_mm": round(float(np.mean(errs3[ok])) if ok.any() else -1.0, 2),
        "n_valid": int(valid.sum()), "n_eval": int(len(valid)),
    }
    print(json.dumps(res), flush=True)
    return {"final": res, "backbone": args.backbone, "steps": args.steps,
            "code_bits": args.code_bits, "kd_weight": args.kd_weight}


if __name__ == "__main__":
    main()
