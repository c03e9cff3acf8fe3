"""The distillation / baseline training CLI, the port's counterpart of the
JAX package's `train_kd.py`:

    python -m kd6d_pose_adlp_tpu_torch.train_kd --config_file configs/smoke.yaml \\
        --data synthetic --max_iters 3 --working_dir D --cpu
    python -m kd6d_pose_adlp_tpu_torch.train_kd --config_file '' --data synthetic \\
        --weight_file_t teacher.pt --device_pool 4 --steps_per_dispatch 5 \\
        --cache_teacher --working_dir D

It takes `train_kd.py`'s flags with the same meaning: it builds the
configs and the synthetic data, the teacher from `--weight_file_t` (a
`torch.save`d state_dict or a JAX checkpoint, read loosely), prints the
model sizes, evaluates the teacher once when a weight file is given
(sanity gate), then trains through `engine/loop.train` with an evaluation
every VAL_FREQ steps and at the end (scan or stream, `--eval_mode`; their
scalars to eval_scalars.jsonl). `--device_pool N` stacks N batches onto the
device and runs `--steps_per_dispatch` steps per call; `--cache_teacher`
votes the teacher over that pool once. Runs on the card unless --cpu is
given. `--config_file ''` takes the built-in defaults.

Defaults that differ from `train_kd.py`, because the JAX default asks for
a module that is not ported: `--compute_dtype float32` (bfloat16),
`--vis_every 0` (1000) and `--fold_teacher_bn False` (True); `--n_devices
0` means one device, not all of them. Flags of modules not ported yet
raise `NotImplementedError` naming their ROADMAP Queue 1 item: `--data
bop`, `--fast_pipeline`, `--n_devices` > 1, `--distributed` and
`--vis_every` > 0 (item 6); `--compute_dtype bfloat16` and `--remat` (item
3); `--fold_teacher_bn` with `--weight_file_t`, and `--quant_teacher`
(item 4).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence


def str2bool(v) -> bool:
    return str(v).lower() in ("yes", "true", "t", "1")


def get_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # base flags (reference arguments/argument.py:6-22)
    p.add_argument("--config_file", type=str, default="./configs/ape.yaml",
                   help="reference-format YAML; '' = the built-in defaults")
    p.add_argument("--working_dir", type=str, default="./outputs/")
    p.add_argument("--weight_file", type=str, default="")
    p.add_argument("--backbone", type=str, default="darknet_tiny_h")
    p.add_argument("--max_iters", type=int, default=20000)
    p.add_argument("--base_lr", type=float, default=0.001)
    p.add_argument("--num_workers", type=int, default=4)
    # teacher flags (reference arguments/argument_kd.py:32-35)
    p.add_argument("--config_file_t", type=str, default="")
    p.add_argument("--backbone_t", type=str, default="darknet53")
    p.add_argument("--weight_file_t", type=str, default="")
    # KD flags (reference arguments/argument_kd.py:37-49)
    p.add_argument("--kd_weight", type=float, default=5.0)
    p.add_argument("--kd_level", type=str, default="pred")
    p.add_argument("--gtype", type=str, default="sinkhorn",
                   choices=["l1", "l2", "sinkhorn", "gaussian", "laplacian", "energy"])
    p.add_argument("--glevel", type=str, default="point", choices=["point"])
    p.add_argument("--p", type=float, default=2.0)
    p.add_argument("--blur", type=float, default=0.001)
    p.add_argument("--gnD", type=int, default=2)
    p.add_argument("--weightedOT", type=str2bool, nargs="?", const=True, default=True)
    p.add_argument("--wot_detach", type=str2bool, nargs="?", const=True, default=False)
    p.add_argument("--scaling", type=float, default=0.5)
    p.add_argument("--reach", type=float, default=0.5)
    p.add_argument("--kd_teacher_class", type=str, default="gt", choices=["gt", "pred"],
                   help="teacher voted class: gt = image's GT label, pred = the "
                        "teacher's best-scoring candidate label")
    # the JAX package's extras
    p.add_argument("--data", type=str, default="bop", choices=["bop", "synthetic"])
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--fast_pipeline", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--n_devices", type=int, default=0, help="0 = one device")
    p.add_argument("--device_pool", type=int, default=0,
                   help="synthetic only: render N batches, keep them on the device "
                        "and run --steps_per_dispatch steps per call, cycling them")
    p.add_argument("--steps_per_dispatch", type=int, default=50)
    p.add_argument("--cache_teacher", type=str2bool, nargs="?", const=True, default=False,
                   help="with --device_pool and distillation: vote the frozen "
                        "teacher over the pool once")
    p.add_argument("--vis_every", type=int, default=0,
                   help="KD cloud scatter dump cadence (0 = off; not ported)")
    p.add_argument("--backbone_init", type=str, default="",
                   help="weight file (torch or JAX) to initialize the student "
                        "backbone from")
    p.add_argument("--fold_teacher_bn", type=str2bool, nargs="?", const=True,
                   default=False, help="fold the teacher's BN into its convs (not ported)")
    p.add_argument("--quant_teacher", type=str2bool, nargs="?", const=True, default=False)
    p.add_argument("--quant_calib_batches", type=int, default=4)
    p.add_argument("--eval_mode", type=str, default="scan", choices=["scan", "stream"],
                   help="scan = the device-resident one-pass evaluator "
                        "(engine/eval_scan); stream = the per-batch evaluator.valid")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p


def check_ported(args: argparse.Namespace) -> None:
    """Raises NotImplementedError on a flag whose module is not ported."""
    unported = (
        (args.data == "bop", "--data bop (the BOP host pipeline)", 6),
        (args.fast_pipeline, "--fast_pipeline", 6),
        (args.n_devices > 1, f"--n_devices {args.n_devices} (the data mesh)", 6),
        (args.distributed, "--distributed", 6),
        (args.vis_every > 0, f"--vis_every {args.vis_every} (KD cloud plots)", 6),
        (args.compute_dtype != "float32", f"--compute_dtype {args.compute_dtype}", 3),
        (args.remat, "--remat", 3),
        (args.fold_teacher_bn and bool(args.weight_file_t),
         "--fold_teacher_bn with --weight_file_t", 4),
        (args.quant_teacher, "--quant_teacher", 4),
    )
    for asked, what, item in unported:
        if asked:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


def build_configs(args: argparse.Namespace):
    """(student config, teacher config) from the YAML files (or the
    defaults, for '') and the flags."""
    from .config import Config, KDConfig, load_yaml_config

    def load(path: str, backbone: str) -> Config:
        if path:
            return load_yaml_config(path, backbone=backbone)
        return Config().replace(model=dataclasses.replace(Config().model, backbone=backbone))

    kd = KDConfig(weight=args.kd_weight, level=args.kd_level, gtype=args.gtype,
                  glevel=args.glevel, p=args.p, blur=args.blur, gn_d=args.gnD,
                  weighted_ot=args.weightedOT, wot_detach=args.wot_detach,
                  scaling=args.scaling, reach=args.reach,
                  teacher_class=args.kd_teacher_class)
    cfg = load(args.config_file, args.backbone)
    cfg = cfg.replace(kd=kd, working_dir=args.working_dir)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype=args.compute_dtype,
                                  remat=args.remat),
        solver=dataclasses.replace(cfg.solver, max_iter=args.max_iters,
                                   base_lr=args.base_lr),
        data=dataclasses.replace(cfg.data, fast_pipeline=args.fast_pipeline))
    cfg_t = load(args.config_file_t or args.config_file, args.backbone_t)
    cfg_t = cfg_t.replace(kd=kd, model=dataclasses.replace(
        cfg_t.model, compute_dtype=args.compute_dtype))
    return cfg, cfg_t


def main(argv: Optional[Sequence[str]] = None):
    """Trains; returns (TrainState, history) of `engine/loop.train`."""
    args = get_argparser().parse_args(argv)
    check_ported(args)
    import torch

    from .data import loaders
    from .data.batch import Batch
    from .engine import evaluator
    from .engine.eval_scan import ScanEvaluator
    from .engine.loop import train
    from .engine.postprocess import build_postprocess
    from .engine.serving import network_fn
    from .models.pose_net import PoseNet, init_pose_net
    from .utils.checkpoint import load_params_loose
    from .utils.logging_utils import ScalarLogger

    device = torch.device("cpu" if args.cpu else "cuda")
    cfg, cfg_t = build_configs(args)
    # distillation needs a positive weight and a teacher; synthetic data
    # allows an untrained (random) teacher for pipeline exercises
    distill = args.kd_weight > 0.0 and (args.weight_file_t != "" or args.data == "synthetic")

    data = loaders.build(cfg, kind=args.data, device=device)
    if data.cfg is not None:
        cfg = data.cfg  # synthetic mesh diameters replace the yaml's LINEMOD ones
    consts = data.consts
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"devices: 1 x {name}", flush=True)

    # the teacher stays on the host but for its sanity gate: loop.train
    # builds the device copy that trains against
    teacher_net = None
    if distill:
        teacher_net = init_pose_net(PoseNet(cfg_t.model, n_fg=cfg.data.n_fg),
                                    torch.Generator().manual_seed(1)).eval()
        if args.weight_file_t:
            n = load_params_loose(args.weight_file_t, teacher_net)
            print(f"teacher: loaded {n} tensors from {args.weight_file_t}", flush=True)

    # model-size comparison (reference train_kd.py:76-78)
    n_student = sum(p.numel() for p in PoseNet(cfg.model, n_fg=cfg.data.n_fg).parameters())
    if teacher_net is not None:
        n_teacher = sum(p.numel() for p in teacher_net.parameters())
        print(f"Model size: Student VS Teacher: {n_student:d} vs {n_teacher:d}", flush=True)
    else:
        print(f"Model size: {n_student:d} params", flush=True)

    scan_eval = None
    if args.eval_mode == "scan":
        # the eval set is staged on the device once, for every evaluation
        scan_eval = ScanEvaluator(cfg, consts, None, data.meshes)
        scan_eval.prepare(data.eval_batches())
    postprocess = build_postprocess(cfg, consts) if scan_eval is None else None

    if distill and args.weight_file_t:
        # teacher sanity gate (reference train_kd.py:85-86)
        print("--- evaluate teacher ---", flush=True)
        t_cfg = dataclasses.replace(cfg_t, test=cfg.test, data=cfg.data)
        teacher_net.to(device)
        if scan_eval is not None:
            ScanEvaluator(t_cfg, consts, teacher_net, data.meshes).share_staged(
                scan_eval).run(step=0, working_dir=args.working_dir)
        else:
            evaluator.valid(cfg, consts, network_fn(teacher_net),
                            build_postprocess(t_cfg, consts), data.eval_batches(),
                            data.meshes, step=0, working_dir=args.working_dir)
        teacher_net.cpu()    # give its device memory back before training

    eval_logger = ScalarLogger(args.working_dir, filename="eval_scalars.jsonl")

    def eval_fn(state, step):
        if scan_eval is not None:
            scan_eval.run(step=step, working_dir=args.working_dir, logger=eval_logger,
                          net=state.net)
        else:
            evaluator.valid(cfg, consts, network_fn(state.net), postprocess,
                            data.eval_batches(), data.meshes, step=step,
                            working_dir=args.working_dir, logger=eval_logger)

    pool, train_iter = None, None
    if args.device_pool > 0:
        # a static pool would freeze the BOP pipeline's per-epoch re-crops
        if args.data != "synthetic":
            raise SystemExit("--device_pool requires --data synthetic")
        it = data.train_iter()
        pool = Batch.stack([next(it) for _ in range(args.device_pool)]).to(device)
        print(f"device pool: {args.device_pool} batches x {pool.images.shape[1]} images",
              flush=True)
    else:
        train_iter = data.train_iter()

    try:
        return train(cfg, consts, train_iter, cfg_t=cfg_t,
                     teacher_state_dict=(None if teacher_net is None
                                         else teacher_net.state_dict()),
                     device=device, eval_fn=eval_fn, working_dir=args.working_dir,
                     pool=pool, steps_per_dispatch=args.steps_per_dispatch,
                     cache_teacher=args.cache_teacher,
                     backbone_init=args.backbone_init or None, vis_every=args.vis_every)
    finally:
        eval_logger.close()


if __name__ == "__main__":
    main()
