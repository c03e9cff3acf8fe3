"""The distillation / baseline training CLI, the port's counterpart of the
JAX package's `train_kd.py`:

    python -m kd6d_pose_adlp_tpu_torch.train_kd --config_file configs/smoke.yaml \\
        --data synthetic --max_iters 3 --working_dir D --cpu
    python -m kd6d_pose_adlp_tpu_torch.train_kd --config_file TREE/config.yaml \\
        --data bop --weight_file_t teacher.pt --num_workers 4 --working_dir D
    python -m kd6d_pose_adlp_tpu_torch.train_kd --config_file '' --data synthetic \\
        --weight_file_t teacher.pt --device_pool 4 --steps_per_dispatch 5 \\
        --cache_teacher --working_dir D
    python -m kd6d_pose_adlp_tpu_torch.train_kd --n_devices 4 ...    # 4 cards, one host
    torchrun --nproc_per_node 4 -m kd6d_pose_adlp_tpu_torch.train_kd --distributed ...

It takes `train_kd.py`'s flags with the same meaning: it builds the
configs and the data (`--data bop`, the default: the BOP tree the config's
lists name, read through the host pipeline with `--num_workers` loader
threads, `--fast_pipeline` for its one-warp path; or `--data synthetic`),
the teacher from `--weight_file_t` (a
`torch.save`d state_dict or a JAX checkpoint, read loosely) with its BN
folded into its convolutions (`--fold_teacher_bn`, on by default, as in
`train_kd.py:190-198`) and, with `--quant_teacher` (which requires the
fold), int8-quantized after calibrating on the first
`--quant_calib_batches` eval batches (`utils/quant`, as in
`train_kd.py:200-217`), prints the model sizes, evaluates the teacher once
when a weight file is given (sanity gate), then trains through `engine/loop.train` with an evaluation
every VAL_FREQ steps and at the end (scan or stream, `--eval_mode`; their
scalars to eval_scalars.jsonl). `--device_pool N` stacks N batches onto the
device and runs `--steps_per_dispatch` steps per call; `--cache_teacher`
votes the teacher over that pool once. Student and teacher compute in
`--compute_dtype` (bfloat16 by default, as in `train_kd.py`; float32 is
the other choice), and `--remat` rematerializes the student forward in
the backward pass. Runs on the card unless --cpu is given.
`--config_file ''` takes the built-in defaults.

Data parallelism, one process a device (`parallel/mesh`), the ranks taking
JAX's global step together (`engine/steps`):
- `--n_devices N` (0, the default: every visible card; one process under
  --cpu) runs N ranks on this host, started by this command, which
  together take one batch of `ims_per_batch` a step, JAX's single-host
  meaning: each rank loads `ims_per_batch / N` from its own shard of the
  data (so N must divide it), with NCCL on the cards and gloo under --cpu.
  More ranks than visible cards raises, where JAX's `devs[:n]` takes
  fewer.
- `--distributed` runs as one rank of a group that torchrun started
  (its RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT): each
  process loads `ims_per_batch` from its own shard, as JAX's processes do.
In both, the LR is divided by the number of ranks, every rank evaluates its
shard of the eval set and scores the merged predictions, and rank 0 alone
writes the files and prints. `main` returns each rank's `(step, history)`
when it started the ranks.

The default that differs from `train_kd.py`, because the JAX default asks
for a module that is not ported: `--vis_every 0` (1000). See
`check_ported` for the flag that raises.
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
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--fast_pipeline", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize the student forward in the backward pass")
    p.add_argument("--n_devices", type=int, default=0,
                   help="ranks on this host, one a device (0 = every visible card; "
                        "one process under --cpu)")
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
                   default=True, help="fold the frozen teacher's BN into its conv "
                                      "weights (with --weight_file_t)")
    p.add_argument("--quant_teacher", type=str2bool, nargs="?", const=True, default=False,
                   help="int8-quantize the frozen teacher (PTQ, utils/quant): "
                        "requires --fold_teacher_bn")
    p.add_argument("--quant_calib_batches", type=int, default=4,
                   help="eval batches that calibrate the activation ranges "
                        "for --quant_teacher")
    p.add_argument("--eval_mode", type=str, default="scan", choices=["scan", "stream"],
                   help="scan = the device-resident one-pass evaluator "
                        "(engine/eval_scan); stream = the per-batch evaluator.valid")
    p.add_argument("--distributed", action="store_true",
                   help="run as one rank of torchrun's process group")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p


def check_ported(args: argparse.Namespace) -> None:
    """Raises NotImplementedError on a flag whose module is not ported yet,
    naming its ROADMAP Queue 1 item: `--vis_every` > 0 (the KD cloud plots,
    item 6c)."""
    if args.vis_every > 0:
        raise NotImplementedError(f"--vis_every {args.vis_every} (KD cloud plots) is not "
                                  "ported yet (ROADMAP Queue 1 item 6c)")


def n_ranks(args: argparse.Namespace) -> int:
    """The ranks `--n_devices` asks this command to start: N, or every
    visible card for 0 (one process under --cpu, or on a host without a
    card, where the run then fails on its first card tensor). More ranks
    than visible cards raises, naming both counts."""
    if args.cpu:
        return args.n_devices or 1
    import torch
    n_cards = torch.cuda.device_count()
    n = args.n_devices or max(n_cards, 1)
    if n > 1 and n > n_cards:
        raise ValueError(f"--n_devices {n} asks for {n} ranks, one a card, but "
                         f"{n_cards} cards are visible")
    return n


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
    """Trains; returns (TrainState, history) of `engine/loop.train`, or each
    rank's (step, history) when `--n_devices` > 1 started the ranks."""
    args = get_argparser().parse_args(argv)
    check_ported(args)
    from .parallel import mesh as pmesh

    if args.distributed:
        mesh = pmesh.init_from_env(cpu=args.cpu)
        try:
            pmesh.make_mesh(args.n_devices, mesh.device)   # 0 or the group's size
            return _train(args, mesh, split=1)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
    n = n_ranks(args)
    if n == 1:
        return _train(args, None, split=1)
    B = build_configs(args)[0].solver.ims_per_batch
    if B % n:
        raise ValueError(f"--n_devices {n} does not divide the batch of {B} images "
                         "(SOLVER.IMS_PER_BATCH)")
    import torch
    # the CPU's threads shared among the ranks
    threads = max(torch.get_num_threads() // n, 1) if args.cpu else None
    return pmesh.spawn(_rank, n, args=(args, n), num_threads=threads)


def _rank(args: argparse.Namespace, n: int):
    """One of the `n` ranks `main` started (`parallel/mesh.spawn`)."""
    import torch.distributed as dist

    from .parallel import mesh as pmesh
    mesh = pmesh.init_from_env(cpu=args.cpu)
    try:
        state, history = _train(args, mesh, split=n)
        return state.step, history
    finally:
        dist.destroy_process_group()


def _train(args: argparse.Namespace, mesh, split: int):
    """The run on this process's rank of `mesh` (None: a single process),
    each rank loading `ims_per_batch / split` images a step."""
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
    from .utils.fold_bn import fold_batchnorm
    from .utils.logging_utils import ScalarLogger

    if mesh is None:
        device = torch.device("cpu" if args.cpu else "cuda")
    else:
        device = mesh.device
    lead = mesh is None or mesh.rank == 0

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    cfg, cfg_t = build_configs(args)
    # distillation needs a positive weight and a teacher; synthetic data
    # allows an untrained (random) teacher for pipeline exercises
    distill = args.kd_weight > 0.0 and (args.weight_file_t != "" or args.data == "synthetic")

    # each rank loads its part of the global batch; the config keeps the
    # global batch (cfg.json, the config hash)
    rank_cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, ims_per_batch=cfg.solver.ims_per_batch // split))
    data = loaders.build(rank_cfg, kind=args.data, device=device)
    if data.cfg is not None:
        # synthetic mesh diameters replace the yaml's LINEMOD ones
        cfg = data.cfg.replace(solver=cfg.solver)
    consts = data.consts
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(f"devices: {1 if mesh is None else mesh.size} x {name}")

    # the teacher stays on the host but for its sanity gate: loop.train
    # builds the device copy that trains against
    teacher_net = None
    if distill:
        teacher_net = init_pose_net(PoseNet(cfg_t.model, n_fg=cfg.data.n_fg),
                                    torch.Generator().manual_seed(1)).eval()
        if args.weight_file_t:
            n = load_params_loose(args.weight_file_t, teacher_net)
            say(f"teacher: loaded {n} tensors from {args.weight_file_t}")
            if args.fold_teacher_bn:
                # the frozen eval-mode teacher's BN is a constant affine:
                # fold it into the conv weights once and rebuild the teacher
                # as the folded model (JAX train_kd.py:190-198)
                folded = fold_batchnorm(teacher_net)
                cfg_t = cfg_t.replace(model=dataclasses.replace(cfg_t.model,
                                                                bn_folded=True))
                teacher_net = PoseNet(cfg_t.model, n_fg=cfg.data.n_fg).eval()
                teacher_net.load_state_dict(folded, strict=True)
                say("teacher: BN folded into conv weights")
            if args.quant_teacher:
                if not args.fold_teacher_bn:
                    raise SystemExit("--quant_teacher requires --fold_teacher_bn")
                # int8 PTQ of the frozen teacher: calibrate the activation
                # ranges on the first eval batches, on the device, then
                # rebuild it as the quant_mode="quant" model (JAX
                # train_kd.py:200-217); the unsharded batches, so that every
                # rank quantizes the same teacher
                from .utils.quant import quantize_posenet
                calib = []
                for b, _ in data.eval_batches(shard=(0, 1)):
                    calib.append(b.images.to(device))
                    if len(calib) >= args.quant_calib_batches:
                        break
                teacher_net, _ = quantize_posenet(cfg_t.model, cfg.data.n_fg,
                                                  folded, calib, device=device)
                teacher_net.cpu()
                cfg_t = cfg_t.replace(model=dataclasses.replace(cfg_t.model,
                                                                quant_mode="quant"))
                say(f"teacher: int8-quantized ({len(calib)} calib batches)")

    # model-size comparison (reference train_kd.py:76-78)
    n_student = sum(p.numel() for p in PoseNet(cfg.model, n_fg=cfg.data.n_fg).parameters())
    if teacher_net is not None:
        n_teacher = sum(p.numel() for p in teacher_net.parameters())
        say(f"Model size: Student VS Teacher: {n_student:d} vs {n_teacher:d}")
    else:
        say(f"Model size: {n_student:d} params")

    scan_eval = None
    if args.eval_mode == "scan":
        # the eval set is staged on the device once, for every evaluation
        scan_eval = ScanEvaluator(cfg, consts, None, data.meshes)
        scan_eval.prepare(data.eval_batches())
    postprocess = build_postprocess(cfg, consts) if scan_eval is None else None

    if distill and args.weight_file_t:
        # teacher sanity gate (reference train_kd.py:85-86)
        say("--- evaluate teacher ---")
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

    eval_logger = (ScalarLogger(args.working_dir, filename="eval_scalars.jsonl")
                   if lead else None)

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
        say(f"device pool: {args.device_pool} batches x {pool.images.shape[1]} images")
    else:
        train_iter = (data.train_iter(args.num_workers) if args.data == "bop"
                      else data.train_iter())

    try:
        return train(cfg, consts, train_iter, cfg_t=cfg_t,
                     teacher_state_dict=(None if teacher_net is None
                                         else teacher_net.state_dict()),
                     device=device, eval_fn=eval_fn, working_dir=args.working_dir,
                     pool=pool, steps_per_dispatch=args.steps_per_dispatch,
                     cache_teacher=args.cache_teacher,
                     backbone_init=args.backbone_init or None, vis_every=args.vis_every,
                     mesh=mesh)
    finally:
        if train_iter is not None:
            train_iter.close()      # the BOP loader's threads stop here
        if eval_logger is not None:
            eval_logger.close()


if __name__ == "__main__":
    main()
