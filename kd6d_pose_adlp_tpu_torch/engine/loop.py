"""Training loop (port of `kd6d_pose_adlp_tpu/engine/loop.py:31-253`):
build the student and (optionally) the frozen teacher, resume from
`latest.ckpt` or initialize the backbone from a weight file, then train
to `cfg.solver.max_iter` in one of two ways:

- the host iterator: one eagerly dispatched step per batch;
- a device pool (`pool`, a `Batch.stack`): `steps_per_dispatch` steps per
  call of `steps.build_multi_step`, cycling the pool's batches, with the
  teacher's votes computed once for the pool when `cache_teacher` is set.

SSC's random draws come from one seeded generator that advances every step.
Every `cfg.solver.val_freq` steps and after the last: `eval_fn(state, step)`,
then `latest.ckpt`. At the end: `final.ckpt` (the student's state_dict),
`info.txt`; `cfg.json` at the start; metrics and images/s to
`scalars.jsonl`. All files go to `working_dir`.

Under a data mesh (`mesh`, `parallel/mesh.DataMesh`), every rank runs this
loop on its own part of each global batch and the ranks take JAX's global
step together (`engine/steps`); rank 0 alone writes the files.

Not ported yet, and raising `NotImplementedError` when asked for: cloud
visualization (`vis_every`, ROADMAP Queue 1 item 6c).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import torch

from ..config import Config
from ..data.batch import Batch, TaskConsts
from ..models.pose_net import PoseNet, init_pose_net
from ..parallel.mesh import DataMesh, barrier, replicate
from ..utils.checkpoint import (config_hash, load_backbone_init, restore_checkpoint,
                                save_checkpoint, save_params)
from ..utils.logging_utils import ScalarLogger, Throughput
from .steps import (TrainState, build_multi_step, build_train_step, create_train_state,
                    make_optimizer, precompute_pool_votes)


def train(cfg: Config,
          consts: TaskConsts,
          train_iter: Optional[Iterable[Batch]],
          *,
          cfg_t: Optional[Config] = None,
          teacher_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
          device="cuda",
          log_every: int = 10,
          eval_fn: Optional[Callable] = None,
          working_dir: Optional[str] = None,
          mesh: Optional[DataMesh] = None,
          resume: bool = True,
          vis_every: int = 0,
          pool: Optional[Batch] = None,
          steps_per_dispatch: int = 50,
          cache_teacher: bool = False,
          backbone_init: Optional[str] = None,
          verbose: bool = True) -> Tuple[TrainState, List[Dict[str, float]]]:
    """Runs the schedule on `device`; returns the final TrainState and the
    logged metrics (one dict per log, with `step`, `images_per_sec` and
    `step_ms`, the mean host-clock time of the steps since the last log).

    - `train_iter` yields Batches (any device; each is moved to `device`).
      It is not read when `pool` is given.
    - `working_dir` (default `cfg.working_dir`) receives the run's files.
    - `resume`: restore `working_dir/latest.ckpt` if it exists (its config
      hash must match) and go on from its step. Otherwise the student
      starts from `init_pose_net` seeded with `cfg.solver.seed`, its
      backbone then loaded from `backbone_init` when given.
    - Distillation is on iff `teacher_state_dict` is given and
      kd.weight > 0; the teacher is a PoseNet of `cfg_t.model`.
    - `pool`: a `Batch.stack` of batches, moved to `device` once; each call
      runs up to `steps_per_dispatch` steps, clipped at the next val_freq
      boundary, and logs once. `cache_teacher` (honoured only with a pool
      and distillation) votes the teacher over the pool once, before the
      first step.
    - `eval_fn(state, step)` (e.g. a `ScanEvaluator` over `state.net`) is
      called when step % cfg.solver.val_freq == 0 and at the last step
      (JAX `engine/loop.py:241-243`); its time is not in `step_ms`.
    - `mesh`: every rank of the data mesh calls `train`, on `mesh.device`
      (`device` is not read), with its own part of each global batch
      (`train_iter`, or its part of every pool batch). The LR is divided
      by the mesh's size (`make_optimizer`); rank 0's state is broadcast
      after the initialization, the resume or the backbone init; each rank
      draws SSC from its own generator, seeded from (seed, rank); images/s
      counts the global batch. Rank 0 alone writes `cfg.json`, the
      checkpoints, `info.txt` and the scalars, and the ranks meet at a
      barrier after each write; the other ranks print nothing.
    """
    if vis_every > 0:
        raise NotImplementedError(
            "train(vis_every=...) is not ported yet (ROADMAP Queue 1 item 6c)")
    if pool is not None and steps_per_dispatch < 1:
        raise ValueError(
            f"steps_per_dispatch must be >= 1 with a device pool "
            f"(got {steps_per_dispatch}); pass pool=None for per-step dispatch")
    device = torch.device(device) if mesh is None else mesh.device
    rank, n_ranks = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    writer = rank == 0
    verbose = verbose and writer
    working_dir = working_dir or cfg.working_dir
    os.makedirs(working_dir, exist_ok=True)
    n_fg = cfg.data.n_fg

    net = PoseNet(cfg.model, n_fg=n_fg)
    optimizer = make_optimizer(cfg, n_devices=n_ranks)
    init_pose_net(net, torch.Generator().manual_seed(cfg.solver.seed))
    state = create_train_state(cfg, net.to(device), optimizer)

    cfg_h = config_hash(cfg)
    latest = os.path.join(working_dir, "latest.ckpt")
    if resume and os.path.exists(latest):
        state, start_step = restore_checkpoint(latest, state, cfg_hash=cfg_h)
        if verbose:
            print(f"resumed from {latest} @ step {start_step}", flush=True)
    elif backbone_init:
        n = load_backbone_init(backbone_init, state.net)
        if verbose:
            print(f"backbone init: {n} tensors from {backbone_init}", flush=True)
    if mesh is not None:
        state = replicate(state, mesh)

    distill = teacher_state_dict is not None and cfg.kd.weight > 0.0
    teacher_net = None
    if distill:
        teacher_net = PoseNet(cfg_t.model, n_fg=n_fg)
        teacher_net.load_state_dict(teacher_state_dict, strict=True)
        teacher_net = teacher_net.to(device).eval()
        for p in teacher_net.parameters():
            p.requires_grad_(False)

    consts = consts.to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.solver.seed + 7919 * rank)   # rank 0: the seed itself
    if pool is None:
        step_fn = build_train_step(cfg, cfg_t, consts, state.net, teacher_net,
                                   optimizer, distill=distill, mesh=mesh)
    else:
        pool = pool.to(device)
        pool_size = int(pool.images.shape[0])
        cache_teacher = cache_teacher and distill
        multi_fn = build_multi_step(cfg, cfg_t, consts, state.net, teacher_net, optimizer,
                                    distill=distill, pool_size=pool_size,
                                    cached_votes=cache_teacher, mesh=mesh)
        teacher_arg = None
        if cache_teacher:
            t0 = time.perf_counter()
            teacher_arg = precompute_pool_votes(cfg, cfg_t, teacher_net, pool)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if verbose:
                print(f"teacher knowledge cached for {pool_size} pool batches "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)

    logger = None
    if writer:
        logger = ScalarLogger(working_dir)
        with open(os.path.join(working_dir, "cfg.json"), "w") as f:
            f.write(cfg.to_json())
    history: List[Dict[str, float]] = []
    meter = Throughput()

    def log(metrics: Dict[str, torch.Tensor], every_print: int) -> None:
        m = {k: float(v) for k, v in metrics.items()}   # synchronizes
        m.update(step=state.step, images_per_sec=meter.images_per_sec,
                 step_ms=1e3 / meter.steps_per_sec)
        history.append(m)
        if logger is not None:
            logger.log(state.step,
                       {f"training/{k}": v for k, v in m.items() if k != "step"})
        meter.reset()
        if verbose and (state.step % every_print == 0 or state.step == cfg.solver.max_iter):
            print(f"step {state.step}/{cfg.solver.max_iter} "
                  f"cls {m['loss_cls']:.4f} reg {m['loss_reg']:.4f} "
                  f"kd {m['loss_kd']:.4f} ips {m['images_per_sec']:.1f}", flush=True)

    def boundary() -> None:
        """eval_fn and latest.ckpt at a val_freq boundary and the last step."""
        if state.step % cfg.solver.val_freq == 0 or state.step == cfg.solver.max_iter:
            if eval_fn is not None:
                eval_fn(state, state.step)
            if writer:
                save_checkpoint(latest, state, state.step, cfg_hash=cfg_h)
            if mesh is not None:
                barrier(mesh)
            meter.reset()

    it = iter(train_iter) if pool is None else None
    while state.step < cfg.solver.max_iter:
        if pool is None:
            batch = next(it).to(device)
            state, metrics = step_fn(state, batch, generator=gen)
            meter.update(int(batch.images.shape[0]) * n_ranks)
            if state.step % log_every == 0 or state.step == cfg.solver.max_iter:
                log(metrics, log_every)
        else:
            # clip the call at the next val_freq boundary (JAX loop.py:168-171)
            stop = min((state.step // cfg.solver.val_freq + 1) * cfg.solver.val_freq,
                       cfg.solver.max_iter)
            k = min(steps_per_dispatch, stop - state.step)
            state, metrics = multi_fn(state, teacher_arg, pool, state.step % pool_size, k,
                                      generator=gen)
            for _ in range(k):
                meter.update(int(pool.images.shape[1]) * n_ranks)
            log(metrics, 1)
        boundary()

    if writer:
        save_params(os.path.join(working_dir, "final.ckpt"), state.net.state_dict())
        with open(os.path.join(working_dir, "info.txt"), "w") as f:
            f.write(f"finished at: {time.strftime('%Y%m%d_%H%M%S')}\n"
                    f"working_dir: {working_dir}\ncommands: {' '.join(sys.argv)}\n")
        logger.close()
    if mesh is not None:
        barrier(mesh)
    return state, history
