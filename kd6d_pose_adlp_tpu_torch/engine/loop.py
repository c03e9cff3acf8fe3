"""Training loop, the host-iterator path (port of
`kd6d_pose_adlp_tpu/engine/loop.py:31-76,213-253`): build the student and
(optionally) the frozen teacher, then one eagerly dispatched step per
batch, with SSC's random draws from one seeded generator that advances
every step, metrics plus images/s every `log_every` steps, and
`eval_fn(state, step)` every `cfg.solver.val_freq` steps and after the last.

Not ported yet, and raising `NotImplementedError` when asked for: the
device-resident pool scan (`pool`), the data mesh (`mesh`), the cached
teacher (`cache_teacher`), cloud visualization (`vis_every`) and `resume`;
checkpoints (`latest.ckpt`, `final.ckpt`) wait for a later slice, so
nothing is written to disk.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import torch

from ..config import Config
from ..data.batch import Batch, TaskConsts
from ..models.pose_net import PoseNet, init_pose_net
from .steps import TrainState, build_train_step, create_train_state, make_optimizer


def train(cfg: Config,
          consts: TaskConsts,
          train_iter: Iterable[Batch],
          *,
          cfg_t: Optional[Config] = None,
          teacher_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
          device="cuda",
          log_every: int = 10,
          eval_fn: Optional[Callable] = None,
          mesh=None,
          resume: bool = False,
          vis_every: int = 0,
          pool=None,
          cache_teacher: bool = False,
          verbose: bool = True) -> Tuple[TrainState, List[Dict[str, float]]]:
    """Runs `cfg.solver.max_iter` steps on `device`; returns the final
    TrainState and the logged metrics (one dict per `log_every` steps, with
    `step`, `images_per_sec` and `step_ms`, the mean host-clock time of the
    steps since the last log).

    - `train_iter` yields Batches (any device; each is moved to `device`).
    - The student starts from `init_pose_net` seeded with
      `cfg.solver.seed`.
    - Distillation is on iff `teacher_state_dict` is given and
      kd.weight > 0; the teacher is a PoseNet of `cfg_t.model`.
    - `eval_fn(state, step)` (e.g. a `ScanEvaluator` over `state.net`) is
      called when step % cfg.solver.val_freq == 0 and at the last step
      (JAX `engine/loop.py:241-243`); its time is not in `step_ms`.
    """
    for name, asked in (("mesh", mesh is not None),
                        ("resume", resume), ("vis_every", vis_every > 0),
                        ("pool", pool is not None), ("cache_teacher", cache_teacher)):
        if asked:
            raise NotImplementedError(f"train({name}=...) is not ported yet")
    device = torch.device(device)
    n_fg = cfg.data.n_fg

    net = PoseNet(cfg.model, n_fg=n_fg)
    optimizer = make_optimizer(cfg)
    init_pose_net(net, torch.Generator().manual_seed(cfg.solver.seed))
    state = create_train_state(cfg, net.to(device), optimizer)

    distill = teacher_state_dict is not None and cfg.kd.weight > 0.0
    teacher_net = None
    if distill:
        teacher_net = PoseNet(cfg_t.model, n_fg=n_fg)
        teacher_net.load_state_dict(teacher_state_dict, strict=True)
        teacher_net = teacher_net.to(device).eval()
        for p in teacher_net.parameters():
            p.requires_grad_(False)

    consts = consts.to(device)
    step_fn = build_train_step(cfg, cfg_t, consts, state.net, teacher_net,
                               optimizer, distill=distill)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.solver.seed)

    history: List[Dict[str, float]] = []
    it = iter(train_iter)
    t_last, n_img = time.perf_counter(), 0
    while state.step < cfg.solver.max_iter:
        batch = next(it).to(device)
        state, metrics = step_fn(state, batch, generator=gen)
        n_img += int(batch.images.shape[0])
        if state.step % log_every == 0 or state.step == cfg.solver.max_iter:
            m = {k: float(v) for k, v in metrics.items()}   # synchronizes
            now = time.perf_counter()
            n_steps = state.step - (history[-1]["step"] if history else 0)
            m.update(step=state.step, images_per_sec=n_img / (now - t_last),
                     step_ms=1e3 * (now - t_last) / n_steps)
            history.append(m)
            t_last, n_img = now, 0
            if verbose:
                print(f"step {state.step}/{cfg.solver.max_iter} "
                      f"cls {m['loss_cls']:.4f} reg {m['loss_reg']:.4f} "
                      f"kd {m['loss_kd']:.4f} ips {m['images_per_sec']:.1f}",
                      flush=True)
        if eval_fn is not None and (state.step % cfg.solver.val_freq == 0
                                    or state.step == cfg.solver.max_iter):
            eval_fn(state, state.step)
            t_last, n_img = time.perf_counter(), 0
    return state, history
