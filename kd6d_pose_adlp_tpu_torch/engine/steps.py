"""The KD train step, K steps per call over a device pool, and the OT
clouds for the plots (port of `kd6d_pose_adlp_tpu/engine/steps.py:30-264`).

One step: teacher forward (eval mode, no gradient) -> teacher-knowledge
voting -> student forward in train mode (its BN statistics update) ->
SSC targets, focal, object-space and Sinkhorn-OT losses -> backward ->
optax-form global-norm clip -> AdamW with the OneCycle LR. With cached
votes (`precompute_pool_votes`) the first two stages leave the step.

JAX keeps the state as an immutable pytree; here the student module holds
the parameters and BN statistics and the optimizer updates them in place.
Student and teacher compute in their configs' `compute_dtype` (float32 or
bfloat16; `models/blocks`), and return float32 outputs. Everything else,
and the networks too in float32, runs in full fp32
(`utils/precision.full_fp32`) whatever the caller's TF32 flags: the
losses, K1 and AdamW, as the JAX step's.

`cfg.model.remat` rematerializes the student forward in the backward pass,
the counterpart of `jax.checkpoint(fwd_train)` (JAX `steps.py:115-119`):
`torch.utils.checkpoint` stores the forward's inputs only and runs it
again when the backward needs its activations. The re-run forward is the
same function, but its train-mode BatchNorms would update their running
statistics a second time (JAX's functional BN updates them once), so the
re-run goes under `blocks.frozen_batch_stats()`.

Under a data mesh (`parallel/mesh.DataMesh`, one rank a device) the W
ranks take together the step JAX takes under `Mesh('data')` on the
concatenation of their batches: BatchNorm statistics over the global batch
(`blocks.global_batch_stats`), each rank's losses its local part of the
global sums, then one flat all-reduce (sum) of the gradients, so the clip,
`grad_norm` and the update are the global ones and the same on every rank.
`make_optimizer(cfg, n_devices=W)` divides the LR by W, as JAX's does.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import Config
from ..data.batch import Batch, TaskConsts
from ..models import anchors as anchor_lib
from ..models import coder
from ..models.blocks import frozen_batch_stats, global_batch_stats
from ..models.pose_net import PoseNet, init_pose_net
from ..ops.object_space import select_class_pred
from ..ops.voting import Votes, vote_cells, votes_to_internal_frame
from ..parallel.mesh import DataMesh, all_reduce_
from ..utils.precision import full_fp32
from .losses import build_kd_clouds, pose_losses, prepare_targets
from .schedule import onecycle_linear_lr


class AdamWState(NamedTuple):
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamW:
    """optax `chain(clip_by_global_norm(max_norm), adamw(lr_schedule, b1, b2,
    eps, weight_decay))` over a parameter list, updating in place.

    Clip as optax: g * (max_norm / |g|) when |g| >= max_norm, untouched
    below (torch's clip_grad_norm_ divides by |g| + 1e-6 instead). The LR
    is the schedule at the update count BEFORE it increments; the bias
    corrections 1 - b**count are float32 powers, as XLA computes them."""

    def __init__(self, lr_schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 max_norm: float = 1.0):
        self.lr_schedule = lr_schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.max_norm = weight_decay, max_norm

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.preserve_format)
                         for p in params]
        return AdamWState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamWState):
        """Applies one update to `params`; returns (new state, |grads|)."""
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(g_norm < self.max_norm, torch.ones_like(g_norm),
                            self.max_norm / g_norm)
        g = torch._foreach_mul(grads, scale)

        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, den)
        torch._foreach_add_(u, params, alpha=self.weight_decay)
        torch._foreach_add_(params, u, alpha=-self.lr_schedule(state.count))
        return AdamWState(count=count, mu=mu, nu=nu), g_norm


class TrainState(NamedTuple):
    step: int
    net: PoseNet          # parameters + BN statistics
    opt_state: AdamWState


def make_optimizer(cfg: Config, n_devices: int = 1) -> AdamW:
    """AdamW(0.9, 0.999, 1e-8, wd) + OneCycle linear LR over max_iter + 100
    steps (the reference passes MAX_ITER+100), LR divided by the device
    count, grad-clip `solver.grad_clip`."""
    total = cfg.solver.max_iter + 100
    return AdamW(onecycle_linear_lr(cfg.solver.base_lr / n_devices, total),
                 b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=cfg.solver.weight_decay,
                 max_norm=cfg.solver.grad_clip)


def create_train_state(cfg: Config, net: PoseNet, optimizer: AdamW,
                       generator: Optional[torch.Generator] = None) -> TrainState:
    """Step 0 over `net` (its weights drawn from `generator` by
    `init_pose_net` when one is given, else kept as they are)."""
    if generator is not None:
        init_pose_net(net, generator)
    return TrainState(step=0, net=net,
                      opt_state=optimizer.init(list(net.parameters())))


def teacher_knowledge(t_cls: torch.Tensor, t_reg: torch.Tensor, batch: Batch,
                      cfg_t: Config, max_votes: int,
                      teacher_class: str = "gt") -> Votes:
    """Teacher voted-cell extraction in the internal frame.

    "gt" votes the image's GT class; "pred" votes the class of the
    teacher's best-scoring (anchor, class) pair (the first on ties, as XLA's
    argmax). The teacher-side RANSAC-PnP is skipped: the KD loss never
    reads its pose."""
    m = cfg_t.model
    scores = torch.sigmoid(t_cls)                                 # (B,A,nfg)
    B, A, n_fg = scores.shape
    if teacher_class == "pred":
        voted_cls = torch.argmax(scores.reshape(B, -1), dim=1) % n_fg
    elif teacher_class == "gt":
        voted_cls = batch.class_ids[:, 0].clamp_min(0).to(torch.int64)
    else:
        raise ValueError(f"teacher_class {teacher_class!r}")
    s = torch.gather(scores, 2, voted_cls[:, None, None].expand(B, A, 1))[..., 0]
    pred16 = select_class_pred(t_reg, voted_cls[:, None].expand(B, A))
    votes = vote_cells(
        s, pred16, input_res=m.input_res, strides=m.level_strides,
        all_sizes=m.anchor_sizes, confidence_th=cfg_t.test.confidence_th,
        positive_num=cfg_t.solver.positive_num,
        positive_lambda=cfg_t.solver.positive_lambda, max_votes=max_votes)
    kp_internal = votes_to_internal_frame(votes, batch.bbox_trans)
    valid = votes.valid & (batch.class_ids[:, :1] >= 0)
    return Votes(kp2d=kp_internal, score=votes.score, valid=valid,
                 box_size=votes.box_size)


@torch.no_grad()
def teacher_votes(cfg: Config, cfg_t: Config, teacher_net: PoseNet,
                  batch: Batch) -> Votes:
    """Teacher forward (eval mode) + voted knowledge for one batch."""
    teacher_net.eval()
    t_cls, t_reg = teacher_net(batch.images)
    return teacher_knowledge(t_cls, t_reg, batch, cfg_t, cfg.kd.max_teacher_cells,
                             teacher_class=cfg.kd.teacher_class)


def _remat_contexts():
    """checkpoint's (forward, recompute) contexts: the re-run forward leaves
    the BN running statistics as the first run left them."""
    return contextlib.nullcontext(), frozen_batch_stats()


def build_train_step(cfg: Config, cfg_t: Optional[Config], consts: TaskConsts,
                     net: PoseNet, teacher_net: Optional[PoseNet],
                     optimizer: AdamW, distill: bool = True,
                     cached_votes: bool = False, mesh: Optional[DataMesh] = None):
    """Returns step_fn(state, batch, uniform=None, generator=None,
    votes=None) -> (state, metrics), metrics a dict of 0-dim tensors on the
    device.

    `uniform` (B, A, G) is SSC's draw for this step; without it the draw
    comes from `generator`. With distill=False (or no teacher) the teacher
    is skipped and loss_kd is 0. With cached_votes=True the step takes the
    batch's precomputed teacher `votes` (`precompute_pool_votes`) in place
    of running the teacher. The whole step, backward included, runs with
    TF32 off; with cfg.model.remat the student forward is rematerialized.

    With a `mesh` of more than one rank, each rank passes its own part of
    the global batch (and of `uniform`) and every rank must call the step:
    it takes the global step (module docstring), and the metrics are the
    global batch's (the losses and num_pos summed over the ranks, loss_kd
    the global mean), the same on every rank."""
    w_img, h_img = float(cfg.data.internal_width), float(cfg.data.internal_height)
    params = list(net.parameters())

    def step_fn(state: TrainState, batch: Batch,
                uniform: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                votes: Optional[Votes] = None):
        with full_fp32():
            return _step(state, batch, uniform, generator, votes)

    def _step(state, batch, uniform, generator, votes):
        teacher = None
        if distill and cached_votes:
            if votes is None:
                raise ValueError("a cached-votes step needs the batch's votes")
            teacher = (votes, w_img, h_img)
        elif distill and teacher_net is not None:
            teacher = (teacher_votes(cfg, cfg_t, teacher_net, batch), w_img, h_img)

        net.train()
        for p in params:
            p.grad = None
        # the backward runs inside too: remat's re-run forward takes the
        # global statistics again, its collectives in the same order on
        # every rank
        with global_batch_stats(net, mesh):
            if cfg.model.remat:
                cls_logits, pred_reg = checkpoint(net, batch.images, use_reentrant=False,
                                                  context_fn=_remat_contexts)
            else:
                cls_logits, pred_reg = net(batch.images)
            out = pose_losses(cls_logits, pred_reg, batch, consts, cfg,
                              teacher=teacher, uniform=uniform, generator=generator,
                              mesh=mesh)
            total = (cfg.solver.loss_weight_cls * out.loss_cls
                     + cfg.solver.loss_weight_reg * out.loss_reg)
            if teacher is not None and cfg.kd.weight > 0:
                total = total + cfg.kd.weight * out.loss_kd
            total.backward()
        # a parameter the loss does not reach (a head scale past num_levels)
        # has a zero gradient in JAX, and weight decay still applies to it
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if mesh is not None:
            # the gradient of the global loss: the sum of the ranks' (JAX's
            # psum; DDP's mean would be 1/W of it)
            all_reduce_(grads, mesh)
        opt_state, g_norm = optimizer.update(params, grads, state.opt_state)
        metrics: Dict[str, torch.Tensor] = {
            "loss_total": total.detach(),
            "loss_cls": out.loss_cls.detach(),
            "loss_reg": out.loss_reg.detach(),
            "loss_kd": out.loss_kd.detach(),
            "num_pos": out.num_pos,
            "grad_norm": g_norm,
        }
        if mesh is not None and mesh.distributed:
            summed = [k for k in metrics if k != "grad_norm"]
            vec = torch.stack([metrics[k].double() for k in summed])
            all_reduce_([vec], mesh)
            metrics.update({k: vec[i].to(metrics[k].dtype) for i, k in enumerate(summed)})
        return TrainState(step=state.step + 1, net=net, opt_state=opt_state), metrics

    return step_fn


def precompute_pool_votes(cfg: Config, cfg_t: Config, teacher_net: PoseNet,
                          pool: Batch) -> Votes:
    """The frozen teacher's voted knowledge for every batch of a device
    pool, once: one teacher forward and vote per pool batch, in sequence
    (peak memory is one batch's teacher activations), stacked along the
    pool axis. The teacher and a static pool do not change, so this equals
    what the live step computes each time it meets the batch. It runs in
    full fp32, as the step does: TF32 teacher maps would move the votes."""
    with full_fp32():
        return Votes.stack([teacher_votes(cfg, cfg_t, teacher_net, pool.take(i))
                            for i in range(int(pool.images.shape[0]))])


def build_multi_step(cfg: Config, cfg_t: Optional[Config], consts: TaskConsts,
                     net: PoseNet, teacher_net: Optional[PoseNet],
                     optimizer: AdamW, distill: bool, pool_size: int,
                     cached_votes: bool = False, mesh: Optional[DataMesh] = None):
    """K train steps per call over a device pool (a `Batch.stack`, leading
    axis pool_size): step i takes pool.take((start + i) % pool_size), the order
    `itertools.cycle` gives. Returns multi_fn(state, teacher_arg, pool,
    start, k, generator=None, uniforms=None) -> (state, metrics).

    - `teacher_arg` is the pool's `Votes` (`precompute_pool_votes`) when
      cached_votes, else unused (the live teacher is `teacher_net`).
    - SSC's draws come from `generator`, or step i takes `uniforms[i]`
      (uniforms (k, B, A, G)).
    - `start` and `k` are host ints; the call enqueues its k steps without
      a host sync.
    - metrics are the per-step means, except num_pos, the last step's, all
      device tensors (JAX `steps.py:224-228`).
    - Under a `mesh`, each rank's pool holds its part of every batch, and
      the steps are `build_train_step`'s global steps."""
    step_fn = build_train_step(cfg, cfg_t, consts, net, teacher_net, optimizer,
                               distill=distill, cached_votes=cached_votes, mesh=mesh)

    def multi_fn(state: TrainState, teacher_arg: Optional[Votes], pool: Batch,
                 start: int, k: int, generator: Optional[torch.Generator] = None,
                 uniforms: Optional[torch.Tensor] = None):
        per_step: List[Dict[str, torch.Tensor]] = []
        for i in range(k):
            idx = (start + i) % pool_size
            state, m = step_fn(state, pool.take(idx),
                               uniform=None if uniforms is None else uniforms[i],
                               generator=generator,
                               votes=teacher_arg.take(idx) if cached_votes else None)
            per_step.append(m)
        metrics = {key: per_step[-1][key] if key == "num_pos" else
                   torch.stack([m[key] for m in per_step]).mean()
                   for key in per_step[0]}
        return state, metrics

    return multi_fn


def build_kd_debug(cfg: Config, cfg_t: Config, consts: TaskConsts, net: PoseNet,
                   teacher_net: PoseNet):
    """The OT point clouds of a batch, for the cloud plots (JAX
    `steps.py:233-264`; the reference plots them from inside its loss,
    losses/kd_loss.py:88-97). Returns debug_fn(batch, uniform=None,
    generator=None) -> (x (B,8,P,2), y (B,8,T,2), a (B,8,P), b (B,8,T),
    img_valid (B,)) of `engine/losses.build_kd_clouds`.

    Teacher and student run their eval-mode forwards without a gradient
    (the student's eval stem is the K2 segment), the teacher's votes and
    SSC's targets (from `uniform` (B, A, G), else `generator`) as in the
    step, in full fp32 outside the networks' compute dtype. The student is
    left in the mode it was in."""
    w_img, h_img = float(cfg.data.internal_width), float(cfg.data.internal_height)
    anchors = torch.as_tensor(anchor_lib.make_anchors(
        cfg.model.input_res, cfg.model.level_strides, cfg.model.level_sizes))

    @torch.no_grad()
    def debug_fn(batch: Batch, uniform: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        was_training = net.training
        with full_fp32():
            teacher_net.eval()
            t_cls, t_reg = teacher_net(batch.images)
            votes = teacher_knowledge(t_cls, t_reg, batch, cfg_t, cfg.kd.max_teacher_cells,
                                      teacher_class=cfg.kd.teacher_class)
            net.eval()
            try:
                cls_logits, pred_reg = net(batch.images)
            finally:
                net.train(was_training)
            tgt = prepare_targets(batch, consts, cfg, uniform=uniform, generator=generator)
            pred16 = select_class_pred(pred_reg, tgt.cls_idx)
            inv_bt = coder.invert_bbox_trans(batch.bbox_trans)
            pred_xy = coder.decode(pred16, anchors.to(pred16.device), inv_bt[:, None])
            return build_kd_clouds(cls_logits, pred_xy, tgt, votes, cfg, w=w_img, h=h_img)

    return debug_fn
