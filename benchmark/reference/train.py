"""The reference training step: teacher forward and votes (distillation),
student forward and backward in train mode, the losses, the global-norm
clip and AdamW with the OneCycle learning rate, one leaf at a time.

The optimizer is optax's `chain(clip_by_global_norm(clip), adamw(lr, 0.9,
0.999, 1e-8, weight_decay))`, which the reference's torch AdamW with
`clip_grad_norm_` follows up to the clip's divisor: g * clip / |g| where
|g| >= clip; m, v moments; bias corrections 1 - b^t in float32; the update
(m_hat / (sqrt(v_hat) + eps) + wd * p) * lr(t - 1). The learning rate is
torch's OneCycleLR(anneal_strategy='linear', pct_start 0.05, div 25,
final div 1e4) over max_iter + 100 steps, boundaries in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .losses import pose_losses, teacher_knowledge
from .net import PoseNet

_f32 = np.float32


def onecycle_lr(max_lr: float, total: int, pct_start: float = 0.05,
                div: float = 25.0, final_div: float = 1e4):
    initial = max_lr / div
    final = initial / final_div
    up = max(int(pct_start * total) - 1, 1)
    down = max(total - up - 1, 1)

    def ramp(step, a, b, off, n):
        frac = np.clip((_f32(step) - _f32(off)) / _f32(n), _f32(0), _f32(1))
        return float(_f32(a) + _f32(b - a) * frac)

    return lambda step: (ramp(step, initial, max_lr, 0, up) if _f32(step) <= _f32(up)
                         else ramp(step, max_lr, final, up, down))


class AdamW:
    def __init__(self, params: List[torch.Tensor], cfg):
        s = cfg.solver
        self.params = params
        self.lr = onecycle_lr(s.base_lr, s.max_iter + 100)
        self.clip, self.wd = s.grad_clip, s.weight_decay
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Updates the parameters in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        clipped = [g * scale for g in grads]
        lr = self.lr(self.t)
        self.t += 1
        bc1 = float(_f32(1) - _f32(self.b1) ** _f32(self.t))
        bc2 = float(_f32(1) - _f32(self.b2) ** _f32(self.t))
        for p, g, m, v in zip(self.params, clipped, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.wd * p
            p.add_(u, alpha=-lr)
        return clipped


def build(cfg, state: Dict[str, torch.Tensor], device,
          cfg_t=None, teacher_state: Optional[Dict[str, torch.Tensor]] = None):
    """The reference student (and BN-folded teacher) from the benchmark's
    weights: (student, teacher or None, optimizer)."""
    net = PoseNet(cfg.model, cfg.n_fg).to(device)
    net.load_state_dict(state, strict=True)
    teacher = None
    if teacher_state is not None:
        from .net import fold_bn
        teacher = PoseNet(cfg_t.model, cfg.n_fg, folded=True).to(device)
        teacher.load_state_dict(fold_bn(teacher_state), strict=True)
        teacher.eval()
    return net, teacher, AdamW(list(net.parameters()), cfg)


def step(cfg, cfg_t, net: PoseNet, teacher: Optional[PoseNet], opt: AdamW,
         batch, consts, uniform, keep_half: bool = False
         ) -> Tuple[float, List[torch.Tensor]]:
    """One step -> (total loss, the clipped gradients AdamW took).

    `keep_half` leaves out the second half of the batch and scales the
    summed terms (focal, object space) by two, the KD term being a mean
    already: the mean taken over the rest, a fault the comparison has to
    catch."""
    if keep_half:
        half = batch["images"].shape[0] // 2
        batch = {k: v[:half] for k, v in batch.items()}
        uniform = uniform[:half]
    votes = None
    if teacher is not None and cfg.kd.weight > 0:
        with torch.no_grad():
            t_cls, t_reg = teacher(batch["images"])
            votes = teacher_knowledge(t_cls, t_reg, batch, cfg_t, cfg.kd.max_teacher_cells)
    net.train()
    for p in net.parameters():
        p.grad = None
    cls, reg = net(batch["images"])
    l_cls, l_reg, l_kd, _ = pose_losses(cls, reg, batch, consts, cfg, uniform, votes)
    total = cfg.solver.loss_weight_cls * l_cls + cfg.solver.loss_weight_reg * l_reg
    if keep_half:
        total = 2 * total
    if votes is not None:
        total = total + cfg.kd.weight * l_kd
    total.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in net.parameters()]
    clipped = opt.step(grads)
    return float(total.detach()), clipped


def leaf_norms(tensors: List[torch.Tensor]) -> List[float]:
    return [math.sqrt(float((t.double() ** 2).sum())) for t in tensors]
