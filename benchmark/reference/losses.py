"""The reference's training objective: SSC targets, focal, object-space and
the Sinkhorn KD term, and the teacher's voted knowledge (frozen copy of the
plain PyTorch in `kd6d_pose_adlp_tpu_torch/engine/losses.py` and
`engine/steps.teacher_knowledge`, on one process, with the potentials from
the plain annealing loop `sinkhorn.solve_potentials_plain`).

Every term is an unnormalized sum as in the reference; `total` applies the
loss weights. A batch is a dict of tensors: images (B, R, R, 3) float
normalized RGB, mask (B, R, R) int32, class_ids (B, G) int32, rotations
(B, G, 3, 3), translations (B, G, 3), bbox_trans (B, 2, 3); `consts` a dict
of K, inv_K (3, 3), kp3d (n_fg, 8, 3) and diameters (n_fg,).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import anchors as anchor_lib
from . import coder, ssc
from .focal import sigmoid_focal_loss
from .object_space import object_space_loss, select_class_pred
from .sinkhorn import sinkhorn_divergence, solve_potentials_plain
from .voting import Votes, vote_cells, votes_to_internal_frame


class Targets(NamedTuple):
    labels: torch.Tensor
    cls_idx: torch.Tensor
    kp3d_cam: torch.Tensor
    kp2d_tgt: torch.Tensor
    pos_mask: torch.Tensor


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def prepare_targets(batch, consts, cfg, uniform: torch.Tensor) -> Targets:
    m, s = cfg.model, cfg.solver
    cls_safe = batch["class_ids"].clamp_min(0).to(torch.int64)
    corners = consts["kp3d"][cls_safe]
    kp2d_gt = coder.project_corners(consts["K"], batch["rotations"], batch["translations"],
                                    corners, batch["bbox_trans"][:, None])
    labels, matched = ssc.ssc_assign(
        batch["mask"], batch["class_ids"], kp2d_gt, input_res=m.input_res,
        strides=m.level_strides, sizes=m.level_sizes, positive_num=s.positive_num,
        positive_lambda=s.positive_lambda, uniform=uniform)
    kp3d_cam = coder._matvec(batch["rotations"], corners) + batch["translations"][:, :, None, :]
    return Targets(labels=labels, cls_idx=torch.gather(cls_safe, 1, matched),
                   kp3d_cam=_take(kp3d_cam, matched), kp2d_tgt=_take(kp2d_gt, matched),
                   pos_mask=labels > 0)


def teacher_knowledge(t_cls, t_reg, batch, cfg_t, max_votes: int) -> Votes:
    """The teacher's votes of each image's ground-truth class, in the
    internal frame (teacher class "gt")."""
    m = cfg_t.model
    scores = torch.sigmoid(t_cls)
    B, A, _ = scores.shape
    voted = batch["class_ids"][:, 0].clamp_min(0).to(torch.int64)
    s = torch.gather(scores, 2, voted[:, None, None].expand(B, A, 1))[..., 0]
    pred16 = select_class_pred(t_reg, voted[:, None].expand(B, A))
    votes = vote_cells(s, pred16, input_res=m.input_res, strides=m.level_strides,
                       all_sizes=m.anchor_sizes, confidence_th=cfg_t.test.confidence_th,
                       positive_num=cfg_t.solver.positive_num,
                       positive_lambda=cfg_t.solver.positive_lambda, max_votes=max_votes)
    kp = votes_to_internal_frame(votes, batch["bbox_trans"])
    valid = votes.valid & (batch["class_ids"][:, :1] >= 0)
    return Votes(kp2d=kp, score=votes.score, valid=valid, box_size=votes.box_size)


def kd_ot_loss(cls_logits, pred_xy, tgt: Targets, votes: Votes, cfg,
               w: float, h: float) -> torch.Tensor:
    kd = cfg.kd
    P = cfg.solver.max_pos
    dev = pred_xy.device
    wh = torch.tensor([w, h], dtype=torch.float32, device=dev)
    sidx = torch.sort(tgt.pos_mask.to(torch.float32), dim=1, descending=True,
                      stable=True).indices[:, :P]
    s_valid = torch.gather(tgt.pos_mask, 1, sidx)
    s_xy = _take(pred_xy, sidx) / wh
    scores = torch.sigmoid(cls_logits)
    s_cls = torch.gather(scores, 2, tgt.cls_idx[..., None])[..., 0].clamp(1e-3, 1 - 1e-3)
    zero = torch.zeros((), device=dev)
    s_w = torch.where(s_valid, torch.gather(s_cls, 1, sidx), zero)
    t_xy = votes.kp2d / wh
    t_w = torch.where(votes.valid, votes.score, zero)
    img_valid = s_valid.any(-1) & votes.valid.any(-1)
    s_w = torch.where(img_valid[:, None], s_w, torch.ones_like(s_w) / s_w.shape[1])
    t_w = torch.where(img_valid[:, None], t_w, torch.ones_like(t_w) / t_w.shape[1])
    if not kd.weighted_ot:
        one = torch.ones((), device=dev)
        s_w = torch.where(img_valid[:, None], torch.where(s_valid, one, zero), s_w)
        t_w = torch.where(img_valid[:, None], torch.where(votes.valid, one, zero), t_w)
    x = s_xy.transpose(1, 2)
    y = t_xy.transpose(1, 2)
    a = s_w[:, None, :].expand(x.shape[:3])
    b = t_w[:, None, :].expand(y.shape[:3])
    if kd.gtype != "sinkhorn":
        raise ValueError(f"the reference computes the Sinkhorn KD term only, not {kd.gtype!r}")
    per_k = sinkhorn_divergence(x, y, a, b, solve=solve_potentials_plain, p=kd.p,
                                blur=kd.blur, scaling=kd.scaling, reach=kd.reach,
                                diameter=2.0)
    return (per_k.sum(-1) * img_valid).sum() / img_valid.sum().clamp_min(1)


def pose_losses(cls_logits, pred_reg, batch, consts, cfg, uniform,
                votes: Optional[Votes] = None):
    """-> (loss_cls, loss_reg, loss_kd, num_pos)."""
    m, s = cfg.model, cfg.solver
    tgt = prepare_targets(batch, consts, cfg, uniform)
    loss_cls = sigmoid_focal_loss(cls_logits, tgt.labels, gamma=s.focal_gamma,
                                  alpha=s.focal_alpha)
    anchors = torch.as_tensor(anchor_lib.make_anchors(m.input_res, m.level_strides,
                                                      m.level_sizes), device=cls_logits.device)
    pred16 = select_class_pred(pred_reg, tgt.cls_idx)
    inv_bt = coder.invert_bbox_trans(batch["bbox_trans"])
    pred_xy = coder.decode(pred16, anchors, inv_bt[:, None])
    if s.loss_reg_type != "3D":
        raise ValueError("the reference computes the object-space (3D) loss only")
    loss_reg = object_space_loss(pred_xy, tgt.kp3d_cam, tgt.cls_idx, tgt.pos_mask,
                                 consts["inv_K"], consts["diameters"])
    loss_kd = torch.zeros((), device=cls_logits.device)
    if votes is not None:
        loss_kd = kd_ot_loss(cls_logits, pred_xy, tgt, votes, cfg,
                             float(cfg.data.internal_width), float(cfg.data.internal_height))
    return loss_cls, loss_reg, loss_kd, tgt.pos_mask.sum()
