"""Loss assembly: SSC targets + focal + object-space + OT distillation
(port of `kd6d_pose_adlp_tpu/engine/losses.py:28-187`).

All terms are unnormalized sums like the reference; the train step applies
the loss weights (cls 0.1, reg 1, kd `kd.weight`). Under a data mesh each
rank's terms are its local parts of the global batch's sums: the OT loss
divides by the global count of valid images (`kd_ot_loss`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import Config
from ..data.batch import Batch, TaskConsts
from ..models import anchors as anchor_lib
from ..models import coder
from ..ops import sinkhorn_fused, ssc
from ..ops.focal import sigmoid_focal_loss
from ..ops.object_space import image_space_loss, object_space_loss, select_class_pred
from ..ops.sinkhorn import batched_samples_loss
from ..ops.voting import Votes
from ..parallel.mesh import DataMesh, all_reduce_


class Targets(NamedTuple):
    labels: torch.Tensor     # (B, A) in {-1, 0, 1..C}
    cls_idx: torch.Tensor    # (B, A) matched 0-based class
    kp3d_cam: torch.Tensor   # (B, A, 8, 3) matched GT corners, camera frame
    kp2d_tgt: torch.Tensor   # (B, A, 8, 2) matched GT corner projections, crop frame
    pos_mask: torch.Tensor   # (B, A) bool


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis over dim 1 for (B, n, ...) x and (B, k) idx."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def prepare_targets(batch: Batch, consts: TaskConsts, cfg: Config,
                    uniform: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> Targets:
    """SSC assignment + per-cell matched GT gathering. `uniform` (B, A, G) is
    SSC's random draw; without it `generator` supplies one."""
    m, s = cfg.model, cfg.solver
    cls_safe = batch.class_ids.clamp_min(0).to(torch.int64)
    corners = consts.kp3d[cls_safe]                               # (B,G,8,3)
    kp2d_gt = coder.project_corners(consts.K, batch.rotations, batch.translations,
                                    corners, batch.bbox_trans[:, None])  # (B,G,8,2)

    labels, matched = ssc.ssc_assign(
        batch.mask, batch.class_ids, kp2d_gt,
        input_res=m.input_res, strides=m.level_strides, sizes=m.level_sizes,
        positive_num=s.positive_num, positive_lambda=s.positive_lambda,
        uniform=uniform, generator=generator)

    kp3d_cam_gt = coder._matvec(batch.rotations, corners) \
        + batch.translations[:, :, None, :]                       # (B,G,8,3)
    return Targets(labels=labels, cls_idx=torch.gather(cls_safe, 1, matched),
                   kp3d_cam=_take(kp3d_cam_gt, matched),
                   kp2d_tgt=_take(kp2d_gt, matched), pos_mask=labels > 0)


class LossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_reg: torch.Tensor
    loss_kd: torch.Tensor
    num_pos: torch.Tensor


def pose_losses(cls_logits: torch.Tensor,   # (B, A, n_fg)
                pred_reg: torch.Tensor,     # (B, A, n_fg*16)
                batch: Batch, consts: TaskConsts, cfg: Config,
                teacher: Optional[tuple] = None,  # (Votes, w_img, h_img)
                uniform: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mesh: Optional[DataMesh] = None) -> LossOut:
    m, s = cfg.model, cfg.solver
    tgt = prepare_targets(batch, consts, cfg, uniform=uniform, generator=generator)

    loss_cls = sigmoid_focal_loss(cls_logits, tgt.labels,
                                  gamma=s.focal_gamma, alpha=s.focal_alpha)

    anchors = torch.as_tensor(anchor_lib.make_anchors(
        m.input_res, m.level_strides, m.level_sizes), device=cls_logits.device)
    pred16 = select_class_pred(pred_reg, tgt.cls_idx)             # (B,A,16)
    inv_bt = coder.invert_bbox_trans(batch.bbox_trans)            # (B,2,3)
    pred_xy = coder.decode(pred16, anchors, inv_bt[:, None])      # (B,A,8,2) internal

    if s.loss_reg_type == "3D":
        loss_reg = object_space_loss(pred_xy, tgt.kp3d_cam, tgt.cls_idx,
                                     tgt.pos_mask, consts.inv_K, consts.diameters)
    else:
        tgt_xy = coder.decode(coder.encode(tgt.kp2d_tgt, anchors), anchors,
                              inv_bt[:, None])
        loss_reg = image_space_loss(pred_xy, tgt_xy, tgt.pos_mask)

    loss_kd = torch.zeros((), device=cls_logits.device)
    if teacher is not None:
        votes, w_img, h_img = teacher
        loss_kd = kd_ot_loss(cls_logits, pred_xy, tgt, votes, cfg, w=w_img, h=h_img,
                             mesh=mesh)
    return LossOut(loss_cls=loss_cls, loss_reg=loss_reg, loss_kd=loss_kd,
                   num_pos=tgt.pos_mask.sum())


def build_kd_clouds(cls_logits, pred_xy, tgt: Targets, votes: Votes, cfg: Config,
                    w: float = 640.0, h: float = 480.0):
    """Student/teacher point clouds + weights for the OT loss. Returns
    (x (B,8,P,2), y (B,8,T,2), a (B,8,P), b (B,8,T), img_valid (B,)) in the
    normalized internal frame. The positives are compacted into P slots by
    a stable descending sort of the 0/1 mask (XLA top_k's order: the lower
    cell index first)."""
    kd = cfg.kd
    P = cfg.solver.max_pos
    dev = pred_xy.device
    wh = torch.tensor([w, h], dtype=torch.float32, device=dev)

    sidx = torch.sort(tgt.pos_mask.to(torch.float32), dim=1, descending=True,
                      stable=True).indices[:, :P]                 # (B,P)
    s_valid = torch.gather(tgt.pos_mask, 1, sidx)
    s_xy = _take(pred_xy, sidx) / wh                              # (B,P,8,2)

    # per-cell score of its matched class
    scores = torch.sigmoid(cls_logits)
    s_cls = torch.gather(scores, 2, tgt.cls_idx[..., None])[..., 0]
    s_cls = s_cls.clamp(1e-3, 1 - 1e-3)
    if kd.wot_detach:
        s_cls = s_cls.detach()
    zero = torch.zeros((), device=dev)
    s_w = torch.where(s_valid, torch.gather(s_cls, 1, sidx), zero)

    t_xy = votes.kp2d / wh                                        # (B,T,8,2)
    t_w = torch.where(votes.valid, votes.score, zero)             # (B,T)

    img_valid = s_valid.any(-1) & votes.valid.any(-1)             # (B,)
    # sanitize empty clouds so the solver stays finite; masked out afterwards
    s_w_safe = torch.where(img_valid[:, None], s_w, torch.ones_like(s_w) / s_w.shape[1])
    t_w_safe = torch.where(img_valid[:, None], t_w, torch.ones_like(t_w) / t_w.shape[1])
    if not kd.weighted_ot:
        one = torch.ones((), device=dev)
        s_w_safe = torch.where(img_valid[:, None], torch.where(s_valid, one, zero),
                               torch.ones_like(s_w) / s_w.shape[1])
        t_w_safe = torch.where(img_valid[:, None], torch.where(votes.valid, one, zero),
                               torch.ones_like(t_w) / t_w.shape[1])

    x = s_xy.transpose(1, 2)                                      # (B,8,P,2)
    y = t_xy.transpose(1, 2)                                      # (B,8,T,2)
    a = s_w_safe[:, None, :].expand(x.shape[:3])
    b = t_w_safe[:, None, :].expand(y.shape[:3])
    return x, y, a, b, img_valid


def kd_ot_loss(cls_logits, pred_xy, tgt: Targets, votes: Votes, cfg: Config,
               w: float = 640.0, h: float = 480.0,
               mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """Distribution-alignment OT loss: per image and keypoint index k, a
    weighted Sinkhorn divergence between the student's positive-cell
    keypoint cloud and the teacher's voted-cell cloud, in the normalized
    internal frame; images with an empty cloud on either side are skipped
    from the mean.

    With gtype="sinkhorn" the potentials are always solved by K1's wrapper
    (`ops/sinkhorn_fused.solve_potentials`): the CUDA kernel on the card,
    its plain version on the CPU, whatever `kd.use_pallas` says.

    Under a `mesh` of more than one rank the mean is over the global batch's
    valid images: their count is summed over the ranks (a count, no
    gradient), and each rank returns its own images' part of the global
    mean."""
    kd = cfg.kd
    x, y, a, b, img_valid = build_kd_clouds(cls_logits, pred_xy, tgt, votes,
                                            cfg, w=w, h=h)
    per_k = batched_samples_loss(
        x, y, a, b, gtype=kd.gtype, p=kd.p, blur=kd.blur,
        scaling=kd.scaling, reach=kd.reach, diameter=2.0,
        solve=sinkhorn_fused.solve_potentials)                     # (B,8)
    per_img = per_k.sum(-1)
    n_valid = img_valid.sum()
    if mesh is not None:
        all_reduce_([n_valid], mesh)
    n_valid = n_valid.clamp_min(1)
    return (per_img * img_valid).sum() / n_valid
