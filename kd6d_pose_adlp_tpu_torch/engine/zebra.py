"""The dense binary-code (zebra) pose pipeline (port of
`kd6d_pose_adlp_tpu/engine/zebra.py`).

Every confident cell is one dense 2D-3D correspondence instead of a vote of
8 bbox corners: the cell regresses the hierarchical binary code
(`ops/binary_code`) of the surface point it corresponds to, and that
point's 2D offset from the anchor centre. Decoding a cell's code picks a
vertex, and RANSAC-EPnP (+LHM) runs over the decoded pairs. A frozen zebra
teacher's per-cell code probabilities are soft BCE targets for the
student on the same cells: dense distillation with no optimal transport.

Fixed shapes throughout: the targets compact the SSC positives into
`solver.max_pos` slots, so the nearest-vertex search is (B, P, V). SSC's
draw comes in as `uniform` (B, A, G) or from a `torch.Generator`, RANSAC's
as `gumbel` (B, iters, max_votes), as in `engine/losses` and
`engine/postprocess`. Selections keep XLA's order on ties (the lower index
first): a stable descending sort and a slice for top-k, `torch.argmin`'s
first minimum for argmin. Everything but the networks runs in full fp32.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from ..config import Config
from ..data.batch import Batch, TaskConsts
from ..models import anchors as anchor_lib
from ..models import coder
from ..models.pose_net import PoseNet
from ..ops import ssc
from ..ops.binary_code import code_bce, decode_vertex
from ..ops.epnp import sample_gumbel
from ..ops.focal import sigmoid_focal_loss
from ..utils.precision import full_fp32
from . import postprocess  # noqa: F401 (registers torch.ops.kd6d.solve_pose)
from .losses import _take
from .steps import AdamW, TrainState


class ZebraTargets(NamedTuple):
    labels: torch.Tensor    # (B, A) SSC labels in {-1, 0, 1..C}
    sidx: torch.Tensor      # (B, P) compacted positive cell indices
    s_valid: torch.Tensor   # (B, P) bool: the slot holds a real positive
    cls_idx: torch.Tensor   # (B, P) matched 0-based class
    code_tgt: torch.Tensor  # (B, P, n_bits) target codes in {0, 1}
    off_tgt: torch.Tensor   # (B, P, 2) target offset (anchor-normalized)
    pt3d: torch.Tensor      # (B, P, 3) corresponded vertex, object frame (mm)


def _anchors(cfg: Config, device) -> torch.Tensor:
    m = cfg.model
    return torch.as_tensor(anchor_lib.make_anchors(m.input_res, tuple(m.level_strides),
                                                   tuple(m.level_sizes)), device=device)


def zebra_targets(batch: Batch, consts: TaskConsts, cfg: Config,
                  uniform: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> ZebraTargets:
    """SSC assignment, then per positive slot the nearest-vertex
    correspondence: the class vertex whose projection (through the matched
    GT pose and the crop affine) lies nearest the cell's anchor centre."""
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
    pos_mask = labels > 0                                         # (B,A)

    sidx = torch.sort(pos_mask.to(torch.float32), dim=1, descending=True,
                      stable=True).indices[:, :s.max_pos]         # (B,P)
    s_valid = torch.gather(pos_mask, 1, sidx)
    g = torch.gather(matched, 1, sidx)                            # (B,P)
    cls_idx = torch.gather(cls_safe, 1, g)                        # (B,P)

    R, T = _take(batch.rotations, g), _take(batch.translations, g)
    verts = consts.verts[cls_idx]                                 # (B,P,V,3)
    proj = coder.project_corners(consts.K, R, T, verts,
                                 batch.bbox_trans[:, None])       # (B,P,V,2)
    a_sel = _anchors(cfg, proj.device)[sidx]                      # (B,P,4)
    center, wh = a_sel[..., :2], a_sel[..., 2:]

    d2 = ((proj - center[..., None, :]) ** 2).sum(-1)             # (B,P,V)
    vidx = torch.argmin(d2, dim=-1)                               # (B,P)
    pt2d = torch.gather(proj, 2, vidx[..., None, None].expand(
        vidx.shape + (1, 2)))[:, :, 0]
    return ZebraTargets(labels=labels, sidx=sidx, s_valid=s_valid, cls_idx=cls_idx,
                        code_tgt=consts.vert_codes[cls_idx, vidx],
                        off_tgt=(pt2d - center) / wh,
                        pt3d=consts.verts[cls_idx, vidx])


def select_cell_codes(code_pred: torch.Tensor, sidx: torch.Tensor,
                      cls_idx: torch.Tensor, n_fg: int, n_bits: int):
    """The (code logits, offset) of each (cell, class) pair: code_pred (B, A,
    n_fg*(n_bits+2)); sidx, cls_idx (B, P) -> ((B, P, n_bits), (B, P, 2))."""
    B, P = sidx.shape
    sel = _take(code_pred, sidx).reshape(B, P, n_fg, n_bits + 2)
    sel = torch.gather(sel, 2, cls_idx[..., None, None].expand(B, P, 1, n_bits + 2))[:, :, 0]
    return sel[..., :n_bits], sel[..., n_bits:]


def _smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


class ZebraLossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_code: torch.Tensor
    loss_off: torch.Tensor
    loss_kd: torch.Tensor
    num_pos: torch.Tensor


def zebra_losses(cls_logits: torch.Tensor, code_pred: torch.Tensor, batch: Batch,
                 consts: TaskConsts, cfg: Config, n_fg: int,
                 teacher_codes: Optional[tuple] = None,
                 uniform: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> ZebraLossOut:
    """Focal on the classes (the corner head's), per-bit BCE on the surface
    code and SmoothL1 on the 2D offset, raw sums over the positive slots.

    teacher_codes, when given, is (t_code_pred (B, A, n_fg*(nb+2)),
    t_cls_logits (B, A, n_fg)) of a frozen zebra teacher: the student's
    positive slots also match the teacher's code probabilities (soft BCE),
    weighted by the teacher's own class score at that cell."""
    s = cfg.solver
    n_bits = cfg.model.code_bits
    tgt = zebra_targets(batch, consts, cfg, uniform=uniform, generator=generator)

    loss_cls = sigmoid_focal_loss(cls_logits, tgt.labels, gamma=s.focal_gamma,
                                  alpha=s.focal_alpha)
    code_logits, off_pred = select_cell_codes(code_pred, tgt.sidx, tgt.cls_idx,
                                              n_fg, n_bits)
    w = tgt.s_valid.to(torch.float32)
    loss_code = code_bce(code_logits, tgt.code_tgt, w)
    loss_off = (_smooth_l1(off_pred - tgt.off_tgt).sum(-1) * w).sum()

    loss_kd = torch.zeros((), device=cls_logits.device)
    if teacher_codes is not None:
        t_code_pred, t_cls_logits = teacher_codes
        t_logits, _ = select_cell_codes(t_code_pred, tgt.sidx, tgt.cls_idx, n_fg, n_bits)
        t_scores = _take(torch.sigmoid(t_cls_logits), tgt.sidx)   # (B,P,nfg)
        t_conf = torch.gather(t_scores, 2, tgt.cls_idx[..., None])[..., 0]
        loss_kd = code_bce(code_logits, torch.sigmoid(t_logits), t_conf.detach() * w)
    return ZebraLossOut(loss_cls=loss_cls, loss_code=loss_code, loss_off=loss_off,
                        loss_kd=loss_kd, num_pos=tgt.s_valid.sum())


def build_zebra_train_step(cfg: Config, consts: TaskConsts, net: PoseNet,
                           teacher_net: Optional[PoseNet], optimizer: AdamW,
                           n_fg: int, distill: bool = False):
    """Returns step_fn(state, batch, uniform=None, generator=None) ->
    (state, metrics), metrics a dict of 0-dim device tensors with JAX's
    names (`zebra.py:210-213`).

    With distill and a teacher, the frozen zebra teacher runs in eval mode
    without gradients first. The student runs in train mode (its BN
    statistics update once), then the losses, the backward and AdamW
    (`engine/steps.AdamW`), all in full fp32 whatever the caller's TF32
    flags. SSC's draw is `uniform` (B, A, G), or comes from `generator`."""
    params = list(net.parameters())
    use_teacher = distill and teacher_net is not None

    def step_fn(state: TrainState, batch: Batch,
                uniform: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        with full_fp32():
            return _step(state, batch, uniform, generator)

    def _step(state, batch, uniform, generator):
        teacher = None
        if use_teacher:
            teacher_net.eval()
            with torch.no_grad():
                t_cls, _, t_code = teacher_net(batch.images)
            teacher = (t_code, t_cls)

        net.train()
        for p in params:
            p.grad = None
        cls_logits, _, code_pred = net(batch.images)
        out = zebra_losses(cls_logits, code_pred, batch, consts, cfg, n_fg,
                           teacher_codes=teacher, uniform=uniform, generator=generator)
        total = (cfg.solver.loss_weight_cls * out.loss_cls
                 + cfg.solver.loss_weight_code * out.loss_code
                 + cfg.solver.loss_weight_code_off * out.loss_off)
        if teacher is not None and cfg.kd.weight > 0:
            total = total + cfg.kd.weight * out.loss_kd
        total.backward()
        # a parameter the loss does not reach (the corner head's pose_pred,
        # a head scale) has a zero gradient in JAX; weight decay still moves it
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        opt_state, g_norm = optimizer.update(params, grads, state.opt_state)
        metrics: Dict[str, torch.Tensor] = {
            "loss_total": total.detach(), "loss_cls": out.loss_cls.detach(),
            "loss_code": out.loss_code.detach(), "loss_off": out.loss_off.detach(),
            "loss_kd": out.loss_kd.detach(), "num_pos": out.num_pos,
            "grad_norm": g_norm}
        return TrainState(step=state.step + 1, net=net, opt_state=opt_state), metrics

    return step_fn


def build_zebra_multi_step(cfg: Config, consts: TaskConsts, net: PoseNet,
                           teacher_net: Optional[PoseNet], optimizer: AdamW,
                           n_fg: int, pool_size: int, distill: bool = False):
    """K zebra steps per call over a device pool (a `Batch.stack`): step i
    takes pool.take((start + i) % pool_size). Returns multi_fn(state, pool,
    start, k, generator=None, uniforms=None) -> (state, metrics); SSC's
    draws come from `generator`, or step i takes `uniforms[i]` (uniforms
    (k, B, A, G)). The metrics are the means over the k steps, except
    num_pos, the last step's (JAX `zebra.py:239-240`)."""
    step_fn = build_zebra_train_step(cfg, consts, net, teacher_net, optimizer, n_fg,
                                     distill=distill)

    def multi_fn(state: TrainState, pool: Batch, start: int, k: int,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[torch.Tensor] = None):
        per_step: List[Dict[str, torch.Tensor]] = []
        for i in range(k):
            state, m = step_fn(state, pool.take((start + i) % pool_size),
                               uniform=None if uniforms is None else uniforms[i],
                               generator=generator)
            per_step.append(m)
        metrics = {key: per_step[-1][key] if key == "num_pos" else
                   torch.stack([m[key] for m in per_step]).mean()
                   for key in per_step[0]}
        return state, metrics

    return multi_fn


def build_zebra_postprocess(cfg: Config, consts: TaskConsts, n_fg: int):
    """Returns predict(cls_logits, code_pred, class_ids, bbox_trans,
    generator=None, gumbel=None) -> dict with R (B,3,3), T (B,3), score
    (B,), cls (B,), n_inliers (B,), valid (B,), pt2d (B,K,2) and pt_valid
    (B,K), K = test.max_votes: the corner postprocess's keys, solved from
    dense correspondences.

    class_ids (B,) is the class to solve per image (negative = invalid).
    The top K cells by that class's score (a stable sort: the lower cell
    first on ties) each decode to one (vertex, 2D point) pair, the point
    mapped from the crop to the internal frame; `kd6d::solve_pose`
    (RANSAC-EPnP, then LHM on the inliers or on every valid point below 6,
    JAX `zebra.py:427-442`) solves them. RANSAC's draws come from
    `generator`, or are injected as `gumbel` (B, ransac_iters, K)."""
    t = cfg.test
    n_bits = cfg.model.code_bits
    anchors = _anchors(cfg, consts.K.device)

    def predict(cls_logits: torch.Tensor, code_pred: torch.Tensor,
                class_ids: torch.Tensor, bbox_trans: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        with full_fp32():
            B, A, _ = cls_logits.shape
            class_ids = class_ids.to(torch.int64)
            gt_cls = class_ids.clamp_min(0)
            scores = torch.sigmoid(cls_logits)
            s = torch.gather(scores, 2, gt_cls[:, None, None].expand(B, A, 1))[..., 0]
            K = t.max_votes
            top = torch.sort(s, dim=1, descending=True, stable=True)
            top_s, sidx = top.values[:, :K], top.indices[:, :K]   # (B,K)
            valid = top_s > t.confidence_th

            code_logits, off = select_cell_codes(code_pred, sidx, gt_cls[:, None].expand(B, K),
                                                 n_fg, n_bits)
            vidx = decode_vertex(torch.sigmoid(code_logits), consts.vert_codes[gt_cls])
            pt3d = consts.verts[gt_cls[:, None], vidx]            # (B,K,3)

            a_sel = anchors[sidx]                                 # (B,K,4)
            pt2d_crop = a_sel[..., :2] + off * a_sel[..., 2:]
            inv_bt = coder.invert_bbox_trans(bbox_trans.to(torch.float32))
            pt2d = coder._matvec(inv_bt[:, :2, :2], pt2d_crop) + inv_bt[:, None, :2, 2]

            if gumbel is None:
                gumbel = sample_gumbel((B, t.ransac_iters, K), generator, pt3d.device)
            R, T, n_in = torch.ops.kd6d.solve_pose(
                pt3d, pt2d, valid, consts.K, gumbel, t.ransac_iters,
                t.ransac_reproj_err, t.lhm_iters)
            conf = torch.sqrt(torch.where(valid, top_s, torch.zeros_like(top_s)).amax(dim=1))
            return dict(R=R, T=T, score=conf, cls=gt_cls.to(torch.int32), n_inliers=n_in,
                        valid=valid.any(-1) & (class_ids >= 0), pt2d=pt2d, pt_valid=valid)

    return predict
