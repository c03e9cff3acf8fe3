"""Inference postprocess: dense predictions -> 6D poses on device (port of
`kd6d_pose_adlp_tpu/engine/postprocess.py`, the single-class path).

threshold -> per-level quota voting -> inverse crop affine -> RANSAC-EPnP ->
LHM refinement on the RANSAC inliers. `mode="multi"` and the host-side
symmetry canonicalization wait for later slices.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import Config
from ..data.batch import TaskConsts
from ..ops.epnp import full_fp32, lhm_refine, ransac_epnp, reprojection_errors
from ..ops.object_space import select_class_pred
from ..ops.smallalg import inv3
from ..ops.voting import vote_cells, votes_to_internal_frame


def build_postprocess(cfg: Config, consts: TaskConsts):
    """Returns predict(cls_logits, pred_reg, class_ids, bbox_trans,
    generator=None, gumbel=None) -> dict with R (B,3,3), T (B,3), score (B,),
    cls (B,), n_inliers (B,), valid (B,), kp2d (B,V,8,2), vote_valid (B,V).

    class_ids (B,) is the class to solve per image (negative = invalid);
    RANSAC draws come from `generator`, or are injected as `gumbel`
    (B, ransac_iters, max_votes * 8)."""
    m, t = cfg.model, cfg.test

    def predict(cls_logits: torch.Tensor, pred_reg: torch.Tensor,
                class_ids: torch.Tensor, bbox_trans: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        with full_fp32():
            class_ids = class_ids.to(torch.int64)
            gt_cls = class_ids.clamp_min(0)
            B, A, _ = cls_logits.shape
            scores = torch.sigmoid(cls_logits)
            s = torch.gather(scores, 2, gt_cls[:, None, None].expand(B, A, 1))[..., 0]
            pred16 = select_class_pred(pred_reg, gt_cls[:, None].expand(B, A))
            votes = vote_cells(
                s, pred16, input_res=m.input_res, strides=m.level_strides,
                all_sizes=m.anchor_sizes, confidence_th=t.confidence_th,
                positive_num=cfg.solver.positive_num,
                positive_lambda=cfg.solver.positive_lambda,
                max_votes=t.max_votes)
            kp_internal = votes_to_internal_frame(votes, bbox_trans.to(torch.float32))

            V = kp_internal.shape[1]
            corners = consts.kp3d[gt_cls]                           # (B, 8, 3)
            pts3d = corners[:, None].expand(B, V, 8, 3).reshape(B, V * 8, 3)
            pts2d = kp_internal.reshape(B, V * 8, 2)
            valid = votes.valid[:, :, None].expand(B, V, 8).reshape(B, V * 8)

            K = consts.K
            R, T, n_in = ransac_epnp(pts3d, pts2d, valid, K,
                                     iters=t.ransac_iters,
                                     reproj_err=t.ransac_reproj_err,
                                     gumbel=gumbel, generator=generator)
            if t.lhm_iters > 0:
                # object-space refinement on the RANSAC inliers
                pix = torch.cat([pts2d, torch.ones_like(pts2d[..., :1])], dim=-1)
                rays = torch.matmul(pix, inv3(K).T)
                err = reprojection_errors(pts3d, pts2d, K, R, T)
                w = ((err < t.ransac_reproj_err) & valid).to(torch.float32)
                w = torch.where(w.sum(-1, keepdim=True) >= 6, w,
                                valid.to(torch.float32))
                R, T = lhm_refine(pts3d, rays, w, R, T, iters=t.lhm_iters)

            # result confidence = sqrt of the max vote score (reference
            # postprocess/postprocess.py:57)
            conf = torch.sqrt(torch.where(votes.valid, votes.score,
                                          torch.zeros_like(votes.score)).amax(dim=1))
            return dict(R=R, T=T, score=conf, cls=gt_cls.to(torch.int32),
                        n_inliers=n_in,
                        valid=votes.valid.any(-1) & (class_ids >= 0),
                        kp2d=kp_internal, vote_valid=votes.valid)

    return predict
