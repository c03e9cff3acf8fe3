"""The reference postprocess of class-agnostic serving: per class, threshold
-> per-level quota voting -> the inverse crop affine -> RANSAC-EPnP over
the injected Gumbel draws -> LHM refinement on the RANSAC inliers (frozen
copy of the plain PyTorch in `kd6d_pose_adlp_tpu_torch/engine/
postprocess.py`, `build_postprocess_multi` and `_make_class_solver`, with
the pose solve written out in place of its registered op).
"""
from __future__ import annotations

from typing import Dict

import torch

from .epnp import lhm_refine, ransac_epnp, reprojection_errors
from .object_space import select_class_pred
from .smallalg import inv3
from .voting import vote_cells, votes_to_internal_frame

KEYS = ("R", "T", "score", "cls", "n_inliers", "valid")


def solve_classes(cfg, K: torch.Tensor, kp3d: torch.Tensor, cls: torch.Tensor,
                  cls_logits: torch.Tensor, pred_reg: torch.Tensor,
                  bbox_trans: torch.Tensor, gumbel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One class id a row: cls (N,), cls_logits (N, A, n_fg), pred_reg (N,
    A, n_fg * 16), bbox_trans (N, 2, 3), gumbel (N, iters, max_votes * 8)
    -> dict of KEYS, each (N, ...)."""
    m, t = cfg.model, cfg.test
    cls = cls.to(torch.int64)
    N, A, _ = cls_logits.shape
    s = torch.gather(torch.sigmoid(cls_logits), 2, cls[:, None, None].expand(N, A, 1))[..., 0]
    pred16 = select_class_pred(pred_reg, cls[:, None].expand(N, A))
    votes = vote_cells(s, pred16, input_res=m.input_res, strides=m.level_strides,
                       all_sizes=m.anchor_sizes, confidence_th=t.confidence_th,
                       positive_num=cfg.solver.positive_num,
                       positive_lambda=cfg.solver.positive_lambda, max_votes=t.max_votes)
    kp = votes_to_internal_frame(votes, bbox_trans.to(torch.float32))
    V = kp.shape[1]
    pts3d = kp3d[cls][:, None].expand(N, V, 8, 3).reshape(N, V * 8, 3)
    pts2d = kp.reshape(N, V * 8, 2)
    valid = votes.valid[:, :, None].expand(N, V, 8).reshape(N, V * 8)
    R, T, n_in = ransac_epnp(pts3d, pts2d, valid, K, iters=t.ransac_iters,
                             reproj_err=t.ransac_reproj_err, gumbel=gumbel)
    if t.lhm_iters > 0:
        pix = torch.cat([pts2d, torch.ones_like(pts2d[..., :1])], dim=-1)
        rays = torch.matmul(pix, inv3(K).T)
        err = reprojection_errors(pts3d, pts2d, K, R, T)
        w = ((err < t.ransac_reproj_err) & valid).to(torch.float32)
        w = torch.where(w.sum(-1, keepdim=True) >= 6, w, valid.to(torch.float32))
        R, T = lhm_refine(pts3d, rays, w, R, T, iters=t.lhm_iters)
    conf = torch.sqrt(torch.where(votes.valid, votes.score,
                                  torch.zeros_like(votes.score)).amax(dim=1))
    return dict(R=R, T=T, score=conf, cls=cls.to(torch.int32), n_inliers=n_in,
                valid=votes.valid.any(-1))


def postprocess_multi(cfg, K, kp3d, cls_logits, pred_reg, bbox_trans,
                      gumbel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every foreground class of every crop as one batch of n_fg * B rows:
    gumbel (n_fg, B, iters, max_votes * 8) -> dict of KEYS, each (B, n_fg, ...)."""
    n_fg, B = gumbel.shape[:2]
    rows = lambda x: x[None].expand((n_fg,) + x.shape).reshape((n_fg * B,) + x.shape[1:])
    cls = torch.arange(n_fg, device=cls_logits.device).repeat_interleave(B)
    out = solve_classes(cfg, K, kp3d, cls, rows(cls_logits), rows(pred_reg),
                        rows(bbox_trans), gumbel.reshape((n_fg * B,) + gumbel.shape[2:]))
    return {k: out[k].reshape((n_fg, B) + out[k].shape[1:]).transpose(0, 1) for k in KEYS}
