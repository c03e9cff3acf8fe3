"""Inference postprocess: dense predictions -> 6D poses on device (port of
`kd6d_pose_adlp_tpu/engine/postprocess.py`).

threshold -> per-level quota voting -> inverse crop affine -> RANSAC-EPnP ->
LHM refinement on the RANSAC inliers. `_make_class_solver` solves one class
id per image and is shared by the single-class postprocess, the
detection-style `build_postprocess_multi` and the scan evaluator
(`engine/eval_scan.py`). Symmetry canonicalization of a predicted R stays on
the host (`apply_symmetry_host`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import Config
from ..data.batch import TaskConsts
from ..ops.epnp import lhm_refine, ransac_epnp, reprojection_errors, sample_gumbel
from ..ops.object_space import select_class_pred
from ..ops.smallalg import inv3
from ..ops.voting import vote_cells, votes_to_internal_frame
from ..utils.precision import full_fp32

# the per-class outputs of build_postprocess_multi, in a fixed order
MULTI_KEYS = ("R", "T", "score", "cls", "n_inliers", "valid")


def build_postprocess(cfg: Config, consts: TaskConsts):
    """Returns predict(cls_logits, pred_reg, class_ids, bbox_trans,
    generator=None, gumbel=None) -> dict with R (B,3,3), T (B,3), score (B,),
    cls (B,), n_inliers (B,), valid (B,), kp2d (B,V,8,2), vote_valid (B,V).

    class_ids (B,) is the class to solve per image (negative = invalid);
    RANSAC draws come from `generator`, or are injected as `gumbel`
    (B, ransac_iters, max_votes * 8)."""
    solve = _make_class_solver(cfg, consts)

    def predict(cls_logits: torch.Tensor, pred_reg: torch.Tensor,
                class_ids: torch.Tensor, bbox_trans: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        class_ids = class_ids.to(torch.int64)
        out = solve(class_ids.clamp_min(0), cls_logits, pred_reg, bbox_trans,
                    generator=generator, gumbel=gumbel)
        out["valid"] = out["valid"] & (class_ids >= 0)
        return out

    return predict


def build_postprocess_multi(cfg: Config, consts: TaskConsts, n_fg: int):
    """Detection-style postprocess: votes and solves PnP for EVERY foreground
    class. Returns predict(cls_logits, pred_reg, bbox_trans, generator=None,
    gumbel=None) -> dict of MULTI_KEYS, each (B, n_fg, ...), `valid`
    marking a class with any vote above threshold.

    The n_fg classes are solved as one batch of n_fg * B rows. The draws
    are one (n_fg, B, ransac_iters, max_votes * 8) Gumbel tensor, from
    `generator` or injected as `gumbel`."""
    t = cfg.test
    solve = _make_class_solver(cfg, consts)

    def predict(cls_logits: torch.Tensor, pred_reg: torch.Tensor,
                bbox_trans: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        B = cls_logits.shape[0]
        dev = cls_logits.device
        shape = (n_fg, B, t.ransac_iters, t.max_votes * 8)
        if gumbel is None:
            gumbel = sample_gumbel(shape, generator, dev)
        if tuple(gumbel.shape) != shape:
            raise ValueError(f"gumbel {tuple(gumbel.shape)} != {shape}")
        rows = lambda x: x[None].expand((n_fg,) + x.shape).reshape((n_fg * B,) + x.shape[1:])
        cls = torch.arange(n_fg, device=dev).repeat_interleave(B)
        out = solve(cls, rows(cls_logits), rows(pred_reg), rows(bbox_trans),
                    gumbel=gumbel.reshape((n_fg * B,) + shape[2:]))
        # (C * B, ...) -> (B, C, ...)
        return {k: out[k].reshape((n_fg, B) + out[k].shape[1:]).transpose(0, 1)
                for k in MULTI_KEYS}

    return predict


def _make_class_solver(cfg: Config, consts: TaskConsts):
    """Shared vote -> RANSAC-EPnP (-> LHM) pipeline for one class id per
    image, in full fp32. Takes the (B, 2, 3) crop affines directly (not a
    Batch), so the scan evaluator reuses it on its staged chunks.

    solve(gt_cls (B,) int, cls_logits, pred_reg, bbox_trans, generator=None,
    gumbel=None) -> dict with R, T, score, cls, n_inliers, valid (the image
    cast a vote), kp2d, vote_valid."""
    m, t = cfg.model, cfg.test

    def solve(gt_cls: torch.Tensor, cls_logits: torch.Tensor,
              pred_reg: torch.Tensor, bbox_trans: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              gumbel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        with full_fp32():
            gt_cls = gt_cls.to(torch.int64)
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

            if gumbel is None:
                gumbel = sample_gumbel((B, t.ransac_iters, V * 8), generator,
                                       pts3d.device)
            R, T, n_in = torch.ops.kd6d.solve_pose(
                pts3d, pts2d, valid, consts.K, gumbel, t.ransac_iters,
                t.ransac_reproj_err, t.lhm_iters)

            # result confidence = sqrt of the max vote score (reference
            # postprocess/postprocess.py:57)
            conf = torch.sqrt(torch.where(votes.valid, votes.score,
                                          torch.zeros_like(votes.score)).amax(dim=1))
            return dict(R=R, T=T, score=conf, cls=gt_cls.to(torch.int32),
                        n_inliers=n_in, valid=votes.valid.any(-1),
                        kp2d=kp_internal, vote_valid=votes.valid)

    return solve


@torch.library.custom_op("kd6d::solve_pose", mutates_args=())
def solve_pose(pts3d: torch.Tensor, pts2d: torch.Tensor, valid: torch.Tensor,
               K: torch.Tensor, gumbel: torch.Tensor, iters: int,
               reproj_err: float, lhm_iters: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RANSAC-EPnP over the injected draws `gumbel` (B, iters, N), then
    `lhm_iters` LHM steps on the inliers (on all valid points below 6) ->
    (R (B, 3, 3), T (B, 3), n_inliers (B,) int32), in the caller's precision
    context.

    A custom op, so that `torch.export` records the pose solve as one node:
    its fixed-count loops (Jacobi sweeps, subspace and power iterations,
    Gauss-Newton and LHM steps) unroll to ~34k graph nodes per request,
    which export traces in ~1 min, saves in ~40 s and loads in ~3 min on
    one host core (64² tiny_h, 16 hypotheses). A loaded program runs this
    function, as the kd6d conv ops, so it needs the port importable."""
    R, T, n_in = ransac_epnp(pts3d, pts2d, valid, K, iters=iters,
                             reproj_err=reproj_err, gumbel=gumbel)
    if lhm_iters > 0:
        # object-space refinement on the RANSAC inliers
        pix = torch.cat([pts2d, torch.ones_like(pts2d[..., :1])], dim=-1)
        rays = torch.matmul(pix, inv3(K).T)
        err = reprojection_errors(pts3d, pts2d, K, R, T)
        w = ((err < reproj_err) & valid).to(torch.float32)
        w = torch.where(w.sum(-1, keepdim=True) >= 6, w, valid.to(torch.float32))
        R, T = lhm_refine(pts3d, rays, w, R, T, iters=lhm_iters)
    return R, T, n_in


@solve_pose.register_fake
def _(pts3d, pts2d, valid, K, gumbel, iters, reproj_err, lhm_iters):
    B = pts3d.shape[0]
    return (pts3d.new_empty((B, 3, 3)), pts3d.new_empty((B, 3)),
            pts3d.new_empty((B,), dtype=torch.int32))


def apply_symmetry_host(R, cls_id: int, symmetry: Dict[int, tuple]):
    """Host-side symmetry canonicalization of a predicted rotation."""
    from ..utils.geometry import pose_symmetry_handling
    if cls_id in symmetry:
        return pose_symmetry_handling(R, symmetry[cls_id])
    return R
