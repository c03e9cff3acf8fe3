"""Keypoint target coder (frozen copy of
`kd6d_pose_adlp_tpu_torch/models/coder.py`).
Runs in fp32 with the small geometric products written out as elementwise
sums, so no TF32 matmul can enter: pose accuracy is sub-pixel."""
from __future__ import annotations

from typing import Optional

import torch


def _matvec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A (..., i, j) applied to points v (..., k, j) -> (..., k, i), fp32
    products summed over j (the einsum "...ij,...kj->...ki")."""
    return (A[..., None, :, :] * v[..., :, None, :]).sum(-1)


def project_corners(K: torch.Tensor, R: torch.Tensor, T: torch.Tensor,
                    corners3d: torch.Tensor,
                    bbox_trans: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Project 8 corners through the pose and (optionally) a 2x3 crop affine.

    K (3,3); R (...,3,3); T (...,3); corners3d (...,8,3); bbox_trans
    (...,2,3) or None -> (...,8,2) pixel coords."""
    cam = _matvec(R, corners3d) + T[..., None, :]                 # (...,8,3)
    uv = _matvec(K, cam)                                          # (...,8,3)
    xy = uv[..., :2] / (uv[..., 2:3] + 1e-8)                      # (...,8,2)
    if bbox_trans is not None:
        xy = _matvec(bbox_trans[..., :2, :2], xy) + bbox_trans[..., None, :2, 2]
    return xy


def decode(pred: torch.Tensor, anchors: torch.Tensor,
           bbox_trans_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pred (...,16) = [dx(8), dy(8)], anchors (...,4) [cx,cy,w,h]
    -> (...,8,2) crop-frame pixels; with `bbox_trans_inv` (...,2,3), mapped
    back to the internal 640x480 frame."""
    cx, cy = anchors[..., 0:1], anchors[..., 1:2]
    w, h = anchors[..., 2:3], anchors[..., 3:4]
    px = pred[..., :8] * w + cx
    py = pred[..., 8:] * h + cy
    xy = torch.stack([px, py], dim=-1)
    if bbox_trans_inv is not None:
        xy = _matvec(bbox_trans_inv[..., :2, :2], xy) + bbox_trans_inv[..., None, :2, 2]
    return xy


def invert_bbox_trans(bbox_trans: torch.Tensor) -> torch.Tensor:
    """(...,2,3) -> (...,2,3) inverse affine (closed form)."""
    a, b, c = bbox_trans[..., 0, 0], bbox_trans[..., 0, 1], bbox_trans[..., 0, 2]
    d, e, f = bbox_trans[..., 1, 0], bbox_trans[..., 1, 1], bbox_trans[..., 1, 2]
    det = a * e - b * d
    ia, ib = e / det, -b / det
    id_, ie = -d / det, a / det
    ic = -(ia * c + ib * f)
    if_ = -(id_ * c + ie * f)
    row0 = torch.stack([ia, ib, ic], dim=-1)
    row1 = torch.stack([id_, ie, if_], dim=-1)
    return torch.stack([row0, row1], dim=-2)
