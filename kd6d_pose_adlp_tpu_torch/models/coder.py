"""Keypoint target coder, decode side (port of `kd6d_pose_adlp_tpu/models/
coder.py:50-77`). Runs in fp32: pose accuracy is sub-pixel."""
from __future__ import annotations

import torch


def decode(pred: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """pred (...,16) = [dx(8), dy(8)], anchors (...,4) [cx,cy,w,h]
    -> (...,8,2) crop-frame pixels."""
    cx, cy = anchors[..., 0:1], anchors[..., 1:2]
    w, h = anchors[..., 2:3], anchors[..., 3:4]
    px = pred[..., :8] * w + cx
    py = pred[..., 8:] * h + cy
    return torch.stack([px, py], dim=-1)


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
