"""Box utilities: the IoU matrix and fixed-shape NMS (port of
`kd6d_pose_adlp_tpu/ops/boxes.py`).

The reference carries NMS in its BoxList (`libs/boxlist.py:270-340`,
torchvision's) although the published pose path never calls it; the JAX
package keeps it as fixed-shape code, and so does the port: `nms` returns a
(N,) bool keep-mask after N pick-max / suppress rounds and never filters.
No Pallas kernel is behind it.
"""
from __future__ import annotations

from typing import Optional

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix of xyxy boxes with the reference's +1 area convention
    (libs/boxlist.py:347-380). a (N, 4), b (M, 4) -> (N, M)."""
    def area(v):
        return (v[..., 2] - v[..., 0] + 1.0) * (v[..., 3] - v[..., 1] + 1.0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt + 1.0).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_th: float = 0.5,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fixed-shape NMS: a (N,) bool keep-mask. Each of N rounds keeps the
    best-scoring live box (`torch.argmax`'s first maximum, as `jnp.argmax`)
    and retires the live boxes whose IoU with it exceeds `iou_th`; `valid`
    masks boxes out from the start."""
    N = boxes.shape[0]
    iou = box_iou(boxes, boxes)
    alive = (torch.ones((N,), dtype=torch.bool, device=boxes.device) if valid is None
             else valid.to(torch.bool).clone())
    keep = torch.zeros((N,), dtype=torch.bool, device=boxes.device)
    neg = torch.tensor(torch.finfo(scores.dtype).min, dtype=scores.dtype,
                       device=scores.device)
    for _ in range(N):
        i = torch.argmax(torch.where(alive, scores, neg))
        any_alive = alive.any()
        keep[i] = keep[i] | any_alive
        suppress = (iou[i] > iou_th) & alive
        alive = torch.where(any_alive, alive & ~suppress, alive)
    return keep


def ml_nms(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
           iou_th: float = 0.5, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Class-aware NMS (reference boxlist_ml_nms, libs/boxlist.py:300-330):
    boxes of different labels never suppress each other, by offsetting each
    label's boxes by the coordinates' span."""
    span = boxes.max() - boxes.min() + 1.0
    off = labels.to(boxes.dtype)[:, None] * span
    return nms(boxes + off, scores, iou_th, valid)
