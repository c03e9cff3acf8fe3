"""The WDR object-space (3D) regression loss and the
class selection of the per-cell regression (frozen copy of
`kd6d_pose_adlp_tpu_torch/ops/object_space.py`).

Dense over all A cells, masked by the positive indicator. fp32 throughout:
the 3x3 products are written out as elementwise sums (the JAX code pins
`Precision.HIGHEST`), so no TF32 matmul can enter on the card.
"""
from __future__ import annotations

import torch


def smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = torch.abs(x - y)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def select_class_pred(pred_reg: torch.Tensor, cls_idx: torch.Tensor) -> torch.Tensor:
    """pred_reg (B, A, n_fg*16), cls_idx (B, A) -> (B, A, 16)."""
    B, A, C16 = pred_reg.shape
    n_fg = C16 // 16
    pr = pred_reg.reshape(B, A, n_fg, 16)
    idx = cls_idx.clamp(0, n_fg - 1).to(torch.int64)[..., None, None]
    return torch.gather(pr, 2, idx.expand(B, A, 1, 16))[..., 0, :]


def object_space_loss(pred_xy: torch.Tensor,     # (B, A, 8, 2) decoded, internal frame
                      kp3d_cam: torch.Tensor,    # (B, A, 8, 3) matched GT corners, camera
                      cls_idx: torch.Tensor,     # (B, A) matched class (0-based)
                      pos_mask: torch.Tensor,    # (B, A) bool
                      inv_K: torch.Tensor,       # (3, 3)
                      diameters: torch.Tensor,   # (n_fg,)
                      scaling: float = 50.0) -> torch.Tensor:
    """Back-project predicted keypoints to rays B = K^-1 [x, y, 1], project
    the GT camera-frame corner onto each ray, P X = B (B.X)/(B.B);
    diameter-normalized SmoothL1 (scale 50 = 0.02 d), per-cell mean over
    8x3, masked sum over cells."""
    homo = torch.cat([pred_xy, torch.ones_like(pred_xy[..., :1])], dim=-1)
    rays = (inv_K * homo[..., None, :]).sum(-1)                  # (B,A,8,3)
    denom = (rays * rays).sum(-1, keepdim=True)
    bx = (rays * kp3d_cam).sum(-1, keepdim=True)
    px = rays * bx / denom
    d = diameters[cls_idx.clamp(0, diameters.shape[0] - 1).to(torch.int64)][..., None, None]
    per_cell = smooth_l1(scaling * (px / d), scaling * (kp3d_cam / d)).reshape(
        px.shape[0], px.shape[1], -1).mean(-1) / scaling
    return (per_cell * pos_mask).sum()

