"""Class selection of the per-cell regression (port of
`kd6d_pose_adlp_tpu/ops/object_space.py:24-31`; the object-space loss waits
for the training slice)."""
from __future__ import annotations

import torch


def select_class_pred(pred_reg: torch.Tensor, cls_idx: torch.Tensor) -> torch.Tensor:
    """pred_reg (B, A, n_fg*16), cls_idx (B, A) -> (B, A, 16)."""
    B, A, C16 = pred_reg.shape
    n_fg = C16 // 16
    pr = pred_reg.reshape(B, A, n_fg, 16)
    idx = cls_idx.clamp(0, n_fg - 1).to(torch.int64)[..., None, None]
    return torch.gather(pr, 2, idx.expand(B, A, 1, 16))[..., 0, :]
