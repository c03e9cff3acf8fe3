"""Multi-class one-vs-all sigmoid focal loss (frozen copy of
`kd6d_pose_adlp_tpu_torch/ops/focal.py`).

Label per cell: 0 = background, 1..C = class id + 1, -1 = ignore (in-mask
but unsampled; contributes exactly zero). Sum-reduced; the train step
applies the weight.
"""
from __future__ import annotations

import torch


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25,
                       eps: float = 1e-4) -> torch.Tensor:
    """logits (..., C); targets (...,) int in {-1, 0, 1..C} -> scalar sum."""
    C = logits.shape[-1]
    class_ids = torch.arange(1, C + 1, dtype=targets.dtype, device=targets.device)
    t = targets[..., None]
    p = torch.sigmoid(logits).clamp(eps, 1 - eps)
    term1 = (1 - p) ** gamma * torch.log(p)
    term2 = p ** gamma * torch.log(1 - p)
    pos = (t == class_ids).to(p.dtype)
    neg = ((t != class_ids) & (t >= 0)).to(p.dtype)
    loss = -pos * alpha * term1 - neg * (1 - alpha) * term2
    return loss.sum()
