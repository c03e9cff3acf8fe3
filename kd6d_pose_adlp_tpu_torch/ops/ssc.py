"""SSC per-level quotas (port of `kd6d_pose_adlp_tpu/ops/ssc.py:30-39`;
the training-side target assignment waits for the training slice)."""
from __future__ import annotations

from typing import Tuple

import torch


def level_quotas(spans: torch.Tensor, level_sizes: Tuple[int, ...],
                 positive_num: int, positive_lambda: float) -> torch.Tensor:
    """spans (..., G) object box spans -> nk (..., L, G) int32 quotas,
    round-half-up by truncating (nk + 0.5) like the JAX astype(int32)."""
    lv = torch.as_tensor(level_sizes, dtype=torch.float32, device=spans.device)
    dk = torch.abs(torch.log2(spans[..., None, :] / lv[:, None]))
    w = torch.exp(-positive_lambda * dk * dk)
    nk = positive_num * w / w.sum(dim=-2, keepdim=True)
    return (nk + 0.5).to(torch.int32)
