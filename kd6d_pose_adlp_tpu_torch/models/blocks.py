"""Shared building blocks (port of `kd6d_pose_adlp_tpu/models/blocks.py`):
Conv -> BatchNorm(eps 1e-5) -> LeakyReLU, and the 2x2 max pool. NCHW."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class ConvBNAct(nn.Module):
    """Conv2d(bias=False) -> BatchNorm2d(eps=1e-5) -> LeakyReLU(alpha).

    Padding is symmetric (torch Conv2d(padding=k//2)), which equals XLA SAME
    at stride 1. BN momentum 0.1 is flax's momentum 0.9."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, alpha: float = 0.1):
        super().__init__()
        self.alpha = alpha
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              padding=kernel_size // 2, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x)), self.alpha)

    def folded_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval-mode BN as a per-channel affine from the running statistics:
        scale = gamma / sqrt(var + eps), shift = beta - mean * scale, (O, 1)."""
        bn = self.bn
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        shift = bn.bias - bn.running_mean * scale
        return scale.reshape(-1, 1), shift.reshape(-1, 1)

    def packed_weight(self) -> torch.Tensor:
        """(O, C, 3, 3) -> (9, O, C) per-tap weights of the fused kernels."""
        w = self.conv.weight
        return w.permute(2, 3, 0, 1).reshape(9, w.shape[0], w.shape[1]).contiguous()


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool (VALID, like flax nn.max_pool); its gradient
    goes to one winner per window, as XLA's SelectAndScatter does."""
    return F.max_pool2d(x, kernel_size=2, stride=2)
