"""Shared building blocks (port of `kd6d_pose_adlp_tpu/models/blocks.py`):
Conv -> BatchNorm(eps 1e-5) -> LeakyReLU, and the 2x2 max pool. NCHW."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train-mode running variance is updated with the
    BIASED batch variance, as flax's `nn.BatchNorm` does
    (`kd6d_pose_adlp_tpu/models/blocks.py:178-186`); torch's own module
    uses the unbiased one (n/(n-1) larger). Normalization, parameter and
    buffer names are torch's, so state_dicts and the converters line up.

    Train mode: y = BN(x) with the biased batch statistics, then
    running <- (1 - momentum) * running + momentum * batch (momentum 0.1 =
    flax's 0.9 on the old value). The statistics come from the
    normalization's own reduction (one pass): mean, and the biased variance
    as invstd^-2 - eps. `torch._batch_norm_impl_index` is the op that
    `F.batch_norm` dispatches to (cuDNN's forward and backward on the card,
    ATen's on the CPU); unlike it, it also returns those statistics. Eval
    mode: torch's running-stat path."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, invstd, _, _ = torch._batch_norm_impl_index(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps,
            torch.backends.cudnn.enabled)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(invstd.pow(-2).sub_(self.eps), self.momentum)
            self.num_batches_tracked.add_(1)
        return y


class ConvBNAct(nn.Module):
    """Conv2d(bias=False) -> BatchNorm2d(eps=1e-5) -> LeakyReLU(alpha).

    Padding is symmetric (torch Conv2d(padding=k//2)), which equals XLA SAME
    at stride 1 and the JAX package's explicit symmetric padding at stride
    2. BN momentum 0.1 is flax's momentum 0.9."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, alpha: float = 0.1, stride: int = 1):
        super().__init__()
        self.alpha = alpha
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=kernel_size // 2,
                              bias=False)
        self.bn = BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)

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
