"""Shared building blocks (port of `kd6d_pose_adlp_tpu/models/blocks.py`):
Conv -> BatchNorm(eps 1e-5) -> LeakyReLU, the 2x2 max pool, and the
compute-dtype convolution and GroupNorm the FPN and head use. NCHW.

Precision follows flax's `dtype=` (`kd6d_pose_adlp_tpu/models/blocks.py:
120-189`): parameters stay float32; each convolution casts its input,
weight and bias to the compute dtype (flax's `promote_dtype`) and returns
that dtype; BatchNorm and GroupNorm keep their statistics in float32
(`force_float32_reductions`), normalize in float32 and round the result to
the compute dtype once. The casts are explicit: `torch.autocast` keeps
BN and GN in float32 and casts elsewhere, a different function from
flax's bfloat16.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# set while torch.utils.checkpoint re-runs a forward in the backward pass
# (`engine/steps.py`, remat): the recomputed BatchNorm must not update its
# running statistics a second time
_FROZEN_STATS = [False]


@contextlib.contextmanager
def frozen_batch_stats():
    """Train-mode BatchNorm2d inside normalizes with the batch statistics
    as usual but leaves its running statistics and counter as they are."""
    prev = _FROZEN_STATS[0]
    _FROZEN_STATS[0] = True
    try:
        yield
    finally:
        _FROZEN_STATS[0] = prev


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train-mode running variance is updated with the
    BIASED batch variance, as flax's `nn.BatchNorm` does
    (`kd6d_pose_adlp_tpu/models/blocks.py:178-186`); torch's own module
    uses the unbiased one (n/(n-1) larger). Normalization, parameter and
    buffer names are torch's, so state_dicts and the converters line up.

    Train mode: y = BN(x) with the biased batch statistics, then
    running <- (1 - momentum) * running + momentum * batch (momentum 0.1 =
    flax's 0.9 on the old value), unless inside `frozen_batch_stats()`.
    The statistics come from the normalization's own reduction (one pass):
    mean, and the biased variance as invstd^-2 - eps.
    `torch._batch_norm_impl_index` is the op that `F.batch_norm` dispatches
    to (cuDNN's or ATen's forward and backward); unlike it, it also returns
    those statistics. Eval mode: torch's running-stat path.

    A bfloat16 input is normalized with float32 statistics and parameters
    in float32 and rounded to bfloat16 once (PyTorch's mixed-type batch
    norm), as flax computes `(x - mean) * rsqrt(var + eps) * scale + bias`
    with float32 mean and var."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, invstd, _, _ = torch._batch_norm_impl_index(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps,
            torch.backends.cudnn.enabled)
        if not _FROZEN_STATS[0]:
            with torch.no_grad():
                self.running_mean.lerp_(mean.float(), self.momentum)
                self.running_var.lerp_(invstd.float().pow(-2).sub_(self.eps),
                                       self.momentum)
                self.num_batches_tracked.add_(1)
        return y


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in `dtype`: input, weight and bias are cast to
    it (float32 parameters, flax's `promote_dtype`), the output is in it."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class GroupNorm(nn.GroupNorm):
    """`nn.GroupNorm` whose result is rounded to `dtype`: statistics and
    normalization in float32 from the input's values, as flax's
    `GroupNorm(dtype=...)` computes them."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


class ConvBNAct(nn.Module):
    """Conv2d(bias=False) -> BatchNorm2d(eps=1e-5) -> LeakyReLU(alpha), in
    `dtype`.

    Padding is symmetric (torch Conv2d(padding=k//2)), which equals XLA SAME
    at stride 1 and the JAX package's explicit symmetric padding at stride
    2. BN momentum 0.1 is flax's momentum 0.9.

    `folded=True` is the inference form with BN folded into the conv
    (`utils/fold_bn.fold_batchnorm`): Conv2d(bias=True) -> LeakyReLU, no
    BN (JAX `blocks.py:169-172`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, alpha: float = 0.1, stride: int = 1,
                 dtype: torch.dtype = torch.float32, folded: bool = False):
        super().__init__()
        self.alpha = alpha
        self.folded = folded
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           stride=stride, padding=kernel_size // 2,
                           bias=folded, dtype=dtype)
        if not folded:
            self.bn = BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv.compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if not self.folded:
            x = self.bn(x)
        return F.leaky_relu(x, self.alpha)

    def folded_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval-mode BN as a per-channel float32 affine, (O, 1) each: from
        the running statistics, scale = gamma / sqrt(var + eps) and shift =
        beta - mean * scale; a folded unit's is (1, conv bias)."""
        if self.folded:
            b = self.conv.bias
            return torch.ones_like(b).reshape(-1, 1), b.reshape(-1, 1)
        bn = self.bn
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        shift = bn.bias - bn.running_mean * scale
        return scale.reshape(-1, 1), shift.reshape(-1, 1)

    def packed_weight(self) -> torch.Tensor:
        """(O, C, 3, 3) -> (9, O, C) per-tap weights of the fused kernels,
        in the compute dtype (JAX `conv_pallas.py:296-303` packs them to
        the slab's dtype)."""
        w = self.conv.weight
        return (w.permute(2, 3, 0, 1).reshape(9, w.shape[0], w.shape[1])
                .to(self.dtype).contiguous())


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool (VALID, like flax nn.max_pool); its gradient
    goes to one winner per window, as XLA's SelectAndScatter does."""
    return F.max_pool2d(x, kernel_size=2, stride=2)
