"""Shared building blocks (port of `kd6d_pose_adlp_tpu/models/blocks.py`):
Conv -> BatchNorm(eps 1e-5) -> LeakyReLU, the 2x2 max pool, and the
compute-dtype convolution and GroupNorm the FPN and head use. NCHW.

`QConv` and `conv2d_int8` are the int8 post-training-quantized conv
(JAX `blocks.py:35-117`).

Precision follows flax's `dtype=` (`kd6d_pose_adlp_tpu/models/blocks.py:
120-189`): parameters stay float32; each convolution casts its input,
weight and bias to the compute dtype (flax's `promote_dtype`) and returns
that dtype; BatchNorm and GroupNorm keep their statistics in float32
(`force_float32_reductions`), normalize in float32 and round the result to
the compute dtype once. The casts are explicit: `torch.autocast` keeps
BN and GN in float32 and casts elsewhere, a different function from
flax's bfloat16.

Under a data mesh of more than one rank (`global_batch_stats`), a
train-mode BatchNorm2d takes its statistics over the global batch, as
flax's BatchNorm does under JAX's `Mesh('data')`.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import DataMesh, all_reduce_sum

# set while torch.utils.checkpoint re-runs a forward in the backward pass
# (`engine/steps.py`, remat): the recomputed BatchNorm must not update its
# running statistics a second time
_FROZEN_STATS = [False]


@contextlib.contextmanager
def global_batch_stats(module: nn.Module, mesh: Optional[DataMesh]):
    """Inside, every train-mode BatchNorm2d of `module` normalizes with the
    statistics of the global batch of `mesh` (one all-reduce each forward,
    differentiable) when the mesh has more than one rank; outside, and on
    one rank, each takes its own batch's."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    if mesh is None or not mesh.distributed:
        yield
        return
    for m in bns:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in bns:
            m.mesh = None


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
    with float32 mean and var.

    With `mesh` set (`global_batch_stats`), train mode takes the global
    batch's statistics instead (`_forward_global`)."""

    mesh: Optional[DataMesh] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.mesh is not None:
            return self._forward_global(x)
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

    def _forward_global(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode BN over the mesh's global batch, flax's arithmetic: the
        per-channel [sum x, sum x^2, count] in float32, summed over the
        ranks by one differentiable all-reduce, then mean = E[x] and the
        fast variance max(E[x^2] - E[x]^2, 0); y = (x - mean) *
        (rsqrt(var + eps) * weight) + bias in float32, rounded to x's dtype
        once. The running statistics take the biased global variance."""
        C = x.shape[1]
        xf = x.float()
        stats = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                           xf.new_full((1,), x.numel() // C)])
        stats = all_reduce_sum(stats, self.mesh)
        n = stats[2 * C]
        mean = stats[:C] / n
        var = torch.clamp_min(stats[C:2 * C] / n - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        if not _FROZEN_STATS[0]:
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
                self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


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


def conv2d_int8(xq: torch.Tensor, kq: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """Exact int8 convolution: xq (B, C, H, W) int8, kq (O, C, k, k) int8,
    symmetric zero padding -> (B, O, Ho, Wo) int32, the sum of products in
    int32 (JAX's `conv_general_dilated(..., preferred_element_type=int32)`).

    An int8 im2col, then `torch._int_mm` (int8 x int8 -> int32): cuDNN has
    no int8 `F.conv2d`, and a float32 accumulation is not exact past 2^24
    (127^2 * 9 * 1024 is more). The contraction (C, dy, dx) is zero-padded
    to a multiple of 8, the output channels to a multiple of 8 and the rows
    to more than 16, as cuBLASLt's int8 product asks on the card; the
    padding is exact, zeros adding nothing."""
    B, C, H, W = xq.shape
    O, _, k, _ = kq.shape
    Ho = (H + 2 * padding - k) // stride + 1
    Wo = (W + 2 * padding - k) // stride + 1
    xp = (F.pad(xq, (padding,) * 4) if padding else xq).contiguous()
    Hp, Wp = H + 2 * padding, W + 2 * padding
    # the (B, Ho, Wo, C, dy, dx) windows as one strided view, then one copy
    cols = xp.as_strided((B, Ho, Wo, C, k, k),
                         (C * Hp * Wp, stride * Wp, stride, Hp * Wp, Wp, 1))
    Kc = C * k * k
    a = cols.reshape(B * Ho * Wo, Kc)
    b = kq.reshape(O, Kc).t()
    pad_k, pad_o = -Kc % 8, -O % 8
    # rows: the map's own size decides (the batch may be symbolic under export)
    pad_m = 17 - Ho * Wo if Ho * Wo <= 16 else 0
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_o:
        b = F.pad(b, (0, pad_o, 0, pad_k))
    acc = torch._int_mm(a.contiguous(), b.contiguous())
    if pad_m:
        acc = acc[:a.shape[0] - pad_m]
    return acc[:, :O].reshape(B, Ho, Wo, O).permute(0, 3, 1, 2)


QUANT_MODES = ("", "calibrate", "quant")


class QConv(nn.Module):
    """Post-training-quantized int8 convolution (JAX `blocks.py:35-117`),
    bias on, symmetric padding at every stride (JAX resolves "SAME" to
    symmetric pads too, `blocks.py:80-90`).

    - "calibrate": the folded float conv (`weight`, `bias` parameters, the
      names of the conv it replaces, computed as `Conv2d` in `dtype`) that
      also keeps the running absmax of its input in the non-persistent
      buffer `in_amax` (`utils/quant.calibrate_amax` zeroes and reads it).
    - "quant": buffers `kernel_q` (O, C, k, k) int8, `w_scale` (O,),
      `bias` (O,) and `in_scale` () float32 (`utils/quant.
      build_quant_state`): xq = clip(round(x / in_scale), -127, 127) in
      int8, the exact int32 conv (`conv2d_int8`), then
      acc * (in_scale * w_scale) + bias in float32, cast to `dtype`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, mode: str = "calibrate",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode not in QUANT_MODES[1:]:
            raise ValueError(f"QConv mode {mode!r}: one of {QUANT_MODES[1:]}")
        self.mode, self.stride, self.compute_dtype = mode, stride, dtype
        self.padding = kernel_size // 2
        shape = (out_channels, in_channels, kernel_size, kernel_size)
        if mode == "calibrate":
            self.weight = nn.Parameter(torch.empty(shape))
            self.bias = nn.Parameter(torch.zeros(out_channels))
            self.register_buffer("in_amax", torch.zeros(()), persistent=False)
        else:
            self.register_buffer("kernel_q", torch.zeros(shape, dtype=torch.int8))
            self.register_buffer("w_scale", torch.ones(out_channels))
            self.register_buffer("bias", torch.zeros(out_channels))
            self.register_buffer("in_scale", torch.ones(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.mode == "calibrate":
            with torch.no_grad():
                torch.maximum(self.in_amax, x.detach().abs().amax().float(),
                              out=self.in_amax)
            return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                            self.stride, self.padding)
        xq = torch.clamp(torch.round(x.float() / self.in_scale), -127, 127).to(torch.int8)
        acc = conv2d_int8(xq, self.kernel_q, self.stride, self.padding)
        y = (acc.float() * (self.in_scale * self.w_scale).reshape(-1, 1, 1)
             + self.bias.reshape(-1, 1, 1))
        return y.to(dt)


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
    BN (JAX `blocks.py:169-172`). `quant_mode` "calibrate" or "quant"
    makes the folded conv a `QConv` (int8 PTQ) and requires `folded`, as
    JAX asserts (`blocks.py:150-157`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, alpha: float = 0.1, stride: int = 1,
                 dtype: torch.dtype = torch.float32, folded: bool = False,
                 quant_mode: str = ""):
        super().__init__()
        self.alpha = alpha
        self.folded = folded
        if quant_mode:
            if not folded:
                raise ValueError("int8 PTQ (quant_mode) runs on the BN-folded network")
            self.conv = QConv(in_channels, out_channels, kernel_size, stride=stride,
                              mode=quant_mode, dtype=dtype)
            return
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
