"""Full-fp32 precision context for the port's numerics on the card.

PyTorch's defaults leave `torch.backends.cudnn.allow_tf32` True, so on an
Ampere-or-later card every cuDNN convolution rounds its inputs to TF32
(10-bit mantissa) unless told otherwise; matmul TF32 is off by default but a
caller may turn it on. The JAX package computes in fp32 (`Precision.HIGHEST`
for its pose math), so every port entry point that must agree with it (the
serving network, the postprocess, the evaluators' scorer) runs inside
`full_fp32()`.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """TF32 off for matmuls and cuDNN convolutions; both flags restored on
    exit, also when the body raises."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
