"""The benchmark's own count of a network's convolution FLOPs, from shapes.

The reference network runs once on the meta device (shapes only, no
arithmetic); a hook on every convolution adds 2 * B * O * Ho * Wo * C * kh
* kw (one multiply and one add a product). Norms, activations, pools and
the losses are not counted: they are not products on the tensor cores.
"""
from __future__ import annotations

import torch
from torch import nn

from reference.net import PoseNet


def conv_flops(B: int, C: int, O: int, Ho: int, Wo: int, kh: int, kw: int) -> int:
    return 2 * B * O * Ho * Wo * C * kh * kw


def forward_flops(m, n_fg: int, batch: int, folded: bool = False) -> int:
    """Convolution FLOPs of one forward of the reference network `m` (a
    `reference.config.Model`) over `batch` images at m.input_res."""
    with torch.device("meta"):
        net = PoseNet(m, n_fg, folded=folded).eval()
        total = [0]

        def hook(mod, inp, out):
            B, O, Ho, Wo = out.shape
            total[0] += conv_flops(B, mod.in_channels // mod.groups, O, Ho, Wo,
                                   *mod.kernel_size)

        for mod in net.modules():
            if isinstance(mod, nn.Conv2d):
                mod.register_forward_hook(hook)
        with torch.no_grad():
            net(torch.empty((batch, m.input_res, m.input_res, 3)))
    return total[0]


def train_step_flops(m_student, n_fg: int, batch: int, m_teacher=None) -> int:
    """One training step: the teacher's forward, the student's forward,
    and its backward counted as twice the forward; nothing recomputed."""
    flops = 3 * forward_flops(m_student, n_fg, batch)
    if m_teacher is not None:
        flops += forward_flops(m_teacher, n_fg, batch, folded=True)
    return flops
