"""FPN + P6/P7 top block (port of `kd6d_pose_adlp_tpu/models/fpn.py`).

Lateral 1x1 + output 3x3 per non-skipped backbone level, nearest 2x
top-down upsampling; P6 = stride-2 3x3 conv of the RAW backbone top feature
(not the FPN output), P7 = stride-2 3x3 conv of ReLU(P6), symmetric padding
1. Names mirror the reference (`inner_convs.{lvl}`, `out_convs.{lvl}`,
`top_blocks.p6|p7`, keyed by backbone level index). Convolutions run in
`dtype` (`models/blocks.Conv2d`); under `quant_mode` each is a `QConv` of
the same name (JAX `fpn.py:32-65`).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv2d, QConv


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channel: int,
                 use_p6p7: bool = True, dtype: torch.dtype = torch.float32,
                 quant_mode: str = ""):
        super().__init__()
        self.used = [i for i, c in enumerate(in_channels) if c > 0]
        assert self.used

        def conv(cin, k, stride=1):
            if quant_mode:
                return QConv(cin, out_channel, k, stride=stride, mode=quant_mode,
                             dtype=dtype)
            return Conv2d(cin, out_channel, k, stride=stride, padding=k // 2,
                          dtype=dtype)

        self.inner_convs = nn.ModuleDict({str(i): conv(in_channels[i], 1)
                                          for i in self.used})
        self.out_convs = nn.ModuleDict({str(i): conv(out_channel, 3)
                                        for i in self.used})
        self.use_p6p7 = use_p6p7
        if use_p6p7:
            self.top_blocks = nn.Module()
            self.top_blocks.p6 = conv(in_channels[self.used[-1]], 3, stride=2)
            self.top_blocks.p7 = conv(out_channel, 3, stride=2)

    def forward(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        top = self.used[-1]
        inner = self.inner_convs[str(top)](inputs[top])
        outs = [self.out_convs[str(top)](inner)]
        for i in reversed(self.used[:-1]):
            inner = self.inner_convs[str(i)](inputs[i]) + upsample2x_nearest(inner)
            outs.insert(0, self.out_convs[str(i)](inner))
        if self.use_p6p7:
            p6 = self.top_blocks.p6(inputs[top])
            p7 = self.top_blocks.p7(F.relu(p6))
            outs.extend([p6, p7])
        return outs
