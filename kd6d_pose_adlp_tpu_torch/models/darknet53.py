"""DarkNet-53 backbone (port of `kd6d_pose_adlp_tpu/models/darknet53.py:21-72`).

3x3/32 init block, then 5 stages of [stride-2 3x3 conv with symmetric
padding 1, then residual DarkUnits (1x1 -> 3x3, skip)], layers
(2, 3, 9, 9, 5), channels (64 ... 1024), LeakyReLU 0.1. The forward returns
the 5 stage outputs [/2, /4, /8, /16, /32].

Parameter names follow pytorchcv (`features.init_block.{conv,bn}`,
`features.stage{i}.unit1.{conv,bn}`,
`features.stage{i}.unit{j}.conv{1,2}.{conv,bn}`), which is what
`kd6d_pose_adlp_tpu/utils/torch_convert.convert_backbone` parses. The JAX
package has no Pallas kernel in this backbone: every unit is a plain
ConvBNAct (cuDNN on the card), in eval and train mode alike.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List

import torch
from torch import nn

from .blocks import ConvBNAct

LAYERS = (2, 3, 9, 9, 5)
CHANNELS = (64, 128, 256, 512, 1024)


class DarkUnit(nn.Module):
    def __init__(self, channels: int, alpha: float = 0.1):
        super().__init__()
        self.conv1 = ConvBNAct(channels, channels // 2, kernel_size=1, alpha=alpha)
        self.conv2 = ConvBNAct(channels // 2, channels, kernel_size=3, alpha=alpha)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x)) + x


class DarkNet53(nn.Module):
    def __init__(self, alpha: float = 0.1):
        super().__init__()
        feats = OrderedDict(init_block=ConvBNAct(3, 32, kernel_size=3, alpha=alpha))
        cin = 32
        for si, (n_units, ch) in enumerate(zip(LAYERS, CHANNELS)):
            units = OrderedDict(unit1=ConvBNAct(cin, ch, kernel_size=3,
                                                alpha=alpha, stride=2))
            for j in range(2, n_units + 1):
                units[f"unit{j}"] = DarkUnit(ch, alpha=alpha)
            feats[f"stage{si + 1}"] = nn.Sequential(units)
            cin = ch
        self.features = nn.Sequential(feats)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) NHWC -> the 5 stage outputs as NCHW maps."""
        x = self.features.init_block(x.permute(0, 3, 1, 2))
        outs = []
        for stage in list(self.features)[1:]:
            x = stage(x)
            outs.append(x)
        return outs
