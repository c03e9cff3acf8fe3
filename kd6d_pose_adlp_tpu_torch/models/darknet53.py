"""DarkNet-53 backbone (port of `kd6d_pose_adlp_tpu/models/darknet53.py:21-72`).

3x3/32 init block, then 5 stages of [stride-2 3x3 conv with symmetric
padding 1, then residual DarkUnits (1x1 -> 3x3, skip)], layers
(2, 3, 9, 9, 5), channels (64 ... 1024), LeakyReLU 0.1. The forward returns
the 5 stage outputs [/2, /4, /8, /16, /32], or with `include_head` the
ImageNet classifier's logits (global average pool, then the Linear
`output`; for the parameter count only). `dtype` is the compute dtype and
`folded` the BN-folded inference form, as in `models/blocks.ConvBNAct`,
and `quant_mode` its int8 PTQ form (every unit a `QConv`).

Parameter names follow pytorchcv (`features.init_block.{conv,bn}`,
`features.stage{i}.unit1.{conv,bn}`,
`features.stage{i}.unit{j}.conv{1,2}.{conv,bn}`, `output`), which is what
`kd6d_pose_adlp_tpu/utils/torch_convert.convert_backbone` parses. The JAX
package has no Pallas kernel in this backbone: every unit is a plain
ConvBNAct (cuDNN on the card), in eval and train mode alike.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import ConvBNAct

LAYERS = (2, 3, 9, 9, 5)
CHANNELS = (64, 128, 256, 512, 1024)


class DarkUnit(nn.Module):
    def __init__(self, channels: int, alpha: float = 0.1, **kw):
        super().__init__()
        self.conv1 = ConvBNAct(channels, channels // 2, kernel_size=1, alpha=alpha, **kw)
        self.conv2 = ConvBNAct(channels // 2, channels, kernel_size=3, alpha=alpha, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x)) + x


class DarkNet53(nn.Module):
    def __init__(self, alpha: float = 0.1, include_head: bool = False,
                 n_classes: int = 1000, dtype: torch.dtype = torch.float32,
                 folded: bool = False, quant_mode: str = ""):
        super().__init__()
        kw = dict(alpha=alpha, dtype=dtype, folded=folded, quant_mode=quant_mode)
        feats = OrderedDict(init_block=ConvBNAct(3, 32, kernel_size=3, **kw))
        cin = 32
        for si, (n_units, ch) in enumerate(zip(LAYERS, CHANNELS)):
            units = OrderedDict(unit1=ConvBNAct(cin, ch, kernel_size=3, stride=2, **kw))
            for j in range(2, n_units + 1):
                units[f"unit{j}"] = DarkUnit(ch, **kw)
            feats[f"stage{si + 1}"] = nn.Sequential(units)
            cin = ch
        self.features = nn.Sequential(feats)
        self.include_head = include_head
        self.dtype = dtype
        if include_head:
            self.output = nn.Linear(cin, n_classes)

    def forward(self, x: torch.Tensor):
        """x (B, H, W, 3) NHWC -> the 5 stage outputs as NCHW maps, or the
        (B, n_classes) logits with include_head."""
        x = self.features.init_block(x.permute(0, 3, 1, 2))
        outs = []
        for stage in list(self.features)[1:]:
            x = stage(x)
            outs.append(x)
        if self.include_head:
            dt = self.dtype
            return F.linear(x.mean(dim=(2, 3)).to(dt), self.output.weight.to(dt),
                            self.output.bias.to(dt))
        return outs
