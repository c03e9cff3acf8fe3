"""DarkNet backbone, `tiny-h` plan (port of `kd6d_pose_adlp_tpu/models/
darknet.py`; the other variants wait for a later slice).

Parameter names follow the reference pytorchcv module
(`features.stage{i}.unit{j}.conv.weight`, `….bn.*`), which is what
`kd6d_pose_adlp_tpu/utils/torch_convert.convert_backbone` parses.

In eval mode the first two stages — stage1_unit1 -> pool -> stage2_unit1 ->
pool, both single 3x3 ConvBNAct units — always run as ONE flat-layout
segment through the fused CUDA kernels (`ops/conv_fused.stem_s2_segment_flat`),
with BN folded from the running statistics; the segment takes any H, W >= 4
and raises below that. In train mode every unit is the plain ConvBNAct, as
the JAX package runs no conv kernel in training.

`stem_stacked=True` is a measurement hook, not a serving option: it sends
the eval stem through the stacked-tap kernel (K3), which computes the same
function more slowly, so that `chip_smoke.py` can count and time K3 on a
served request.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List

import torch
from torch import nn

from ..ops.conv_fused import stem_s2_segment_flat
from .blocks import ConvBNAct, max_pool_2x2

# channel plans (reference backbone/darknet.py:157-180)
DARKNET_CHANNELS = {
    "tiny-h": ([[8], [16], [8, 64, 8, 64], [16, 128, 16, 128],
                [32, 256, 32, 256, 64]], True),
}


class DarkNet(nn.Module):
    def __init__(self, version: str = "tiny-h", alpha: float = 0.1,
                 stem_stacked: bool = False):
        super().__init__()
        if version not in DARKNET_CHANNELS:
            raise NotImplementedError(f"darknet variant {version!r} is not ported")
        channels, odd_pointwise = DARKNET_CHANNELS[version]
        self.stem_stacked = stem_stacked
        stages, cin = OrderedDict(), 3
        for si, stage in enumerate(channels):
            units = OrderedDict()
            for j, feats in enumerate(stage):
                # pointwise iff multi-unit stage and unit parity matches
                # odd_pointwise (reference backbone/darknet.py:88-92)
                pointwise = (len(stage) > 1) and not (
                    ((j + 1) % 2 == 1) ^ odd_pointwise)
                units[f"unit{j + 1}"] = ConvBNAct(
                    cin, feats, kernel_size=1 if pointwise else 3, alpha=alpha)
                cin = feats
            stages[f"stage{si + 1}"] = nn.Sequential(units)
        self.features = nn.Sequential(stages)
        self.alpha = alpha

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) NHWC -> the 4 pyramid maps [/2, /4, /8, /16] as
        NCHW: stages 1-3 after their trailing pool, and stage 5."""
        stages = list(self.features)
        pooled = []
        if not self.training:
            u1, u2 = stages[0][0], stages[1][0]
            sc1, bi1 = u1.folded_affine()
            sc2, bi2 = u2.folded_affine()
            p1, p2 = stem_s2_segment_flat(
                x.contiguous(), u1.packed_weight(), sc1, bi1,
                u2.packed_weight(), sc2, bi2, alpha=self.alpha,
                stacked=self.stem_stacked)
            pooled = [p1.permute(0, 3, 1, 2), p2.permute(0, 3, 1, 2)]
            x = pooled[-1]
        else:
            x = x.permute(0, 3, 1, 2)
        for si in range(len(pooled), len(stages)):
            x = stages[si](x)
            if si != len(stages) - 1:
                x = max_pool_2x2(x)
                pooled.append(x)
        # reference forward: out1..out3 = stages 1-3, out4 = stage5(stage4(.))
        return [pooled[0], pooled[1], pooled[2], x]
