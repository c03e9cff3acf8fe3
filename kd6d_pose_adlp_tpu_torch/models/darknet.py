"""DarkNet backbone family (port of `kd6d_pose_adlp_tpu/models/darknet.py`):
every channel plan of `DARKNET_CHANNELS`, the space-to-depth stem, the
ImageNet classifier head (for the parameter counts only), the compute
dtype and the BN-folded form.

Parameter names follow the reference pytorchcv module
(`features.stage{i}.unit{j}.conv.weight`, `….bn.*`, `final_conv.*`),
which is what `kd6d_pose_adlp_tpu/utils/torch_convert.convert_backbone`
parses.

In eval mode the first two stages — stage1_unit1 -> pool -> stage2_unit1 ->
pool, both single 3x3 ConvBNAct units in every plan — always run as ONE
flat-layout segment through the fused CUDA kernels
(`ops/conv_fused.stem_s2_segment_flat`), with BN folded from the running
statistics (or the folded unit's bias), in the compute dtype; the segment
takes any H, W >= 4 and raises below that. Under `quant_mode` (int8 PTQ,
"calibrate" or "quant") every unit is a `QConv` unit instead, in eval mode
too: those two units then compute an int8 function, not the kernels' (JAX
`darknet.py:68`). With `s2d_stem` the image is
rearranged to half resolution and 4x the channels first, and stage 1 has
no pool after it: the segment is stage1_unit1 -> stage2_unit1 -> pool. In
train mode every unit is the plain ConvBNAct, as the JAX package runs no
conv kernel in training.

`stem_stacked=True` is a measurement hook, not a serving option: it sends
the eval stem through the stacked-tap kernel (K3), which computes the same
function more slowly, so that `chip_smoke.py` can count and time K3 on a
served request.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from ..ops.conv_fused import stem_s2_segment_flat
from .blocks import Conv2d, ConvBNAct, max_pool_2x2

# channel plans (reference backbone/darknet.py:157-180), and the JAX
# package's lane-padded tiny-h-wide
DARKNET_CHANNELS = {
    "ref": ([[16], [32], [64], [128], [256], [512], [1024]], False),
    "tiny": ([[16], [32], [16, 128, 16, 128], [32, 256, 32, 256],
              [64, 512, 64, 512, 128]], True),
    "tiny-h": ([[8], [16], [8, 64, 8, 64], [16, 128, 16, 128],
                [32, 256, 32, 256, 64]], True),
    "19": ([[32], [64], [128, 64, 128], [256, 128, 256], [512, 256, 512, 256, 512],
            [1024, 512, 1024, 512, 1024]], False),
    "tiny-h-wide": ([[32], [32], [32, 64, 32, 64], [32, 128, 32, 128],
                     [32, 256, 32, 256, 64]], True),
}


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel (dy * 2 + dx) * C + c
    (JAX `darknet.py:56-59`)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // 2, W // 2, 4 * C)


class DarkNet(nn.Module):
    def __init__(self, version: str = "tiny-h", alpha: float = 0.1,
                 stem_stacked: bool = False, s2d_stem: bool = False,
                 include_head: bool = False, n_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, folded: bool = False,
                 quant_mode: str = ""):
        super().__init__()
        if version not in DARKNET_CHANNELS:
            raise ValueError(f"unknown darknet variant {version!r}")
        channels, odd_pointwise = DARKNET_CHANNELS[version]
        self.stem_stacked = stem_stacked
        self.s2d_stem = s2d_stem
        self.include_head = include_head
        self.dtype = dtype
        self.quant_mode = quant_mode
        stages, cin = OrderedDict(), 12 if s2d_stem else 3
        for si, stage in enumerate(channels):
            units = OrderedDict()
            for j, feats in enumerate(stage):
                # pointwise iff multi-unit stage and unit parity matches
                # odd_pointwise (reference backbone/darknet.py:88-92)
                pointwise = (len(stage) > 1) and not (
                    ((j + 1) % 2 == 1) ^ odd_pointwise)
                units[f"unit{j + 1}"] = ConvBNAct(
                    cin, feats, kernel_size=1 if pointwise else 3, alpha=alpha,
                    dtype=dtype, folded=folded, quant_mode=quant_mode)
                cin = feats
            stages[f"stage{si + 1}"] = nn.Sequential(units)
        self.features = nn.Sequential(stages)
        if include_head:
            self.final_conv = Conv2d(cin, n_classes, 1, dtype=dtype)
        self.alpha = alpha

    def forward(self, x: torch.Tensor):
        """x (B, H, W, 3) NHWC -> the 4 pyramid maps [/2, /4, /8, /16] as
        NCHW: stages 1-3 after their trailing pool (stage 1 unpooled under
        s2d_stem) and stage 5; with include_head the classifier's
        (B, n_classes) logits instead."""
        stages = list(self.features)
        if self.s2d_stem:
            x = space_to_depth(x)
        pyr = []   # stage outputs, pooled but the last (and s2d's first)
        if not self.training and not self.quant_mode:
            u1, u2 = stages[0][0], stages[1][0]
            sc1, bi1 = u1.folded_affine()
            sc2, bi2 = u2.folded_affine()
            p1, p2 = stem_s2_segment_flat(
                x.to(self.dtype).contiguous(), u1.packed_weight(), sc1, bi1,
                u2.packed_weight(), sc2, bi2, alpha=self.alpha,
                stacked=self.stem_stacked, pool_first=not self.s2d_stem)
            pyr = [p1.permute(0, 3, 1, 2), p2.permute(0, 3, 1, 2)]
            x = pyr[-1]
        else:
            x = x.permute(0, 3, 1, 2)
        for si in range(len(pyr), len(stages)):
            x = stages[si](x)
            if si != len(stages) - 1 and not (self.s2d_stem and si == 0):
                x = max_pool_2x2(x)
            pyr.append(x)
        if self.include_head:
            return self.final_conv(x).mean(dim=(2, 3))
        # reference forward: out1..out3 = stages 1-3, out4 = stage5(stage4(.))
        return [pyr[0], pyr[1], pyr[2], pyr[4]]
