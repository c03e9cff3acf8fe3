"""Full dense pose network: backbone -> FPN -> head -> flat per-cell outputs
(port of `kd6d_pose_adlp_tpu/models/pose_net.py`).

Outputs keep the JAX layout: (B, A, C) with cells flattened in NHWC order
(levels concatenated, row-major within a level), matching the static anchor
table of `anchors.make_anchors`.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from .blocks import ConvBNAct
from .darknet import DarkNet
from .darknet53 import DarkNet53
from .fpn import FPN
from .head import PoseHead

_BACKBONE_VERSIONS = {"darknet_tiny_h": "tiny-h", "darknet53": None}


class PoseNet(nn.Module):
    """Backbones: `darknet_tiny_h` (the student; its eval stem runs the K2
    segment) and `darknet53` (the KD teacher; plain units). Train mode runs
    every unit as a plain ConvBNAct, as the JAX package runs no conv kernel
    in training (`kd6d_pose_adlp_tpu/ops/conv_pallas.py:37-41`).

    `stem_stacked` is a measurement hook (see `models/darknet.py`): it
    routes the eval-mode stem segment through the slower stacked-tap kernel
    (K3) instead of the flat one (K2); same function. Serving leaves it
    off."""

    def __init__(self, cfg: ModelConfig, n_fg: int = 15,
                 stem_stacked: bool = False):
        super().__init__()
        if cfg.backbone not in _BACKBONE_VERSIONS:
            raise NotImplementedError(f"backbone {cfg.backbone!r} is not ported")
        if cfg.compute_dtype != "float32" or cfg.bn_folded or cfg.quant_mode \
                or cfg.code_bits or cfg.remat:
            raise NotImplementedError(
                "only the float32, unfolded, unquantized, un-rematerialized "
                "keypoint network is ported")
        self.cfg = cfg
        self.n_fg = n_fg
        if cfg.backbone == "darknet53":
            if stem_stacked:
                raise ValueError("stem_stacked applies to darknet_tiny_h only")
            self.backbone = DarkNet53()
        else:
            self.backbone = DarkNet(_BACKBONE_VERSIONS[cfg.backbone],
                                    stem_stacked=stem_stacked)
        self.fpn = FPN(cfg.feat_channels, cfg.out_channel,
                       use_p6p7=cfg.use_higher_levels)
        self.head = PoseHead(cfg.out_channel, n_fg, n_conv=cfg.n_conv,
                             n_levels=max(5, cfg.num_levels))
        self.register_buffer("pixel_mean", torch.as_tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("pixel_std", torch.as_tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, H, W, 3) -> (cls (B, A, n_fg), reg (B, A, n_fg*16)) f32.

        uint8 input = raw BGR crops, flipped to RGB and ImageNet-normalized
        here in fp32; float input is taken as already-normalized RGB."""
        if images.dtype == torch.uint8:
            x = images.flip(-1).to(torch.float32)
            images = (x / 255.0 - self.pixel_mean) / self.pixel_std
        feats = self.backbone(images.to(torch.float32))
        pyramid = self.fpn(feats)
        assert len(pyramid) == self.cfg.num_levels
        logits, pose_reg = self.head(pyramid)
        B = images.shape[0]
        flat_cls = torch.cat([l.permute(0, 2, 3, 1).reshape(B, -1, self.n_fg)
                              for l in logits], dim=1)
        flat_reg = torch.cat([r.permute(0, 2, 3, 1).reshape(B, -1, self.n_fg * 16)
                              for r in pose_reg], dim=1)
        assert flat_cls.shape[1] == self.cfg.num_cells, (
            flat_cls.shape, self.cfg.num_cells)
        return flat_cls, flat_reg


def init_pose_net(net: PoseNet, generator: Optional[torch.Generator] = None,
                  prior: Optional[float] = None) -> PoseNet:
    """Draw every parameter from `generator` with the JAX package's
    initializers: backbone convs kaiming-uniform (a=0), FPN convs
    kaiming-uniform (a=1) with zero bias, head convs N(0, 0.01) with zero
    bias and the focal prior on cls_logits; norms at weight 1, bias 0."""
    prior = net.cfg.prior if prior is None else prior

    def uniform_(t, bound):
        with torch.no_grad():
            t.copy_(torch.empty(t.shape).uniform_(-bound, bound,
                                                  generator=generator))

    def normal_(t, std):
        with torch.no_grad():
            t.copy_(torch.empty(t.shape).normal_(0.0, std, generator=generator))

    for m in net.backbone.modules():
        if isinstance(m, ConvBNAct):
            fan_in = m.conv.weight[0].numel()
            uniform_(m.conv.weight, math.sqrt(6.0 / fan_in))
            m.bn.reset_parameters()
    for m in net.fpn.modules():
        if isinstance(m, nn.Conv2d):
            uniform_(m.weight, math.sqrt(3.0 / m.weight[0].numel()))
            nn.init.zeros_(m.bias)
    for m in net.head.modules():
        if isinstance(m, nn.Conv2d):
            normal_(m.weight, 0.01)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.GroupNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    nn.init.constant_(net.head.cls_logits.bias, -math.log((1 - prior) / prior))
    for s in net.head.scales:
        nn.init.ones_(s.scale)
    return net
