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
from .blocks import QUANT_MODES, ConvBNAct
from .darknet import DarkNet
from .darknet53 import DarkNet53
from .fpn import FPN
from .head import PoseHead

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_backbone(cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                  stem_stacked: bool = False) -> nn.Module:
    """The backbone `cfg.backbone` names (JAX `pose_net.py:23-41`), in
    `dtype`, BN-folded when `cfg.bn_folded`, int8 PTQ under
    `cfg.quant_mode`."""
    kw = dict(dtype=dtype, folded=cfg.bn_folded, quant_mode=cfg.quant_mode)
    if cfg.backbone == "darknet53":
        if stem_stacked:
            raise ValueError("stem_stacked applies to the DarkNet backbones only")
        return DarkNet53(**kw)
    versions = {"darknet_tiny": ("tiny", False), "darknet_tiny_h": ("tiny-h", False),
                "darknet_tiny_h_wide": ("tiny-h-wide", False),
                "darknet_tiny_h_s2d": ("tiny-h", True)}
    if cfg.backbone not in versions:
        raise ValueError(f"Unsupported backbone {cfg.backbone}")
    version, s2d = versions[cfg.backbone]
    return DarkNet(version, s2d_stem=s2d, stem_stacked=stem_stacked, **kw)


class PoseNet(nn.Module):
    """Backbones: every one `config._BACKBONE_SPECS` names — the students
    `darknet_tiny_h`, `darknet_tiny`, `darknet_tiny_h_wide` and
    `darknet_tiny_h_s2d` (their eval stem runs the K2 segment) and the
    teacher `darknet53` (plain units) — in `cfg.compute_dtype` "float32"
    or "bfloat16" (parameters and BN statistics float32, outputs float32),
    BN-folded or not (`cfg.bn_folded`, weights from
    `utils/fold_bn.fold_batchnorm`). Train mode runs every unit as a plain
    ConvBNAct, as the JAX package runs no conv kernel in training
    (`kd6d_pose_adlp_tpu/ops/conv_pallas.py:37-41`). `cfg.remat` belongs
    to the train step (`engine/steps.py`). `cfg.quant_mode` "calibrate" or
    "quant" is the int8 PTQ network (requires `cfg.bn_folded`; its weights
    come from `utils/quant.quantize_posenet`): every backbone unit, FPN
    conv and tower conv a `QConv`, the eval stem included (no K2), the
    head's output convs float. `cfg.code_bits` > 0 adds the dense
    binary-code head's `code_pred` conv and a third output (`engine/zebra`).

    `stem_stacked` is a measurement hook (see `models/darknet.py`): it
    routes the eval-mode stem segment through the slower stacked-tap kernel
    (K3) instead of the flat one (K2); same function. Serving leaves it
    off."""

    def __init__(self, cfg: ModelConfig, n_fg: int = 15,
                 stem_stacked: bool = False):
        super().__init__()
        if cfg.quant_mode not in QUANT_MODES:
            raise ValueError(f"quant_mode {cfg.quant_mode!r}: one of {QUANT_MODES}")
        if cfg.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of {sorted(DTYPES)}")
        self.cfg = cfg
        self.n_fg = n_fg
        self.dtype = DTYPES[cfg.compute_dtype]
        self.backbone = make_backbone(cfg, self.dtype, stem_stacked)
        self.fpn = FPN(cfg.feat_channels, cfg.out_channel,
                       use_p6p7=cfg.use_higher_levels, dtype=self.dtype,
                       quant_mode=cfg.quant_mode)
        self.head = PoseHead(cfg.out_channel, n_fg, n_conv=cfg.n_conv,
                             n_levels=max(5, cfg.num_levels), dtype=self.dtype,
                             quant_mode=cfg.quant_mode, code_bits=cfg.code_bits)
        self.register_buffer("pixel_mean", torch.as_tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("pixel_std", torch.as_tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """images (B, H, W, 3) -> (cls (B, A, n_fg), reg (B, A, n_fg*16)) f32,
        and with `code_bits` > 0 a third output, code (B, A,
        n_fg*(code_bits+2)) f32 (JAX `pose_net.py:84-89`).

        uint8 input = raw BGR crops, flipped to RGB and ImageNet-normalized
        here in fp32; float input is taken as already-normalized RGB. The
        normalized images are cast to the compute dtype before the
        backbone, the outputs back to float32 (JAX `pose_net.py:60-61`)."""
        if images.dtype == torch.uint8:
            x = images.flip(-1).to(torch.float32)
            images = (x / 255.0 - self.pixel_mean) / self.pixel_std
        feats = self.backbone(images.to(self.dtype))
        pyramid = self.fpn(feats)
        assert len(pyramid) == self.cfg.num_levels
        maps = self.head(pyramid)
        B = images.shape[0]
        # each level NCHW -> NHWC, flattened to (B, cells, channels)
        flat = tuple(torch.cat([m.permute(0, 2, 3, 1).reshape(B, -1, m.shape[1])
                                for m in level_maps], dim=1).float()
                     for level_maps in maps)
        assert flat[0].shape[1] == self.cfg.num_cells, (
            flat[0].shape, self.cfg.num_cells)
        return flat


def init_pose_net(net: PoseNet, generator: Optional[torch.Generator] = None,
                  prior: Optional[float] = None) -> PoseNet:
    """Draw every parameter from `generator` with the JAX package's
    initializers: backbone convs kaiming-uniform (a=0) with zero bias when
    folded, FPN convs kaiming-uniform (a=1) with zero bias, head convs
    N(0, 0.01) with zero bias and the focal prior on cls_logits; norms at
    weight 1, bias 0; the classifier heads of `include_head`, DarkNet's
    `final_conv` N(0, 0.01) and DarkNet53's `output` flax's Dense default
    (LeCun truncated normal), both with zero bias."""
    if net.cfg.quant_mode:
        raise ValueError("an int8 PoseNet takes its weights from utils/quant."
                         "quantize_posenet, not from an initializer")
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
            uniform_(m.conv.weight, math.sqrt(6.0 / m.conv.weight[0].numel()))
            if m.folded:
                nn.init.zeros_(m.conv.bias)
            else:
                m.bn.reset_parameters()
    head = getattr(net.backbone, "final_conv", None)
    if head is not None:
        normal_(head.weight, 0.01)
        nn.init.zeros_(head.bias)
    head = getattr(net.backbone, "output", None)
    if head is not None:
        # variance_scaling(1, fan_in, truncated_normal): the normal cut at two
        # standard deviations, rescaled to keep the variance 1 / fan_in
        std = math.sqrt(1.0 / head.weight.shape[1]) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(head.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        nn.init.zeros_(head.bias)
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
