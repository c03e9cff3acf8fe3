"""The plain reference network: darknet_tiny_h or darknet53 -> FPN (P6/P7)
-> the shared dense head, in float32, in plain torch operations.

It follows the reference's published structure (WDRNet+, reference
models/model.py and backbone/darknet*.py): Conv (no bias) -> BatchNorm(eps
1e-5) -> LeakyReLU(0.1) units; the FPN's lateral 1x1 and output 3x3 convs
with nearest 2x upsampling, P6 from the raw top backbone map and P7 from
ReLU(P6); two towers of 4 x (3x3 conv, GroupNorm(32), ReLU), one learnable
scale a level on the regression. Parameter names are the program's
(pytorchcv's for the backbones), so one state dict loads into both.

No fused stem, no kernel: in eval mode every unit is conv -> BN from the
running statistics -> LeakyReLU, and a BN-folded teacher (`fold_bn`) is
conv with bias -> LeakyReLU. In train mode BatchNorm takes the batch's
statistics and leaves the running ones alone (the reference runs three
steps and compares no running statistic).
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import Model

PIXEL_MEAN = (0.485, 0.456, 0.406)
PIXEL_STD = (0.229, 0.224, 0.225)

# darknet_tiny_h's stages (reference backbone/darknet.py:157-180); in a
# multi-unit stage units 1, 3, 5 are 1x1 and units 2, 4 are 3x3
TINY_H = [[8], [16], [8, 64, 8, 64], [16, 128, 16, 128], [32, 256, 32, 256, 64]]
D53_LAYERS = (2, 3, 9, 9, 5)
D53_CHANNELS = (64, 128, 256, 512, 1024)


class Unit(nn.Module):
    """Conv -> BN -> LeakyReLU(0.1); `folded`: conv with bias -> LeakyReLU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 folded: bool = False):
        super().__init__()
        self.folded = folded
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, bias=folded)
        if not folded:
            self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        x = self.conv(x)
        if not self.folded:
            bn = self.bn
            if self.training:
                x = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
            else:
                x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                                 bn.bias, False, 0.0, bn.eps)
        return F.leaky_relu(x, 0.1)


class DarkUnit(nn.Module):
    def __init__(self, ch: int, folded: bool):
        super().__init__()
        self.conv1 = Unit(ch, ch // 2, 1, folded=folded)
        self.conv2 = Unit(ch // 2, ch, 3, folded=folded)

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


class TinyH(nn.Module):
    def __init__(self, folded: bool = False):
        super().__init__()
        stages, cin = OrderedDict(), 3
        for si, stage in enumerate(TINY_H):
            units = OrderedDict()
            for j, ch in enumerate(stage):
                pointwise = len(stage) > 1 and j % 2 == 0
                units[f"unit{j + 1}"] = Unit(cin, ch, 1 if pointwise else 3, folded=folded)
                cin = ch
            stages[f"stage{si + 1}"] = nn.Sequential(units)
        self.features = nn.Sequential(stages)

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        stages = list(self.features)
        for si, stage in enumerate(stages):
            x = stage(x)
            if si != len(stages) - 1:
                x = F.max_pool2d(x, 2, 2)
            outs.append(x)
        return [outs[0], outs[1], outs[2], outs[4]]


class DarkNet53(nn.Module):
    def __init__(self, folded: bool = False):
        super().__init__()
        feats = OrderedDict(init_block=Unit(3, 32, 3, folded=folded))
        cin = 32
        for si, (n, ch) in enumerate(zip(D53_LAYERS, D53_CHANNELS)):
            units = OrderedDict(unit1=Unit(cin, ch, 3, stride=2, folded=folded))
            for j in range(2, n + 1):
                units[f"unit{j}"] = DarkUnit(ch, folded)
            feats[f"stage{si + 1}"] = nn.Sequential(units)
            cin = ch
        self.features = nn.Sequential(feats)

    def forward(self, x) -> List[torch.Tensor]:
        x = self.features.init_block(x)
        outs = []
        for stage in list(self.features)[1:]:
            x = stage(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    def __init__(self, feat_channels, width: int, p6p7: bool):
        super().__init__()
        self.used = [i for i, c in enumerate(feat_channels) if c > 0]
        self.inner_convs = nn.ModuleDict(
            {str(i): nn.Conv2d(feat_channels[i], width, 1) for i in self.used})
        self.out_convs = nn.ModuleDict(
            {str(i): nn.Conv2d(width, width, 3, 1, 1) for i in self.used})
        self.p6p7 = p6p7
        if p6p7:
            self.top_blocks = nn.Module()
            self.top_blocks.p6 = nn.Conv2d(feat_channels[self.used[-1]], width, 3, 2, 1)
            self.top_blocks.p7 = nn.Conv2d(width, width, 3, 2, 1)

    def forward(self, feats):
        top = self.used[-1]
        inner = self.inner_convs[str(top)](feats[top])
        outs = [self.out_convs[str(top)](inner)]
        for i in reversed(self.used[:-1]):
            up = inner.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            inner = self.inner_convs[str(i)](feats[i]) + up
            outs.insert(0, self.out_convs[str(i)](inner))
        if self.p6p7:
            p6 = self.top_blocks.p6(feats[top])
            outs += [p6, self.top_blocks.p7(F.relu(p6))]
        return outs


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))


def _tower(width: int, n_conv: int) -> nn.Sequential:
    layers = []
    for _ in range(n_conv):
        layers += [nn.Conv2d(width, width, 3, 1, 1), nn.GroupNorm(32, width, eps=1e-5),
                   nn.ReLU()]
    return nn.Sequential(*layers)


class Head(nn.Module):
    def __init__(self, width: int, n_fg: int, n_conv: int, n_scales: int):
        super().__init__()
        self.cls_tower = _tower(width, n_conv)
        self.pose_tower = _tower(width, n_conv)
        self.cls_logits = nn.Conv2d(width, n_fg, 3, 1, 1)
        self.pose_pred = nn.Conv2d(width, n_fg * 16, 3, 1, 1)
        self.scales = nn.ModuleList([Scale() for _ in range(n_scales)])

    def forward(self, feats):
        cls, reg = [], []
        for lvl, x in enumerate(feats):
            cls.append(self.cls_logits(self.cls_tower(x)))
            reg.append(self.pose_pred(self.pose_tower(x)) * self.scales[lvl].scale)
        return cls, reg


class PoseNet(nn.Module):
    """images (B, H, W, 3): uint8 BGR crops (flipped to RGB and ImageNet-
    normalized here) or normalized float RGB -> (cls (B, A, n_fg), reg
    (B, A, n_fg * 16)), cells in NHWC order, levels concatenated."""

    def __init__(self, m: Model, n_fg: int, folded: bool = False):
        super().__init__()
        self.m = m
        if m.backbone == "darknet53":
            self.backbone = DarkNet53(folded)
        elif m.backbone == "darknet_tiny_h":
            self.backbone = TinyH(folded)
        else:
            raise ValueError(f"the reference has no backbone {m.backbone!r}")
        self.fpn = FPN(m.feat_channels, m.out_channel, m.use_higher_levels)
        self.head = Head(m.out_channel, n_fg, m.n_conv, max(5, m.num_levels))

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if images.dtype == torch.uint8:
            x = images.flip(-1).to(torch.float32)
            mean = torch.tensor(PIXEL_MEAN, device=x.device)
            std = torch.tensor(PIXEL_STD, device=x.device)
            images = (x / 255.0 - mean) / std
        feats = self.backbone(images.permute(0, 3, 1, 2))
        cls, reg = self.head(self.fpn(feats))
        B = images.shape[0]
        flat = lambda maps: torch.cat([t.permute(0, 2, 3, 1).reshape(B, -1, t.shape[1])
                                       for t in maps], dim=1)
        return flat(cls), flat(reg)


def fold_bn(state: Dict[str, torch.Tensor], eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Eval-mode BatchNorm folded into its conv, in float64, rounded to
    float32: w' = w * g / sqrt(var + eps), b' = beta - mean * g / sqrt(var +
    eps); the BN entries dropped. For a `PoseNet(folded=True)`."""
    out = dict(state)
    for key in [k for k in state if k.endswith(".conv.weight")]:
        unit = key[:-len(".conv.weight")]
        if f"{unit}.bn.weight" not in state:
            continue
        g, b, mean, var = (state[f"{unit}.bn.{n}"].double()
                           for n in ("weight", "bias", "running_mean", "running_var"))
        f = g / torch.sqrt(var + eps)
        out[key] = (state[key].double() * f.reshape(-1, 1, 1, 1)).float()
        out[f"{unit}.conv.bias"] = (b - mean * f).float()
        for n in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
            out.pop(f"{unit}.bn.{n}", None)
    return out


def init_spec(net: PoseNet, prior: float) -> Dict[str, Tuple[str, float]]:
    """How each entry of the state dict is drawn, as the program's
    initializers draw them: backbone conv weights uniform(+-sqrt(6 /
    fan_in)), FPN conv weights uniform(+-sqrt(3 / fan_in)), head conv
    weights normal(0, 0.01), biases 0 but the class logits' focal prior
    -log((1 - prior) / prior), norm weights and scales 1, BN running
    variances 1, the rest 0. -> {name: (kind, value)}, kind "uniform"
    (value the bound), "normal" (the std) or "const"."""
    spec = {}
    for name, t in net.state_dict().items():
        fan_in = t[0].numel() if t.dim() > 1 else 1
        if name.endswith("conv.weight") and name.startswith("backbone."):
            spec[name] = ("uniform", math.sqrt(6.0 / fan_in))
        elif name.startswith("fpn.") and name.endswith("weight"):
            spec[name] = ("uniform", math.sqrt(3.0 / fan_in))
        elif name.startswith("head.") and name.endswith("weight") and t.dim() == 4:
            spec[name] = ("normal", 0.01)
        elif name == "head.cls_logits.bias":
            spec[name] = ("const", -math.log((1 - prior) / prior))
        elif name.endswith(("bn.weight", "running_var", ".scale")) or (
                name.startswith("head.") and name.endswith("weight")):
            spec[name] = ("const", 1.0)
        else:
            spec[name] = ("const", 0.0)
    return spec
