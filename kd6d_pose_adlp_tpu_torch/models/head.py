"""Dense pose head (port of `kd6d_pose_adlp_tpu/models/head.py`).

Two towers of n_conv x (3x3 conv, GroupNorm(32, eps 1e-5), ReLU), shared
across pyramid levels; cls tower -> cls_logits (n_fg channels), pose tower ->
pose_pred (n_fg*16 channels) times a learnable per-level scalar. Names
mirror the reference Sequential (`cls_tower.{3k}` conv, `{3k+1}` GN).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return x * self.scale


def _tower(width: int, n_conv: int) -> nn.Sequential:
    layers = []
    for _ in range(n_conv):
        layers += [nn.Conv2d(width, width, 3, padding=1),
                   nn.GroupNorm(32, width, eps=1e-5), nn.ReLU()]
    return nn.Sequential(*layers)


class PoseHead(nn.Module):
    def __init__(self, width: int, n_fg: int, n_conv: int = 4,
                 n_levels: int = 5):
        super().__init__()
        self.cls_tower = _tower(width, n_conv)
        self.pose_tower = _tower(width, n_conv)
        self.cls_logits = nn.Conv2d(width, n_fg, 3, padding=1)
        self.pose_pred = nn.Conv2d(width, n_fg * 16, 3, padding=1)
        self.scales = nn.ModuleList([Scale() for _ in range(n_levels)])

    def forward(self, feats: List[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        logits, pose_reg = [], []
        for lvl, x in enumerate(feats):
            logits.append(self.cls_logits(self.cls_tower(x)))
            pose_reg.append(self.scales[lvl](self.pose_pred(self.pose_tower(x))))
        return logits, pose_reg
