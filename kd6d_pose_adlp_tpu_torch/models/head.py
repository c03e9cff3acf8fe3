"""Dense pose head (port of `kd6d_pose_adlp_tpu/models/head.py`).

Two towers of n_conv x (3x3 conv, GroupNorm(32, eps 1e-5), ReLU), shared
across pyramid levels; cls tower -> cls_logits (n_fg channels), pose tower ->
pose_pred (n_fg*16 channels) times a learnable per-level scalar. Names
mirror the reference Sequential (`cls_tower.{3k}` conv, `{3k+1}` GN).
Convolutions and GroupNorm results are in `dtype` (`models/blocks`); the
scaled regression is float32, as JAX's bf16 map times its float32 scale.
Under `quant_mode` the tower convs are `QConv`s; cls_logits and pose_pred
stay float (JAX `head.py:39-42`).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from .blocks import Conv2d, GroupNorm, QConv


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return x * self.scale


def _tower(width: int, n_conv: int, dtype: torch.dtype, quant_mode: str) -> nn.Sequential:
    layers = []
    for _ in range(n_conv):
        conv = (QConv(width, width, 3, mode=quant_mode, dtype=dtype) if quant_mode
                else Conv2d(width, width, 3, padding=1, dtype=dtype))
        layers += [conv, GroupNorm(32, width, eps=1e-5, dtype=dtype), nn.ReLU()]
    return nn.Sequential(*layers)


class PoseHead(nn.Module):
    def __init__(self, width: int, n_fg: int, n_conv: int = 4,
                 n_levels: int = 5, dtype: torch.dtype = torch.float32,
                 quant_mode: str = ""):
        super().__init__()
        self.cls_tower = _tower(width, n_conv, dtype, quant_mode)
        self.pose_tower = _tower(width, n_conv, dtype, quant_mode)
        self.cls_logits = Conv2d(width, n_fg, 3, padding=1, dtype=dtype)
        self.pose_pred = Conv2d(width, n_fg * 16, 3, padding=1, dtype=dtype)
        self.scales = nn.ModuleList([Scale() for _ in range(n_levels)])

    def forward(self, feats: List[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        logits, pose_reg = [], []
        for lvl, x in enumerate(feats):
            logits.append(self.cls_logits(self.cls_tower(x)))
            pose_reg.append(self.scales[lvl](self.pose_pred(self.pose_tower(x))))
        return logits, pose_reg
