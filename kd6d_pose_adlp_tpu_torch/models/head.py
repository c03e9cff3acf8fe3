"""Dense pose head (port of `kd6d_pose_adlp_tpu/models/head.py`).

Two towers of n_conv x (3x3 conv, GroupNorm(32, eps 1e-5), ReLU), shared
across pyramid levels; cls tower -> cls_logits (n_fg channels), pose tower ->
pose_pred (n_fg*16 channels) times a learnable per-level scalar. Names
mirror the reference Sequential (`cls_tower.{3k}` conv, `{3k+1}` GN).
Convolutions and GroupNorm results are in `dtype` (`models/blocks`); the
scaled regression is float32, as JAX's bf16 map times its float32 scale.
Under `quant_mode` the tower convs are `QConv`s; cls_logits and pose_pred
stay float (JAX `head.py:39-42`). `code_bits` > 0 adds the dense
binary-code head's `code_pred` on the pose tower (JAX `head.py:57-58`):
n_fg * (code_bits + 2) channels, each class's block its code logits and
the 2D offset of its surface point, with no Scale; a float conv under
`quant_mode` too.
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
                 quant_mode: str = "", code_bits: int = 0):
        super().__init__()
        self.cls_tower = _tower(width, n_conv, dtype, quant_mode)
        self.pose_tower = _tower(width, n_conv, dtype, quant_mode)
        self.cls_logits = Conv2d(width, n_fg, 3, padding=1, dtype=dtype)
        self.pose_pred = Conv2d(width, n_fg * 16, 3, padding=1, dtype=dtype)
        self.code_pred = (Conv2d(width, n_fg * (code_bits + 2), 3, padding=1, dtype=dtype)
                          if code_bits > 0 else None)
        self.scales = nn.ModuleList([Scale() for _ in range(n_levels)])

    def forward(self, feats: List[torch.Tensor]) -> Tuple[List[torch.Tensor], ...]:
        """(logits, pose_reg), and the code maps when `code_pred` exists,
        each a list over the levels."""
        logits, pose_reg, codes = [], [], []
        for lvl, x in enumerate(feats):
            logits.append(self.cls_logits(self.cls_tower(x)))
            p = self.pose_tower(x)
            pose_reg.append(self.scales[lvl](self.pose_pred(p)))
            if self.code_pred is not None:
                codes.append(self.code_pred(p))
        if self.code_pred is not None:
            return logits, pose_reg, codes
        return logits, pose_reg
