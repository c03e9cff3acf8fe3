"""Checkpoint loading (port of `kd6d_pose_adlp_tpu/utils/checkpoint.py:99`,
`load_params_loose` only).

The port's checkpoints are `torch.save`d state_dicts. Saving and restoring a
whole train state, the config hash, and reading the JAX package's msgpack
checkpoints are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn


def load_params_loose(path: str, module: nn.Module) -> int:
    """Partial ("loose") restore of a state_dict file into `module`: keys the
    module lacks are dropped, tensors whose shape differs are skipped, and
    the module keeps its own values for every key the file lacks (reference
    libs/train_libs.py:99-105). Returns the number of tensors loaded."""
    restored = torch.load(path, map_location="cpu", weights_only=True)
    own = module.state_dict()
    n_loaded = 0
    for k, v in restored.items():
        if k in own and tuple(own[k].shape) == tuple(v.shape):
            own[k] = v
            n_loaded += 1
    module.load_state_dict(own, strict=True)
    return n_loaded
