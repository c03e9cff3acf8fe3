"""Per-dataset constants as torch tensors (port of
`kd6d_pose_adlp_tpu/data/batch.py:34-67`). The training `Batch` waits for
the training slice; serving takes images, crop affines and class ids
directly."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TaskConsts(NamedTuple):
    """K (3,3) internal intrinsics; inv_K (3,3); kp3d (n_fg,8,3) 3D bbox
    corners per class (mm); diameters (n_fg,) mesh diameters (mm)."""
    K: torch.Tensor
    inv_K: torch.Tensor
    kp3d: torch.Tensor
    diameters: torch.Tensor

    @staticmethod
    def create(K: np.ndarray, kp3d: np.ndarray, diameters,
               device="cuda") -> "TaskConsts":
        K = np.asarray(K, np.float32).reshape(3, 3)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return TaskConsts(K=f32(K), inv_K=f32(np.linalg.inv(K)),
                          kp3d=f32(kp3d), diameters=f32(diameters))

    def to(self, device) -> "TaskConsts":
        return TaskConsts(*(t.to(device) for t in self))
