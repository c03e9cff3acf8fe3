"""Fixed-shape batch and per-dataset constants as torch tensors (port of
`kd6d_pose_adlp_tpu/data/batch.py:16-67`). Serving takes images, crop
affines and class ids directly; training takes a `Batch`, or a pool of them
(`Batch.stack`: every field with a leading pool axis; `pool.take(i)` is
batch i, as the JAX package's tree_map(lambda x: x[i], pool))."""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class Batch(NamedTuple):
    """One training step of data. All shapes static.

    images:       (B, R, R, 3) float32, normalized RGB (DZI crops)
    mask:         (B, R, R)    int32 instance ids: 0 bg, 1..G objects, -1 erased
    class_ids:    (B, G)       int32 0-based class ids, -1 padding
    rotations:    (B, G, 3, 3) float32
    translations: (B, G, 3)    float32 (mm)
    bbox_trans:   (B, 2, 3)    float32 affine internal-frame -> crop
    """
    images: torch.Tensor
    mask: torch.Tensor
    class_ids: torch.Tensor
    rotations: torch.Tensor
    translations: torch.Tensor
    bbox_trans: torch.Tensor

    @staticmethod
    def from_numpy(**arrays) -> "Batch":
        return Batch(**{k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in arrays.items()})

    def to(self, device) -> "Batch":
        return Batch(*(t.to(device, non_blocking=True) for t in self))

    @staticmethod
    def stack(batches: Sequence["Batch"]) -> "Batch":
        """A pool: each field stacked along a new leading axis."""
        return Batch(*(torch.stack(ts) for ts in zip(*batches)))

    def take(self, i) -> "Batch":
        """Entry `i` (an int, slice or index tensor) of every field's leading
        axis: `pool.take(i)` is the pool's batch i."""
        return Batch(*(t[i] for t in self))


class TaskConsts(NamedTuple):
    """K (3,3) internal intrinsics; inv_K (3,3); kp3d (n_fg,8,3) 3D bbox
    corners per class (mm); diameters (n_fg,) mesh diameters (mm); for the
    dense binary-code head only, else None: verts (n_fg,V,3) surface points
    per class (mm) and vert_codes (n_fg,V,n_bits) their codes
    (`ops/binary_code.build_codes`)."""
    K: torch.Tensor
    inv_K: torch.Tensor
    kp3d: torch.Tensor
    diameters: torch.Tensor
    verts: Optional[torch.Tensor] = None
    vert_codes: Optional[torch.Tensor] = None

    @staticmethod
    def create(K: np.ndarray, kp3d: np.ndarray, diameters,
               verts: Optional[np.ndarray] = None,
               vert_codes: Optional[np.ndarray] = None,
               device="cuda") -> "TaskConsts":
        K = np.asarray(K, np.float32).reshape(3, 3)
        f32 = lambda a: (None if a is None else
                         torch.as_tensor(np.asarray(a, np.float32), device=device))
        return TaskConsts(K=f32(K), inv_K=f32(np.linalg.inv(K)),
                          kp3d=f32(kp3d), diameters=f32(diameters),
                          verts=f32(verts), vert_codes=f32(vert_codes))

    def to(self, device) -> "TaskConsts":
        return TaskConsts(*(None if t is None else t.to(device) for t in self))
