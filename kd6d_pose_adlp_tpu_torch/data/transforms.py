"""Image normalisation constants and the keep-ratio internal-frame fit
(copies of `kd6d_pose_adlp_tpu/data/transforms.py:23-38`). The host
augmentation pipeline is not ported yet."""
from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def internal_frame_matrix(width: int, height: int, target_w: int, target_h: int
                          ) -> np.ndarray:
    """Keep-ratio center-fit 3x3 matrix of a (width, height) frame into the
    (target_w, target_h) internal frame (reference libs/transform.py Resize)."""
    cx, cy = width / 2.0, height / 2.0
    if (target_w / target_h) > (width / height):
        scale = target_h / height
    else:
        scale = target_w / width
    return np.array([[scale, 0.0, -scale * cx + target_w / 2],
                     [0.0, scale, -scale * cy + target_h / 2],
                     [0.0, 0.0, 1.0]], np.float32)
