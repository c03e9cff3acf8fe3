"""Image normalisation constants (copy of `kd6d_pose_adlp_tpu/data/
transforms.py:23-24`). The host augmentation pipeline is not ported yet."""
from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
