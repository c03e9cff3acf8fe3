"""Host batch assembly (port of `kd6d_pose_adlp_tpu/data/pipeline.py:283`,
`collate` only). The BOP host pipeline (`BOPPoseDataset`, `PrefetchLoader`)
is not ported yet."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .batch import Batch


def collate(samples: List[Dict]) -> Batch:
    """Stack sample dicts (image, mask, class_ids, rotations, translations,
    bbox_trans) into one Batch of CPU tensors."""
    stack = lambda k: np.stack([s[k] for s in samples])
    return Batch.from_numpy(images=stack("image"), mask=stack("mask"),
                            class_ids=stack("class_ids"), rotations=stack("rotations"),
                            translations=stack("translations"),
                            bbox_trans=stack("bbox_trans"))
