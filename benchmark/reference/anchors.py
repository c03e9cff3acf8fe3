"""Static anchor grids (frozen copy of
`kd6d_pose_adlp_tpu_torch/models/anchors.py`).

One square anchor per cell: cx = (col + 0.5) * stride, cy = (row + 0.5) *
stride, w = h = size; levels concatenated, row-major within a level — the
cell order of the network's flat outputs.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def make_anchors(input_res: int, strides: Tuple[int, ...],
                 sizes: Tuple[int, ...]) -> np.ndarray:
    """(A, 4) float32 [cx, cy, w, h], rows in row-major (y, x) order per level."""
    assert len(strides) == len(sizes)
    out = []
    for stride, size in zip(strides, sizes):
        g = input_res // stride
        ys = (np.arange(g, dtype=np.float32) + 0.5) * stride
        xs = (np.arange(g, dtype=np.float32) + 0.5) * stride
        cy, cx = np.meshgrid(ys, xs, indexing="ij")
        lvl = np.stack(
            [cx.reshape(-1), cy.reshape(-1),
             np.full(g * g, float(size), np.float32),
             np.full(g * g, float(size), np.float32)], axis=1)
        out.append(lvl)
    return np.concatenate(out, axis=0).astype(np.float32)


def level_slices(input_res: int, strides: Sequence[int]):
    """[(start, end)] per level into the flat anchor axis."""
    spans, start = [], 0
    for stride in strides:
        g = input_res // stride
        spans.append((start, start + g * g))
        start += g * g
    return spans
