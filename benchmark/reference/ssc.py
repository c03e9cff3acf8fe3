"""SSC positive sampling, fixed-shape and batched (frozen copy of
`kd6d_pose_adlp_tpu_torch/ops/ssc.py`).

Candidate cells are anchor centres inside a GT's instance mask; each
(level, GT) keeps its nk candidates of smallest uniform score, nk from the
SSC quota formula. The uniform draw (B, A, G) is an argument, so a test can
hand both frameworks the same numbers; without one it comes from an
explicit `torch.Generator`.

Ties: XLA's `top_k` and `argmax` put the lowest index first. `torch.topk`
promises no order, so the selection here is a stable ascending sort, and
the first selected GT is taken as the smallest selected index.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import anchors as anchor_lib

INF = 1e9


def level_quotas(spans: torch.Tensor, level_sizes: Tuple[int, ...],
                 positive_num: int, positive_lambda: float) -> torch.Tensor:
    """spans (..., G) object box spans -> nk (..., L, G) int32 quotas,
    round-half-up by truncating (nk + 0.5) like the JAX astype(int32)."""
    lv = torch.as_tensor(level_sizes, dtype=torch.float32, device=spans.device)
    dk = torch.abs(torch.log2(spans[..., None, :] / lv[:, None]))
    w = torch.exp(-positive_lambda * dk * dk)
    nk = positive_num * w / w.sum(dim=-2, keepdim=True)
    return (nk + 0.5).to(torch.int32)


def gt_box_spans(kp2d: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """kp2d (..., G, 8, 2) projected corners (crop frame); valid (..., G) bool
    -> (..., G) max box side with the +1 convention; invalid GTs get 1."""
    x1, x2 = kp2d[..., 0].amin(-1), kp2d[..., 0].amax(-1)
    y1, y2 = kp2d[..., 1].amin(-1), kp2d[..., 1].amax(-1)
    span = torch.maximum(x2 - x1 + 1.0, y2 - y1 + 1.0)
    return torch.where(valid, span, torch.ones_like(span))


def _select_k_smallest(r_lvl: torch.Tensor, nk_lvl: torch.Tensor,
                       k_cap: int) -> torch.Tensor:
    """r_lvl (B, Al, G) scores, nk_lvl (B, G) quotas (<= k_cap) -> (B, Al, G)
    bool: the cell is among the nk smallest scores of its (image, GT)
    column, ties to the lower cell index."""
    B, Al, G = r_lvl.shape
    kk = min(k_cap, Al)
    idx = torch.sort(r_lvl, dim=1, stable=True).indices[:, :kk]   # (B, kk, G)
    take = torch.arange(kk, device=r_lvl.device)[None, :, None] < nk_lvl[:, None, :]
    sel = torch.zeros((B, Al, G), dtype=torch.bool, device=r_lvl.device)
    return sel.scatter_(1, idx, take)


def ssc_assign(mask: torch.Tensor,          # (B, H, W) int instance ids
               class_ids: torch.Tensor,     # (B, G) int, -1 pad
               kp2d: torch.Tensor,          # (B, G, 8, 2) corners, crop frame
               *,
               input_res: int,
               strides: Tuple[int, ...],
               sizes: Tuple[int, ...],
               positive_num: int = 10,
               positive_lambda: float = 1.0,
               uniform: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
    """-> (labels (B, A) int32 in {-1, 0, 1..C}, matched_gt (B, A) int64).

    `uniform` (B, A, G) in [0, 1) is the random score of each (cell, GT);
    if None it is drawn with `torch.rand` from `generator` on the mask's
    device."""
    B, G = class_ids.shape
    dev = mask.device
    anchors = torch.as_tensor(anchor_lib.make_anchors(input_res, tuple(strides),
                                                      tuple(sizes)), device=dev)
    A = anchors.shape[0]
    H, W = mask.shape[1:]

    # mask value at each anchor centre (floor + clamp)
    cx = anchors[:, 0].clamp(0, W - 1).to(torch.int64)
    cy = anchors[:, 1].clamp(0, H - 1).to(torch.int64)
    mask_at = mask[:, cy, cx]                                    # (B, A)

    valid_gt = class_ids >= 0                                    # (B, G)
    gt_idx = torch.arange(1, G + 1, dtype=mask_at.dtype, device=dev)
    cand = (mask_at[:, :, None] == gt_idx) & valid_gt[:, None, :]  # (B, A, G)

    spans = gt_box_spans(kp2d, valid_gt)                         # (B, G)
    nk = level_quotas(spans, sizes, positive_num, positive_lambda)  # (B, L, G)

    if uniform is None:
        uniform = torch.rand((B, A, G), generator=generator, device=dev)
    elif uniform.shape != (B, A, G):
        raise ValueError(f"uniform {tuple(uniform.shape)} != {(B, A, G)}")
    r = torch.where(cand, uniform.to(torch.float32),
                    torch.full((), INF, device=dev))

    selected = torch.cat([
        _select_k_smallest(r[:, s:e], nk[:, li], positive_num) & cand[:, s:e]
        for li, (s, e) in enumerate(anchor_lib.level_slices(input_res, strides))],
        dim=1)                                                   # (B, A, G)

    is_pos = selected.any(-1)
    g_ar = torch.arange(G, device=dev)
    first = torch.where(selected, g_ar, G).amin(-1)              # first selected GT
    matched_gt = torch.where(is_pos, first, torch.zeros_like(first))
    in_any_mask = cand.any(-1)

    matched_cls = torch.gather(class_ids, 1, matched_gt)         # (B, A)
    labels = torch.where(is_pos, matched_cls + 1,
                         torch.where(in_any_mask, -1, 0)).to(torch.int32)
    return labels, matched_gt
