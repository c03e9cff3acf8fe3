"""Fixed-shape keypoint voting (port of `kd6d_pose_adlp_tpu/ops/voting.py`).

1. candidate cells: sigmoid score > confidence threshold,
2. box size from the reference's prefix-max-confidence scan over levels,
3. per-level quota nk from the SSC formula over the FULL anchor_sizes list,
4. per-level top-nk cells by score, compacted into a fixed (max_votes,) set.

Ties: `lax.top_k` and the stable argsort of the JAX version put the lower
index first; `torch.topk` promises no order, so every selection here is a
stable sort (`torch.sort(stable=True)`) and a slice.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..models import anchors as anchor_lib
from ..models import coder
from .ssc import level_quotas

NEG = -1e9


class Votes(NamedTuple):
    """One batch's votes; a pool's (`Votes.stack`) has a leading pool axis
    on every field, and `pool_votes.take(i)` is batch i's."""
    kp2d: torch.Tensor      # (B, V, 8, 2) decoded keypoints (crop frame)
    score: torch.Tensor     # (B, V) sigmoid scores (0 for padding)
    valid: torch.Tensor     # (B, V) bool
    box_size: torch.Tensor  # (B,) reprojected box size used for quotas

    @staticmethod
    def stack(votes: Sequence["Votes"]) -> "Votes":
        return Votes(*(torch.stack(ts) for ts in zip(*votes)))

    def take(self, i) -> "Votes":
        return Votes(*(t[i] for t in self))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis over dim 1 for (B, n, ...) x and (B, k) idx."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def vote_cells(scores: torch.Tensor,   # (B, A) sigmoid scores of ONE class
               pred16: torch.Tensor,   # (B, A, 16) class-selected regression
               *,
               input_res: int,
               strides: Tuple[int, ...],
               all_sizes: Tuple[int, ...],
               confidence_th: float = 0.1,
               positive_num: int = 10,
               positive_lambda: float = 1.0,
               max_votes: int = 64) -> Votes:
    B, A = scores.shape
    dev = scores.device
    L = len(strides)
    sizes = tuple(all_sizes[:L])
    anchors = torch.as_tensor(anchor_lib.make_anchors(input_res, tuple(strides),
                                                      sizes), device=dev)
    slices = anchor_lib.level_slices(input_res, strides)

    kp2d = coder.decode(pred16, anchors)                 # (B, A, 8, 2)
    span = torch.maximum(
        kp2d[..., 0].amax(-1) - kp2d[..., 0].amin(-1),
        kp2d[..., 1].amax(-1) - kp2d[..., 1].amin(-1))   # (B, A), no +1 here
    masked = torch.where(scores > confidence_th, scores,
                         torch.full_like(scores, NEG))

    # per-level best candidate (first max on ties) and its size
    best_s, best_sz = [], []
    for s, e in slices:
        idx = torch.argmax(masked[:, s:e], dim=1, keepdim=True)
        bs = torch.gather(masked[:, s:e], 1, idx)[:, 0]
        bz = torch.gather(span[:, s:e], 1, idx)[:, 0]
        best_s.append(bs)
        best_sz.append(torch.where(bs > NEG / 2, bz, torch.zeros_like(bz)))
    best_s = torch.stack(best_s, dim=1)                  # (B, L)
    best_sz = torch.stack(best_sz, dim=1)

    # a level is considered iff its best score beats all earlier levels' best
    prev_max = torch.cat([torch.zeros((B, 1), device=dev),
                          torch.cummax(best_s, dim=1).values[:, :-1]], dim=1)
    considered = best_s > prev_max
    box_size = torch.where(considered, best_sz,
                           torch.zeros_like(best_sz)).amax(dim=1)  # (B,)

    nk_full = level_quotas(box_size.clamp_min(1e-3)[:, None], all_sizes,
                           positive_num, positive_lambda)          # (B, L_all, 1)
    nk = nk_full[:, :L, 0]

    k_lvl = min(positive_num + 1, max_votes)
    sel_scores, sel_idx, sel_valid = [], [], []
    for li, (s, e) in enumerate(slices):
        k = min(k_lvl, e - s)
        srt = torch.sort(masked[:, s:e], dim=1, descending=True, stable=True)
        top_v, top_i = srt.values[:, :k], srt.indices[:, :k]
        rank = torch.arange(k, device=dev)[None]
        ok = (rank < nk[:, li:li + 1]) & (top_v > NEG / 2)
        sel_scores.append(torch.where(ok, top_v, torch.zeros_like(top_v)))
        sel_idx.append(top_i + s)
        sel_valid.append(ok)
    sel_scores = torch.cat(sel_scores, dim=1)
    sel_idx = torch.cat(sel_idx, dim=1)
    sel_valid = torch.cat(sel_valid, dim=1)

    # compact valid votes first (stable), pad/trim to max_votes
    order = torch.sort((~sel_valid).to(torch.int32), dim=1, stable=True).indices
    sel_scores = torch.gather(sel_scores, 1, order)[:, :max_votes]
    sel_idx = torch.gather(sel_idx, 1, order)[:, :max_votes]
    sel_valid = torch.gather(sel_valid, 1, order)[:, :max_votes]
    pad = max_votes - sel_scores.shape[1]
    if pad > 0:
        sel_scores = torch.nn.functional.pad(sel_scores, (0, pad))
        sel_idx = torch.nn.functional.pad(sel_idx, (0, pad))
        sel_valid = torch.nn.functional.pad(sel_valid, (0, pad))

    return Votes(kp2d=_take(kp2d, sel_idx), score=sel_scores, valid=sel_valid,
                 box_size=box_size)


def votes_to_internal_frame(votes: Votes, bbox_trans: torch.Tensor) -> torch.Tensor:
    """Map crop-frame votes to the internal 640x480 frame via inv(bbox_trans).
    bbox_trans (B, 2, 3) -> (B, V, 8, 2)."""
    inv = coder.invert_bbox_trans(bbox_trans)            # (B, 2, 3)
    A = inv[:, None, :2, :2]
    t = inv[:, None, :2, 2]
    return torch.matmul(votes.kp2d, A.transpose(-1, -2)) + t[:, :, None, :]
