"""Hierarchical binary surface codes, the dense binary-code (zebra) head's
correspondences (port of `kd6d_pose_adlp_tpu/ops/binary_code.py`).

Each surface point of a class gets an n-bit code from a balanced
hierarchical bisection of its vertex set (bit 0 the root split); a cell
regresses the code of the surface point it sees, and decoding the code
picks one vertex, so every confident cell gives one 2D-3D correspondence.

`build_codes` and `sample_box_surface` are host-side numpy, bit-identical
to the JAX package's. `decode_vertex` is one matmul and an argmin: with bit
weight w_i = 2^-i (larger than all later bits together) the weighted
Hamming argmin over the vertex codes is the greedy tree walk for hard bits.
It runs in fp32 with TF32 off, as JAX's `Precision.HIGHEST` einsum.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.precision import full_fp32


def build_codes(verts: np.ndarray, n_bits: int) -> np.ndarray:
    """Balanced hierarchical bisection codes.

    verts (V, 3) float -> (V, n_bits) float32 in {0, 1}. Each group splits
    at the median of its projection onto its principal axis, ties kept in
    index order (stable sort); a group of one vertex stops splitting and
    keeps its later bits 0. Unique per vertex once V <= 2^n_bits and the
    vertices are distinct. A degenerate group (all its points equal) has
    no principal axis and splits by index."""
    verts = np.asarray(verts, np.float64)
    V = verts.shape[0]
    codes = np.zeros((V, n_bits), np.float32)
    groups = [np.arange(V)]
    for bit in range(n_bits):
        nxt = []
        for g in groups:
            if len(g) <= 1:
                nxt.append(g)
                continue
            X = verts[g] - verts[g].mean(0)
            try:
                _, s, vt = np.linalg.svd(X, full_matrices=False)
                d = vt[0]
                if not np.isfinite(d).all() or s[0] < 1e-12:
                    raise np.linalg.LinAlgError
            except np.linalg.LinAlgError:
                # ndarray.ptp is gone in NumPy 2; np.ptp is the same function
                d = np.eye(3)[int(np.argmax(np.ptp(X, axis=0)))]
            proj = X @ d
            order = np.argsort(proj, kind="stable")
            half = len(g) // 2
            hi = g[order[half:]]
            codes[hi, bit] = 1.0
            nxt.append(g[order[:half]])
            nxt.append(hi)
        groups = nxt
    return codes


def sample_box_surface(corners: np.ndarray, n_per_axis: int = 6) -> np.ndarray:
    """Deterministic grid sample of an axis-aligned box surface.

    corners (8, 3) (`data/synthetic.make_box_corners`) -> (V, 3) float32,
    an n_per_axis² grid on each of the 6 faces with the points shared by
    several faces kept once (V = 6 n² - 12 n + 8), sorted lexicographically.
    The synthetic stand-in for a mesh's vertex set."""
    h = np.abs(np.asarray(corners, np.float64)).max(0)  # half sizes (3,)
    lin = [np.linspace(-h[i], h[i], n_per_axis) for i in range(3)]
    pts = []
    for axis in range(3):
        u, v = [a for a in range(3) if a != axis]
        gu, gv = np.meshgrid(lin[u], lin[v], indexing="ij")
        for sign in (-1.0, 1.0):
            f = np.zeros((n_per_axis * n_per_axis, 3))
            f[:, u] = gu.ravel()
            f[:, v] = gv.ravel()
            f[:, axis] = sign * h[axis]
            pts.append(f)
    pts = np.concatenate(pts, 0)
    pts = np.unique(np.round(pts, 6), axis=0)
    return pts.astype(np.float32)


def decode_vertex(code_prob: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Weighted-Hamming argmin decode: soft bits -> vertex index.

    code_prob (..., n_bits) in [0, 1] (sigmoid outputs); codes (V, n_bits)
    in {0, 1}, or (B, V, n_bits) per image against code_prob (B, K,
    n_bits). cost(., v) = sum_i w_i (p_i + c_vi - 2 p_i c_vi), w_i = 2^-i,
    as one matmul p @ (w - 2 w c)^T plus a per-vertex constant. Returns
    (...,) int64 indices, the first on equal costs (as jnp.argmin)."""
    with full_fp32():
        n_bits = codes.shape[-1]
        w = 2.0 ** (-torch.arange(n_bits, dtype=torch.float32, device=codes.device))
        cw = codes.to(torch.float32) * w                          # (..., V, nb)
        const = cw.sum(-1)
        if codes.dim() > 2:
            const = const.unsqueeze(-2)                           # (B, 1, V)
        cost = torch.matmul(code_prob.to(torch.float32),
                            (w - 2.0 * cw).transpose(-1, -2)) + const
        return torch.argmin(cost, dim=-1)


def code_bce(code_logits: torch.Tensor, code_tgt: torch.Tensor,
             weight: torch.Tensor) -> torch.Tensor:
    """Per-bit sigmoid BCE summed over the bits, weighted per element.

    code_logits (..., n_bits); code_tgt (..., n_bits) in [0, 1] (hard codes
    or a teacher's probabilities: the same formula distills both); weight
    (...,), zero on padded slots. The unnormalized sum, as the corner
    losses' raw sums."""
    z = code_logits.to(torch.float32)
    t = code_tgt.to(torch.float32)
    # stable BCE with logits: max(z, 0) - z t + log1p(exp(-|z|))
    per_bit = torch.clamp_min(z, 0.0) - z * t + torch.log1p(torch.exp(-torch.abs(z)))
    return (per_bit.sum(-1) * weight).sum()
