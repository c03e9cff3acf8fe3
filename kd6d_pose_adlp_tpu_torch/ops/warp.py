"""Affine image warping on the device, the host pipeline's crop in tensor
ops (port of `kd6d_pose_adlp_tpu/ops/warp.py`).

The raw-frame endpoint (`engine/serving.build_frame_infer_fn`) takes RAW
camera frames and a (center, scale) detection window and does the
keep-ratio internal-frame fit and the DZI crop itself: ONE composed
raw -> crop affine, gray 128 past the raw image, black 0 past the 640x480
internal frame; the bilinear taps blend the border constant as
cv2.warpAffine(BORDER_CONSTANT) does. float32 throughout, rounded
half-to-even to uint8 at the end.
"""
from __future__ import annotations

from typing import Tuple

import torch


def dzi_affine_rows(center: torch.Tensor, scale: torch.Tensor, res: int) -> torch.Tensor:
    """Batched (B, 2, 3) DZI crop affine (rot 0): maps the square window
    (center (B, 2), side scale (B,)) in source coordinates onto res²."""
    r = res / scale
    zeros = torch.zeros_like(r)
    tx = res / 2.0 - r * center[:, 0]
    ty = res / 2.0 - r * center[:, 1]
    row0 = torch.stack([r, zeros, tx], dim=-1)
    row1 = torch.stack([zeros, r, ty], dim=-1)
    return torch.stack([row0, row1], dim=1).to(torch.float32)


def compose_affine(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) affine composition A∘B (B first)."""
    RA, tA = A[..., :2], A[..., 2]
    RB, tB = B[..., :2], B[..., 2]
    R = torch.einsum("...ij,...jk->...ik", RA, RB)
    t = torch.einsum("...ij,...j->...i", RA, tB) + tA
    return torch.cat([R, t[..., None]], dim=-1)


def invert_affine(M: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) -> (..., 2, 3) inverse."""
    a, b, tx = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    c, d, ty = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    row0 = torch.stack([ia, ib, itx], dim=-1)
    row1 = torch.stack([ic, id_, ity], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _grid(Minv: torch.Tensor, res: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source coordinates (B, res, res) of every output pixel under the
    inverse affines Minv (B, 2, 3); x runs along the last axis."""
    xs = torch.arange(res, dtype=torch.float32, device=Minv.device)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    m = Minv[:, :, :, None, None]
    sx = m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]
    sy = m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]
    return sx, sy


def _sample_bilinear(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                     border: float) -> torch.Tensor:
    """img (B, H, W, C) float; sx, sy (B, res, res) source coordinates ->
    (B, res, res, C). A tap outside the image contributes the border
    constant, blended bilinearly (cv2 BORDER_CONSTANT)."""
    B, H, W, _ = img.shape
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    b = torch.arange(B, device=img.device)[:, None, None]

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[b, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return torch.where(inb[..., None], v, torch.full_like(v, border))

    v00, v01 = tap(y0i, x0i), tap(y0i, x0i + 1)
    v10, v11 = tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def affine_crop(img: torch.Tensor, M: torch.Tensor, res: int,
                border: float = 0.0) -> torch.Tensor:
    """Warp images (B, H, W, C) by the (B, 2, 3) affines M (source -> output
    coordinates, the host `transforms.warp_image` convention) onto a res²
    grid -> (B, res, res, C) float32."""
    sx, sy = _grid(invert_affine(M), res)
    return _sample_bilinear(img.to(torch.float32), sx, sy, border)


def frame_to_crop(frames: torch.Tensor, M_int: torch.Tensor, center: torch.Tensor,
                  scale: torch.Tensor, res: int,
                  internal_wh: Tuple[int, int] = (640, 480)
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched raw frame -> DZI crop, on the frames' device.

    frames (B, H, W, 3) uint8 BGR; M_int (2, 3) the static raw -> internal
    fit (`data/transforms.internal_frame_matrix` of the frame size); center
    (B, 2) and scale (B,) the DZI window in INTERNAL-frame coordinates.
    Returns (crops (B, res, res, 3) uint8, bbox_trans (B, 2, 3)), bbox_trans
    the internal -> crop affine the postprocess takes. Gray 128 where the
    window sees past the raw image, black 0 past the internal frame."""
    W, H = internal_wh
    Mc = dzi_affine_rows(center, scale, res)
    Mfull = compose_affine(Mc, M_int.to(torch.float32).expand(Mc.shape))
    crop = affine_crop(frames, Mfull, res, border=128.0)
    # blackout outside the internal frame (the second warp's border)
    ix, iy = _grid(invert_affine(Mc), res)
    inside = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
    crop = torch.where(inside[..., None], crop, torch.zeros_like(crop))
    return torch.round(crop).clamp(0, 255).to(torch.uint8), Mc
