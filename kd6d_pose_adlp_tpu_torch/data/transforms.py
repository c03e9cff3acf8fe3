"""Host image and annotation transforms of the BOP pipeline (port of
`kd6d_pose_adlp_tpu/data/transforms.py`), in numpy and the port's data
plane, without an image library.

Resize to the internal 640x480 frame with a K remap, the train-time
augmentations (shift / scale / rotate, background, HSV, pencil sharpen,
noise, Gaussian smooth, occlusion, grayscale) and normalisation (reference
`libs/transform.py`, `libs/train_libs.py:212-254`).
The internal-frame fit and the random shift / scale / rotate are one affine,
one resample and one pose re-fit, as in the JAX package.

`remap_poses` always solves, with one solver (`utils/pnp.solve_pnp_epnp`,
OpenCV's EPnP in float64); the JAX package keeps the old pose when cv2 is
missing. The warps and `normalize_fast` always run in the data plane; the
JAX package falls back to cv2. The cv2 calls of the HSV, sharpen, smooth and
background augmentations are the data plane's bit-equal counterparts
(`csrc/cvarith.cpp`); the numpy around them, and the draws from the
generator, are the JAX package's own, in its order and count.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..utils import geometry as geo
from ..utils.pnp import solve_pnp_epnp
from . import imread, native

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


def remap_poses(src_K, Rs, Ts, kp3d_per_obj, dst_K, M3):
    """Re-fit each pose under dst_K after the 2D affine M3: project the
    object's 3D corners with src_K, warp them, solve EPnP under dst_K
    (reference libs/utils.py:504-526 via libs/poses.py:44-66). float32 out."""
    new_Rs, new_Ts = [], []
    for R, T, pt3d in zip(Rs, Ts, kp3d_per_obj):
        MK = M3 @ src_K if M3.shape == (3, 3) else np.vstack([M3, [0, 0, 1]]) @ src_K
        pts = MK @ (np.asarray(R) @ pt3d.T + np.asarray(T).reshape(3, 1))
        xy2d = (pts[:2] / (pts[2:] + 1e-8)).T
        R_new, T_new = solve_pnp_epnp(pt3d, xy2d, dst_K)
        new_Rs.append(R_new.astype(np.float32))
        new_Ts.append(T_new.astype(np.float32))
    return new_Rs, new_Ts


def random_ssr_matrix(rng: np.random.Generator, shift: float, scale: float,
                      rot: float, width: int, height: int) -> np.ndarray:
    """Random shift/scale/rotate 3x3 (reference libs/utils.py:161-179)."""
    dw, dh = int(width * shift), int(height * shift)
    px = rng.integers(-dw, dw + 1) if dw > 0 else 0
    py = rng.integers(-dh, dh + 1) if dh > 0 else 0
    ang = rng.uniform(-rot, rot) if rot > 0 else 0.0
    sf = rng.uniform(-scale, scale) + 1.0 if scale > 0 else 1.0
    return geo.shift_scale_rotate_matrix(px, py, ang, sf, width, height)


def distort_hsv(img: np.ndarray, rng, h_ratio, s_ratio, v_ratio) -> np.ndarray:
    """Scale H, S and V by 1 + U(-1, 1) x ratio each (three draws, also for a
    ratio of 0), clipped where the factor exceeds 1 (reference
    libs/transform.py RandomHSV)."""
    hsv = native.bgr2hsv(img)
    h = hsv[:, :, 0].astype(np.float32)
    s = hsv[:, :, 1].astype(np.float32)
    v = hsv[:, :, 2].astype(np.float32)
    a = rng.uniform(-1, 1) * h_ratio + 1
    b = rng.uniform(-1, 1) * s_ratio + 1
    c = rng.uniform(-1, 1) * v_ratio + 1
    hsv[:, :, 0] = (h * a) if a < 1 else np.clip(h * a, None, 179)
    hsv[:, :, 1] = (s * b) if b < 1 else np.clip(s * b, None, 255)
    hsv[:, :, 2] = (v * c) if c < 1 else np.clip(v * c, None, 255)
    return native.hsv2bgr(hsv)


def distort_noise(img: np.ndarray, rng, ratio: float) -> np.ndarray:
    """Gaussian pixel noise of a sigma drawn from [0, ratio) x 255."""
    sigma = rng.uniform(0, ratio)
    out = img.astype(np.float32) + rng.normal(0, sigma, img.shape) * 255
    return np.clip(out, 0, 255).astype(np.uint8)


def distort_smooth(img: np.ndarray, rng, ratio: float) -> np.ndarray:
    """7x7 Gaussian blur of a sigma drawn from [0, ratio)."""
    return native.gaussian_blur7(img, rng.uniform(0, ratio))


def random_occlusion(img: np.ndarray, mask: np.ndarray, rng,
                     prob: float) -> Tuple[np.ndarray, np.ndarray]:
    """Random-erasing inside the object bbox; erased pixels get mask -1
    (reference libs/transform.py RandomOcclusion)."""
    if rng.random() > prob:
        return img, mask
    ys, xs = np.nonzero(mask > 0)
    if len(xs) < 4:
        return img, mask
    x1, x2, y1, y2 = xs.min(), xs.max(), ys.min(), ys.max()
    bw, bh = x2 - x1 + 1, y2 - y1 + 1
    w = max(int(bw * rng.uniform(0.1, 0.4)), 1)
    h = max(int(bh * rng.uniform(0.1, 0.4)), 1)
    ox = int(x1 + rng.uniform(0, 1) * (bw - w))
    oy = int(y1 + rng.uniform(0, 1) * (bh - h))
    img = img.copy()
    mask = mask.copy()
    img[oy:oy + h, ox:ox + w] = rng.integers(0, 256, (h, w, img.shape[2]))
    mask[oy:oy + h, ox:ox + w] = -1
    return img, mask


def pencil_sharpen(img: np.ndarray, rng, prob: float) -> np.ndarray:
    """Edge-boost aug (reference libs/transform.py RandomPencilSharpen):
    box-blur at a drawn size, an edge image (ratio or difference), min-max
    normalised, alpha-blended back and normalised again."""
    if rng.random() >= prob:
        return img
    ks = int(rng.choice([5, 7, 9, 11]))
    blurred = native.box_blur(img, ks).astype(np.float32)
    if rng.random() < 0.5:
        edge = img / (blurred + 0.01)
    else:
        edge = img - blurred
    edge = native.normalize_minmax(edge).astype(np.uint8)
    alpha = rng.uniform(0.5, 0.95)
    out = img * (1 - alpha) + edge * alpha
    return native.normalize_minmax(out).astype(np.uint8)


class BackgroundBank:
    """Random background replacement (reference libs/transform.py
    RandomBackground): with p=0.5 the pixels outside the instance mask are
    swapped for a random image of a directory's .png / .jpg files, read as
    cv2.imread reads them, by signature whatever the name
    (`imread.read_color`: progressive and CMYK JPEG, palette, sub-8-bit,
    tRNS and Adam7 PNG, turned by EXIF orientation; TIFF) and resized
    bilinearly. A file that reads as None (missing, empty or damaged, a
    float TIFF, which IMREAD_COLOR refuses, as cv2.imread gives it) is drawn
    again, up to four draws in all as in the JAX package; a file that cv2
    reads and the port does not decode raises `native.UnsupportedImage`."""

    def __init__(self, background_dir: Optional[str]):
        self.files = []
        if background_dir and os.path.isdir(background_dir):
            self.files = [os.path.join(background_dir, f)
                          for f in sorted(os.listdir(background_dir))
                          if f.endswith((".png", ".jpg"))]

    def __call__(self, img: np.ndarray, mask: np.ndarray, rng) -> np.ndarray:
        if not self.files or rng.random() < 0.5:
            return img
        bg = None
        for _ in range(4):
            bg = imread.read_color(self.files[int(rng.integers(0, len(self.files)))])
            if bg is not None:
                break
        if bg is None:
            return img
        bg = native.resize_linear(bg, (img.shape[1], img.shape[0]))
        out = img.copy()
        keep = mask > 0
        out[~keep] = bg[~keep]
        return out


def grayscalize(img: np.ndarray) -> np.ndarray:
    """BGR uint8 -> its grey replicated to 3 channels, in the fixed point of
    `cv2.cvtColor(COLOR_BGR2GRAY)` (15 fraction bits, rounded)."""
    i = img.astype(np.int32)
    g = ((i[..., 0] * 3735 + i[..., 1] * 19235 + i[..., 2] * 9798 + (1 << 14)) >> 15)
    return np.repeat(g.astype(np.uint8)[..., None], 3, -1)


def normalize(img_bgr: np.ndarray) -> np.ndarray:
    """BGR uint8 -> normalized RGB float32 (reference libs/transform.py
    Normalize: /255, ImageNet mean/std)."""
    rgb = img_bgr[:, :, ::-1].astype(np.float32) / 255.0
    return (rgb - IMAGENET_MEAN) / IMAGENET_STD


def warp_image(img: np.ndarray, M: np.ndarray, out_wh, border=(0, 0, 0)) -> np.ndarray:
    """Bilinear warp of a uint8 image into out_wh = (w, h) (data plane)."""
    return native.warp_affine_u8(img, np.asarray(M, np.float64), (out_wh[1], out_wh[0]),
                                 border=border)


def warp_mask(mask: np.ndarray, M: np.ndarray, out_wh, border: int = 0) -> np.ndarray:
    """Nearest warp of an int32 instance mask into out_wh = (w, h)."""
    return native.warp_affine_i32(np.ascontiguousarray(mask, np.int32),
                                  np.asarray(M, np.float64), (out_wh[1], out_wh[0]),
                                  border=border)


def normalize_fast(img_bgr: np.ndarray) -> np.ndarray:
    """`normalize` in the data plane (one fused pass)."""
    return native.normalize_bgr_u8(img_bgr, IMAGENET_MEAN, IMAGENET_STD)
