"""Procedural BOP-style scenes (port of `kd6d_pose_adlp_tpu/data/
synthetic.py:68-231`, the same numpy RNG stream sample for sample,
`single_class` and `classes` included, and the full 640x480 frames that
`make_bop_dataset` writes as a BOP tree).

No LINEMOD data ships with the repo, so training batches, serving requests
and task constants for smoke runs come from here: a painted cuboid per
class under a random pose, cropped by a DZI affine.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..utils import geometry as geo
from .batch import Batch, TaskConsts
from .transforms import IMAGENET_MEAN, IMAGENET_STD

_INTERNAL_K = np.array([[572.4114, 0, 325.2611],
                        [0, 573.57043, 242.04899],
                        [0, 0, 1]], np.float32)


def make_box_corners(n_fg: int, base: float = 40.0) -> np.ndarray:
    """(n_fg, 8, 3) axis-aligned box corners, per-class sizes (mm)."""
    out = []
    for c in range(n_fg):
        hx = base * (1.0 + 0.07 * c)
        hy = base * (0.8 + 0.05 * c)
        hz = base * (1.2 - 0.03 * c)
        corners = np.array([[sx * hx, sy * hy, sz * hz]
                            for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                           np.float32)
        out.append(corners)
    return np.stack(out)


def _fill_convex(mask: np.ndarray, pts: np.ndarray, value: int):
    """Rasterize the convex hull of pts into mask (half-plane test)."""
    from scipy.spatial import ConvexHull
    try:
        hull = ConvexHull(pts)
        poly = pts[hull.vertices]
    except Exception:
        return
    H, W = mask.shape
    x0 = max(int(np.floor(poly[:, 0].min())), 0)
    x1 = min(int(np.ceil(poly[:, 0].max())) + 1, W)
    y0 = max(int(np.floor(poly[:, 1].min())), 0)
    y1 = min(int(np.ceil(poly[:, 1].max())) + 1, H)
    if x1 <= x0 or y1 <= y0:
        return
    xs, ys = np.meshgrid(np.arange(x0, x1) + 0.5, np.arange(y0, y1) + 0.5)
    inside = np.ones(xs.shape, bool)
    n = len(poly)
    for i in range(n):
        ax, ay = poly[i]
        bx, by = poly[(i + 1) % n]
        # scipy's 2D hull vertices are counter-clockwise
        cross = (bx - ax) * (ys - ay) - (by - ay) * (xs - ax)
        inside &= cross >= 0
    mask[y0:y1, x0:x1][inside] = value


@dataclasses.dataclass
class SyntheticPoseDataset:
    """Procedural pose scenes. Deterministic given (seed, index)."""
    n_fg: int = 15
    input_res: int = 256
    internal_wh: Tuple[int, int] = (640, 480)
    max_objs: int = 8
    single_class: Optional[int] = None  # LINEMOD-style one-object scenes
    # restrict sampled classes to a subset; None = all
    classes: Optional[Tuple[int, ...]] = None
    seed: int = 0

    def __post_init__(self):
        self.kp3d = make_box_corners(self.n_fg)
        self.diameters = np.linalg.norm(
            self.kp3d.max(1) - self.kp3d.min(1), axis=1).astype(np.float32)
        self.K = _INTERNAL_K

    def consts(self, device="cuda", code_bits: int = 0,
               verts_per_axis: int = 6) -> TaskConsts:
        """The task constants on `device`. code_bits > 0 adds the dense
        binary-code tables (JAX `synthetic.py:86-97`): per class, a box-surface
        grid of `verts_per_axis` points a side as the vertex set, and its
        hierarchical codes."""
        if code_bits <= 0:
            return TaskConsts.create(self.K, self.kp3d, self.diameters, device=device)
        from ..ops.binary_code import build_codes, sample_box_surface
        verts = np.stack([sample_box_surface(self.kp3d[c], verts_per_axis)
                          for c in range(self.n_fg)])              # (C,V,3)
        codes = np.stack([build_codes(v, code_bits) for v in verts])
        return TaskConsts.create(self.K, self.kp3d, self.diameters, verts=verts,
                                 vert_codes=codes, device=device)

    def _render(self, index: int, train: bool):
        """One scene: the crop in [0, 1] RGB plus its annotations."""
        rng = np.random.default_rng((self.seed * 1_000_003 + index) & 0x7FFFFFFF)
        W, H = self.internal_wh
        if self.single_class is not None:
            cls = self.single_class
        elif self.classes is not None:
            cls = int(self.classes[int(rng.integers(0, len(self.classes)))])
        else:
            cls = int(rng.integers(0, self.n_fg))
        R = geo.quaternion2rotation(rng.normal(size=4)).astype(np.float32)
        z = rng.uniform(650, 1100)
        x = rng.uniform(-0.25, 0.25) * z * W / self.K[0, 0] / 2
        y = rng.uniform(-0.25, 0.25) * z * H / self.K[1, 1] / 2
        T = np.array([x + rng.uniform(-30, 30), y + rng.uniform(-30, 30), z],
                     np.float32)

        corners = self.kp3d[cls]
        kp_internal = geo.project_points(self.K, R, T, corners)

        box = geo.corners_bbox_xyxy(kp_internal[None])[0]
        cx, cy = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
        bw, bh = box[2] - box[0], box[3] - box[1]
        if train:
            sr = 1 + 0.25 * (2 * rng.random() - 1)
            sh = 0.25 * (2 * rng.random(2) - 1)
            center = np.array([cx + bw * sh[0], cy + bh * sh[1]])
            scale = max(bh, bw) * sr * 1.5
        else:
            center = np.array([cx, cy])
            scale = max(max(bh, bw), 1) * 1.5
        scale = min(scale, max(H, W)) * 1.0
        M = geo.dzi_affine(center, scale, self.input_res)

        kp_crop = geo.apply_affine(M, kp_internal)

        res = self.input_res
        mask = np.zeros((res, res), np.int32)
        _fill_convex(mask, kp_crop, 1)
        img = rng.uniform(0, 0.15, size=(res, res, 3)).astype(np.float32)
        cam = (R @ corners.T + T[:, None]).T
        base = np.array([0.25 + 0.045 * cls, 0.85 - 0.04 * cls, 0.5], np.float32)
        face_colors = np.stack([np.roll(base, k) * (0.45 + 0.11 * k)
                                for k in range(6)]).astype(np.float32)
        # corner index = 4*(x>0) + 2*(y>0) + (z>0)
        faces = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4),
                 (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5)]
        depth = [cam[list(f), 2].mean() for f in faces]
        fimg = np.zeros((res, res), np.int32)
        for fi in np.argsort(depth)[::-1]:                 # farthest first
            _fill_convex(fimg, kp_crop[list(faces[fi])], fi + 1)
        painted = fimg > 0
        img[painted] = face_colors[fimg[painted] - 1]
        img = np.clip(img + rng.normal(0, 0.02, img.shape).astype(np.float32), 0, 1)
        return img, mask, cls, R, T, M

    def sample(self, index: int, train: bool = True):
        """The JAX dataset's sample dict: ImageNet-normalized float RGB."""
        img, mask, cls, R, T, M = self._render(index, train)
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
        G = self.max_objs
        class_ids = np.full((G,), -1, np.int32)
        rotations = np.zeros((G, 3, 3), np.float32)
        translations = np.zeros((G, 3), np.float32)
        class_ids[0] = cls
        rotations[0] = R
        translations[0] = T
        W, H = self.internal_wh
        return dict(image=img, mask=mask, class_ids=class_ids,
                    rotations=rotations, translations=translations,
                    bbox_trans=M,
                    meta=dict(K=self.K, width=W, height=H, cls=cls, R=R, T=T))

    def sample_internal(self, index: int):
        """Full internal-frame (640x480) rendering of one scene: the raw frame
        a BOP dataset stores on disk (`make_bop_dataset` writes these with
        scene_gt / scene_camera JSONs, so the BOP host pipeline runs without
        LINEMOD). dict(img uint8 (H, W, 3) RGB, mask uint8 (0 / 255), cls,
        R, T), bit-equal to the JAX package's for the same seed and index."""
        rng = np.random.default_rng((self.seed * 1_000_003 + index) & 0x7FFFFFFF)
        W, H = self.internal_wh
        if self.single_class is not None:
            cls = self.single_class
        elif self.classes is not None:
            cls = int(self.classes[int(rng.integers(0, len(self.classes)))])
        else:
            cls = int(rng.integers(0, self.n_fg))
        R = geo.quaternion2rotation(rng.normal(size=4)).astype(np.float32)
        z = rng.uniform(650, 1100)
        x = rng.uniform(-0.25, 0.25) * z * W / self.K[0, 0] / 2
        y = rng.uniform(-0.25, 0.25) * z * H / self.K[1, 1] / 2
        T = np.array([x + rng.uniform(-30, 30), y + rng.uniform(-30, 30), z],
                     np.float32)
        corners = self.kp3d[cls]
        kp = geo.project_points(self.K, R, T, corners)       # (8,2) internal

        mask = np.zeros((H, W), np.int32)
        _fill_convex(mask, kp, 1)
        img = rng.uniform(0, 0.15, size=(H, W, 3)).astype(np.float32)
        cam = (R @ corners.T + T[:, None]).T
        base = np.array([0.25 + 0.045 * cls, 0.85 - 0.04 * cls, 0.5], np.float32)
        face_colors = np.stack([np.roll(base, k) * (0.45 + 0.11 * k)
                                for k in range(6)]).astype(np.float32)
        faces = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4),
                 (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5)]
        depth = [cam[list(f), 2].mean() for f in faces]
        fimg = np.zeros((H, W), np.int32)
        for fi in np.argsort(depth)[::-1]:
            _fill_convex(fimg, kp[list(faces[fi])], fi + 1)
        painted = fimg > 0
        img[painted] = face_colors[fimg[painted] - 1]
        img = np.clip(img + rng.normal(0, 0.02, img.shape).astype(np.float32), 0, 1)
        return dict(img=(img * 255).astype(np.uint8),
                    mask=(mask * 255).astype(np.uint8),
                    cls=cls, R=R, T=T)

    def batch(self, indices, train: bool = True) -> Batch:
        """A training Batch of CPU tensors (the JAX dataset's numpy leaves,
        stacked); `Batch.to(device)` moves it."""
        samples = [self.sample(i, train) for i in indices]
        stack = lambda k: np.stack([s[k] for s in samples])
        return Batch.from_numpy(
            images=stack("image"), mask=stack("mask"),
            class_ids=stack("class_ids"), rotations=stack("rotations"),
            translations=stack("translations"), bbox_trans=stack("bbox_trans"))

    def requests(self, indices, train: bool = False):
        """A serving request batch: uint8 BGR crops (B, res, res, 3), crop
        affines (B, 2, 3) f32, class ids (B,) int32, plus the ground-truth
        R (B, 3, 3) and T (B, 3) for checking the answers."""
        scenes = [self._render(i, train) for i in indices]
        crops = np.stack([np.rint(s[0] * 255.0)[..., ::-1] for s in scenes])
        return dict(images=crops.astype(np.uint8),
                    bbox_trans=np.stack([s[5] for s in scenes]).astype(np.float32),
                    class_ids=np.asarray([s[2] for s in scenes], np.int32),
                    R=np.stack([s[3] for s in scenes]),
                    T=np.stack([s[4] for s in scenes]))
