"""BOP dataset parsing on the host (port of `kd6d_pose_adlp_tpu/data/bop.py`).

The reference's annotation flow (`libs/utils.py:238-301`,
`libs/dataset.py:27-183`): image list -> per-image (K, merged instance mask,
class ids, R, T) from scene_camera.json / scene_gt.json / mask_visib PNGs.
JSON files are cached per path; decoded frames and annotations go through a
byte-budgeted LRU (`KD6D_DECODE_CACHE_MB`, 2048 by default, 0 disables).
Frames and masks are read without an image library (`data/imread.py`): PNG
by `data/png.py` (any colour type and bit depth, tRNS, Adam7), JPEG (BOP's
PBR renders; sequential or progressive, grey, colour or CMYK) by
`data/jpeg.py`, and TIFF (ITODD's grey and depth images, 16-bit camera
frames) by `data/tiff.py`, told apart by their signatures as cv2 does;
damaged files read as cv2 reads them, an image where its decoder recovers
and None where cv2 gives None. A float32 frame (a float TIFF) is passed on
as float32, as the JAX package passes it, and the warp casts it.
"""
from __future__ import annotations

import collections
import functools
import json
import os
import threading
from typing import Dict, List, Tuple

import numpy as np

from . import imread


@functools.lru_cache(maxsize=256)
def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


class _ByteLRU:
    """Thread-safe byte-budgeted LRU for decoded frames and annotations. A
    training run re-reads each image tens of times, so decoded arrays are
    kept and returned SHARED and write-protected; the pipeline only ever
    warps or copies them."""

    def __init__(self, budget_bytes: int):
        self._d: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.budget = budget_bytes
        self.nbytes = 0

    def get(self, key):
        with self._lock:
            hit = self._d.get(key)
            if hit is None:
                return None
            self._d.move_to_end(key)
            return hit[0]

    def put(self, key, value, nbytes: int):
        if nbytes > self.budget:
            return
        with self._lock:
            if key in self._d:
                return
            self._d[key] = (value, nbytes)
            self.nbytes += nbytes
            while self.nbytes > self.budget and self._d:
                _, (_, ob) = self._d.popitem(last=False)
                self.nbytes -= ob


_DECODE_CACHE = _ByteLRU(
    int(float(os.environ.get("KD6D_DECODE_CACHE_MB", "2048")) * 2**20))


def read_image(path: str) -> np.ndarray:
    """BGR uint8 image with the reference's normalizations
    (libs/dataset.py:59-90): uint16 -> uint8, gray -> 3ch, alpha -> white bg.
    Decoded frames are LRU-cached and returned write-protected; callers
    must copy before mutating. A palette or RGB PNG with tRNS reads as BGRA
    and is composited on white like any alpha; a float32 image (a float
    TIFF) is returned as float32, as in the JAX package. Where
    cv2.imread gives None (a missing, empty or damaged file, an OpenEXR
    file) it raises FileNotFoundError, as the JAX package does; where
    cv2.imread raises, `native.ImageSizeError`; a file that cv2 reads and
    the port does not decode (`imread`'s docstring lists what) raises
    `native.UnsupportedImage` naming it."""
    cached = _DECODE_CACHE.get(path)
    if cached is not None:
        return cached
    img = imread.read(path)
    if img is None:
        raise FileNotFoundError(path)
    if img.dtype == np.uint16:
        img = (img / 256).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    if img.shape[2] == 4:
        alpha = img[:, :, 3:4].astype(np.float32) / 255.0
        img = (img[:, :, :3].astype(np.float32) * alpha
               + 255.0 * (1 - alpha)).astype(np.uint8)
    img.setflags(write=False)
    _DECODE_CACHE.put(path, img, img.nbytes)
    return img


def get_single_bop_annotation(img_path: str, obj2cls: Dict[str, int]
                              ) -> Tuple[np.ndarray, np.ndarray, List[int],
                                         List[np.ndarray], List[np.ndarray]]:
    """(K, merged_mask(int32), class_ids, Rs, Ts) — reference libs/utils.py:238-301.

    The whole annotation (mask PNGs decoded + merged) is LRU-cached per
    image path; arrays come back write-protected and shared. A mask that
    reads as None (missing, empty or damaged) skips its instance, as a
    failed cv2.imread does in the JAX package."""
    img_path = img_path.strip()
    ckey = (img_path, tuple(sorted(obj2cls.items())))
    cached = _DECODE_CACHE.get(ckey)
    if cached is not None:
        K, merged, class_ids, Rs, Ts = cached
        return K, merged, list(class_ids), list(Rs), list(Ts)
    gt_dir, tmp, img_name = img_path.rsplit("/", 2)
    if tmp != "rgb":
        raise ValueError(f"{img_path}: a BOP frame lives in <scene>/rgb/")
    base = os.path.splitext(img_name)[0]
    cam_json = _load_json(os.path.join(gt_dir, "scene_camera.json"))
    gt_json = _load_json(os.path.join(gt_dir, "scene_gt.json"))
    im_id = str(int(base)) if str(int(base)) in cam_json else base
    annot_cam = cam_json[im_id]
    annot_poses = gt_json[im_id]

    K = np.asarray(annot_cam["cam_K"], np.float32).reshape(3, 3)
    class_ids, Rs, Ts = [], [], []
    merged = None
    inst = 1
    for i, pose in enumerate(annot_poses):
        mask_file = os.path.join(gt_dir, "mask_visib", f"{base}_{i:06d}.png")
        mv = imread.read(mask_file)
        if mv is None:
            continue
        if merged is None:
            merged = np.zeros(mv.shape[:2], np.int32)
        obj_id = str(pose["obj_id"])
        if obj_id not in obj2cls:
            continue
        class_ids.append(obj2cls[obj_id])
        Rs.append(np.asarray(pose["cam_R_m2c"], np.float32).reshape(3, 3))
        Ts.append(np.asarray(pose["cam_t_m2c"], np.float32).reshape(3))
        merged[mv == 255] = inst
        inst += 1
    if merged is None:
        merged = np.zeros((480, 640), np.int32)
    K.setflags(write=False)
    merged.setflags(write=False)
    for a in Rs + Ts:
        a.setflags(write=False)
    _DECODE_CACHE.put(ckey, (K, merged, tuple(class_ids), tuple(Rs), tuple(Ts)),
                      K.nbytes + merged.nbytes + sum(a.nbytes for a in Rs + Ts))
    return K, merged, list(class_ids), list(Rs), list(Ts)


def read_image_list(list_file: str) -> List[str]:
    """The list's frame paths, relative entries taken from its directory."""
    root = os.path.dirname(os.path.abspath(list_file))
    with open(list_file) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    return [ln if os.path.isabs(ln) else os.path.join(root, ln) for ln in lines]
