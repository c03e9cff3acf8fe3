"""BOP dataset -> fixed-shape samples, with threaded prefetch (port of
`kd6d_pose_adlp_tpu/data/pipeline.py`).

Per-item flow (reference libs/dataset.py:59-183 `getitem_dzi`): load image +
BOP annotation -> resize/augment to the internal 640x480 frame (one combined
affine + pose re-fit) -> drop tiny-mask objects -> GT-pose symmetry
canonicalization -> DZI crop to input_res² with `bbox_trans`. With
`cfg.data.fast_pipeline` the frame is never materialized: one composed
raw -> crop warp. The sample contract matches `data.synthetic`, but the
image is the raw uint8 BGR crop (PoseNet normalizes it on the device).
Random draws follow the JAX package's seeding exactly, so the same seed
gives the same augmentations.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Optional

import numpy as np

from ..config import Config
from ..utils import geometry as geo
from ..utils.mesh import load_bbox_3d, load_bop_meshes
from . import bop
from . import transforms as T
from .batch import Batch, TaskConsts
from .native import UnsupportedImage


class BOPPoseDataset:
    def __init__(self, cfg: Config, list_file: str, train: bool):
        self.cfg = cfg
        self.train = train
        self.images = bop.read_image_list(list_file)
        self.meshes, self.obj2cls = load_bop_meshes(cfg.data.mesh_dir)
        self.kp3d = load_bbox_3d(cfg.data.bbox_file)
        self.sym = cfg.data.symmetry_dict()
        self.internal_K = cfg.data.internal_K_np()
        self.backgrounds = T.BackgroundBank(cfg.solver.aug_background_dir)
        self.fast = bool(cfg.data.fast_pipeline)

    def __len__(self):
        return len(self.images)

    def consts(self, device="cuda") -> TaskConsts:
        return TaskConsts.create(self.internal_K, self.kp3d, self.cfg.data.mesh_diameters,
                                 device=device)

    def eval_items(self):
        """[(image_idx, object_idx)] pairs for per-object evaluation crops
        (reference dzi_test_mobj, libs/dzi_libs.py:222-242: multi-object
        scenes evaluate one DZI crop per object). Counts come from
        scene_gt.json only (no mask reads); an image whose annotation cannot
        be read is left out, as in the JAX package."""
        items = []
        for i, path in enumerate(self.images):
            try:
                gt_dir, _, img_name = path.strip().rsplit("/", 2)
                base = os.path.splitext(img_name)[0]
                gt = bop._load_json(os.path.join(gt_dir, "scene_gt.json"))
                key = str(int(base)) if str(int(base)) in gt else base
                n = sum(1 for p in gt[key] if str(p["obj_id"]) in self.obj2cls)
            except (OSError, ValueError, KeyError):
                continue
            for j in range(n):
                items.append((i, j))
        return items

    def _pixel_augs(self, img: np.ndarray, mask: np.ndarray, rng):
        """Train-time pixel augmentations (reference libs/transform.py chain,
        in the JAX package's order: background, HSV, sharpen, noise, smooth,
        occlusion, grayscale). The slow path applies them to the 640x480
        internal frame like the reference; the fast path to the crop."""
        s = self.cfg.solver
        img = self.backgrounds(img, mask, rng)
        if s.aug_color_h or s.aug_color_s or s.aug_color_v:
            img = T.distort_hsv(img, rng, s.aug_color_h, s.aug_color_s, s.aug_color_v)
        if s.aug_sharpen > 0:
            img = T.pencil_sharpen(img, rng, s.aug_sharpen)
        if s.aug_noise > 0:
            img = T.distort_noise(img, rng, s.aug_noise)
        if s.aug_smooth > 0:
            img = T.distort_smooth(img, rng, s.aug_smooth)
        if s.aug_occlusion > 0:
            img, mask = T.random_occlusion(img, mask, rng, s.aug_occlusion)
        if s.aug_grayscalize:
            img = T.grayscalize(img)
        return img, mask

    @staticmethod
    def _inside_internal(Mc: np.ndarray, res: int, W: int, H: int
                         ) -> Optional[np.ndarray]:
        """Boolean (res,res) of crop pixels whose internal-frame coordinates
        lie inside the WxH frame, or None when ALL do (checked via the 4 crop
        corners; affine maps preserve convexity). The two-warp chain zeroes
        everything outside the frame (the second warp's border); the fast
        single-warp path reproduces that."""
        A = np.asarray(Mc[:, :2], np.float64)
        t = np.asarray(Mc[:, 2], np.float64)
        Ainv = np.linalg.inv(A)
        corners = np.array([[0.0, 0.0], [res - 1, 0], [0, res - 1], [res - 1, res - 1]])
        ic = (corners - t) @ Ainv.T
        if (ic[:, 0] >= 0).all() and (ic[:, 0] <= W - 1).all() \
                and (ic[:, 1] >= 0).all() and (ic[:, 1] <= H - 1).all():
            return None
        xs = np.arange(res, dtype=np.float64)
        # separable broadcast: internal coords = Ainv @ ([x,y] - t)
        ix = (Ainv[0, 0] * (xs - t[0]))[None, :] + (Ainv[0, 1] * (xs - t[1]))[:, None]
        iy = (Ainv[1, 0] * (xs - t[0]))[None, :] + (Ainv[1, 1] * (xs - t[1]))[:, None]
        return (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)

    def sample(self, index: int, seed: int = 0,
               focus_obj: Optional[int] = None) -> Optional[Dict]:
        """One sample dict (image, mask, class_ids, rotations, translations,
        bbox_trans, meta), or None when the frame has no usable object (the
        loader redraws, as the reference does). A frame that cv2.imread
        gives None for (missing, empty or damaged) or a missing annotation
        also gives None, as in the JAX package, and so does a mask that
        reads with colour channels (a palette or RGB PNG), whose merge fails
        there with an IndexError; a mask that reads as None only drops its
        instance. A frame or mask whose size cv2.imread raises an error for
        (`native.ImageSizeError`) gives None too, as any exception there
        does. A float32 frame (a float TIFF) is warped as JAX warps it, cast
        to uint8. A frame or mask that cv2 reads and the port cannot decode
        raises UnsupportedImage naming it, since the JAX package would train
        on it."""
        cfg = self.cfg
        s = cfg.solver
        rng = np.random.default_rng((seed * 1_000_003 + index) & 0x7FFFFFFF)
        path = self.images[index % len(self.images)]
        try:
            img = bop.read_image(path)
            K, mask, class_ids, Rs, Ts = bop.get_single_bop_annotation(path, self.obj2cls)
        except UnsupportedImage:
            raise
        except (OSError, ValueError, LookupError):
            return None
        if len(class_ids) == 0:
            return None
        n_orig = len(class_ids)  # raw instance ids in `mask` are 1..n_orig
        h, w = img.shape[:2]
        W, H = cfg.data.internal_width, cfg.data.internal_height
        # eval meta carries the RAW-frame annotation (the evaluator remaps
        # predictions back to this frame), symmetry-canonicalized like the GT
        raw = dict(K=K.copy(), class_ids=list(class_ids),
                   rotations=[geo.pose_symmetry_handling(R, self.sym[c])
                              if c in self.sym else np.asarray(R, np.float32)
                              for R, c in zip(Rs, class_ids)],
                   translations=[np.asarray(t, np.float32).reshape(3) for t in Ts])

        # one combined affine: internal-frame fit (+ train-time SSR aug)
        M = T.internal_frame_matrix(w, h, W, H)
        if self.train:
            M = T.random_ssr_matrix(rng, s.aug_shift, s.aug_scale, s.aug_rotation, W, H) @ M
        raw_img, raw_mask = img, mask
        if self.fast:
            # the 640x480 frame is never materialized: a half-res nearest
            # warp of the instance mask gives the areas the tiny-mask filter
            # needs; image and mask reach the crop through ONE composed warp
            Sh = np.diag([0.5, 0.5, 1.0]).astype(np.float64)
            mask_half = T.warp_mask(mask, Sh @ M, (W // 2, H // 2))
        else:
            img = T.warp_image(img, M, (W, H), border=(128, 128, 128))
            mask = T.warp_mask(mask, M, (W, H))
        kp3d_objs = [self.kp3d[c] for c in class_ids]
        Rs, Ts = T.remap_poses(K, Rs, Ts, kp3d_objs, self.internal_K, M)

        # pixel-level augmentations (train only; the fast path augments the
        # crop instead, after the DZI warp)
        if self.train and not self.fast:
            img, mask = self._pixel_augs(img, mask, rng)

        # drop objects with tiny masks (reference remove_invalids, min_area=10)
        if self.fast:
            # half-res areas scale by 4; 10 px at full res = 2.5 half-px
            keep = [i for i in range(len(class_ids))
                    if 4 * int((mask_half == (i + 1)).sum()) >= 10]
        else:
            keep, new_mask = [], np.zeros_like(mask)
            new_mask[mask == -1] = -1
            nxt = 1
            for i in range(len(class_ids)):
                m = mask == (i + 1)
                if m.sum() < 10:
                    continue
                keep.append(i)
                new_mask[m] = nxt
                nxt += 1
            mask = new_mask if keep else mask
        if not keep:
            return None
        raw_indices = list(keep)  # original instance index per filtered slot
        class_ids = [class_ids[i] for i in keep]
        Rs = [Rs[i] for i in keep]
        Ts = [Ts[i] for i in keep]

        # GT symmetry canonicalization (reference libs/dataset.py:174-176)
        Rs = [geo.pose_symmetry_handling(R, self.sym[c]) if c in self.sym else R
              for R, c in zip(Rs, class_ids)]

        # per-object eval crops (reference dzi_test_mobj): bring the focused
        # object to slot 0 (the crop target and the voted class) and remap
        # the instance mask accordingly; meta carries only that object's GT
        if focus_obj is not None:
            if focus_obj not in keep:
                return None  # dropped by remove_invalids, like the reference
            fi = keep.index(focus_obj)
            order = [fi] + [k for k in range(len(class_ids)) if k != fi]
            class_ids = [class_ids[k] for k in order]
            Rs = [Rs[k] for k in order]
            Ts = [Ts[k] for k in order]
            raw_indices = [raw_indices[k] for k in order]
            if not self.fast:
                lut = np.zeros(len(order) + 2, np.int32)  # [0]=bg, [-1] = -1
                for new, old in enumerate(order):
                    lut[old + 1] = new + 1
                neg = mask < 0
                mask = lut[np.clip(mask, 0, len(order))]
                mask[neg] = -1
            raw = dict(K=raw["K"], class_ids=[raw["class_ids"][focus_obj]],
                       rotations=[raw["rotations"][focus_obj]],
                       translations=[raw["translations"][focus_obj]])

        # DZI crop on the FIRST object (reference dzi_train/dzi_test use
        # bbox[0]; LINEMOD scenes carry one object)
        kp2d = geo.project_points(self.internal_K, Rs[0], Ts[0], self.kp3d[class_ids[0]])
        box = geo.corners_bbox_xyxy(kp2d[None])[0]
        cx, cy = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
        bw, bh = box[2] - box[0], box[3] - box[1]
        if self.train:
            sr = 1 + 0.25 * (2 * rng.random() - 1)
            sh = 0.25 * (2 * rng.random(2) - 1)
            center = np.array([cx + bw * sh[0], cy + bh * sh[1]])
            scale = max(bh, bw) * sr * 1.5
        else:
            center = np.array([cx, cy])
            scale = max(max(bh, bw), 1.0) * 1.5
        scale = min(scale, max(H, W)) * 1.0
        res = cfg.model.input_res
        Mc = geo.dzi_affine(center, scale, res)
        if self.fast:
            # ONE composed raw->crop warp: outside the raw image = gray(128)
            # where the internal frame would show it, outside the internal
            # frame = 0 (blackout mask below), as the two-warp chain gives
            Mfull = (np.vstack([Mc, [0.0, 0.0, 1.0]]).astype(np.float64)
                     @ np.asarray(M, np.float64))
            crop = T.warp_image(raw_img, Mfull, (res, res), border=(128, 128, 128))
            mc = T.warp_mask(raw_mask, Mfull, (res, res))
            # renumber raw instance ids -> final slots (keep filter + focus
            # reorder), exactly what the slow path's frame-mask LUTs produce
            raw_lut = np.zeros(n_orig + 1, np.int32)  # dropped instances -> 0
            for slot, orig_i in enumerate(raw_indices):
                raw_lut[orig_i + 1] = slot + 1
            neg = mc < 0
            mask_c = raw_lut[np.clip(mc, 0, n_orig)]
            mask_c[neg] = -1
            inside = self._inside_internal(Mc, res, W, H)
            if inside is not None:
                crop[~inside] = 0
                mask_c[~inside] = 0
            if self.train:
                crop, mask_c = self._pixel_augs(crop, mask_c, rng)
        else:
            crop = T.warp_image(img, Mc, (res, res))
            mask_c = T.warp_mask(mask, Mc, (res, res))

        G = s.max_objs
        cls_arr = np.full((G,), -1, np.int32)
        R_arr = np.zeros((G, 3, 3), np.float32)
        T_arr = np.zeros((G, 3), np.float32)
        n = min(len(class_ids), G)
        cls_arr[:n] = class_ids[:n]
        for i in range(n):
            R_arr[i] = Rs[i]
            T_arr[i] = Ts[i]
        return dict(
            image=crop, mask=mask_c, class_ids=cls_arr,
            rotations=R_arr, translations=T_arr, bbox_trans=Mc,
            meta=dict(filename=(path if focus_obj is None else f"{path}#obj{focus_obj}"),
                      K=raw["K"], width=w, height=h,
                      class_ids=raw["class_ids"],
                      rotations=raw["rotations"],
                      translations=raw["translations"]))


def collate(samples: List[Dict]) -> Batch:
    """Stack sample dicts (image, mask, class_ids, rotations, translations,
    bbox_trans) into one Batch of CPU tensors."""
    stack = lambda k: np.stack([s[k] for s in samples])  # noqa: E731
    return Batch.from_numpy(images=stack("image"), mask=stack("mask"),
                            class_ids=stack("class_ids"), rotations=stack("rotations"),
                            translations=stack("translations"),
                            bbox_trans=stack("bbox_trans"))


class PrefetchLoader:
    """Threaded batch prefetcher; yields (Batch, metas). Decoding (zlib) and
    the data plane's warps release the interpreter lock, so threads overlap.
    Failed samples are redrawn randomly like the reference
    (libs/dataset.py:64-70).

    `shard=(rank, count)` gives this loader rank's disjoint 1/count slice of
    every epoch's index order (the reference's DistributedSampler,
    libs/distributed.py:109-151): all ranks draw the SAME epoch permutation
    (seeded by epoch) and take strided slices."""

    def __init__(self, dataset, batch_size: int, train: bool = True,
                 num_threads: int = 2, depth: int = 4, seed: int = 0,
                 shard: Optional[tuple] = None):
        self.ds = dataset
        self.bs = batch_size
        self.train = train
        self.seed = seed
        self.num_threads = max(num_threads, 1)
        self.depth = depth
        self.shard = shard
        if shard is not None:
            rank, count = shard
            if not 0 <= rank < count:
                raise ValueError(f"shard {shard}: need 0 <= rank < count")

    def _make_batch(self, epoch: int, indices):
        """One batch from the given dataset indices; failed samples are
        redrawn uniformly like the reference (libs/dataset.py:64-70)."""
        rng = np.random.default_rng(epoch * 7919 + int(indices[0]))
        samples = []
        pending = list(indices)
        while len(samples) < self.bs:
            idx = pending.pop(0) if pending else int(rng.integers(0, len(self.ds)))
            s = self.ds.sample(int(idx) % len(self.ds), seed=self.seed + epoch)
            if s is not None:
                samples.append(s)
        return collate(samples), [s["meta"] for s in samples]

    def _index_stream(self):
        """Batch index lists from per-epoch permutations. Eval mode ends
        after one epoch; train cycles forever."""
        def epoch_order(epoch: int) -> np.ndarray:
            order = np.random.default_rng(self.seed + epoch).permutation(
                len(self.ds)) if self.train else np.arange(len(self.ds))
            if self.shard is not None:
                rank, count = self.shard
                order = order[rank::count]
            return order

        epoch, pos = 0, 0
        order = epoch_order(0)
        while True:
            yield epoch, [order[(pos + k) % len(order)] for k in range(self.bs)]
            pos += self.bs
            if pos >= len(order):
                epoch += 1
                pos = 0
                if self.train:
                    order = epoch_order(epoch)
                else:
                    return

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        # `stop` means the CONSUMER left: only then may a built batch be
        # dropped. The end of eval's one epoch is signalled by StopIteration
        # and the live-thread count, so in-flight final batches still reach
        # the queue. A producer's failure is handed to the consumer, which
        # raises it.
        stop = threading.Event()
        stream = self._index_stream()
        lock = threading.Lock()
        live = [self.num_threads]
        errors: List[BaseException] = []

        def producer():
            # N threads share the index stream; completion order (and thus
            # batch order) varies across threads, like a torch DataLoader
            # with workers; contents are seed-deterministic
            try:
                while not stop.is_set():
                    with lock:
                        try:
                            epoch, idx = next(stream)
                        except StopIteration:
                            break
                    batch = self._make_batch(epoch, idx)
                    # bounded put that re-checks stop: a plain q.put could
                    # block forever once the consumer has left
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.2)
                            break
                        except queue.Full:
                            continue
            except Exception as e:  # noqa: BLE001 - raised again in the consumer
                errors.append(e)
            finally:
                with lock:
                    live[0] -= 1

        threads = [threading.Thread(target=producer, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            while True:
                # read live BEFORE errors and q.empty(): a producer records
                # its failure and makes its last put before its decrement, so
                # live==0 then no error and an empty queue really is the end
                # of the epoch
                with lock:
                    n_live = live[0]
                if errors:
                    raise errors[0]
                if n_live == 0 and q.empty():
                    break
                try:
                    yield q.get(timeout=0.5)
                except queue.Empty:
                    continue
        finally:
            stop.set()
            # unblock any producer waiting on a full queue, then reap
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            for t in threads:
                t.join(timeout=2.0)
