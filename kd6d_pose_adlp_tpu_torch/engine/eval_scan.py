"""One-pass evaluation over a device-resident eval set (port of
`kd6d_pose_adlp_tpu/engine/eval_scan.py`).

`ScanEvaluator.prepare` uploads the whole eval set to the device once; each
`run` loops over its chunks on the device (network -> vote -> RANSAC-EPnP ->
LHM, `postprocess._make_class_solver`), re-fits every pose whose image has
its own K with one batched EPnP (`libs/evaluate.py:174-195`), and copies the
flat (N, ...) results to the host in one transfer. ADD/ADI/REP errors of
every (gt, prediction) pair are then computed in one device call
(`build_pose_diff_scorer`); aggregation (thresholds, AUC, depth bins, miss
penalties) is host NumPy on (N,) arrays, as in the JAX package.

The streaming `evaluator.valid` is the oracle: with the same draws the
predictions and the metric table are the same. Both draw the RANSAC Gumbel
noise chunk by chunk, in the same order, from one generator seeded with
`seed` (or take `gumbel_fn(chunk_idx)`). The JAX module's host-metric
option (`device_metrics=False`) has no caller and is not ported.

Under a torch.distributed group of more than one process each process
prepares and runs its own shard of the eval set; `run` merges the
predictions across processes before scoring (`evaluator.merge_predictions`,
JAX `eval_scan.py:404-413`).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..data.batch import TaskConsts
from ..ops.epnp import epnp
from ..utils import metrics as M
from ..utils.logging_utils import ScalarLogger
from ..utils.precision import full_fp32
from .evaluator import _generator, merge_predictions, prediction_entry, score_and_report
from .postprocess import _make_class_solver
from .serving import network_fn


def build_eval_scan(cfg: Config, consts: TaskConsts, forward: Callable):
    """run(images, bbox_trans, class_ids, K_img, remap_mask, generator=None,
    gumbel_fn=None, timings=None) -> dict of flat (N, ...) device tensors.

    Inputs are chunked (Nc, B, ...) device tensors, K_img and remap_mask
    flat (N, 3, 3) / (N,). `forward(images, chunk_idx) -> (cls_logits,
    pred_reg)` runs the network (tests inject fabricated outputs by
    chunk). The draws of chunk i come from `generator`, in chunk order, or
    from `gumbel_fn(i)` (B, ransac_iters, max_votes * 8). With `timings`,
    the device is synchronized around each stage and the host-clock
    seconds of the network ("network_s") and the postprocess plus refit
    ("postprocess_s") are added to it."""
    solver = _make_class_solver(cfg, consts)
    device = consts.K.device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(images, bbox_trans, class_ids, K_img, remap_mask,
            generator: Optional[torch.Generator] = None,
            gumbel_fn: Optional[Callable[[int], torch.Tensor]] = None,
            timings: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        clock = {"network_s": 0.0, "postprocess_s": 0.0}

        def lap(key, t0):
            if timings is not None:
                sync()
                t1 = time.perf_counter()
                clock[key] += t1 - t0
                return t1
            return t0

        outs: List[Dict[str, torch.Tensor]] = []
        t = time.perf_counter()
        for i in range(images.shape[0]):
            cls_logits, pred_reg = forward(images[i], i)
            t = lap("network_s", t)
            cid = class_ids[i][:, 0].to(torch.int64)
            with torch.inference_mode():
                out = solver(cid.clamp_min(0), cls_logits, pred_reg, bbox_trans[i],
                             generator=generator,
                             gumbel=None if gumbel_fn is None else gumbel_fn(i).to(device))
            out["valid"] = out["valid"] & (cid >= 0)
            outs.append(out)
            t = lap("postprocess_s", t)
        flat = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

        # pose remap to the native per-image K (reference remap_predictions,
        # libs/evaluate.py:174-195): reproject the 8 corners under the new K
        # and re-solve PnP; the math of evaluator.remap_pose_host with EPnP
        with torch.inference_mode(), full_fp32():
            corners = consts.kp3d[flat["cls"].to(torch.int64)]      # (N, 8, 3)
            cam = torch.matmul(corners, flat["R"].transpose(1, 2)) + flat["T"][:, None, :]
            uv = torch.matmul(cam, K_img.transpose(1, 2))
            xy = uv[..., :2] / (uv[..., 2:3] + 1e-8)
            R2, T2 = epnp(corners, xy, K_img, torch.ones(corners.shape[:2], device=device))
            flat["R"] = torch.where(remap_mask[:, None, None], R2, flat["R"])
            flat["T"] = torch.where(remap_mask[:, None], T2, flat["T"])
        lap("postprocess_s", t)
        if timings is not None:
            for k, v in clock.items():
                timings[k] = timings.get(k, 0.0) + v
        return flat

    return run


def to_host_once(flat: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One device-to-host copy of a dict of (N, ...) tensors: packed into one
    (N, F) float32 buffer (ints and bools are exact in float32 below 2^24),
    copied, and unpacked to their dtypes and shapes."""
    N = next(iter(flat.values())).shape[0]
    keys = list(flat)
    buf = torch.cat([flat[k].reshape(N, -1).to(torch.float32) for k in keys], dim=1)
    host = buf.cpu().numpy()
    out, c = {}, 0
    for k in keys:
        shape, n = tuple(flat[k].shape), int(np.prod(flat[k].shape[1:], dtype=np.int64))
        dtype = {torch.bool: np.bool_, torch.int32: np.int32,
                 torch.int64: np.int64}.get(flat[k].dtype, np.float32)
        out[k] = host[:, c:c + n].reshape(shape).astype(dtype)
        c += n
    return out


def build_pose_diff_scorer(meshes: Sequence[np.ndarray],
                           sym_class_ids: Sequence[int],
                           max_pts: int = 1000, chunk: int = 16, device="cuda"):
    """Device ADD/ADI + 2D-reprojection errors over flat prediction arrays.

    Same per-pair math as utils.metrics.compute_pose_diff_batch (reference
    libs/utils.py:715-745): identical mesh subsample (seeded rng(0) choice),
    closest-point matching for symmetric classes by a squared-distance
    matmul argmin over `chunk` pairs at a time, in fp32 with TF32 off. Ties
    between exactly equidistant mesh points go to the first index (as
    `jnp.argmin`; cKDTree may pick another on degenerate meshes, err_3d is
    unaffected).

    Returns score(cls, K, gtR, gtT, pR, pT) -> (err3d (N,), err2d (N,)), all
    inputs (N, ...) float32 / int tensors on `device`; `score.device` is
    that device."""
    device = torch.device(device)
    C = len(meshes)
    subs = [M._subsample_mesh(m, max_pts) for m in meshes]
    P = max(len(s) for s in subs)
    table = np.zeros((C, P, 3), np.float32)
    nvalid = np.zeros((C,), np.int64)
    for c, s in enumerate(subs):
        table[c, :len(s)] = s
        nvalid[c] = len(s)
    is_sym_c = np.zeros((C,), bool)
    for c in sym_class_ids:
        if 0 <= c < C:
            is_sym_c[c] = True
    tbl = torch.as_tensor(table, device=device)
    nv = torch.as_tensor(nvalid, device=device)
    sym_v = torch.as_tensor(is_sym_c, device=device)
    ar = torch.arange(P, device=device)

    def score(cls, K, gtR, gtT, pR, pT):
        with torch.inference_mode(), full_fp32():
            cls = cls.to(torch.int64)
            pts = tbl[cls]                                     # (N, P, 3)
            vmask = ar[None, :] < nv[cls][:, None]             # (N, P)
            inv_n = 1.0 / nv[cls].to(torch.float32)
            p1 = torch.matmul(pts, gtR.transpose(1, 2)) + gtT[:, None, :]
            p2 = torch.matmul(pts, pR.transpose(1, 2)) + pT[:, None, :]
            matched = []
            for s in range(0, p1.shape[0], chunk):
                a, b, v = p1[s:s + chunk], p2[s:s + chunk], vmask[s:s + chunk]
                d2 = (b * b).sum(-1)[:, None, :] - 2.0 * torch.matmul(a, b.transpose(1, 2))
                d2 = torch.where(v[:, None, :], d2, torch.full_like(d2, float("inf")))
                idx = torch.argmin(d2, dim=-1)                 # first minimum
                matched.append(torch.gather(b, 1, idx[..., None].expand(-1, -1, 3)))
            p2m = torch.where(sym_v[cls][:, None, None], torch.cat(matched), p2)

            def proj(p):
                q = torch.matmul(p, K.transpose(1, 2))
                return q[..., :2] / (q[..., 2:] + 1e-8)

            w = vmask.to(torch.float32)
            e3 = (w * torch.linalg.vector_norm(p1 - p2m, dim=2)).sum(1) * inv_n
            e2 = (w * torch.linalg.vector_norm(proj(p1) - proj(p2m), dim=2)).sum(1) * inv_n
            return e3, e2

    score.device = device
    return score


def evaluate_pose_predictions_device(predictions: Dict, class_number: int,
                                     meshes: Sequence[np.ndarray],
                                     mesh_diameters: Sequence[float],
                                     symmetry_types: Dict[int, Sequence],
                                     scorer=None, device="cuda") -> Dict:
    """Drop-in for utils.metrics.evaluate_pose_predictions with the per-pair
    ADD/ADI/REP errors computed in ONE device call over all classes.
    Aggregation — thresholds, AUC, depth bins, miss penalties (reference
    libs/evaluate.py:24-172) — is the host code of the JAX package."""
    class_num = class_number - 1
    depth_bins = 3
    if scorer is None:
        scorer = build_pose_diff_scorer(meshes, list(symmetry_types.keys()),
                                        device=device)

    depth_min, depth_max = M.INF, 0.0
    for item in predictions.values():
        for T in np.asarray(item["meta"]["translations"]).reshape(-1, 3):
            depth_min = min(depth_min, float(T[2]))
            depth_max = max(depth_max, float(T[2]))
    depth_max += 1e-5
    bin_w = (depth_max - depth_min) / depth_bins

    # pass 1: flatten every (gt, best-pred) hit across ALL classes; record
    # misses (penalty errors) immediately
    flat = {k: [] for k in ("cls", "K", "gtR", "gtT", "pR", "pT", "bin")}
    miss_adi = [[] for _ in range(class_num)]    # per class penalty errors
    miss_bin: List = []
    for item in predictions.values():
        meta = item["meta"]
        gt_ids = list(meta["class_ids"])
        for clsid in range(class_num):
            if clsid not in gt_ids:
                continue
            gi = gt_ids.index(clsid)
            gtT = np.asarray(meta["translations"]).reshape(-1, 3)[gi]
            depth_idx = int((float(gtT[2]) - depth_min) / bin_w)
            pred = [p for p in item["pred"] if int(p[1]) == clsid]
            if pred:
                flat["cls"].append(clsid)
                flat["K"].append(np.asarray(meta["K"], np.float32).reshape(3, 3))
                flat["gtR"].append(np.asarray(meta["rotations"],
                                              np.float32).reshape(-1, 3, 3)[gi])
                flat["gtT"].append(gtT.astype(np.float32))
                flat["pR"].append(np.asarray(pred[0][2], np.float32))
                flat["pT"].append(np.asarray(pred[0][3], np.float32).reshape(3))
                flat["bin"].append(depth_idx)
            else:
                miss_adi[clsid].append(1.0)
                miss_bin.append(depth_idx)

    if flat["cls"]:
        cls_a = np.asarray(flat["cls"], np.int64)
        dev = lambda k: torch.as_tensor(np.stack(flat[k]), device=scorer.device)
        e3, e2 = scorer(torch.as_tensor(cls_a, device=scorer.device), dev("K"),
                        dev("gtR"), dev("gtT"), dev("pR"), dev("pT"))
        e3 = e3.cpu().numpy().astype(np.float64)
        e2 = e2.cpu().numpy().astype(np.float64)
        bins_a = np.asarray(flat["bin"])
    else:
        cls_a = np.zeros((0,), np.int64)
        e3 = e2 = np.zeros((0,), np.float64)
        bins_a = np.zeros((0,), np.int64)

    adi_per_class, auc_per_class, rep_per_class = [], [], []
    errs_adi_depth = [[] for _ in range(depth_bins)]
    errs_rep_depth = [[] for _ in range(depth_bins)]
    for clsid in range(class_num):
        sel = cls_a == clsid
        rel = e3[sel] / mesh_diameters[clsid]
        errors_adi = list(miss_adi[clsid]) + rel.tolist()
        errors_abs3d = [1e10] * len(miss_adi[clsid]) + e3[sel].tolist()
        errors_rep = [50.0] * len(miss_adi[clsid]) + e2[sel].tolist()
        for r, p, b in zip(rel, e2[sel], bins_a[sel]):
            errs_adi_depth[b].append(float(r))
            errs_rep_depth[b].append(float(p))
        if errors_adi:
            adi_per_class.append({
                "ADI" + (f"{t:.2f}d").lstrip("0"):
                    100.0 * (np.asarray(errors_adi) < t).mean()
                for t in M.THRESHOLDS_ADI})
            auc_per_class.append(
                {"AUC    ": 100.0 * M.auc_metric(errors_abs3d, 100.0)})
            rep_per_class.append({
                f"REP{t:02d}px": 100.0 * (np.asarray(errors_rep) < t).mean()
                for t in M.THRESHOLDS_REP})
        else:
            adi_per_class.append({})
            auc_per_class.append({})
            rep_per_class.append({})
    for b in miss_bin:
        errs_adi_depth[b].append(1.0)
        errs_rep_depth[b].append(50.0)

    adi_per_depth, rep_per_depth = [], []
    for i in range(depth_bins):
        if errs_adi_depth[i]:
            adi_per_depth.append({
                "ADI" + (f"{t:.2f}d").lstrip("0"):
                    100.0 * (np.asarray(errs_adi_depth[i]) < t).mean()
                for t in M.THRESHOLDS_ADI})
            rep_per_depth.append({
                f"REP{t:02d}px": 100.0 * (np.asarray(errs_rep_depth[i]) < t).mean()
                for t in M.THRESHOLDS_REP})
        else:
            adi_per_depth.append({})
            rep_per_depth.append({})

    return dict(adi_per_class=adi_per_class, auc_per_class=auc_per_class,
                rep_per_class=rep_per_class, adi_per_depth=adi_per_depth,
                rep_per_depth=rep_per_depth, depth_range=[depth_min, depth_max])


class ScanEvaluator:
    """Drives the one-pass eval on the device of `consts`. Build once,
    `prepare()` the eval set once (stacks and uploads every chunk; they stay
    resident for every later `run`, so evaluation every VAL_FREQ steps pays
    the host pipeline and the upload once), then `run()` per evaluation:
    it evaluates the current weights of `net`, or of the `net` given to
    `run` (a training run's student). `forward(images, chunk_idx)`
    overrides the network (tests inject fabricated outputs). Results match
    `evaluator.valid` with the same draws."""

    def __init__(self, cfg: Config, consts: TaskConsts, net,
                 meshes: Sequence[np.ndarray], forward: Optional[Callable] = None):
        self.cfg, self.consts = cfg, consts
        self.device = consts.K.device
        self.meshes = meshes
        self.sym = cfg.data.symmetry_dict()
        self.net = net
        if forward is None:
            forward = lambda images, idx: network_fn(self.net)(images)  # noqa: E731
        self._run_fn = build_eval_scan(cfg, consts, forward)
        self._scorer = build_pose_diff_scorer(meshes, list(self.sym.keys()),
                                              device=self.device)
        self._staged = None

    def share_staged(self, other: "ScanEvaluator") -> "ScanEvaluator":
        """Reuse another evaluator's uploaded eval set (and scorer, when the
        metric config matches)."""
        if other._staged is None:
            raise RuntimeError("source evaluator not prepared")
        self._staged = other._staged
        if self.sym == other.sym:
            self._scorer = other._scorer
        return self

    def prepare(self, eval_batches: Iterable) -> "ScanEvaluator":
        """Stack (batch, metas) pairs into chunked device tensors."""
        K_int = self.consts.K.cpu().numpy()
        imgs, bts, cids, metas = [], [], [], []
        for batch, ms in eval_batches:
            imgs.append(batch.images)
            bts.append(batch.bbox_trans)
            cids.append(batch.class_ids)
            metas.append(list(ms))
        if not imgs:
            raise ValueError("empty eval set")
        flat_metas = [m for ms in metas for m in ms]
        K_img = np.stack([np.asarray(m["K"], np.float32).reshape(3, 3)
                          for m in flat_metas])
        remap = ~np.array([np.allclose(k, K_int, atol=1e-4) for k in K_img])
        dev = self.device
        self._staged = dict(
            images=torch.stack(imgs).to(dev),
            bbox_trans=torch.stack(bts).to(dev, torch.float32),
            class_ids=torch.stack(cids).to(dev),
            K_img=torch.as_tensor(K_img, device=dev),
            remap=torch.as_tensor(remap, device=dev),
            metas=metas, flat_metas=flat_metas,
        )
        return self

    def run(self, step: int = 0, working_dir: Optional[str] = None,
            logger: Optional[ScalarLogger] = None, seed: int = 0,
            gumbel_fn: Optional[Callable[[int], torch.Tensor]] = None,
            verbose: bool = True, timings: Optional[dict] = None,
            net=None) -> Dict:
        """Evaluate (`net`, when given, from now on); `timings` (a dict)
        receives the host-clock seconds of
        "network_s", "postprocess_s" (both synchronized per chunk),
        "host_s" (the copy and the per-image pass) and "scoring_s" (the
        device scorer, the table and preds.json)."""
        if self._staged is None:
            raise RuntimeError("call prepare(eval_batches) first")
        if net is not None:
            self.net = net
        st = self._staged
        cfg = self.cfg
        gen = _generator(self.device, seed, gumbel_fn)
        flat = self._run_fn(st["images"], st["bbox_trans"], st["class_ids"],
                            st["K_img"], st["remap"], generator=gen,
                            gumbel_fn=gumbel_fn, timings=timings)
        t0 = time.perf_counter()
        out = to_host_once(flat)
        preds = merge_predictions({meta["filename"]: prediction_entry(out, i, meta, self.sym)
                                   for i, meta in enumerate(st["flat_metas"])})
        t1 = time.perf_counter()

        results = score_and_report(
            cfg, preds,
            lambda p: evaluate_pose_predictions_device(
                p, cfg.data.n_class, self.meshes, list(cfg.data.mesh_diameters),
                self.sym, scorer=self._scorer),
            step, working_dir, logger, verbose)
        if timings is not None:
            timings["host_s"] = timings.get("host_s", 0.0) + t1 - t0
            timings["scoring_s"] = timings.get("scoring_s", 0.0) + time.perf_counter() - t1
        return results
