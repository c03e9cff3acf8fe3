"""The serving endpoint (port of `kd6d_pose_adlp_tpu/engine/serving.py:
35-83,236-242`): one function `(images, bbox_trans, class_ids, seed) ->
poses` closing over the network, the voting + RANSAC-EPnP + LHM postprocess
and the task constants; `mode="multi"` solves every foreground class.

The network runs in its config's compute dtype (`ModelConfig.
compute_dtype`: float32, or bfloat16 with float32 outputs), its float32
parts and the postprocess in full fp32 (`utils/precision.full_fp32`)
whatever the caller's TF32 flags, as the JAX endpoint's.

Export (`torch.export`) and the raw-frame endpoint wait for later slices.
"""
from __future__ import annotations

import time
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..data.batch import TaskConsts
from ..models.pose_net import PoseNet
from ..utils.precision import full_fp32
from .postprocess import MULTI_KEYS, build_postprocess, build_postprocess_multi

# serving outputs, in a fixed order so consumers can rely on it (and
# MULTI_KEYS, build_postprocess_multi's)
SINGLE_KEYS = ("R", "T", "score", "cls", "n_inliers", "valid", "kp2d",
               "vote_valid")


def network_fn(net: nn.Module):
    """network(images) -> (cls_logits, pred_reg), float32: `net` in eval
    mode, in its compute dtype, under inference mode and full fp32 (TF32 off
    for cuDNN and matmuls). A net that was in train mode (a training run's
    student) is put back."""
    def network(images: torch.Tensor):
        was_training = net.training
        net.eval()
        try:
            with torch.inference_mode(), full_fp32():
                return net(images)
        finally:
            net.train(was_training)

    return network


def build_infer_fn(cfg: Config, consts: TaskConsts,
                   model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]],
                   mode: str = "single", device="cuda"):
    """Inference endpoint over a trained model, on `device`.

    `model_or_state` is a `PoseNet` or its state_dict (loaded strictly
    into a `PoseNet(cfg.model)`, in cfg.model.compute_dtype).
    Arguments of the returned `infer(images, bbox_trans, class_ids, seed=0,
    gumbel=None, timings=None)`:
      images     (B, res, res, 3) uint8 BGR crop or pre-normalized float RGB
      bbox_trans (B, 2, 3) f32 — the DZI crop affine of each image
      class_ids  (B,) int — the class to solve; negative marks it invalid.
                 Ignored by mode="multi", which solves every foreground class.
      seed       int — seeds the RANSAC draws (a torch.Generator on `device`)
      gumbel     optional injected draws, (B, ransac_iters, max_votes*8); for
                 mode="multi" (n_fg, B, ransac_iters, max_votes*8)
      timings    optional dict; if given, the card is synchronized after the
                 network and after the postprocess, and their host-clock
                 seconds are stored under "network_s" / "postprocess_s".
    Returns a dict of tensors on `device` in SINGLE_KEYS order (mode
    "single") or MULTI_KEYS order, each (B, n_fg, ...) (mode "multi").
    `infer.network(images) -> (cls_logits, pred_reg)` is the endpoint's
    network call alone, pinned to fp32 as inside `infer`.
    """
    if mode not in ("single", "multi"):
        raise ValueError(f"serving mode {mode!r}: 'single' or 'multi'")
    device = torch.device(device)
    if isinstance(model_or_state, nn.Module):
        net = model_or_state
    else:
        net = PoseNet(cfg.model, n_fg=cfg.data.n_fg)
        net.load_state_dict(model_or_state, strict=True)
    net = net.to(device).eval()
    consts = consts.to(device)
    pinned = network_fn(net)

    def network(images):
        return pinned(torch.as_tensor(images).to(device))

    if mode == "multi":
        pp_multi = build_postprocess_multi(cfg, consts, cfg.data.n_fg)
        pp = lambda c, r, ids, bt, **kw: pp_multi(c, r, bt, **kw)
        keys = MULTI_KEYS
    else:
        pp = build_postprocess(cfg, consts)
        keys = SINGLE_KEYS

    def _sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def infer(images, bbox_trans, class_ids, seed: int = 0,
              gumbel: Optional[torch.Tensor] = None,
              timings: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        bbox_trans = torch.as_tensor(bbox_trans, dtype=torch.float32).to(device)
        class_ids = torch.as_tensor(class_ids).to(device)
        gen = None
        if gumbel is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(seed))
        else:
            gumbel = gumbel.to(device)
        with torch.inference_mode():
            t0 = time.perf_counter()
            cls_logits, pred_reg = network(images)
            if timings is not None:
                _sync()
                t1 = time.perf_counter()
            out = pp(cls_logits, pred_reg, class_ids, bbox_trans,
                     generator=gen, gumbel=gumbel)
            if timings is not None:
                _sync()
                timings["network_s"] = t1 - t0
                timings["postprocess_s"] = time.perf_counter() - t1
        return {k: out[k] for k in keys}

    infer.model = net
    infer.network = network
    return infer


def centered_bbox_trans(batch_size: int, res: int) -> np.ndarray:
    """Identity-crop affine stack for callers serving pre-cropped images
    (kp2d outputs then stay in the crop's own pixel frame)."""
    M = np.zeros((batch_size, 2, 3), np.float32)
    M[:, 0, 0] = 1.0
    M[:, 1, 1] = 1.0
    return M
