"""The serving endpoints and the exported serving artifact (port of
`kd6d_pose_adlp_tpu/engine/serving.py`).

`build_infer_fn` is one function `(images, bbox_trans, class_ids, seed) ->
poses` closing over the network, the voting + RANSAC-EPnP + LHM
postprocess and the task constants; `mode="multi"` solves every foreground
class. `build_frame_infer_fn` takes RAW camera frames and a detection
window instead and does the internal-frame fit + DZI crop on the device
(`ops/warp.py`).

The network runs in its config's compute dtype (`ModelConfig.
compute_dtype`: float32, or bfloat16 with float32 outputs), its float32
parts and the postprocess in full fp32 (`utils/precision.full_fp32`)
whatever the caller's TF32 flags, as the JAX endpoint's.

`export_inference` writes the endpoint as a `torch.export` artifact (a
`.pt2` file, weights inside, plus `path.json` metadata) and
`load_serving` reads it back into a callable with the same contract. The
differences from the JAX artifact:
- the RANSAC draws are an input of the program (`gumbel`), since an
  exported program takes no `torch.Generator`: the loader's `serve(...,
  seed)` draws them as `build_infer_fn` does, from a generator seeded with
  `seed` on the serving device, so the poses are the eager endpoint's;
- the program is exported for the device it serves on (the JAX `platforms`
  list and its per-platform drop have no counterpart);
- the fused stem conv (K2/K3) and the pose solve are the port's custom ops
  (`torch.ops.kd6d.*`, `ops/conv_fused.py`, `engine/postprocess.
  solve_pose`), so loading needs the port importable; the loaded program
  launches K2 on the card and counts it as the eager endpoint does;
- the TF32 flags are not part of a graph: the loaded program runs under
  `full_fp32` as the eager network does.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..data.batch import TaskConsts
from ..data.transforms import internal_frame_matrix
from ..models.pose_net import PoseNet
from ..ops import warp
from ..ops.epnp import sample_gumbel
from ..utils.precision import full_fp32
from .postprocess import MULTI_KEYS, build_postprocess, build_postprocess_multi

# serving outputs, in a fixed order so consumers can rely on it (and
# MULTI_KEYS, build_postprocess_multi's)
SINGLE_KEYS = ("R", "T", "score", "cls", "n_inliers", "valid", "kp2d",
               "vote_valid")


def network_fn(net: nn.Module):
    """network(images) -> (cls_logits, pred_reg) (a zebra net's code third),
    float32: `net` in eval mode, in its compute dtype, under inference mode
    and full fp32 (TF32 off for cuDNN and matmuls). A net that was in train
    mode (a training run's student) is put back."""
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
    net = _as_net(cfg, model_or_state).to(device).eval()
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


def _as_net(cfg: Config, model_or_state) -> nn.Module:
    if isinstance(model_or_state, nn.Module):
        return model_or_state
    net = PoseNet(cfg.model, n_fg=cfg.data.n_fg)
    net.load_state_dict(model_or_state, strict=True)
    return net


def _frame_matrix(cfg: Config, frame_hw: Tuple[int, int]) -> torch.Tensor:
    """The static raw -> internal fit of a (height, width) frame, (2, 3)."""
    h, w = frame_hw
    return torch.from_numpy(internal_frame_matrix(
        w, h, cfg.data.internal_width, cfg.data.internal_height)[:2].copy())


def build_frame_infer_fn(cfg: Config, consts: TaskConsts,
                         model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]],
                         frame_hw: Tuple[int, int], mode: str = "single",
                         device="cuda"):
    """Raw-frame inference endpoint on `device`: the host crop chain moved
    onto the device (JAX `serving.py:86-121`).

    Arguments of the returned `infer(frames, centers, scales, class_ids,
    seed=0, gumbel=None, timings=None)`:
      frames    (B, frame_h, frame_w, 3) uint8 BGR raw camera frames
      centers   (B, 2) f32 — the DZI window center in INTERNAL-frame coords
      scales    (B,) f32 — the window side in internal coords
      class_ids, seed, gumbel, timings — as in `build_infer_fn`; timings
                also gets "warp_s", the frame -> crop warp alone.
    Returns `build_infer_fn`'s dict; kp2d and the crop affine are in
    internal-frame coordinates, as when the host pipeline crops.
    `infer.crops(frames, centers, scales) -> (crops, bbox_trans)` is the
    warp alone (`ops/warp.frame_to_crop`)."""
    device = torch.device(device)
    res = cfg.model.input_res
    M_int = _frame_matrix(cfg, frame_hw).to(device)
    base = build_infer_fn(cfg, consts, model_or_state, mode=mode, device=device)
    wh = (cfg.data.internal_width, cfg.data.internal_height)

    def crops(frames, centers, scales):
        with torch.inference_mode():
            return warp.frame_to_crop(
                torch.as_tensor(frames).to(device),
                M_int, torch.as_tensor(centers, dtype=torch.float32).to(device),
                torch.as_tensor(scales, dtype=torch.float32).to(device), res,
                internal_wh=wh)

    def infer(frames, centers, scales, class_ids, seed: int = 0,
              gumbel: Optional[torch.Tensor] = None,
              timings: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        images, bbox_trans = crops(frames, centers, scales)
        if timings is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timings["warp_s"] = time.perf_counter() - t0
        return base(images, bbox_trans, class_ids, seed=seed, gumbel=gumbel,
                    timings=timings)

    infer.model = base.model
    infer.network = base.network
    infer.crops = crops
    return infer


class _Endpoint(nn.Module):
    """The module `export_inference` traces: network + postprocess, the
    RANSAC draws an input, the outputs a tuple in `keys` order."""

    def __init__(self, cfg: Config, consts: TaskConsts, net: nn.Module, mode: str,
                 frame_hw: Optional[Tuple[int, int]]):
        super().__init__()
        self.net, self.mode, self.res = net, mode, cfg.model.input_res
        self.wh = (cfg.data.internal_width, cfg.data.internal_height)
        if mode == "multi":
            self.pp = build_postprocess_multi(cfg, consts, cfg.data.n_fg)
            self.keys = MULTI_KEYS
        else:
            self.pp = build_postprocess(cfg, consts)
            self.keys = SINGLE_KEYS
        if mode == "frame":
            self.register_buffer("M_int", _frame_matrix(cfg, frame_hw).to(consts.K.device),
                                 persistent=False)

    def forward(self, *args):
        if self.mode == "frame":
            frames, centers, scales, class_ids, gumbel = args
            images, bbox_trans = warp.frame_to_crop(frames, self.M_int, centers, scales,
                                                    self.res, internal_wh=self.wh)
        else:
            images, bbox_trans, class_ids, gumbel = args
        cls_logits, pred_reg = self.net(images)
        if self.mode == "multi":
            out = self.pp(cls_logits, pred_reg, bbox_trans, gumbel=gumbel)
        else:
            out = self.pp(cls_logits, pred_reg, class_ids, bbox_trans, gumbel=gumbel)
        return tuple(out[k] for k in self.keys)


def export_inference(cfg: Config, consts: TaskConsts,
                     model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]],
                     path: str, batch_size: int = 1, mode: str = "single",
                     frame_hw: Optional[Tuple[int, int]] = None,
                     device="cuda") -> dict:
    """Export the endpoint with `torch.export` to `path` (a .pt2 file, the
    weights inside) and its metadata to `path`.json; returns the metadata.

    The program's inputs are JAX's with the seed replaced by the draws:
    (images (B, res, res, 3) uint8, bbox_trans (B, 2, 3) f32, class_ids (B,)
    int32, gumbel (B, ransac_iters, max_votes*8) f32, led by n_fg for
    mode="multi"), or for mode="frame" (frames
    (B, h, w, 3) uint8, centers (B, 2) f32, scales (B,) f32, class_ids,
    gumbel). It is traced on `device` in eval mode; `batch_size=0` makes the
    batch dimension symbolic (one artifact, any batch size), traced with an
    example batch of 2 (torch specializes the sizes 0 and 1)."""
    if mode not in ("single", "multi", "frame"):
        raise ValueError(f"serving mode {mode!r}: 'single', 'multi' or 'frame'")
    if mode == "frame" and frame_hw is None:
        raise ValueError("mode='frame' requires frame_hw=(height, width)")
    device = torch.device(device)
    net = _as_net(cfg, model_or_state).to(device).eval()
    module = _Endpoint(cfg, consts.to(device), net, mode, frame_hw).eval()
    res = cfg.model.input_res
    B = batch_size or 2
    gumbel = torch.zeros(((cfg.data.n_fg,) if mode == "multi" else ())
                         + (B, cfg.test.ransac_iters, cfg.test.max_votes * 8), device=device)
    ids = torch.zeros((B,), dtype=torch.int32, device=device)
    if mode == "frame":
        fh, fw = frame_hw
        args = (torch.zeros((B, fh, fw, 3), dtype=torch.uint8, device=device),
                torch.zeros((B, 2), device=device), torch.full((B,), float(res), device=device),
                ids, gumbel)
    else:
        args = (torch.zeros((B, res, res, 3), dtype=torch.uint8, device=device),
                torch.as_tensor(centered_bbox_trans(B, res), device=device), ids, gumbel)
    dynamic = None
    if batch_size == 0:
        # 65535: CUDA's grid limit, which ops of the card's graph assume
        b = torch.export.Dim("batch", min=1, max=65535)
        dims = [{0: b} for _ in args]
        dims[-1] = {1: b} if mode == "multi" else {0: b}
        dynamic = (tuple(dims),)     # forward(*args)
    with torch.no_grad(), full_fp32():
        program = torch.export.export(module, args, dynamic_shapes=dynamic, strict=False)
    for node in program.graph.nodes:
        # the exporting host's source lines: a third of the file, of no use
        # to the serving side
        node.meta.pop("stack_trace", None)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    meta = {
        "mode": mode,
        "frame_hw": list(frame_hw) if frame_hw else None,
        "batch_size": batch_size if batch_size else "symbolic",
        "input_res": res,
        "n_fg": cfg.data.n_fg,
        "backbone": cfg.model.backbone,
        "bytes": os.path.getsize(path),
        "output_keys": list(module.keys),
        "device": device.type,
        "gumbel_shape": [cfg.test.ransac_iters, cfg.test.max_votes * 8],
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def load_serving(path: str, meta: Optional[dict] = None, device="cuda"):
    """Read an exported artifact; returns (serve, metadata).

    `serve(images, bbox_trans, class_ids, seed=0)` (or, for mode="frame",
    `serve(frames, centers, scales, class_ids, seed=0)`) returns the output
    dict of `build_infer_fn`, in the same key order, on `device`, without the
    model code: it draws the RANSAC noise from a generator seeded with
    `seed` on `device`, as the eager endpoint does, and runs the program
    under inference mode and full fp32. `device` must be the one the
    artifact was exported on. Importing this module registers the
    `torch.ops.kd6d.*` ops the program calls (the K2 / K3 wrappers of
    `ops/conv_fused` through the models, `solve_pose` of `postprocess`)."""
    if meta is None:
        with open(path + ".json") as f:
            meta = json.load(f)
    device = torch.device(device)
    if meta.get("device", device.type) != device.type:
        raise ValueError(f"{path} was exported for {meta['device']}, not {device.type}: "
                         "export it again on the serving device")
    program = torch.export.load(path).module()
    keys = meta["output_keys"]
    iters, n = meta["gumbel_shape"]
    multi = meta["mode"] == "multi"

    def run(inputs, class_ids, seed):
        B = inputs[0].shape[0]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        shape = ((meta["n_fg"], B, iters, n) if multi else (B, iters, n))
        gumbel = sample_gumbel(shape, gen, device)
        ids = torch.as_tensor(class_ids).to(device, torch.int32)
        with torch.inference_mode(), full_fp32():
            out = program(*inputs, ids, gumbel)
        return dict(zip(keys, out))

    if meta["mode"] == "frame":
        def serve(frames, centers, scales, class_ids, seed: int = 0):
            return run((torch.as_tensor(frames).to(device),
                        torch.as_tensor(centers, dtype=torch.float32).to(device),
                        torch.as_tensor(scales, dtype=torch.float32).to(device)),
                       class_ids, seed)
    else:
        def serve(images, bbox_trans, class_ids, seed: int = 0):
            return run((torch.as_tensor(images).to(device),
                        torch.as_tensor(bbox_trans, dtype=torch.float32).to(device)),
                       class_ids, seed)
    return serve, meta


def centered_bbox_trans(batch_size: int, res: int) -> np.ndarray:
    """Identity-crop affine stack for callers serving pre-cropped images
    (kp2d outputs then stay in the crop's own pixel frame)."""
    M = np.zeros((batch_size, 2, 3), np.float32)
    M[:, 0, 0] = 1.0
    M[:, 1, 1] = 1.0
    return M
