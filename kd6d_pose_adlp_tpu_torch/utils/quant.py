"""int8 post-training quantization (PTQ) of a frozen PoseNet (port of
`kd6d_pose_adlp_tpu/utils/quant.py`).

Scheme (symmetric, no zero point, so zero padding stays exact):
- weights: a per-output-channel scale absmax(kernel[o]) / 127, rounded to
  int8 once on the host in float64 numpy (`quantize_kernel`, the JAX
  package's arithmetic, so the int8 kernels and scales are bit-equal given
  equal float weights);
- activations: one static scale per conv input, absmax / 127, from a few
  calibration batches through the BN-folded float network in
  quant_mode="calibrate" (`models/blocks.QConv` keeps the running absmax);
- dequantization: the int32 conv sum * (in_scale * w_scale[o]) + folded
  bias in float32, then the compute dtype.

Pipeline: `utils/fold_bn.fold_batchnorm` -> `calibrate_amax` ->
`build_quant_state`; `quantize_posenet` does the last two. The result loads
into `PoseNet(ModelConfig(bn_folded=True, quant_mode="quant"))`. The head's
output convs (cls_logits, pose_pred) stay float.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .precision import full_fp32


def quantize_kernel(kernel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """HWIO float kernel -> (int8 kernel, (O,) float32 per-output-channel
    scale), in float64 (JAX `utils/quant.py:33-39`)."""
    k = np.asarray(kernel, np.float64)
    absmax = np.abs(k).max(axis=(0, 1, 2))
    w_scale = np.maximum(absmax, 1e-12) / 127.0
    kq = np.clip(np.round(k / w_scale), -127, 127).astype(np.int8)
    return kq, w_scale.astype(np.float32)


def _qconvs(net: nn.Module):
    from ..models.blocks import QConv
    return [(n, m) for n, m in net.named_modules() if isinstance(m, QConv)]


def calibrate_amax(net_calibrate: nn.Module, calib_batches: Iterable
                   ) -> Dict[str, np.float32]:
    """Run the calibration batches (images the network takes, on its
    device) through a quant_mode="calibrate" PoseNet in eval mode, in full
    fp32, and return each QConv's input absmax over all of them (the
    element-wise max over batches), keyed by module name."""
    convs = _qconvs(net_calibrate)
    if not convs:
        raise ValueError("calibrate_amax needs a quant_mode='calibrate' network")
    for _, m in convs:
        m.in_amax.zero_()
    was_training = net_calibrate.training
    net_calibrate.eval()
    n = 0
    try:
        with torch.no_grad(), full_fp32():
            for images in calib_batches:
                net_calibrate(images)
                n += 1
    finally:
        net_calibrate.train(was_training)
    if n == 0:
        raise ValueError("calibrate_amax needs at least one batch")
    return {name: np.float32(m.in_amax.item()) for name, m in convs}


def build_quant_state(folded: Mapping[str, torch.Tensor],
                      amax: Mapping[str, np.float32]) -> Dict[str, torch.Tensor]:
    """BN-folded float state_dict + calibration absmax -> the state_dict of
    the quant_mode="quant" PoseNet: every conv with an absmax moves from
    `weight` (+ `bias`) to `kernel_q` (int8, OIHW), `w_scale`, `bias` and
    `in_scale`; everything else (GroupNorm, the head's output convs, the
    per-level scales) passes through (JAX `build_quant_variables`)."""
    out = {k: v.detach().cpu() for k, v in folded.items()}
    for name, a in amax.items():
        w = out.pop(f"{name}.weight")
        kq, w_scale = quantize_kernel(w.double().permute(2, 3, 1, 0).numpy())
        bias = out.pop(f"{name}.bias", None)
        out[f"{name}.kernel_q"] = torch.from_numpy(
            np.ascontiguousarray(kq.transpose(3, 2, 0, 1)))
        out[f"{name}.w_scale"] = torch.from_numpy(w_scale)
        out[f"{name}.bias"] = (torch.zeros(kq.shape[-1]) if bias is None
                               else bias.float())
        out[f"{name}.in_scale"] = torch.tensor(
            np.float32(max(float(a), 1e-12) / 127.0))
    return out


def quantize_posenet(model_cfg, n_fg: int, folded: Mapping[str, torch.Tensor],
                     calib_batches: Iterable, device="cuda"):
    """One-call PTQ of a BN-folded PoseNet state_dict: calibrate on
    `calib_batches` on `device`, quantize, and return (the quant_mode="quant"
    PoseNet on `device` in eval mode, its state_dict). `model_cfg` must have
    bn_folded=True."""
    from ..models.pose_net import PoseNet

    if not model_cfg.bn_folded:
        raise ValueError("quantize_posenet expects BN-folded weights "
                         "(utils/fold_bn.fold_batchnorm first)")
    net_c = PoseNet(dataclasses.replace(model_cfg, quant_mode="calibrate"), n_fg=n_fg)
    net_c.load_state_dict(folded, strict=True)
    amax = calibrate_amax(net_c.to(device), calib_batches)
    state = build_quant_state(folded, amax)
    net_q = PoseNet(dataclasses.replace(model_cfg, quant_mode="quant"), n_fg=n_fg)
    net_q.load_state_dict(state, strict=True)
    return net_q.to(device).eval(), state
