"""BatchNorm-into-conv folding for frozen (inference-mode) networks (port of
`kd6d_pose_adlp_tpu/utils/fold_bn.py`).

The KD teacher runs in eval mode with frozen weights, so each BatchNorm is
an affine map with constant coefficients:

    y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta

Folding f = gamma / sqrt(var + eps) into the conv weight and beta - mean * f
into a conv bias removes the normalization from every teacher forward. The
folded weights are applied with `ModelConfig(bn_folded=True)` (see
`models/blocks.ConvBNAct`). The arithmetic is float64 on the host, cast to
float32, as the JAX package's.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
from torch import nn

_BN = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def fold_batchnorm(weights: Union[nn.Module, Mapping], eps: float = 1e-5
                   ) -> Dict[str, torch.Tensor]:
    """Fold every {conv (no bias), bn} pair into {conv (weight, bias)}.

    `weights` is a port module, its state_dict, or the JAX package's
    variables (`{"params", "batch_stats"}`, or the `{"params"}` that its own
    `fold_batchnorm` returns, which is folded already and only converted).
    Returns a state_dict (on the CPU) of the same model built with
    `bn_folded=True`: `….conv.weight` scaled, `….conv.bias` added, the
    `….bn.*` entries gone; everything else (FPN, head, GroupNorm) passes
    through unchanged."""
    if isinstance(weights, nn.Module):
        sd = weights.state_dict()
    elif "params" in weights:
        from .convert import from_jax_variables
        sd = from_jax_variables(weights)
    else:
        sd = weights
    out = {k: v.detach().cpu() for k, v in sd.items()}
    for key in [k for k in out if k.endswith(".conv.weight")]:
        unit = key[:-len(".conv.weight")]
        if f"{unit}.bn.running_mean" not in out or f"{unit}.conv.bias" in out:
            continue
        g, b, mean, var = (out[f"{unit}.bn.{n}"].double() for n in _BN[:4])
        f = g / torch.sqrt(var + eps)
        w = out[key].double() * f.reshape(-1, 1, 1, 1)
        out[key] = w.float()
        out[f"{unit}.conv.bias"] = (b - mean * f).float()
        for n in _BN:
            out.pop(f"{unit}.bn.{n}", None)
    return out
