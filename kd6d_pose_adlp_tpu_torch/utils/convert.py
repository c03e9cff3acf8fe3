"""Flax variables -> this port's state_dict.

Takes the JAX package's `{"params", "batch_stats"}` tree (nested dicts of
arrays) of a `PoseNet`, whole or in part (a backbone-only file), and returns
the port's state_dict of the parts present:
HWIO conv kernels -> OIHW weights, BN scale/bias/mean/var ->
weight/bias/running_mean/running_var, GN scale -> weight. The port's names
are the reference torch names that `kd6d_pose_adlp_tpu/utils/
torch_convert.convert_pose_module` parses, so the reverse direction is that
function.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: Dict, prefix: str, node: Mapping):
    sd[prefix + ".weight"] = _t(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in node:
        sd[prefix + ".bias"] = _t(node["bias"])


def _conv_bn(sd: Dict, pre: str, block: Mapping, stats: Mapping):
    """One ConvBNAct: flax {conv, bn} params + {bn} stats -> `pre.conv/bn.*`
    (the running statistics only when `stats` holds them)."""
    _conv(sd, pre + ".conv", block["conv"])
    bn = block["bn"]
    sd[pre + ".bn.weight"] = _t(bn["scale"])
    sd[pre + ".bn.bias"] = _t(bn["bias"])
    if "bn" in stats:
        sd[pre + ".bn.running_mean"] = _t(stats["bn"]["mean"])
        sd[pre + ".bn.running_var"] = _t(stats["bn"]["var"])
        sd[pre + ".bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict of every subtree present in `variables`
    (`backbone`, `fpn`, `head` under "params"; "batch_stats" optional)."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    sd: Dict[str, torch.Tensor] = {}

    # darknet (tiny-h): stage{i}_unit{j}; darknet53: init_block,
    # stage{i}_unit1 and the residual stage{i}_unit{j}/conv{1,2}
    for name, block in params.get("backbone", {}).items():
        st = stats.get("backbone", {}).get(name, {})
        m = re.fullmatch(r"init_block|stage(\d+)_unit(\d+)", name)
        if not m:
            raise KeyError(f"unexpected backbone module {name!r}")
        pre = ("backbone.features.init_block" if m.group(1) is None else
               f"backbone.features.stage{m.group(1)}.unit{m.group(2)}")
        if "conv1" in block:
            for sub in ("conv1", "conv2"):
                _conv_bn(sd, f"{pre}.{sub}", block[sub], st.get(sub, {}))
        else:
            _conv_bn(sd, pre, block, st)

    for name, node in params.get("fpn", {}).items():
        m = re.fullmatch(r"(inner|out)(\d+)|(p6|p7)", name)
        if not m:
            raise KeyError(f"unexpected fpn module {name!r}")
        if m.group(3):
            pre = f"fpn.top_blocks.{m.group(3)}"
        else:
            pre = f"fpn.{m.group(1)}_convs.{m.group(2)}"
        _conv(sd, pre, node)

    for name, node in params.get("head", {}).items():
        if name == "scales":
            for lvl, s in enumerate(np.asarray(node).reshape(-1)):
                sd[f"head.scales.{lvl}.scale"] = _t([s])
            continue
        m = re.fullmatch(r"(cls|pose)_(conv|gn)(\d+)", name)
        if m:
            tower, kind, k = m.group(1), m.group(2), int(m.group(3))
            if kind == "conv":
                _conv(sd, f"head.{tower}_tower.{3 * k}", node)
            else:
                sd[f"head.{tower}_tower.{3 * k + 1}.weight"] = _t(node["scale"])
                sd[f"head.{tower}_tower.{3 * k + 1}.bias"] = _t(node["bias"])
        elif name in ("cls_logits", "pose_pred"):
            _conv(sd, f"head.{name}", node)
        else:
            raise KeyError(f"unexpected head module {name!r}")
    return sd


def read_jax_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The port's state_dict of a JAX checkpoint file (flax msgpack): a
    `save_params` file ({"params", "batch_stats"}, e.g. `final.ckpt`) or a
    `save_checkpoint` file, whose train state holds the same two trees."""
    from .msgpack_read import read_msgpack_file
    raw = read_msgpack_file(path)
    if "params" not in raw and isinstance(raw.get("state"), dict):
        raw = raw["state"]
    if "params" not in raw:
        raise ValueError(f"{path}: no 'params' tree (keys {sorted(raw)})")
    return from_jax_variables(raw)
