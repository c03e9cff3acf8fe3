"""Reference-format PyTorch weight files -> the port's state_dict (port of
`kd6d_pose_adlp_tpu/utils/torch_convert.py`).

The port's module names are the reference torch names (`models/darknet.py`,
`models/darknet53.py`, `models/fpn.py`, `models/head.py`), and its convs
are OIHW as the reference's, so what the JAX module does with a layout
change (OIHW -> HWIO, Linear (out, in) -> (in, out), BN weight -> scale)
is here a renaming only:

- `load_torch_state_dict` (JAX `:34`) reads a `torch.save` file with
  `weights_only=True`: a state_dict, or the reference's checkpoint layout
  `{"model": state_dict, "steps", "optim", "sched"}` (its `latest.pth` /
  `final.pth`), whose "model" it unwraps; DDP's `module.` prefix is
  stripped (JAX `scripts/ingest_reference.py:53-54`).
- `backbone_to_port` (JAX `convert_backbone`, `:49`) reads a pytorchcv
  DarkNet / DarkNet53 dict under the port's names: `features.…` ->
  `backbone.features.…`, `output.final_conv.*` -> `backbone.final_conv.*`
  (`models/darknet.py`), darknet53's Linear `output.{weight,bias}` ->
  `backbone.output.*` (`models/darknet53.py`).
- `to_port_names` applies both to a whole file: a full PoseModule dict
  keeps its `backbone.` / `fpn.` / `head.` names (the backbone's pytorchcv
  head renamed), a backbone-only dict goes under `backbone.`.
- `load_imgclsmob_zip` (`:172`) and `imgclsmob_to_backbone_ckpt` (`:192`)
  ingest a pytorchcv / imgclsmob release zip into a port `final.ckpt` that
  `--backbone_init` reads.

JAX's `merge_into_variables` (`:220`) has no counterpart:
`utils/checkpoint._load_matching` overlays a state_dict on a module's own
(keys it lacks dropped, shapes that differ skipped), which is its job.
"""
from __future__ import annotations

import io
import pickle
import re
import zipfile
from typing import Any, Dict, Optional

import torch

# pytorchcv's classifier heads under the port's backbone names
_HEADS = ((re.compile(r"output\.final_conv\.(weight|bias)"), r"final_conv.\1"),
          (re.compile(r"output\.(weight|bias)"), r"output.\1"))


def _torch_load(src: Any, what: str) -> Any:
    try:
        return torch.load(src, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{what}: torch.load(weights_only=True) refuses the file "
                         f"(it holds more than tensors and plain containers): {e}") from e


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a `torch.save` file: the file's dict, or its
    "model" dict in the reference's checkpoint layout, without DDP's
    `module.` prefix. Raises ValueError, naming the file, when
    `weights_only=True` refuses it or it holds no dict."""
    sd = _torch_load(path, path)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: holds a {type(sd).__name__}, not a state_dict")
    return {k.removeprefix("module."): v for k, v in sd.items()}


def _head_name(k: str) -> Optional[str]:
    """The port's name of a pytorchcv classifier-head key, else None."""
    for pat, repl in _HEADS:
        if pat.fullmatch(k):
            return pat.sub(repl, k)
    return None


def backbone_to_port(sd: Dict[str, torch.Tensor], prefix: str = ""
                     ) -> Dict[str, torch.Tensor]:
    """A pytorchcv DarkNet / DarkNet53 state_dict (keys under `prefix`)
    under the port's names: `backbone.features.…`, `backbone.final_conv.*`,
    `backbone.output.*`. Other keys are dropped."""
    out = {}
    for key, v in sd.items():
        if not key.startswith(prefix):
            continue
        k = key[len(prefix):]
        if k.startswith("features."):
            out["backbone." + k] = v
        elif _head_name(k) is not None:
            out["backbone." + _head_name(k)] = v
    return out


def to_port_names(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference state_dict under the port's names: a backbone-only
    pytorchcv dict (`features.…`) through `backbone_to_port`, a full
    PoseModule dict with its backbone's pytorchcv head renamed
    (`backbone.output.final_conv.*` -> `backbone.final_conv.*`)."""
    if any(k.startswith("features.") for k in sd):
        return backbone_to_port(sd)
    out = {}
    for k, v in sd.items():
        head = _head_name(k.removeprefix("backbone.")) if k.startswith("backbone.") else None
        out["backbone." + head if head else k] = v
    return out


def load_imgclsmob_zip(zip_path: str) -> Dict[str, torch.Tensor]:
    """The state_dict inside a pytorchcv / imgclsmob release zip (one
    `{name}-{error}-{sha1}.pth`, reference backbone/model_store.py:560-587),
    read from memory."""
    with zipfile.ZipFile(zip_path) as zf:
        names = [n for n in zf.namelist() if n.endswith(".pth")]
        if len(names) != 1:
            raise ValueError(f"{zip_path}: expected exactly one .pth inside, got {names}")
        raw = zf.read(names[0])
    sd = _torch_load(io.BytesIO(raw), f"{zip_path}:{names[0]}")
    if not isinstance(sd, dict):
        raise ValueError(f"{zip_path}:{names[0]} holds a {type(sd).__name__}, "
                         "not a state_dict")
    return sd


def imgclsmob_to_backbone_ckpt(zip_path: str, backbone: str, out_path: str,
                               input_res: int = 256) -> int:
    """An imgclsmob ImageNet release zip -> a port `final.ckpt` (`save_params`)
    that `train_kd --backbone_init` reads: the zip's backbone tensors over a
    fresh PoseNet (seed 0). Returns the number of tensors converted, as the
    JAX function counts them (BN's `num_batches_tracked` is no tensor of
    flax's)."""
    from ..config import ModelConfig
    from ..models.pose_net import PoseNet, init_pose_net
    from .checkpoint import _load_matching, _loaded, save_params

    converted = {k: v for k, v in backbone_to_port(load_imgclsmob_zip(zip_path)).items()
                 if not k.endswith("num_batches_tracked")}
    net = init_pose_net(PoseNet(ModelConfig(backbone=backbone, input_res=input_res)),
                        torch.Generator().manual_seed(0))
    _loaded(_load_matching(net, converted), zip_path, f"{backbone} backbone")
    save_params(out_path, net.state_dict())
    return len(converted)
