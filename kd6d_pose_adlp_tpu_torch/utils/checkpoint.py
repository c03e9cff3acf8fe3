"""Checkpoints (port of `kd6d_pose_adlp_tpu/utils/checkpoint.py:19-116`).

The port writes `torch.save` files: `save_checkpoint` the whole train
state (step, the student's state_dict with its BN running statistics,
AdamW's count, mu and nu, and the config hash) for `resume`, `save_params`
the student's state_dict (`final.ckpt`). Writes are atomic (a `.tmp` file
then `os.replace`), so a crash mid-write leaves the previous file whole.

`load_params_loose` and `load_backbone_init` read either format: a file
that starts as a msgpack map is a JAX package checkpoint (flax msgpack,
read by `utils/msgpack_read` and converted by `utils/convert`), anything
else a `torch.save` file read by `utils/torch_convert`: a state_dict, or the
reference's checkpoint `{"model": state_dict, ...}`, with or without DDP's
`module.` prefix, or a pytorchcv backbone dict. Both raise ValueError,
naming the file, when it loads no tensor: the JAX package raises on such a
file too (its msgpack parse fails), and a silent zero-tensor load would go
on with random weights.
"""
from __future__ import annotations

import hashlib
import os
from typing import Any, Dict

import torch
from torch import nn

from .msgpack_read import is_msgpack_map
from .torch_convert import load_torch_state_dict, to_port_names


def config_hash(cfg: Any) -> str:
    """Hash of the architecture-relevant config, the JAX package's fields
    (model, n_class, positive_num, max_pos, max_objs, kd), so the same
    config hashes the same in both packages. Schedule fields (working_dir,
    val_freq, max_iter) are left out, so a resume may extend the schedule."""
    parts = [repr(cfg.model), repr(cfg.data.n_class),
             repr(cfg.solver.positive_num), repr(cfg.solver.max_pos),
             repr(cfg.solver.max_objs), repr(cfg.kd)]
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]


def _atomic_save(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def save_checkpoint(path: str, state, step: int, cfg_hash: str = "") -> None:
    """Writes `state` (an `engine/steps.TrainState`) at `step`."""
    opt = state.opt_state
    _atomic_save({
        "step": int(step),
        "net": {k: _cpu(v) for k, v in state.net.state_dict().items()},
        "opt": {"count": int(opt.count), "mu": [_cpu(t) for t in opt.mu],
                "nu": [_cpu(t) for t in opt.nu]},
        "cfg_hash": cfg_hash,
    }, path)


def restore_checkpoint(path: str, state_template, cfg_hash: str = ""):
    """Restores a `save_checkpoint` file into `state_template` (its net and
    AdamW buffers are overwritten in place, on their device); returns
    (state, step). A config hash in both the file and the call that
    differs raises: a state trained under other flags is never wanted."""
    from ..engine.steps import AdamWState, TrainState
    raw = torch.load(path, map_location="cpu", weights_only=True)
    saved_hash = raw.get("cfg_hash", "")
    if cfg_hash and saved_hash and saved_hash != cfg_hash:
        raise ValueError(
            f"checkpoint {path} was written under a different config "
            f"(hash {saved_hash} != {cfg_hash}); refusing to resume")
    net = state_template.net
    net.load_state_dict(raw["net"], strict=True)
    opt = state_template.opt_state
    for name in ("mu", "nu"):
        dst, src = getattr(opt, name), raw["opt"][name]
        if len(dst) != len(src) or any(d.shape != s.shape for d, s in zip(dst, src)):
            raise ValueError(f"checkpoint {path}: optimizer {name} does not match "
                             "the model's parameters")
        with torch.no_grad():
            for d, s in zip(dst, src):
                d.copy_(s)
    step = int(raw["step"])
    return TrainState(step=step, net=net,
                      opt_state=AdamWState(count=int(raw["opt"]["count"]),
                                           mu=opt.mu, nu=opt.nu)), step


def save_params(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Writes a state_dict (on the CPU) as a `torch.save` file."""
    _atomic_save({k: _cpu(v) for k, v in state_dict.items()}, path)


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The port's state_dict of a weight file in any format the module
    docstring names."""
    with open(path, "rb") as f:
        head = f.read(1)
    if is_msgpack_map(head):
        from .convert import read_jax_checkpoint
        return read_jax_checkpoint(path)
    return to_port_names(load_torch_state_dict(path))


def _load_matching(module: nn.Module, restored: Dict[str, torch.Tensor],
                   keep=lambda k: True) -> int:
    own = module.state_dict()
    n_loaded = 0
    for k, v in restored.items():
        if keep(k) and k in own and tuple(own[k].shape) == tuple(v.shape):
            own[k] = v
            n_loaded += 1
    module.load_state_dict(own, strict=True)
    return n_loaded


def _loaded(n: int, path: str, what: str) -> int:
    if n == 0:
        raise ValueError(f"{path}: no tensor of the file matches the {what} "
                         "(by name and shape); nothing was loaded")
    return n


def load_backbone_init(path: str, module: nn.Module, prefix: str = "backbone") -> int:
    """Backbone-only initialization from a full-model (or backbone-only)
    weight file: the parameters AND BN running statistics under `prefix.`
    whose shapes match are loaded into `module`, everything else keeps its
    own values (the reference's ImageNet backbone init,
    libs/train_libs.py:82-87). `num_batches_tracked`, which flax has no
    counterpart of, stays as the module has it, so the count matches the
    JAX package's. Returns the number of tensors loaded; raises ValueError
    when that is 0."""
    return _loaded(_load_matching(
        module, read_state_dict(path),
        lambda k: k.startswith(prefix + ".") and not k.endswith("num_batches_tracked")),
        path, f"module's {prefix}")


def load_params_loose(path: str, module: nn.Module) -> int:
    """Partial ("loose") restore of a weight file (either format) into
    `module`: keys the module lacks are dropped, tensors whose shape differs
    are skipped, and the module keeps its own values for every key the file
    lacks (reference libs/train_libs.py:99-105). Returns the number of
    tensors loaded; raises ValueError when that is 0."""
    return _loaded(_load_matching(module, read_state_dict(path)), path, "module")
