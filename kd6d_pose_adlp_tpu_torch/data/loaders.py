"""Unified data access for the CLIs (port of `kd6d_pose_adlp_tpu/data/
loaders.py:19-92`, the synthetic source).

`build(cfg, kind)` returns a DataBundle with the same interface for every
source, so the evaluation and training entry points are source-agnostic. Only
`kind="synthetic"` is ported; the BOP-on-disk source waits for the BOP host
pipeline, and the per-process shards of multi-process runs for the port of
`parallel/mesh`.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterable, List, Optional

import numpy as np

from ..config import Config
from .batch import Batch, TaskConsts


@dataclasses.dataclass
class DataBundle:
    consts: TaskConsts
    meshes: List[np.ndarray]          # per-class vertex arrays (for ADD/ADI)
    train_iter: Callable[..., Iterable[Batch]]
    eval_batches: Callable[..., Iterable]  # yields (Batch, metas)
    cfg: Optional[Config] = None      # source-adjusted config (synthetic diameters)


def build(cfg: Config, kind: str = "bop", eval_limit: Optional[int] = None,
          device="cuda") -> DataBundle:
    """The data source `kind` for `cfg`; the task constants live on
    `device`, batches are CPU tensors (the consumer moves them)."""
    if kind == "synthetic":
        return _build_synthetic(cfg, eval_limit or 64, device)
    if kind == "bop":
        raise NotImplementedError(
            "data kind 'bop' (the BOP host pipeline) is not ported yet "
            "(ROADMAP Queue 1 item 6); use kind='synthetic'")
    raise ValueError(f"unknown data kind {kind!r}")


def _build_synthetic(cfg: Config, eval_n: int, device) -> DataBundle:
    from .pipeline import collate
    from .synthetic import SyntheticPoseDataset
    # mixed-class scenes: every class appears, like a multi-class BOP split
    ds = SyntheticPoseDataset(n_fg=cfg.data.n_fg, input_res=cfg.model.input_res,
                              max_objs=cfg.solver.max_objs, single_class=None,
                              seed=cfg.solver.seed)
    consts = ds.consts(device=device)
    meshes = [np.asarray(ds.kp3d[c]) for c in range(cfg.data.n_fg)]
    bs = cfg.solver.ims_per_batch
    # use the synthetic box diameters, not the LINEMOD ones from the yaml
    cfg_d = dataclasses.replace(
        cfg, data=dataclasses.replace(
            cfg.data, mesh_diameters=tuple(np.asarray(ds.diameters))))

    def train_iter():
        for step in itertools.count():
            yield ds.batch(range(1000 + step * bs, 1000 + (step + 1) * bs), train=True)

    def eval_batches():
        tb = cfg.test.ims_per_batch
        all_idx = list(range(eval_n))
        for start in range(0, len(all_idx), tb):
            idx = all_idx[start:start + tb]
            while len(idx) < tb:  # static shapes: pad by wrapping
                idx += all_idx[:tb - len(idx)]
            samples = [ds.sample(i, train=False) for i in idx]
            batch = collate(samples)
            metas = [dict(filename=f"synthetic_{i:06d}.png",
                          K=s["meta"]["K"], width=s["meta"]["width"],
                          height=s["meta"]["height"],
                          class_ids=[s["meta"]["cls"]],
                          rotations=[s["meta"]["R"]],
                          translations=[s["meta"]["T"]])
                     for i, s in zip(idx, samples)]
            yield batch, metas

    return DataBundle(consts=consts, meshes=meshes, train_iter=train_iter,
                      eval_batches=eval_batches, cfg=cfg_d)
