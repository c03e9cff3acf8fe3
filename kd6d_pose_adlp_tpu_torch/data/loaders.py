"""Unified data access for the CLIs (port of `kd6d_pose_adlp_tpu/data/
loaders.py`): BOP trees on disk or procedural synthetic scenes.

`build(cfg, kind)` returns a DataBundle with the same interface for every
source, so the evaluation and training entry points are source-agnostic.
Each bundle's `train_iter(..., shard=None)` and `eval_batches(shard=None)`
read this process's data shard `(rank, count)` from the torch.distributed
group when none is given (`_process_shard`), as the JAX package's read
its process group: disjoint training streams and strided eval shards.
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
        return _build_bop(cfg, eval_limit, device)
    raise ValueError(f"unknown data kind {kind!r}")


def _process_shard(shard) -> Optional[tuple]:
    """(rank, count) for multi-process data sharding, the reference's
    DistributedSampler split (libs/distributed.py:109-151): `shard` when
    given (tests), else this process's rank and the size of its
    torch.distributed group; None (no slicing) in a single process."""
    if shard is not None:
        return shard
    from ..parallel.mesh import process_count, process_index
    if process_count() > 1:
        return (process_index(), process_count())
    return None


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

    def train_iter(shard=None):
        rank, count = _process_shard(shard) or (0, 1)
        for step in itertools.count():
            # disjoint per-process index windows: global stream position
            # step * count + rank
            g = step * count + rank
            yield ds.batch(range(1000 + g * bs, 1000 + (g + 1) * bs), train=True)

    def eval_batches(shard=None):
        tb = cfg.test.ims_per_batch
        all_idx = list(range(eval_n))
        sh = _process_shard(shard)
        if sh is not None:
            all_idx = all_idx[sh[0]::sh[1]]  # disjoint per-process shard
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


def _build_bop(cfg: Config, eval_limit: Optional[int], device) -> DataBundle:
    from .pipeline import BOPPoseDataset, PrefetchLoader, collate
    train_ds = BOPPoseDataset(cfg, cfg.data.train_list, train=True)
    valid_ds = BOPPoseDataset(cfg, cfg.data.valid_list or cfg.data.test_list, train=False)
    consts = train_ds.consts(device=device)

    def train_iter(num_threads: int = 2, shard=None):
        """Training batches forever; closing the generator stops the
        loader's threads."""
        loader = iter(PrefetchLoader(train_ds, cfg.solver.ims_per_batch, train=True,
                                     num_threads=num_threads, seed=cfg.solver.seed,
                                     shard=_process_shard(shard)))
        try:
            for batch, _ in loader:
                yield batch
        finally:
            loader.close()

    def eval_batches(shard=None):
        # one eval sample per (image, object): reference dzi_test_mobj
        items = valid_ds.eval_items()
        if eval_limit is not None:
            items = items[:eval_limit]
        sh = _process_shard(shard)
        if sh is not None:
            items = items[sh[0]::sh[1]]  # disjoint per-process eval shard
        tb = cfg.test.ims_per_batch
        for start in range(0, len(items), tb):
            samples = []
            for img_i, obj_j in items[start:start + tb]:
                s = valid_ds.sample(img_i, seed=0, focus_obj=obj_j)
                if s is not None:
                    samples.append(s)
            if not samples:
                continue
            while len(samples) < tb:  # static shapes: pad with a duplicate
                samples.append(samples[-1])
            yield collate(samples), [s["meta"] for s in samples]

    return DataBundle(consts=consts, meshes=train_ds.meshes,
                      train_iter=train_iter, eval_batches=eval_batches)
