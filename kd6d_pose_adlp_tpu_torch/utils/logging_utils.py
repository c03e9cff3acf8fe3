"""Observability: scalar metrics logging + step timing (a copy of
`kd6d_pose_adlp_tpu/utils/logging_utils.py`).

The reference logs to tensorboardX (`train_kd.py:117-122`). Here: a
dependency-free JSONL scalar logger (one line per event, trivially plottable)
plus an images/sec meter; TensorBoard event files are written too when the
`tensorboard` package happens to be importable.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class ScalarLogger:
    def __init__(self, working_dir: str, filename: str = "scalars.jsonl"):
        os.makedirs(working_dir, exist_ok=True)
        self.path = os.path.join(working_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self._tb = None
        try:  # optional TensorBoard writer
            from torch.utils.tensorboard import SummaryWriter  # type: ignore
            self._tb = SummaryWriter(working_dir)
        except Exception:
            self._tb = None

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class Throughput:
    """images/sec + step-time meter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._images = 0
        self._steps = 0

    def update(self, n_images: int):
        self._images += n_images
        self._steps += 1

    @property
    def images_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._images / dt if dt > 0 else 0.0

    @property
    def steps_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0
