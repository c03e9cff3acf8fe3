"""Optimizer schedules as plain functions of the step (port of
`kd6d_pose_adlp_tpu/engine/schedule.py:17-44`).

OneCycle with linear annealing (torch OneCycleLR's anneal_strategy='linear',
three_phase=False, as the reference configures it): warm up from
max_lr/div_factor to max_lr over pct_start of the steps, then anneal
linearly to max_lr/div_factor/final_div_factor. The boundary arithmetic is
the JAX package's, evaluated in float32 as XLA does; torch's own
`OneCycleLR` places the phase boundaries differently and is not used.

The reference keeps Adam's beta1 at 0.9 (cycle_momentum=False);
`onecycle_linear_beta1` models the cycle_momentum=True variant and is not
used by the train step.
"""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def _phases(total_steps: int, pct_start: float):
    up = max(int(pct_start * total_steps) - 1, 1)
    down = max(total_steps - up - 1, 1)
    return up, down


def _ramp(step, start: float, end: float, offset: int, length: int):
    frac = np.clip((_f32(step) - _f32(offset)) / _f32(length), _f32(0), _f32(1))
    return _f32(start) + _f32(end - start) * frac


def onecycle_linear_lr(max_lr: float, total_steps: int, pct_start: float = 0.05,
                       div_factor: float = 25.0, final_div_factor: float = 1e4):
    initial = max_lr / div_factor
    final = initial / final_div_factor
    up, down = _phases(total_steps, pct_start)

    def schedule(step) -> float:
        if _f32(step) <= _f32(up):
            return float(_ramp(step, initial, max_lr, 0, up))
        return float(_ramp(step, max_lr, final, up, down))

    return schedule


def onecycle_linear_beta1(total_steps: int, pct_start: float = 0.05,
                          max_momentum: float = 0.95, base_momentum: float = 0.85):
    up, down = _phases(total_steps, pct_start)

    def schedule(step) -> float:
        if _f32(step) <= _f32(up):
            return float(_ramp(step, max_momentum, base_momentum, 0, up))
        return float(_ramp(step, base_momentum, max_momentum, up, down))

    return schedule
