"""Profiling hooks (port of `kd6d_pose_adlp_tpu/utils/profiling.py`; the
reference has none).

- `trace(log_dir)`: a context manager over `torch.profiler` for a window of
  steps. It records the host's operators and, when a card is present, its
  CUDA kernels, and writes a Chrome trace (`*.pt.trace.json`, which
  chrome://tracing, Perfetto and TensorBoard's profiler plugin open) into
  `log_dir`.
- `grad_param_ratios(grads, params)`: max and mean |grad| / |param| (the
  reference's `network_grad_ratio`, libs/utils.py:20-41).
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Dict, Iterable, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profiles the body; yields the profiler (its `key_averages()` are
    readable after the body) and sets its `trace_path` to the Chrome trace
    written into `log_dir` on exit. Synchronizes the card before the trace
    ends, so the body's kernels are in it."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(prof.trace_path)


def grad_param_ratios(grads: Iterable[torch.Tensor],
                      params: Iterable[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{"grad_max_ratio": max|g| / (max|p| + 1e-12), "grad_mean_ratio":
    mean|g| / (mean|p| + 1e-12)} over lists of tensors (a module's:
    `[p.grad for p in net.parameters()]` and `net.parameters()`), both
    means over the gradients' element count as in JAX; 0-dim tensors."""
    grads = [g.detach() for g in grads]
    params = [p.detach() for p in params]
    gmax = torch.stack([g.abs().max() for g in grads]).max()
    pmax = torch.stack([p.abs().max() for p in params]).max()
    gsum = torch.stack([g.abs().sum() for g in grads]).sum()
    psum = torch.stack([p.abs().sum() for p in params]).sum()
    n = sum(g.numel() for g in grads)
    return {"grad_max_ratio": gmax / (pmax + 1e-12),
            "grad_mean_ratio": (gsum / n) / (psum / n + 1e-12)}
