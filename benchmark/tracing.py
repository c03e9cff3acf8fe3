"""The traced part of a `--trace 1` run, and its reduction to numbers.

`profiled(fn, tmpdir)` runs `fn` twice under `torch.profiler`, each time
ending with a synchronize, writing the Chrome trace under `tmpdir` and
reading it back. The first stretch traces the device's activity alone
(CUPTI), as `chip_smoke.profile_request` does, so that the host runs
about as fast as in the window; it gives

- device busy seconds: the union of kernel, memcpy and memset intervals;
- the window: host seconds from the profiler's start to the synchronize;
- device operations by name, their count and seconds.

The second stretch also records the host's operators, which slows the
host several fold; it gives only the idle gaps: each stretch in which no
device operation runs, named by what the host was doing there (the
outermost host operator that overlaps it most, over every host thread),
summed by that name.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import time
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _outermost(events: List[dict]) -> List[List[Tuple[float, float, str]]]:
    """Each host thread's events not inside another of that thread, sorted
    (they do not overlap)."""
    by_tid = collections.defaultdict(list)
    for e in events:
        by_tid[(e.get("pid"), e.get("tid"))].append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    out = []
    for evs in by_tid.values():
        evs.sort(key=lambda t: (t[0], -t[1]))
        top, end = [], -1.0
        for a, b, n in evs:
            if a >= end:
                top.append((a, b, n))
                end = b
        out.append(top)
    return out


def reduce(trace: dict, window_s: float) -> Dict:
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    busy = _merge([(e["ts"], e["ts"] + e.get("dur", 0)) for e in dev])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e.get("dur", 0)
    # the window on the trace's clock: from the first to the last event
    starts = [e["ts"] for e in events]
    t0 = min(starts) if starts else 0.0
    t1 = max((e["ts"] + e.get("dur", 0) for e in events), default=0.0)
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    threads = [(t, [a for a, _, _ in t]) for t in _outermost(host)]
    idle: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps:
        best, best_ov = "(no host operator)", 0.0
        for top, starts_t in threads:
            i = max(bisect.bisect_right(starts_t, g0) - 1, 0)
            while i < len(top) and top[i][0] < g1:
                a, b, n = top[i]
                ov = min(b, g1) - max(a, g0)
                if ov > best_ov:
                    best, best_ov = n, ov
                i += 1
        idle[best] += (g1 - g0) * 1e-6
    return dict(
        busy_s=busy_us * 1e-6, window_s=window_s, trace_s=(t1 - t0) * 1e-6,
        kernels=sum(1 for e in dev if e.get("cat") == "kernel"),
        ops={n: (c, t * 1e-6) for n, (c, t) in by_name.items()},
        idle=dict(idle))


def _stretch(fn: Callable[[], None], tmpdir: str, activities) -> Dict:
    from torch.profiler import profile
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    return reduce(trace, window_s)


def profiled(fn: Callable[[], None], tmpdir: str,
             counters: Callable[[], Dict] = dict) -> Dict:
    """`reduce`'s summary of fn() traced on the device alone, with
    `counters()` read right after it, and `idle` (and `host_window_s`)
    from fn() traced again with the host's operators."""
    from torch.profiler import ProfilerActivity
    out = _stretch(fn, tmpdir, [ProfilerActivity.CUDA])
    out["counters"] = counters()
    host = _stretch(fn, tmpdir, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    out["idle"], out["host_window_s"] = host["idle"], host["window_s"]
    return out


def breakdown(summary: Dict, n: int = 10) -> Dict:
    """The result line's `breakdown`: the device operations that took most
    time and the longest idle gaps by host operator, at most n each."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][1])[:n]
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[name[:160], s] for name, (_, s) in ops],
            "idle_gaps": [[name[:160], s] for name, s in idle]}


def kernel_seconds(summary: Dict, fragment: str) -> Tuple[int, float]:
    """(count, seconds) of the device operations whose name holds
    `fragment`."""
    hits = [v for k, v in summary["ops"].items() if fragment in k]
    return sum(c for c, _ in hits), sum(s for _, s in hits)
