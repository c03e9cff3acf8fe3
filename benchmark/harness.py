"""One run of one cell of the benchmark of `kd6d_pose_adlp_tpu_torch`.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one cell is data, found by name:
`workloads/<cell>.json` names its configuration (`configs/<config>.json`),
its traffic (`traffic/<traffic>.json`, whose `kind` names the generator
`traffic/<kind>.py`) and the limits of its correctness check; every
per-layer metric is a reader `metrics/<metric>.py`. A later cell, traffic
mix or metric is a new file, and this one does not change.

A run: the process start, the generator's set-up (inputs and weights made
from the seed on the card, the program built and warmed on the cell's
shapes), which is `setup_s`; the measured window of `--seconds`; the peak
memory; the program's state freed; the check against the plain reference
in `reference/`; then one JSON line on standard output, the last. With
`--trace 0` its metrics are the cell's end-to-end ones; with `--trace 1`
the traced run's per-layer ones (and `breakdown`). The numbers the check
compared, each beside its limit, are the last lines on standard error and
the result line's last key, `checks`.

The run fails (exit code other than 0, no result) where there is no CUDA
card or fewer than the cell asks for, and where `jax`, `jaxlib`, `flax` or
the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "kd6d_pose_adlp_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux), 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload_names() -> List[str]:
    return sorted(f[:-5] for f in os.listdir(os.path.join(HERE, "workloads"))
                  if f.endswith(".json"))


def load_cell(name: str) -> Dict:
    """The cell's workload, configuration and traffic files, one dict."""
    cell = load_json("workloads", f"{name}.json")
    cell["name"] = name
    cell["config_raw"] = load_json("configs", f"{cell['config']}.json")
    cell["traffic_raw"] = load_json("traffic", f"{cell['traffic']}.json")
    return cell


def traffic_kind(cell: Dict):
    kind = cell["traffic_raw"]["kind"]
    return load_module(os.path.join(HERE, "traffic", f"{kind}.py"), f"bench_traffic_{kind}")


def metric_readers() -> Dict[str, object]:
    out = {}
    d = os.path.join(HERE, "metrics")
    for f in sorted(os.listdir(d)):
        if f.endswith(".py") and not f.startswith("_"):
            name = f[:-3]
            out[name] = load_module(os.path.join(d, f), "bench_metric_" + name.replace(".", "_"))
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def deep_tuple(v):
    return tuple(deep_tuple(x) for x in v) if isinstance(v, list) else v


def port_config(raw: dict, which: str = "student"):
    """The program's `Config` for one model of a configuration file."""
    from kd6d_pose_adlp_tpu_torch import config as C
    sec = lambda cls, d: cls(**{k: deep_tuple(v) for k, v in d.items()})
    return C.Config(data=sec(C.DataConfig, raw["data"]),
                    model=sec(C.ModelConfig, raw[which]["model"]),
                    solver=sec(C.SolverConfig, raw["solver"]),
                    test=sec(C.TestConfig, raw["test"]),
                    kd=sec(C.KDConfig, raw["kd"]))


class Run:
    """What one run knows: its arguments and cell, the device, the
    measured numbers, the raw data the per-layer readers read (`layer`)
    and the check's comparisons (`checks`: name, value, limit)."""

    def __init__(self, args, cell: Dict, device, t_start: float, tmpdir: str):
        self.args, self.cell, self.device = args, cell, device
        self.seed, self.seconds = args.seed, args.seconds
        self.t_start, self.tmpdir = t_start, tmpdir
        self.traffic = cell["traffic_raw"]
        self.config = cell["config_raw"]
        self.limits = cell.get("limits", {})
        self.layer: Dict = {}
        self.checks: List[Tuple[str, float, float]] = []
        self.notes: List[str] = []
        self.attempted = self.failed = 0
        self.e2e: Dict[str, Tuple[float, str]] = {}

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start

    def mark(self, what: str):
        """Notes the seconds since the process started at a step of set-up."""
        self.notes.append(f"set-up: {what} at {self.elapsed():.2f} s")

    def check(self, name: str, value: float):
        limit = self.limits.get(name)
        if limit is None:
            raise KeyError(f"workloads/{self.cell['name']}.json has no limit for {name!r}")
        self.checks.append((name, float(value), float(limit)))


def set_reference_precision(torch, tf32: bool):
    """The reference's precision: float32 with TF32 off (the configuration's)
    or, for the control, TF32 on."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def steady_host():
    """One process with few threads: no intra-op thread pool (the hot path
    runs on the device; torchrun sets OMP_NUM_THREADS=1 alike)."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout; the
    program's nvcc libraries go to its own `_build/` there."""
    base = os.path.join(HERE, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")


def main(argv=None, t_start: Optional[float] = None, device=None,
         cell: Optional[Dict] = None, out=None, err=None) -> int:
    """Runs one cell; returns the exit code. `device` and `cell` are for
    the benchmark's own tests, which drive a run on the CPU at a small
    size; the command line always measures on the card."""
    t_start = time.perf_counter() - process_age_s() if t_start is None else t_start
    out, err = out or sys.stdout, err or sys.stderr
    args = parse(argv)
    cell = cell or load_cell(args.workload)
    cache_dirs()
    chips = int(cell.get("chips", 1))
    if device is None:
        steady_host()
        import torch
        torch.set_num_threads(1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"the cell needs {chips} CUDA card(s); this machine has {n}", file=err)
            return 2
        device = torch.device("cuda", 0)
    import torch
    kind = traffic_kind(cell)
    if torch.device(device).type == "cuda":
        torch.zeros(1, device=device)
    with tempfile.TemporaryDirectory() as tmpdir:
        run = Run(args, cell, torch.device(device), t_start, tmpdir)
        run.mark("torch imported, device ready")
        kind.setup(run)
        # the set-up's objects out of the collector's way: a collection in
        # the window then walks only what the window made
        gc.collect()
        gc.freeze()
        setup_s = run.elapsed()
        if args.trace:
            kind.traced(run)
        else:
            kind.window(run)
        cuda = run.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
        found = forbidden_modules()
        kind.release(run)
        gc.unfreeze()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        kind.check(run)
        metrics = {}
        if args.trace:
            for name, reader in metric_readers().items():
                value = reader.read(run)
                if value is not None:
                    metrics[name] = {"value": value, "unit": reader.UNIT}
        else:
            metrics = {k: {"value": v, "unit": u} for k, (v, u) in run.e2e.items()}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    found = sorted(set(found) | set(forbidden_modules()))
    if found:
        print(f"modules loaded that a run may not load: {found}", file=err)
        return 3
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in run.checks)
    correct = bool(run.checks) and ok and run.failed == 0
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if args.trace and "trace" in run.layer:
        dev["busy_s"] = run.layer["trace"]["busy_s"]
        dev["window_s"] = run.layer["trace"]["window_s"]
        from tracing import breakdown
        result["breakdown"] = breakdown(run.layer["trace"])
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    for note in run.notes:
        print(note, file=err)
    print(f"correct: {correct} ({run.attempted} attempted, {run.failed} failed)", file=err)
    for n, v, lim in run.checks:
        print(f"check {n}: {v!r} (limit {lim!r}) {'ok' if math.isfinite(v) and v <= lim else 'FAILED'}",
              file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
