"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into a shared library (no PyTorch headers: a build takes seconds), loaded
with ctypes. Libraries go to `kd6d_pose_adlp_tpu_torch/_build/`, named by a
hash of the source and flags, so an edited source rebuilds and an unchanged
one is reused. Building happens at first use, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "kd6d_pose_adlp_tpu_torch are built from csrc/ at first use")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start `nvcc` for one source; returns (target, process or None)."""
    target = library_path(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = open(target.with_suffix(".log"), "w")
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                             str(CSRC / f"{name}.cu")],
                            stdout=log, stderr=subprocess.STDOUT)
    return target, (proc, tmp, log)


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source, all `nvcc` processes started together."""
    started = {n: _start(n) for n in names}
    for name, (target, job) in started.items():
        if job is None:
            continue
        proc, tmp, log = job
        rc = proc.wait()
        log.close()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc {rc}):\n"
                               + target.with_suffix(".log").read_text())
        os.replace(tmp, target)
    return {n: t for n, (t, _) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _loaded[name] = lib
    return lib
