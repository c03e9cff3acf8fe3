"""What the kernel benchmarks of scripts/ share: building versions of a
kernel's source side by side."""
from __future__ import annotations

import ctypes
import os
import subprocess


def build(sources, symbols, variants=(("", ()),)):
    """Compile each source into its own library with the port's nvcc flags,
    all nvcc processes at once, and print ptxas's register, spill and entry
    lines. `symbols` maps each C entry point to its argtypes. Returns {name:
    ctypes handle} with those argtypes set and an int result on each entry
    point; a name is the source's index and base name. Each (suffix, flags)
    of `variants` builds every source once more with the extra nvcc flags,
    its name ending in the suffix."""
    from kd6d_pose_adlp_tpu_torch.utils import cuda_build as cb

    cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for k, src in enumerate(sources):
        for suffix, flags in variants:
            name = f"{k}_{os.path.splitext(os.path.basename(src))[0]}{suffix}"
            lib = cb.BUILD_DIR / f"bench_{name}.so"
            jobs[name] = (lib, subprocess.Popen(
                [cb.nvcc_path(), *cb.NVCC_FLAGS, *flags, "-o", str(lib), src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
        handle = ctypes.CDLL(str(lib))
        for symbol, argtypes in symbols.items():
            fn = getattr(handle, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[name] = handle
    return libs
