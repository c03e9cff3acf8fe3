"""ctypes bindings of the port's host data plane (`csrc/dataplane.cpp`; the
counterpart of `kd6d_pose_adlp_tpu/data/native.py`).

The library is built with g++ at first use into `kd6d_pose_adlp_tpu_torch/
_build/`, named by a hash of the source and flags as the CUDA libraries are
(`utils/cuda_build.py`), and loaded once per process. There is no fallback:
the BOP pipeline's warps, normalisation and PNG decoding run here, so a
failed build raises. Each call runs on one thread (the C functions' thread
count is 1): the loader's threads parallelize across samples.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..utils.cuda_build import BUILD_DIR, CSRC

# portable code: the JAX package adds -march=native, but the warps' fixed
# point gives the same pixels without it (tests/test_torch_port_bop.py
# holds them bit-equal to its native path)
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def library_path():
    src = (CSRC / "dataplane.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libdataplane-{digest}.so"


def _build(target) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(CSRC / "dataplane.cpp"), "-o", str(tmp),
                           "-lpthread"], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for csrc/dataplane.cpp (rc {proc.returncode}):\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, target)


def get_lib() -> ctypes.CDLL:
    """The data plane's ctypes handle, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            c = ctypes.c_int
            lib.warp_affine_u8.argtypes = [u8p, c, c, c, u8p, c, c, f64p, u8p, c]
            lib.warp_affine_u8.restype = None
            lib.warp_affine_i32.argtypes = [i32p, c, c, i32p, c, c, f64p, ctypes.c_int32, c]
            lib.warp_affine_i32.restype = None
            lib.normalize_bgr_u8.argtypes = [u8p, c, c, f32p, f32p, f32p, c]
            lib.normalize_bgr_u8.restype = None
            lib.png_unfilter.argtypes = [u8p, c, c, c, u8p]
            lib.png_unfilter.restype = c
            _lib = lib
    return _lib


def _affine(M) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(M, np.float64)[:2].reshape(-1))


def warp_affine_u8(src: np.ndarray, M, out_hw, border=(0, 0, 0)) -> np.ndarray:
    """Bilinear warp of an (H, W) or (H, W, C) uint8 image by the src -> dst
    affine M (2x3 or 3x3) into out_hw = (h, w) (, C), `border` per channel
    outside the source."""
    lib = get_lib()
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim == 2:
        src = src[:, :, None]
    dh, dw = out_hw
    dst = np.empty((dh, dw, src.shape[2]), np.uint8)
    b = np.ascontiguousarray(np.asarray(border, np.uint8)[: src.shape[2]])
    if len(b) < src.shape[2]:
        raise ValueError(f"border {border} has fewer values than the {src.shape[2]} channels")
    lib.warp_affine_u8(src, src.shape[0], src.shape[1], src.shape[2], dst, dh, dw,
                       _affine(M), b, 1)
    return dst


def warp_affine_i32(src: np.ndarray, M, out_hw, border: int = 0) -> np.ndarray:
    """Nearest-neighbour warp of an (H, W) int32 label image."""
    lib = get_lib()
    src = np.ascontiguousarray(src, np.int32)
    if src.ndim != 2:
        raise ValueError(f"warp_affine_i32 takes an (H, W) label image, got {src.shape}")
    dh, dw = out_hw
    dst = np.empty((dh, dw), np.int32)
    lib.warp_affine_i32(src, src.shape[0], src.shape[1], dst, dh, dw, _affine(M),
                        border, 1)
    return dst


def normalize_bgr_u8(img: np.ndarray, mean, std) -> np.ndarray:
    """(H, W, 3) BGR uint8 -> (H, W, 3) RGB float32 (px / 255 - mean) / std."""
    lib = get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"normalize_bgr_u8 takes an (H, W, 3) image, got {img.shape}")
    out = np.empty((img.shape[0], img.shape[1], 3), np.float32)
    lib.normalize_bgr_u8(img, img.shape[0], img.shape[1],
                         np.ascontiguousarray(mean, np.float32),
                         np.ascontiguousarray(std, np.float32), out, 1)
    return out


def png_unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    """The (rows, stride) uint8 bytes of a PNG image from its inflated IDAT
    stream `raw` (rows of a filter-type byte and `stride` filtered bytes),
    `bpp` bytes a pixel. Raises ValueError on a short stream or a filter
    type outside 0-4."""
    lib = get_lib()
    raw = np.ascontiguousarray(raw, np.uint8).reshape(-1)
    if raw.size < rows * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, {rows} rows of {stride} "
                         f"need {rows * (stride + 1)}")
    out = np.empty((rows, stride), np.uint8)
    bad = lib.png_unfilter(raw, rows, stride, bpp, out)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type {raw[(bad - 1) * (stride + 1)]}")
    return out
