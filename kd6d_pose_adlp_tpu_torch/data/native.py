"""ctypes bindings of the port's host data plane (`csrc/dataplane.cpp`, the
counterpart of `kd6d_pose_adlp_tpu/data/native.py`; `csrc/jpeg.cpp`, the
sequential and progressive JPEG decoder; `csrc/cvarith.cpp`, cv2's uint8 colour, filter and
resize arithmetic of the augmentations; `csrc/rasters.cpp`, the LZW, PackBits
and predictor loops of the TIFF decoder).

The four sources are built with g++ at first use into one library in
`kd6d_pose_adlp_tpu_torch/_build/`, named by a hash of the sources and flags
as the CUDA libraries are (`utils/cuda_build.py`), and loaded once per
process. There is no fallback: the BOP pipeline's warps, normalisation,
decoding and augmentations run here, so a failed build raises. Each call
runs on one thread and releases the interpreter lock (ctypes does): the
loader's threads parallelize across samples.
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
# holds them bit-equal to its native path); no contraction into FMAs, as
# csrc/cvarith.cpp fuses exactly where cv2 does, with std::fma
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")
SOURCES = ("dataplane.cpp", "jpeg.cpp", "cvarith.cpp", "rasters.cpp")

_lib = None
_lock = threading.Lock()


class UnsupportedImage(ValueError):
    """An image file that cv2.imread reads and the port cannot decode (a
    format other than PNG, JPEG and TIFF, the TIFF features `tiff.py`
    lists, or an arithmetic-coded, lossless or 12-bit JPEG). The BOP
    pipeline raises it, where a file cv2 cannot read only skips its sample:
    the JAX package reads such files with cv2, so skipping them would change
    what is trained and scored."""


class CorruptImage(ValueError):
    """An image file that cv2.imread gives None for: damage where its decoder
    stops with an error (a JPEG cut inside its headers, a PNG cut anywhere
    or failing a critical chunk's CRC, a TIFF cut short, ...), a layout
    cv2's decoder refuses, an OpenEXR file (the cv2 the port follows is
    built without OpenEXR), or bytes that no format cv2 knows begins with.
    `imread.read` returns None for it, as cv2.imread does; the message names
    what the decoder met. Not an UnsupportedImage."""


class ImageSizeError(ValueError):
    """A file whose header gives a size that cv2.imread raises cv2.error for
    (validateInputImageSize: a width or height outside 1 to 2^20, or more
    than 2^30 pixels) where its decoder accepted the header. `imread.read`
    raises it instead of returning None, as cv2.imread raises: the BOP
    pipeline's sample then gives None, as the JAX package's does for any
    exception, and the background bank stops, as it does there."""


def check_size(w: int, h: int, name: str) -> None:
    """Raise ImageSizeError where cv2.imread's size check fails."""
    if not (0 < w <= 1 << 20 and 0 < h <= 1 << 20 and w * h <= 1 << 30):
        raise ImageSizeError(f"{name}: a {w}x{h} image, a size cv2.imread raises an error for")


def library_path():
    src = b"".join((CSRC / name).read_bytes() for name in SOURCES)
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libdataplane-{digest}.so"


def _build(target) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, *(str(CSRC / name) for name in SOURCES),
                           "-o", str(tmp), "-lpthread"], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for csrc/{', '.join(SOURCES)} (rc {proc.returncode}):\n"
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
            i64 = ctypes.c_int64
            lib.jpeg_info.argtypes = [ctypes.c_char_p, i64, i32p, ctypes.c_char_p, c]
            lib.jpeg_info.restype = c
            lib.jpeg_decode.argtypes = [ctypes.c_char_p, i64, u8p, i64, c, ctypes.c_char_p, c]
            lib.jpeg_decode.restype = c
            f = ctypes.c_double
            lib.bgr2hsv_u8.argtypes = [u8p, i64, u8p]
            lib.hsv2bgr_u8.argtypes = [u8p, c, c, u8p]
            lib.gaussian_blur7_u8.argtypes = [u8p, c, c, c, f, u8p]
            lib.box_blur_u8.argtypes = [u8p, c, c, c, c, u8p]
            lib.normalize_minmax_f32.argtypes = [f32p, i64, f32p]
            lib.normalize_minmax_f64.argtypes = [f64p, i64, f64p]
            lib.resize_linear_u8.argtypes = [u8p, c, c, c, u8p, c, c]
            for name in ("bgr2hsv_u8", "hsv2bgr_u8", "gaussian_blur7_u8", "box_blur_u8",
                         "normalize_minmax_f32", "normalize_minmax_f64", "resize_linear_u8"):
                getattr(lib, name).restype = None
            lib.tiff_lzw.argtypes = [ctypes.c_char_p, i64, u8p, i64]
            lib.tiff_packbits.argtypes = [ctypes.c_char_p, i64, u8p, i64]
            lib.tiff_hor_acc.argtypes = [u8p, i64, i64, c, c]
            lib.tiff_fp_acc.argtypes = [u8p, i64, i64, c, c]
            for name in ("tiff_lzw", "tiff_packbits"):
                getattr(lib, name).restype = c
            lib.tiff_hor_acc.restype = lib.tiff_fp_acc.restype = None
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
    `bpp` bytes a pixel. Raises CorruptImage on a short stream or a filter
    type outside 0-4, where libpng fails and cv2.imread gives None."""
    lib = get_lib()
    raw = np.ascontiguousarray(raw, np.uint8).reshape(-1)
    if raw.size < rows * (stride + 1):
        raise CorruptImage(f"PNG data holds {raw.size} bytes, {rows} rows of {stride} "
                           f"need {rows * (stride + 1)}")
    out = np.empty((rows, stride), np.uint8)
    bad = lib.png_unfilter(raw, rows, stride, bpp, out)
    if bad:
        raise CorruptImage(f"PNG row {bad - 1} has filter type {raw[(bad - 1) * (stride + 1)]}")
    return out


def _jpeg_fail(name: str, rc: int, err) -> ValueError:
    kind = CorruptImage if rc == 1 else UnsupportedImage
    return kind(f"{name}: {err.value.decode(errors='replace')}")


def jpeg_decode(data: bytes, color: bool, name: str = "<bytes>") -> np.ndarray:
    """The JPEG `data` (sequential or progressive; grey, YCbCr, RGB, CMYK or
    YCCK) decoded as libjpeg-turbo decodes it for cv2.imread, damaged data
    recovered as libjpeg recovers it: (H, W) grey or (H, W, 3) BGR uint8, or
    (H, W, 3) BGR always when `color` (IMREAD_COLOR's conversion). Raises
    CorruptImage naming `name` where libjpeg stops with an error (cv2 gives
    None), UnsupportedImage for what `csrc/jpeg.cpp` does not decode (its
    header comment lists both)."""
    lib = get_lib()
    info = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(256)
    rc = lib.jpeg_info(data, len(data), info, err, len(err))
    if rc:
        raise _jpeg_fail(name, rc, err)
    h, w, nc = int(info[0]), int(info[1]), int(info[2])
    out = np.empty((h, w) if nc == 1 and not color else (h, w, 3), np.uint8)
    rc = lib.jpeg_decode(data, len(data), out, out.size, int(color), err, len(err))
    if rc:
        raise _jpeg_fail(name, rc, err)
    return out


def tiff_lzw(src: bytes, size: int):
    """libtiff's LZW decode of a strip or tile into `size` bytes: (bytes,
    rc), rc 0 when they were all decoded, 1 after the error libtiff reports
    (the bytes past what was decoded are 0), 2 for old-style LZW."""
    out = np.empty(size, np.uint8)
    rc = get_lib().tiff_lzw(src, len(src), out, size)
    return out, rc


def tiff_packbits(src: bytes, size: int):
    """libtiff's PackBits decode into `size` bytes: (bytes, rc) as
    `tiff_lzw`."""
    out = np.empty(size, np.uint8)
    rc = get_lib().tiff_packbits(src, len(src), out, size)
    return out, rc


def tiff_predict(buf: np.ndarray, rows: int, row_bytes: int, bytes_per_sample: int,
                 stride: int, floating: bool) -> None:
    """Undo TIFF predictor 2 (`floating` False: native-order integer
    samples) or 3 (floating point) in place on `rows` rows of `row_bytes`
    bytes of the uint8 array `buf`, samples `stride` apart."""
    fn = get_lib().tiff_fp_acc if floating else get_lib().tiff_hor_acc
    fn(buf, rows, row_bytes, bytes_per_sample, stride)


def _image(img: np.ndarray, what: str, channels=None) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or 0 in img.shape or (channels is not None
                                           and img.shape[2] != channels):
        raise ValueError(f"{what} takes a non-empty (H, W, {channels or 'C'}) uint8 "
                         f"image, got {img.shape}")
    return img


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2HSV) of an (H, W, 3) uint8 image."""
    img = _image(img, "bgr2hsv", 3)
    out = np.empty_like(img)
    get_lib().bgr2hsv_u8(img, img.shape[0] * img.shape[1], out)
    return out


def hsv2bgr(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2BGR) of an (H, W, 3) uint8 image."""
    hsv = _image(hsv, "hsv2bgr", 3)
    out = np.empty_like(hsv)
    get_lib().hsv2bgr_u8(hsv, hsv.shape[0], hsv.shape[1], out)
    return out


def gaussian_blur7(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (7, 7), sigma) of an (H, W, C) uint8 image
    (sigma <= 0: cv2's 7-tap table)."""
    img = _image(img, "gaussian_blur7")
    out = np.empty_like(img)
    get_lib().gaussian_blur7_u8(img, img.shape[0], img.shape[1], img.shape[2], float(sigma), out)
    return out


def box_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.blur(img, (ksize, ksize)) of an (H, W, C) uint8 image, ksize odd
    and at most 15 (cv2's 8U fixed-point division holds to 16^2 taps)."""
    if ksize % 2 != 1 or not 1 <= ksize <= 15:
        raise ValueError(f"box_blur takes an odd ksize of at most 15, got {ksize}")
    img = _image(img, "box_blur")
    out = np.empty_like(img)
    get_lib().box_blur_u8(img, img.shape[0], img.shape[1], img.shape[2], int(ksize), out)
    return out


def normalize_minmax(x: np.ndarray) -> np.ndarray:
    """cv2.normalize(x, None, alpha=0, beta=255, norm_type=NORM_MINMAX) of a
    float32 or float64 array, over all its elements; the same dtype out."""
    x = np.asarray(x)
    if x.dtype not in (np.float32, np.float64) or x.size == 0:
        raise ValueError(f"normalize_minmax takes a non-empty float32 or float64 array, "
                         f"got {x.dtype} {x.shape}")
    x = np.ascontiguousarray(x)
    out = np.empty_like(x)
    fn = get_lib().normalize_minmax_f32 if x.dtype == np.float32 else \
        get_lib().normalize_minmax_f64
    fn(x.reshape(-1), x.size, out.reshape(-1))
    return out


def resize_linear(img: np.ndarray, out_wh) -> np.ndarray:
    """cv2.resize(img, out_wh) (INTER_LINEAR) of an (H, W, C) uint8 image."""
    img = _image(img, "resize_linear")
    w, h = int(out_wh[0]), int(out_wh[1])
    if w < 1 or h < 1:
        raise ValueError(f"resize_linear to {out_wh}")
    out = np.empty((h, w, img.shape[2]), np.uint8)
    get_lib().resize_linear_u8(img, img.shape[0], img.shape[1], img.shape[2], out, h, w)
    return out
