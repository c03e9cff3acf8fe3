"""Image files as `cv2.imread` reads them, without an image library, the
decoder chosen by the file's signature as cv2's findDecoder chooses it,
never by its name: PNG (`png.py`), JPEG (`jpeg.py`) and TIFF (`tiff.py`).

`read(path)` is `cv2.imread(path, IMREAD_UNCHANGED)`; `read_color(path)` is
`cv2.imread(path)` (IMREAD_COLOR). For PNG and JPEG that is grey to three
channels, alpha dropped, 16 bits to their high byte, and the image turned by
the EXIF orientation of a JPEG's APP1 block or a PNG's eXIf chunk as cv2's
ExifTransform turns it (orientations 2-8: a flip, a rotation or a
transpose; `read`, as IMREAD_UNCHANGED, never turns). A TIFF reads as
cv2's TIFF decoder gives it under either flag, dtype included (float32 and
uint16 under IMREAD_UNCHANGED); `tiff.py` says how it converts for
IMREAD_COLOR.

Both return None where cv2.imread does: for a missing or unreadable file, an
empty one, bytes that no format cv2 reads begins with, an OpenEXR file (the
cv2 these files were held against is built without OpenEXR), and damage or
a layout that cv2's decoder stops at (`native.CorruptImage`, which `decode`
raises). A file that cv2 reads and the port does not (BMP, Radiance,
WebP, Sun raster, PNM, PAM, PFM, JPEG 2000, GIF and AVIF by their
signatures, the TIFF features `tiff.py` lists, arithmetic-coded, lossless
or 12-bit JPEG) raises `native.UnsupportedImage` (a ValueError) naming the
file and the format or feature.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from . import jpeg, png, tiff
from .native import CorruptImage, UnsupportedImage


def _no_decoder(fmt: str):
    def decode(data: bytes, name: str, color: bool):
        raise UnsupportedImage(f"{name}: a {fmt} file, a format cv2 reads and the port does "
                               "not decode")
    return decode


def _openexr(data: bytes, name: str, color: bool):
    raise CorruptImage(f"{name}: an OpenEXR file; the cv2 the port follows is built without "
                       "OpenEXR and reads it as None")


# cv2's decoders in the order findDecoder tries them, each with its
# signature check; PNG and JPEG, None here, are decoded in `decode`
_DECODERS = (
    ("BMP", lambda d: d[:2] == b"BM", _no_decoder("BMP")),
    ("Radiance", lambda d: d[:6] == b"#?RGBE" or d[:10] == b"#?RADIANCE",
     _no_decoder("Radiance")),
    ("JPEG", lambda d: d[:3] == jpeg.SIGNATURE, None),
    ("WebP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP", _no_decoder("WebP")),
    ("Sun raster", lambda d: d[:4] == b"\x59\xa6\x6a\x95", _no_decoder("Sun raster")),
    ("PNM", lambda d: d[:1] == b"P" and d[1:2] in b"1234567" and len(d) > 2
     and d[2:3].isspace(), _no_decoder("PNM")),
    ("PFM", lambda d: d[:2] in (b"PF", b"Pf") and d[2:3].isspace(), _no_decoder("PFM")),
    ("TIFF", tiff.is_tiff, tiff.decode),
    ("PNG", lambda d: d[:8] == png.SIGNATURE, None),
    ("JPEG 2000", lambda d: d[:12] == b"\0\0\0\x0cjP  \r\n\x87\n"
     or d[:4] == b"\xff\x4f\xff\x51", _no_decoder("JPEG 2000")),
    ("OpenEXR", lambda d: d[:4] == b"\x76\x2f\x31\x01", _openexr),
    ("GIF", lambda d: d[:6] in (b"GIF87a", b"GIF89a"), _no_decoder("GIF")),
    ("AVIF", lambda d: d[4:8] == b"ftyp" and any(
        d[i:i + 4] in (b"avif", b"avis")
        for i in range(8, min(len(d), int.from_bytes(d[:4], "big")), 4)),
     _no_decoder("AVIF")),
)


def _tiff_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 of an EXIF TIFF block, 1 when
    absent or unreadable."""
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None or len(tiff) < 8:
        return 1
    off = struct.unpack(order + "I", tiff[4:8])[0]
    if off + 2 > len(tiff):
        return 1
    for i in range(struct.unpack(order + "H", tiff[off:off + 2])[0]):
        p = off + 2 + 12 * i
        if p + 10 > len(tiff):
            break
        tag, kind = struct.unpack(order + "HH", tiff[p:p + 4])
        if tag == 0x0112:
            return struct.unpack(order + "H", tiff[p + 8:p + 10])[0] if kind == 3 else 1
    return 1


def _jpeg_exif(data: bytes) -> bytes:
    """The TIFF block of the first Exif APP1 segment before the first scan."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD9, 0xDA):
            break
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + n]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            return body[6:]
        pos += 2 + n
    return b""


def _png_exif(data: bytes) -> bytes:
    """The body of a PNG's eXIf chunk."""
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"eXIf":
            return data[pos + 8:pos + 8 + n]
        if kind in (b"IDAT", b"IEND"):
            break
        pos += 12 + n
    return b""


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """`img` turned by an EXIF orientation as cv2's ExifTransform turns it:
    2 flips left-right, 3 turns half way, 4 flips upside down, 5 transposes,
    6, 7 and 8 transpose and then flip left-right, both ways or upside down;
    any other value leaves it."""
    if 5 <= orientation <= 8:
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flip:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def decode(data: bytes, name: str = "<bytes>", color: bool = False) -> np.ndarray:
    """Decode the file contents `data` as `read` (or, with `color`,
    `read_color`) does; raises CorruptImage where that returns None."""
    for fmt, match, fn in _DECODERS:
        if match(data):
            break
    else:
        raise CorruptImage(f"{name}: empty, or not an image file cv2 reads")
    if fn is not None:
        return fn(data, name, color)
    is_png = fmt == "PNG"
    if not is_png:
        img = jpeg.decode(data, name=name, color=color)
    else:
        img = png.decode(data, name=name)
    if not color:
        return img
    if is_png:
        if img.dtype == np.uint16:               # libpng's strip_16: the high byte
            img = (img >> 8).astype(np.uint8)
        img = np.repeat(img[:, :, None], 3, axis=2) if img.ndim == 2 else img[:, :, :3]
    exif = _png_exif(data) if is_png else _jpeg_exif(data)
    return _orient(img, _tiff_orientation(exif) if exif else 1)


def read(path: str, color: bool = False) -> Optional[np.ndarray]:
    """The image in `path` as `cv2.imread(path, IMREAD_UNCHANGED)`
    gives it, or with `color` as `cv2.imread(path)` does: None where cv2
    gives None; `native.ImageSizeError` where cv2.imread raises."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        return decode(data, name=path, color=color)
    except (OSError, CorruptImage):
        return None


def read_color(path: str) -> Optional[np.ndarray]:
    """The image in `path` as `cv2.imread(path)` (IMREAD_COLOR) gives it:
    (H, W, 3) BGR uint8, or None where cv2 gives None."""
    return read(path, color=True)
