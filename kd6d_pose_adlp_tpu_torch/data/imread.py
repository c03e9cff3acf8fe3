"""Image files as `cv2.imread` reads them, without an image library: PNG
(`png.py`) or JPEG (`jpeg.py`), chosen by the file's signature as cv2
chooses, never by its name.

`read(path)` is `cv2.imread(path, IMREAD_UNCHANGED)`; `read_color(path)` is
`cv2.imread(path)` (IMREAD_COLOR): grey to three channels, alpha dropped,
16 bits to their high byte. cv2 turns an image by its EXIF orientation under
IMREAD_COLOR; an orientation other than 1 raises here instead. A file in
another format, or one that the two decoders do not handle, raises
`UnsupportedImage` (a ValueError) naming the file.
"""
from __future__ import annotations

import struct

import numpy as np

from . import jpeg, png
from .native import UnsupportedImage


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


def decode(data: bytes, name: str = "<bytes>", color: bool = False) -> np.ndarray:
    """Decode the PNG or JPEG file contents `data` as `read` (or, with
    `color`, `read_color`) does."""
    is_png = data[:8] == png.SIGNATURE
    if not is_png and data[:3] != jpeg.SIGNATURE:
        raise UnsupportedImage(f"{name}: neither a PNG nor a JPEG file, the two formats "
                               "the port decodes")
    if color:
        exif = _png_exif(data) if is_png else _jpeg_exif(data)
        orientation = _tiff_orientation(exif) if exif else 1
        if 2 <= orientation <= 8:
            raise UnsupportedImage(f"{name}: EXIF orientation {orientation} is not "
                                   "supported (cv2 turns the image under IMREAD_COLOR)")
    if not is_png:
        return jpeg.decode(data, name=name, color=color)
    img = png.decode(data, name=name)
    if not color:
        return img
    if img.dtype == np.uint16:                   # libpng's strip_16: the high byte
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def read(path: str, color: bool = False) -> np.ndarray:
    """The PNG or JPEG in `path` as `cv2.imread(path, IMREAD_UNCHANGED)`
    gives it, or with `color` as `cv2.imread(path)` does."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, name=path, color=color)


def read_color(path: str) -> np.ndarray:
    """The PNG or JPEG in `path` as `cv2.imread(path)` (IMREAD_COLOR) gives
    it: (H, W, 3) BGR uint8."""
    return read(path, color=True)
