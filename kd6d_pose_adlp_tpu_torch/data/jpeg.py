"""JPEG reading without an image library: the port's counterpart of
`cv2.imread(path, IMREAD_UNCHANGED)` for JPEG frames (BOP's PBR renders).

`read` hands the file to the data plane's decoder (`csrc/jpeg.cpp`, which
releases the interpreter lock, so loader threads overlap) and returns what
cv2 returns: (H, W) grey or (H, W, 3) BGR uint8, bit-equal to
libjpeg-turbo's default decompression, for sequential and progressive
frames. An Adobe APP14 marker of transform 0 reads as RGB, with no colour
conversion, as libjpeg does; a 4-component file (CMYK, or YCCK under Adobe
transform 2) reads as (H, W, 3) BGR by OpenCV's CMYK -> BGR step, as cv2
gives it under either flag. A damaged file decodes as libjpeg recovers it
(cut data, garbage, bad codes, wrong restart markers, progressive data
smoothed where its coefficients are incomplete); where libjpeg stops with
an error it raises `native.CorruptImage` (cv2.imread gives None), and an
arithmetic-coded, lossless or 12-bit file raises `native.UnsupportedImage`,
both ValueErrors naming the file. `imread.py` chooses between this and
`png.py` by signature and turns CorruptImage into None.
"""
from __future__ import annotations

import numpy as np

from . import native

SIGNATURE = b"\xff\xd8\xff"


def read(path: str) -> np.ndarray:
    """The JPEG in `path` as `cv2.imread(path, IMREAD_UNCHANGED)` gives it;
    raises CorruptImage where that gives None."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, name=path)


def decode(data: bytes, name: str = "<bytes>", color: bool = False) -> np.ndarray:
    """Decode the JPEG file contents `data` (see `read`); `color` gives
    (H, W, 3) BGR for a grey file too, as IMREAD_COLOR does."""
    if data[:3] != SIGNATURE:
        raise native.UnsupportedImage(f"{name}: not a JPEG file")
    return native.jpeg_decode(data, color, name=name)
