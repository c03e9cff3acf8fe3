"""PNG reading and writing without an image library: the port's counterpart
of `cv2.imread(path, cv2.IMREAD_UNCHANGED)` and `cv2.imwrite(path.png)` for
the frames and masks of a BOP tree.

`read` parses the chunks, inflates IDAT with the standard library's zlib
(which releases the interpreter lock, so loader threads overlap) and undoes
the five row filters in the data plane (`csrc/dataplane.cpp`
`png_unfilter`). It returns what `cv2.imread(IMREAD_UNCHANGED)` returns:
grey as (H, W), RGB as BGR (H, W, 3), grey + alpha and RGBA as BGRA
(H, W, 4), 8-bit as uint8 and 16-bit as native-endian uint16. Palette
images, bit depths below 8, Adam7 interlace, tRNS transparency and damaged
files raise `native.UnsupportedImage` (a ValueError) naming the file.
`write` emits filter type 0 rows through zlib.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native
from .native import UnsupportedImage

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # colour type -> samples a pixel


def read(path: str) -> np.ndarray:
    """The image in `path` as `cv2.imread(path, IMREAD_UNCHANGED)` gives it."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, name=path)


def _chunks(data: bytes, name: str):
    if data[:8] != SIGNATURE:
        raise UnsupportedImage(f"{name}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + n
        if end > len(data):
            raise UnsupportedImage(f"{name}: chunk {kind!r} is truncated")
        body = data[pos + 8:end - 4]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[end - 4:end])[0]:
            raise UnsupportedImage(f"{name}: chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end
    raise UnsupportedImage(f"{name}: no IEND chunk")


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode the PNG file contents `data` (see `read`)."""
    header, idat = None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            raise UnsupportedImage(f"{name}: tRNS transparency is not supported")
    if header is None or not idat:
        raise UnsupportedImage(f"{name}: no IHDR or IDAT chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype == 3:
        raise UnsupportedImage(f"{name}: palette PNGs are not supported")
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise UnsupportedImage(f"{name}: colour type {ctype} at bit depth {depth} is not "
                               "supported (grey, RGB, grey + alpha or RGBA at 8 or 16 bits)")
    if interlace != 0:
        raise UnsupportedImage(f"{name}: Adam7 interlaced PNGs are not supported")
    if comp != 0 or filt != 0:
        raise UnsupportedImage(f"{name}: unknown compression {comp} or filter method {filt}")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    try:
        raw = zlib.decompress(b"".join(idat))
        rows = native.png_unfilter(np.frombuffer(raw, np.uint8), h, w * bpp, bpp)
    except (zlib.error, UnsupportedImage) as e:
        raise UnsupportedImage(f"{name}: {e}") from None
    img = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    img = img.reshape(h, w, ch)
    if ch == 1:
        return np.ascontiguousarray(img[:, :, 0])
    if ch == 2:                                   # grey + alpha -> BGRA
        return np.ascontiguousarray(img[:, :, [0, 0, 0, 1]])
    if ch == 3:
        return np.ascontiguousarray(img[:, :, ::-1])
    return np.ascontiguousarray(img[:, :, [2, 1, 0, 3]])


def write(path: str, img: np.ndarray) -> None:
    """Write `img` as `cv2.imwrite` would read back: (H, W) grey, (H, W, 3)
    BGR or (H, W, 4) BGRA, uint8 or uint16; zlib at its fastest level, as
    cv2's default."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"{path}: PNG takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        ctype, rgb = 0, img[:, :, None]
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, rgb = 2, img[:, :, ::-1]
    elif img.ndim == 3 and img.shape[2] == 4:
        ctype, rgb = 6, img[:, :, [2, 1, 0, 3]]
    else:
        raise ValueError(f"{path}: cannot write an image of shape {img.shape}")
    h, w = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(rgb.astype(">u2") if depth == 16 else rgb).reshape(h, -1)
    raw = np.zeros((h, rows.view(np.uint8).shape[1] + 1), np.uint8)
    raw[:, 1:] = rows.view(np.uint8)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def unfilter_plain(raw: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    """Plain numpy version of `native.png_unfilter` (the PNG specification's
    five filters, a row at a time, a pixel at a time where a filter reads
    the reconstructed left neighbour): the reference the data plane is held
    against."""
    src = np.asarray(raw, np.uint8).reshape(-1)[: rows * (stride + 1)].reshape(rows, stride + 1)
    out = np.zeros((rows, stride), np.int64)
    for y in range(rows):
        kind, line = int(src[y, 0]), src[y, 1:].astype(np.int64)
        up = out[y - 1] if y > 0 else np.zeros(stride, np.int64)
        if kind == 0:
            out[y] = line
        elif kind == 2:
            out[y] = (line + up) % 256
        elif kind in (1, 3, 4):
            for x0 in range(0, stride, bpp):
                x = np.arange(x0, min(x0 + bpp, stride))
                a = out[y, x - bpp] if x0 >= bpp else np.zeros(len(x), np.int64)
                b = up[x]
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) // 2
                else:
                    c = up[x - bpp] if x0 >= bpp else np.zeros(len(x), np.int64)
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                out[y, x] = (line[x] + pred) % 256
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}")
    return out.astype(np.uint8)
