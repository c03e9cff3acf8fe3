"""PNG reading and writing without an image library: the port's counterpart
of `cv2.imread(path, cv2.IMREAD_UNCHANGED)` and `cv2.imwrite(path.png)` for
the frames, masks and backgrounds of a BOP tree.

`read` parses the chunks, inflates IDAT with the standard library's zlib
(which releases the interpreter lock, so loader threads overlap), undoes the
five row filters in the data plane (`csrc/dataplane.cpp` `png_unfilter`),
one Adam7 pass at a time for an interlaced file, and returns what
`cv2.imread(IMREAD_UNCHANGED)` returns through libpng's transformations:
grey as (H, W), bit depths 1, 2 and 4 scaled to 0-255
(`png_set_expand_gray_1_2_4_to_8`); RGB and palette images as BGR
(H, W, 3), or BGRA (H, W, 4) with a tRNS chunk (`png_set_tRNS_to_alpha`:
the palette's alpha, or 0 where an RGB pixel equals the tRNS colour); grey
+ alpha and RGBA as BGRA; 8-bit as uint8 and 16-bit as native-endian
uint16. A grey image's tRNS adds no alpha, as in cv2. A palette index past
the PLTE reads black and opaque, as libpng's zeroed 256-entry palette gives.
Damaged files, and the chunks libpng only warns of and drops (a tRNS with
out-of-range samples, beside an alpha channel or longer than the palette),
raise `native.UnsupportedImage` (a ValueError) naming the file.
`write` emits filter type 0 rows through zlib.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native
from .native import UnsupportedImage

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}      # colour type -> samples a pixel


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


_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(h, w, ch) samples of unfiltered rows: uint16 at 16 bits, else uint8
    (sub-byte samples unpacked, most significant bits first)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows.reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :w, None]


def _pixels(raw: np.ndarray, w: int, h: int, ch: int, depth: int, interlace: int):
    """(h, w, ch) samples of the inflated IDAT stream `raw`."""
    bpp = max(1, ch * depth // 8)
    if interlace == 0:
        stride = (w * ch * depth + 7) // 8
        return _samples(native.png_unfilter(raw, h, stride, bpp), w, ch, depth)
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in ADAM7:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:                   # an empty pass has no rows at all
            continue
        stride = (pw * ch * depth + 7) // 8
        rows = native.png_unfilter(raw[pos:], ph, stride, bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
        pos += ph * (stride + 1)
    return out


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode the PNG file contents `data` (see `read`)."""
    header, idat, plte, trns = None, [], None, None
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            if len(body) != 13:
                raise UnsupportedImage(f"{name}: IHDR of {len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
    if header is None or not idat:
        raise UnsupportedImage(f"{name}: no IHDR or IDAT chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if not 0 < w * h <= 1 << 30:                 # cv2's CV_IO_MAX_IMAGE_PIXELS
        raise UnsupportedImage(f"{name}: image size {w}x{h}")
    if depth not in _DEPTHS.get(ctype, ()):
        raise UnsupportedImage(f"{name}: colour type {ctype} at bit depth {depth} is not a PNG")
    if interlace not in (0, 1) or comp != 0 or filt != 0:
        raise UnsupportedImage(f"{name}: unknown compression {comp}, filter method {filt} or "
                               f"interlace method {interlace}")
    if ctype == 3 and (plte is None or len(plte) % 3 or not 3 <= len(plte) <= 768):
        raise UnsupportedImage(f"{name}: a palette image needs a PLTE of 1-256 entries")
    if trns is not None:
        n = {0: 2, 2: 6}.get(ctype)
        if ctype == 3:
            if not 1 <= len(trns) <= len(plte) // 3:
                raise UnsupportedImage(f"{name}: tRNS has no entries or more than the palette")
        elif n is None or len(trns) != n:
            raise UnsupportedImage(f"{name}: invalid tRNS for colour type {ctype}")
        elif depth < 16 and max(struct.unpack(f">{n // 2}H", trns)) >> depth:
            raise UnsupportedImage(f"{name}: tRNS has out-of-range samples for bit depth "
                                   f"{depth}")
    ch = _CHANNELS[ctype]
    try:
        img = _pixels(np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8), w, h, ch, depth,
                      interlace)
    except (zlib.error, UnsupportedImage) as e:
        raise UnsupportedImage(f"{name}: {e}") from None
    if ctype == 3:                               # png_set_palette_to_rgb (+ tRNS_to_alpha)
        lut = np.zeros((256, 4), np.uint8)
        lut[:, 3] = 255
        lut[:len(plte) // 3, 2::-1] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        if trns:
            lut[:len(trns), 3] = np.frombuffer(trns, np.uint8)
        return lut[img[:, :, 0], :4 if trns else 3]
    if ch == 1:
        if depth < 8:                            # png_set_expand_gray_1_2_4_to_8
            img = img * np.uint8(255 // ((1 << depth) - 1))
        return np.ascontiguousarray(img[:, :, 0])
    if ch == 2:                                  # grey + alpha -> BGRA
        return np.ascontiguousarray(img[:, :, [0, 0, 0, 1]])
    if ch == 3:
        if trns is None:
            return np.ascontiguousarray(img[:, :, ::-1])
        key = np.array(struct.unpack(">3H", trns), img.dtype)
        alpha = np.where((img == key).all(axis=2), 0, np.iinfo(img.dtype).max)
        return np.ascontiguousarray(np.concatenate(
            [img[:, :, ::-1], alpha[:, :, None].astype(img.dtype)], axis=2))
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
