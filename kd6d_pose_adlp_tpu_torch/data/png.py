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
the palette's alpha, or 0 where an RGB pixel equals the tRNS colour, whose
samples libpng compares in the image's bit depth); grey + alpha and RGBA as
BGRA; 8-bit as uint8 and 16-bit as native-endian uint16. A grey image's
tRNS adds no alpha, as in cv2. A palette index past the PLTE reads black and
opaque, as libpng's zeroed 256-entry palette gives.

Damage is handled as cv2's PNG reader (OpenCV's chunk loop over libpng
1.6) handles it: an ancillary chunk that fails its CRC, a PLTE in an image
without a palette, and a tRNS that libpng only warns of (beside an alpha
channel or in a grey image, of the wrong length, longer than the palette,
before PLTE, after IDAT or a second one) are dropped; a file cut anywhere
(IEND included), a critical chunk failing its CRC, a chunk name that is not
four letters with the third upper case, a bad or misplaced IHDR, an unknown
critical chunk, a palette image without a single valid PLTE before IDAT,
no IDAT, and IDAT data that fails to inflate (a bad Adler-32 included),
never ends or holds fewer rows than the image, raise `native.CorruptImage` (a
ValueError naming the file): cv2.imread gives None for them. Inflated data
past the last row, data after IEND and IEND's own CRC are ignored, as
there. `write` emits filter type 0 rows through zlib.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native
from .native import CorruptImage

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}      # colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_MAX_SIDE = 1000000                              # libpng's default user width / height limit
# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def read(path: str) -> np.ndarray:
    """The image in `path` as `cv2.imread(path, IMREAD_UNCHANGED)` gives it;
    raises CorruptImage where that gives None."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, name=path)


def _valid_name(kind: bytes) -> bool:
    return all(65 <= c <= 90 or 97 <= c <= 122 for c in kind) and 65 <= kind[2] <= 90


def _chunks(data: bytes, name: str):
    """(kind, body, crc_ok) of each chunk up to IEND (not yielded)."""
    if data[:8] != SIGNATURE:
        raise CorruptImage(f"{name}: not a PNG file")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise CorruptImage(f"{name}: the file ends before IEND")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if n > 0x7FFFFFFF or not _valid_name(kind):
            raise CorruptImage(f"{name}: bad chunk length or name at byte {pos}")
        end = pos + 12 + n
        if end > len(data):
            raise CorruptImage(f"{name}: chunk {kind!r} is truncated")
        if kind == b"IEND":
            return
        body = data[pos + 8:end - 4]
        yield kind, body, zlib.crc32(kind + body) == struct.unpack(">I", data[end - 4:end])[0]
        pos = end


def unpack_samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(h, w, ch) samples of unfiltered rows: uint16 at 16 bits, else uint8
    (sub-byte samples unpacked, most significant bits first; one channel;
    bytes past the w-th sample of a row ignored). Also TIFF's."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows.reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :w, None]


def _passes(w: int, h: int, ch: int, depth: int, interlace: int):
    """(x0, y0, dx, dy, pass width, pass height, row stride) of each
    non-empty pass: the whole image, or Adam7's seven."""
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw > 0 and ph > 0:                    # an empty pass has no rows at all
            yield x0, y0, dx, dy, pw, ph, (pw * ch * depth + 7) // 8


def _inflate(stream: bytes, need: int, name: str) -> np.ndarray:
    """The first `need` bytes of the zlib `stream`, which must inflate
    without error (its Adler-32 included) to its end."""
    d = zlib.decompressobj()
    try:
        raw = d.decompress(stream)
    except zlib.error as e:
        raise CorruptImage(f"{name}: IDAT data fails to inflate ({e})") from None
    if len(raw) < need or not d.eof:
        raise CorruptImage(f"{name}: IDAT data inflates to {len(raw)} bytes "
                           f"{'' if d.eof else 'and does not end'}; the rows need {need}")
    return np.frombuffer(raw, np.uint8)[:need]


def _pixels(raw: np.ndarray, passes, w: int, h: int, ch: int, depth: int, name: str):
    """(h, w, ch) samples of the inflated IDAT bytes `raw`."""
    bpp = max(1, ch * depth // 8)
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph, stride in passes:
        try:
            rows = native.png_unfilter(raw[pos:], ph, stride, bpp)
        except CorruptImage as e:
            raise CorruptImage(f"{name}: {e}") from None
        out[y0::dy, x0::dx] = unpack_samples(rows, pw, ch, depth)
        pos += ph * (stride + 1)
    return out


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode the PNG file contents `data` (see `read`)."""
    header, idat, plte, trns = None, [], None, None
    for kind, body, crc_ok in _chunks(data, name):
        critical = kind[0] < 97
        if header is None and kind != b"IHDR":
            raise CorruptImage(f"{name}: the first chunk is {kind!r}, not IHDR")
        if kind == b"PLTE" and header[3] != 3:
            continue                             # a suggested palette: unused
        if not crc_ok:
            if critical:
                raise CorruptImage(f"{name}: chunk {kind!r} fails its CRC")
            continue                             # libpng drops it with a warning
        if kind == b"IHDR":
            if header is not None or len(body) != 13:
                raise CorruptImage(f"{name}: a second IHDR or one of {len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body)
            w, h, depth, ctype, comp, filt, interlace = header
            if not (0 < w <= _MAX_SIDE and 0 < h <= _MAX_SIDE and w * h <= 1 << 30):
                raise CorruptImage(f"{name}: image size {w}x{h}")
            if depth not in _DEPTHS.get(ctype, ()):
                raise CorruptImage(f"{name}: colour type {ctype} at bit depth {depth} is "
                                   "not a PNG")
            if interlace not in (0, 1) or comp != 0 or filt != 0:
                raise CorruptImage(f"{name}: unknown compression {comp}, filter method {filt} "
                                   f"or interlace method {interlace}")
        elif kind == b"IDAT":
            if header[3] == 3 and plte is None:
                raise CorruptImage(f"{name}: a palette image needs a PLTE before IDAT")
            idat.append(body)
        elif kind == b"PLTE":
            if plte is not None or idat or len(body) % 3 or not 3 <= len(body) <= 768:
                raise CorruptImage(f"{name}: a second, misplaced or invalid PLTE")
            plte = body[:3 << header[2]]         # libpng keeps 2^depth entries
        elif kind == b"tRNS":
            if trns is None and not idat and _trns_valid(header, plte, body):
                trns = body
        elif critical:
            raise CorruptImage(f"{name}: unknown critical chunk {kind!r}")
    if header is None or not idat:
        raise CorruptImage(f"{name}: no IHDR or IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    ch = _CHANNELS[ctype]
    passes = list(_passes(w, h, ch, depth, interlace))
    need = sum(ph * (stride + 1) for *_, ph, stride in passes)
    img = _pixels(_inflate(b"".join(idat), need, name), passes, w, h, ch, depth, name)
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
        key = np.array(struct.unpack(">3H", trns), np.uint32) & ((1 << depth) - 1)
        alpha = np.where((img == key.astype(img.dtype)).all(axis=2), 0, np.iinfo(img.dtype).max)
        return np.ascontiguousarray(np.concatenate(
            [img[:, :, ::-1], alpha[:, :, None].astype(img.dtype)], axis=2))
    return np.ascontiguousarray(img[:, :, [2, 1, 0, 3]])


def _trns_valid(header, plte, body: bytes) -> bool:
    """Whether libpng keeps a tRNS chunk (png_handle_tRNS): an RGB colour of
    six bytes, or 1 to palette-length alphas after PLTE; a grey image's
    keeps no alpha in cv2, and beside an alpha channel there is none."""
    ctype = header[3]
    if ctype == 2:
        return len(body) == 6
    if ctype == 3:
        return plte is not None and 1 <= len(body) <= len(plte) // 3
    return False


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
