"""TIFF files as `cv2.imread` reads them, without an image library (OpenCV's
grfmt_tiff.cpp over libtiff 4.7).

Only the first IFD is read, as cv2 reads the first page: classic and
BigTIFF, either byte order; strips or tiles, chunky or separate planes;
compression none, LZW and PackBits (`csrc/rasters.cpp`), Deflate (zlib) and
JPEG (the JPEGTables stream put ahead of each strip or tile, decoded by
`csrc/jpeg.cpp` as libjpeg does it under libtiff's colour mode: YCbCr
converted to RGB, RGB and grey taken as stored); predictor 2 on 8, 16 and
32-bit samples and predictor 3 on floats; FillOrder 2 bits reversed.

What cv2 gives depends on the depth it reads into:
  - 8 bits (every IMREAD_COLOR read, and 1, 4 and 8-bit files under
    IMREAD_UNCHANGED) goes through libtiff's TIFFReadRGBA: grey of 1 or 8
    bits is scaled to 0-255 (MinIsWhite inverted) and 16-bit grey keeps its
    high byte; RGB of 16 bits becomes (v + 128) // 257; a palette of 1 to
    8 bits is read as 8 bits when every entry is below 256, else by the
    high byte; unassociated alpha is premultiplied ((v * a + 127) // 255),
    associated or unspecified alpha is kept. The result is BGR, BGRA (four
    samples under IMREAD_UNCHANGED) or, for grey, a palette of 1 bit and
    grey with alpha under IMREAD_UNCHANGED, one channel of OpenCV's fixed-
    point grey. A strip or tile whose data fails to decode is what decoded
    before the error and zeros after it, with neither predictor nor byte
    order undone; one that lies outside the file gives None. Floats have no
    8-bit reading: IMREAD_COLOR gives None for them. 2-bit files, and 4-bit
    ones other than a palette, are None.
  - 16 bits (16-bit grey, RGB or RGBA under IMREAD_UNCHANGED) and float32
    are read as stored: RGB comes out BGR, RGBA BGRA, MinIsWhite is not
    inverted. Any strip or tile that fails gives None.
  - The Orientation tag turns the result as EXIF orientations turn a JPEG;
    5 to 8 give None unless the image is square, as in cv2.

The IFD is read by libtiff's rules (`_Layout`): which bad tags fail the
directory and which are ignored, strip arrays read up to the strip count,
byte counts estimated where missing, a Compression number libtiff does not
know leaving no codec (its strips decode to zeros under the 8-bit read).

Raises `native.UnsupportedImage` naming the file and the feature for what
the port does not decode: CCITT, old-style JPEG, LogLuv, ThunderScan, NeXT
and Pixar compressions (LZMA, ZSTD, WebP and the others that cv2's libtiff
is built without read as None); signed, 32-bit integer and 64-bit samples; 16-bit or
float separate planes (cv2 reads them from memory it never wrote); CMYK,
Lab and YCbCr without JPEG; 16-bit palettes; old-style LZW. Damage that
cv2 gives None for raises `native.CorruptImage`.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from . import jpeg, native
from .png import unpack_samples
from .native import CorruptImage, UnsupportedImage, check_size

SIGNATURES = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
          16: 8, 17: 8, 18: 8}
_INT_TYPES = {1: "B", 6: "b", 3: "H", 8: "h", 4: "I", 9: "i", 16: "Q", 17: "q"}
# compressions cv2's libtiff decodes and the port does not; those libtiff
# knows without being built with them (JBIG, LZMA, ZSTD, WebP, JPEG XL,
# LERC) read as None; a number libtiff does not know reads as uncompressed
_UNPORTED = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 6: "old-style JPEG",
             32771: "CCITT RLEW", 32766: "NeXT", 32809: "ThunderScan", 32908: "Pixar log",
             32909: "Pixar log", 34676: "SGI LogL", 34677: "SGI LogLuv"}
_NOT_CONFIGURED = {34661, 34925, 50000, 50001, 50002, 34887}
_BITREV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
# TIFFTAG numbers
(_WIDTH, _LENGTH, _BPS, _COMPRESSION, _PHOTOMETRIC, _FILLORDER, _STRIPOFFSETS, _ORIENTATION,
 _SPP, _ROWSPERSTRIP, _STRIPBYTECOUNTS, _PLANAR, _PREDICTOR, _COLORMAP, _TILEWIDTH,
 _TILELENGTH, _TILEOFFSETS, _TILEBYTECOUNTS, _EXTRASAMPLES, _SAMPLEFORMAT, _JPEGTABLES) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320, 322, 323, 324, 325,
    338, 339, 347)


def is_tiff(data: bytes) -> bool:
    return data[:4] in SIGNATURES


def _ifd(data: bytes, name: str):
    """(byte order, {tag: (type, count, value field)} of the first IFD's
    entries (a tag's first), the IFD's size in bytes with its out-of-line
    values); CorruptImage where libtiff's TIFFOpen fails."""
    order = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\0", b"\0+")
    try:
        if big:
            if struct.unpack(order + "HH", data[4:8]) != (8, 0):
                raise CorruptImage(f"{name}: a BigTIFF header of another offset size")
            off = struct.unpack(order + "Q", data[8:16])[0]
            n = struct.unpack(order + "Q", data[off:off + 8])[0]
            first, size, cfmt, inline = off + 8, 20, "Q", 8
        else:
            off = struct.unpack(order + "I", data[4:8])[0]
            n = struct.unpack(order + "H", data[off:off + 2])[0]
            first, size, cfmt, inline = off + 2, 12, "I", 4
    except struct.error:
        raise CorruptImage(f"{name}: the TIFF header or first IFD is outside the file") from None
    if first + n * size > len(data):
        raise CorruptImage(f"{name}: the first TIFF IFD is cut")
    entries, space = {}, (16 if big else 8) + first - off + n * size + inline
    for i in range(n):
        e = data[first + i * size:first + (i + 1) * size]
        tag, typ = struct.unpack(order + "HH", e[:4])
        count = struct.unpack(order + cfmt, e[4:4 + inline])[0]
        nbytes = _SIZES.get(typ, 0) * count
        if nbytes > inline:
            space += nbytes
        if tag in entries:
            continue
        entries[tag] = (typ, count, e[4 + inline:4 + 2 * inline])
    return order, entries, space


class _Bad(Exception):
    """A tag libtiff cannot read: the wrong type or count, a value out of
    range or outside the file."""


class _Tags:
    """Tag values as libtiff's TIFFReadDirEntry* functions give them."""

    def __init__(self, order: str, entries: dict, data: bytes, name: str):
        self.order, self.entries, self.data, self.name = order, entries, data, name

    def raw(self, tag: int, limit=None):
        """The bytes of `tag`'s first min(count, limit) values (libtiff's
        TIFFReadDirEntryArrayWithLimit): in the entry where all `count`
        values fit there, else where it points; None where they lie outside
        the file."""
        typ, count, field = self.entries[tag]
        n = _SIZES[typ] * (count if limit is None else min(count, limit))
        if _SIZES[typ] * count <= len(field):
            return field[:n]
        p = struct.unpack(self.order + ("Q" if len(field) == 8 else "I"), field)[0]
        return self.data[p:p + n] if p + n <= len(self.data) else None

    def ints(self, tag: int, limit=None):
        """The integer values of `tag` (the first `limit`), None if absent;
        _Bad if libtiff cannot read them as unsigned integers."""
        if tag not in self.entries:
            return None
        typ = self.entries[tag][0]
        raw = self.raw(tag, limit) if typ in _INT_TYPES else None
        if raw is None:
            raise _Bad(tag)
        vals = struct.unpack(self.order + _INT_TYPES[typ] * (len(raw) // _SIZES[typ]), raw)
        if any(v < 0 for v in vals):
            raise _Bad(tag)
        return list(vals)

    def one(self, tag: int, default, strict: bool, hi: int = 0xFFFF, ok=None):
        """A single-valued tag: a bad one fails the directory (`strict`:
        CorruptImage) or is ignored (the default)."""
        try:
            vals = self.ints(tag)
            if vals is None:
                return default
            if len(vals) != 1 or vals[0] > hi or (ok is not None and not ok(vals[0])):
                raise _Bad(tag)
            return vals[0]
        except _Bad:
            if strict:
                raise CorruptImage(f"{self.name}: TIFF tag {tag} unreadable") from None
            return default

    def per_sample(self, tag: int, default, spp: int):
        """BitsPerSample / SampleFormat: one value, or one a sample, all
        equal (TIFFReadDirEntryPersampleShort); anything else fails."""
        try:
            vals = self.ints(tag)
        except _Bad:
            raise CorruptImage(f"{self.name}: TIFF tag {tag} unreadable") from None
        if vals is None:
            return default
        if vals and vals[0] <= 0xFFFF and (len(vals) == 1 or (
                len(vals) >= spp and len(set(vals[:spp])) == 1)):
            return vals[0]
        raise CorruptImage(f"{self.name}: TIFF tag {tag} of {len(vals)} values")


def _inflate(raw: bytes, size: int):
    """libtiff's ZIPDecode: (bytes, ok), the output cut at `size` and what
    inflated before an error kept."""
    d = zlib.decompressobj()
    out, step = [], 4096
    got = 0
    for i in range(0, max(len(raw), 1), step):
        chunk = raw[i:i + step]
        probe = d.copy()
        try:
            part = d.decompress(chunk, size - got)
        except zlib.error:
            for b in range(len(chunk)):                   # what inflated before the error
                try:
                    part = probe.decompress(chunk[b:b + 1], size - got)
                except zlib.error:
                    break
                out.append(part)
                got += len(part)
            return b"".join(out), False
        out.append(part)
        got += len(part)
        if got >= size:
            return b"".join(out)[:size], True
        if d.eof:
            break
    return b"".join(out), False


class _Layout:
    """The first IFD as libtiff's TIFFReadDirectory and cv2's readHeader
    take it: a bad size, tile, PlanarConfig, RowsPerStrip, SamplesPerPixel,
    ExtraSamples, BitsPerSample or SampleFormat fails the directory; a bad
    Photometric, Predictor, FillOrder, Orientation or ColorMap is ignored (a
    missing Photometric fails cv2); strip offsets and byte counts are read
    up to the strip count, and missing or unreadable byte counts estimated
    as libtiff estimates them."""

    def __init__(self, data: bytes, name: str):
        self.order, entries, space = _ifd(data, name)
        self.name = name
        t = _Tags(self.order, entries, data, name)
        # none means uncompressed, a value a sample is read as one (libtiff's
        # TIFFReadDirEntryPersampleShort, before SamplesPerPixel is known); an
        # unknown one leaves no codec (decoding fails); one libtiff lacks
        # fails the directory
        self.compression = t.per_sample(_COMPRESSION, 1, 1)
        if self.compression in _NOT_CONFIGURED:
            raise CorruptImage(f"{name}: TIFF compression {self.compression}, which cv2's "
                               "libtiff is built without")
        self.w = t.one(_WIDTH, None, True, 2**32 - 1)
        self.h = t.one(_LENGTH, None, True, 2**32 - 1)
        if self.w is None or self.h is None:
            raise CorruptImage(f"{name}: the TIFF IFD lacks ImageWidth or ImageLength")
        self.spp = t.one(_SPP, 1, True, ok=lambda v: v > 0)
        self.planar = t.one(_PLANAR, 1, True, ok=lambda v: v in (1, 2))
        self.bps = t.per_sample(_BPS, 1, self.spp)
        self.sf = t.per_sample(_SAMPLEFORMAT, 1, self.spp)
        if not 1 <= self.sf <= 6:
            raise CorruptImage(f"{name}: TIFF sample format {self.sf}")
        try:
            self.extra = t.ints(_EXTRASAMPLES) or []
        except _Bad:
            raise CorruptImage(f"{name}: TIFF ExtraSamples unreadable") from None
        if len(self.extra) > self.spp or any(v > 2 for v in self.extra):
            raise CorruptImage(f"{name}: TIFF ExtraSamples {self.extra}")
        self.photometric = t.one(_PHOTOMETRIC, None, False)
        if self.photometric is None:
            raise CorruptImage(f"{name}: a TIFF without a readable Photometric tag")
        self.predictor = t.one(_PREDICTOR, 1, False)
        self.fillorder = t.one(_FILLORDER, 1, False, ok=lambda v: v in (1, 2))
        self.orientation = t.one(_ORIENTATION, 1, False, ok=lambda v: 1 <= v <= 8)
        try:
            self.colormap = t.ints(_COLORMAP)
        except _Bad:
            self.colormap = None
        if self.colormap is not None and len(self.colormap) != 3 << min(self.bps, 16):
            self.colormap = None                         # "incorrect count; tag ignored"
        self.jpegtables = t.raw(_JPEGTABLES) if entries.get(_JPEGTABLES, (0,))[0] == 7 else None
        self.tiled = _TILEWIDTH in entries or _TILELENGTH in entries
        if self.tiled:
            self.cw = t.one(_TILEWIDTH, 0, True, 2**32 - 1)
            self.ch = t.one(_TILELENGTH, 0, True, 2**32 - 1)
            offs, counts = _TILEOFFSETS, _TILEBYTECOUNTS
        else:
            rps = t.one(_ROWSPERSTRIP, 2**32 - 1, True, 2**32 - 1, ok=lambda v: v > 0)
            self.cw, self.ch = self.w, (self.h if rps == 2**32 - 1 else rps)
            offs, counts = _STRIPOFFSETS, _STRIPBYTECOUNTS
        if self.w <= 0 or self.h <= 0 or self.cw <= 0 or self.ch <= 0:
            raise CorruptImage(f"{name}: a TIFF of a zero size")
        planes = self.spp if self.planar == 2 else 1
        self.across = -(-self.w // self.cw)
        self.per_plane = self.across * -(-self.h // self.ch)
        n = self.per_plane * planes
        try:
            self.offsets = t.ints(offs, n)
        except _Bad:
            raise CorruptImage(f"{name}: TIFF strip or tile offsets unreadable") from None
        if self.offsets is None or (len(self.offsets) < n and n > 1_000_000):
            raise CorruptImage(f"{name}: the TIFF IFD lacks its strip or tile offsets, or "
                               f"lists {n} of them")
        self.offsets = (self.offsets + [0] * n)[:n]      # trimmed, or padded with 0
        if entries.get(counts, (3,))[0] not in _SIZES:
            raise CorruptImage(f"{name}: TIFF byte counts of an unknown type")
        try:
            self.counts = t.ints(counts, n)
        except _Bad:                                     # ignored, then estimated
            self.counts = None
        row_bytes = (self.cw * (1 if self.planar == 2 else self.spp) * self.bps + 7) // 8
        if self.counts is None or (n == 1 and not self.tiled and self.compression == 1 and (
                self.counts[0] > len(data) - self.offsets[0]
                or self.counts[0] < row_bytes * self.h)):
            self.counts = self._estimate(len(data), space, row_bytes, n, planes)
        self.counts = (self.counts + [0] * n)[:n]

    def _estimate(self, size: int, space: int, row_bytes: int, n: int, planes: int):
        """libtiff's EstimateStripByteCounts."""
        if self.compression != 1:
            left = max(size - space, 0) // planes
            counts = [left] * n
            if self.offsets[-1] > size - left:
                counts[-1] = max(size - self.offsets[-1], 0)
            return counts
        return [row_bytes * (self.ch if self.tiled else min(self.ch, self.h))] * n

    def chunk_shape(self, index: int):
        """(rows, columns) the strip or tile `index` of a plane decodes to."""
        if self.tiled:
            return self.ch, self.cw
        row = (index // self.across) * self.ch
        return min(self.ch, self.h - row), self.w


def _decode_chunk(data: bytes, lay: _Layout, k: int, rows: int, cols: int, nsamp: int,
                  keep_partial: bool):
    """(samples (rows, cols * nsamp) in native order, ok) of strip or tile
    k, as libtiff's TIFFReadEncodedStrip / Tile gives it; None where
    libtiff fails before decoding (the data is outside the file)."""
    name, bps = lay.name, lay.bps
    row_bytes = (cols * nsamp * bps + 7) // 8
    size = rows * row_bytes
    off, cnt = lay.offsets[k], lay.counts[k] if k < len(lay.counts) else 0
    if cnt <= 0 or off + cnt > len(data):
        return None, False
    raw = data[off:off + cnt]
    if lay.fillorder == 2:
        raw = _BITREV[np.frombuffer(raw, np.uint8)].tobytes()
    comp = lay.compression
    if comp == 1:
        ok = len(raw) >= size
        buf = np.frombuffer(raw[:size], np.uint8).copy() if ok else np.zeros(size, np.uint8)
    elif comp == 5:
        buf, rc = native.tiff_lzw(raw, size)
        if rc == 2:
            raise UnsupportedImage(f"{name}: old-style (pre-TIFF 5.0) LZW")
        ok = rc == 0
    elif comp in (8, 32946):
        out, ok = _inflate(raw, size)
        buf = np.zeros(size, np.uint8)
        buf[:len(out)] = np.frombuffer(out, np.uint8)
    elif comp == 32773:
        buf, rc = native.tiff_packbits(raw, size)
        ok = rc == 0
    elif comp in _UNPORTED:
        raise UnsupportedImage(f"{name}: TIFF compression {_UNPORTED[comp]}")
    else:                                                # no codec: the decode fails
        buf, ok = np.zeros(size, np.uint8), False
    if not ok:
        if not keep_partial:
            return None, False
        return buf.reshape(rows, row_bytes), False
    if bps in (16, 32) and lay.order == ">" and lay.predictor != 3:
        buf = buf.view(f">u{bps // 8}").astype(f"<u{bps // 8}").view(np.uint8)
    if lay.predictor == 2:
        native.tiff_predict(buf, rows, row_bytes, bps // 8, nsamp, floating=False)
    elif lay.predictor == 3:
        native.tiff_predict(buf, rows, row_bytes, bps // 8, nsamp, floating=True)
    return buf.reshape(rows, row_bytes), True


def _jpeg_chunk(data: bytes, lay: _Layout, k: int, rows: int, cols: int):
    """An 8-bit JPEG strip or tile decoded as libtiff's JPEG codec does
    it: (rows, cols, channels) uint8 (RGB order), or None."""
    off, cnt = lay.offsets[k], lay.counts[k] if k < len(lay.counts) else 0
    if cnt <= 0 or off + cnt > len(data):
        return None
    raw = data[off:off + cnt]
    tables = lay.jpegtables or b""
    if tables[:2] == b"\xff\xd8" and tables[-2:] == b"\xff\xd9" and raw[:2] == b"\xff\xd8":
        raw = tables[:-2] + raw[2:]
    # libtiff sets the colour space itself: an Adobe marker makes csrc/jpeg.cpp
    # convert YCbCr (transform 1) or take RGB as stored (transform 0)
    transform = 1 if lay.photometric == 6 else 0
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([transform])
    raw = raw[:2] + adobe + raw[2:]
    try:
        img = jpeg.decode(raw, name=lay.name)
    except CorruptImage:
        return None
    if img.ndim == 3:
        img = img[:, :, ::-1]
    return img.reshape(img.shape[0], img.shape[1], -1)


def _samples(data: bytes, lay: _Layout, keep_partial: bool, skew: bool = False):
    """The whole image as (h, w, spp) samples (uint8, native uint16 or
    uint32 words of float32), or None where a strip or tile fails as cv2
    fails on it. With `skew`, a tile cut by the right edge is read as
    libtiff's putagreytile and put16bitbwtile read it: each row starts
    (tile width - visible width) bytes, not samples, past the last."""
    bps, spp = lay.bps, lay.spp
    dt = {1: np.uint8, 8: np.uint8, 4: np.uint8, 16: np.uint16, 32: np.uint32}[bps]
    img = np.zeros((lay.h, lay.w, spp), dt)
    planes = spp if lay.planar == 2 else 1
    nsamp = 1 if lay.planar == 2 else spp
    for p in range(planes):
        for i in range(lay.per_plane):
            k = p * lay.per_plane + i
            y0, x0 = (i // lay.across) * lay.ch, (i % lay.across) * lay.cw
            rows, cols = lay.chunk_shape(i)
            if lay.compression == 7:
                block = _jpeg_chunk(data, lay, k, rows, cols)
                if block is None:
                    if p == 0 or not keep_partial:
                        return None
                    continue
                if block.shape[:2] != (rows, cols) or block.shape[2] != nsamp:
                    raise UnsupportedImage(f"{lay.name}: a JPEG strip or tile of another "
                                           "size or sample count than the TIFF's")
            else:
                buf, ok = _decode_chunk(data, lay, k, rows, cols, nsamp, keep_partial)
                if buf is None:
                    if p == 0 or not keep_partial:
                        return None
                    continue
                if bps < 8:                              # one sample a pixel (RGBA refuses more)
                    block = unpack_samples(buf, cols * nsamp, 1, bps)
                else:                                    # native order (raw after an error)
                    block = buf.view(dt)
                ww = min(cols, lay.w - x0)
                if skew and lay.tiled and ww < cols:
                    pb = nsamp * bps // 8
                    flat = buf.reshape(-1)
                    stride = ww * pb + (cols - ww)
                    block = np.zeros((rows, cols * pb), np.uint8)
                    for r in range(rows):
                        block[r, :ww * pb] = flat[r * stride:r * stride + ww * pb]
                    block = block.view(dt)
                block = block.reshape(rows, cols, nsamp)
            hh, ww = min(rows, lay.h - y0), min(cols, lay.w - x0)
            if lay.planar == 2:
                img[y0:y0 + hh, x0:x0 + ww, p] = block[:hh, :ww, 0]
            else:
                img[y0:y0 + hh, x0:x0 + ww] = block[:hh, :ww]
    return img


def _rgba(img: np.ndarray, lay: _Layout) -> np.ndarray:
    """TIFFReadRGBA's (h, w, 4) RGBA of the samples."""
    ph, bps, spp = lay.photometric, lay.bps, lay.spp
    h, w = img.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    out[:, :, 3] = 255
    if ph in (0, 1) and lay.planar == 2 and spp > 1:     # read as RGB: g = b = r, no map
        v = img.astype(np.int64)
        if bps == 16:
            v = (v + 128) // 257
        out[:, :, 0] = out[:, :, 1] = out[:, :, 2] = v[:, :, 0]
        if lay.extra[:1] == [2]:
            out[:, :, :3] = (v[:, :, :1] * v[:, :, 1:2] + 127) // 255
        return out
    if ph in (0, 1):
        v = img[:, :, 0]
        if bps == 16:
            g = (v >> 8).astype(np.uint8)
            if ph == 0:
                g = 255 - g
        else:
            top = (1 << bps) - 1
            lut = (np.arange(top + 1) * 255 // top) if ph == 1 else \
                ((top - np.arange(top + 1)) * 255 // top)
            g = lut.astype(np.uint8)[v]
        out[:, :, 0] = out[:, :, 1] = out[:, :, 2] = g
        return out
    if ph == 3:
        n = 1 << bps
        cmap = np.asarray(lay.colormap, np.int64)[:3 * n].reshape(3, n)
        if cmap.max(initial=0) >= 256:
            cmap = cmap >> 8
        out[:, :, :3] = cmap.T.astype(np.uint8)[img[:, :, 0]]
        return out
    # RGB (YCbCr under JPEG comes out of libjpeg as RGB)
    v = img.astype(np.int64)
    if bps == 16:
        v = (v + 128) // 257
    out[:, :, :3] = v[:, :, :3]
    if spp > 3:
        a = v[:, :, 3]
        out[:, :, 3] = a
        if lay.extra[:1] == [2]:                         # unassociated: premultiplied
            out[:, :, :3] = (v[:, :, :3] * a[:, :, None] + 127) // 255
    return out


def _check_rgba_ok(lay: _Layout) -> bool:
    """TIFFRGBAImageOK (with what the port decodes)."""
    ph, bps, spp = lay.photometric, lay.bps, lay.spp
    if bps not in (1, 2, 4, 8, 16) or (lay.planar == 2 and spp > 1 and bps < 8):
        return False
    if ph in (0, 1):
        return not (lay.planar == 1 and spp != 1 and bps < 8)
    if ph == 3:
        return lay.colormap is not None
    if ph == 2:
        return spp - len(lay.extra) >= 3 and bps in (8, 16)
    if ph == 6 and lay.compression == 7:
        return bps == 8
    if ph in (5, 6, 8, 32844, 32845):                    # CMYK, YCbCr, CIELab, LogL, LogLuv
        raise UnsupportedImage(f"{lay.name}: TIFF photometric {ph}"
                               f"{' without JPEG' if ph == 6 else ''}")
    return False


def decode(data: bytes, name: str = "<bytes>", color: bool = False) -> np.ndarray:
    """The TIFF's first page as cv2.imread gives it (IMREAD_UNCHANGED, or
    IMREAD_COLOR with `color`); raises CorruptImage where that gives None."""
    lay = _Layout(data, name)
    bps, spp, ph, sf = lay.bps, lay.spp, lay.photometric, lay.sf
    grey = ph in (0, 1)
    # readHeader: the type cv2 reads into (None where it refuses)
    if bps == 4 and ph == 3:
        pass
    elif bps in (1, 8) and (bps == 8 or sf in (1, 2)):
        pass
    elif bps == 16 and sf == 1:
        pass
    elif bps == 32 and sf == 3:
        pass
    elif (bps in (10, 12, 14, 16) and sf == 2) or (bps in (10, 12, 14) and sf == 1) \
            or (bps == 32 and sf in (1, 2)) or (bps == 64 and sf == 3):
        raise UnsupportedImage(f"{name}: TIFF samples of {bps} bits, sample format {sf}")
    else:
        raise CorruptImage(f"{name}: TIFF samples of {bps} bits, sample format {sf}, "
                           "which cv2 refuses")
    if spp > 4 or spp < 1 or (bps == 32 and spp == 2):
        raise CorruptImage(f"{name}: a TIFF of {spp} samples a pixel at {bps} bits")
    if bps == 16 and ph == 3:
        raise UnsupportedImage(f"{name}: a 16-bit TIFF palette")
    if lay.compression == 7 and bps != 8:
        raise UnsupportedImage(f"{name}: a {bps}-bit JPEG TIFF")
    if lay.predictor not in (1, 2, 3) or (lay.predictor == 2 and bps not in (8, 16, 32)) \
            or (lay.predictor == 3 and sf != 3):
        raise CorruptImage(f"{name}: TIFF predictor {lay.predictor} at {bps} bits, format {sf}")
    if ph == 3 or bps == 4:
        channels, depth = (1 if bps == 1 else 3), 8
    elif spp == 2:
        channels, depth = 1, 8
    else:
        channels, depth = (1 if grey else spp), (bps if bps in (16, 32) else 8)
    if color:
        channels, depth = 3, 8
    check_size(lay.w, lay.h, name)
    # cv2's readData asserts: tiles or strips of at most 2^24 rows and
    # columns and under 1 GiB
    if lay.cw > 1 << 24 or lay.ch > 1 << 24 or \
            lay.cw * lay.ch * min(spp, 4) * max(1, bps // 8) >= 1 << 30:
        raise CorruptImage(f"{name}: a TIFF strip or tile of {lay.cw}x{lay.ch}, which cv2 refuses")
    if depth == 8:
        if not _check_rgba_ok(lay):
            raise CorruptImage(f"{name}: TIFFRGBAImageOK refuses {bps}-bit samples, "
                               f"photometric {ph}")
        skew = (lay.planar == 1 or spp == 1) and grey and (bps == 16 or (bps == 8 and spp == 2))
        img = _samples(data, lay, keep_partial=True, skew=skew)
        if img is None:
            raise CorruptImage(f"{name}: a TIFF strip or tile outside the file")
        rgba = _rgba(img, lay).astype(np.int32)
        if channels == 1:
            out = ((rgba[:, :, 0] * 4899 + rgba[:, :, 1] * 9617 + rgba[:, :, 2] * 1868 + 8192)
                   >> 14).astype(np.uint8)
        else:
            out = rgba[:, :, [2, 1, 0, 3][:channels]].astype(np.uint8)
    else:
        if lay.planar == 2 and spp > 1:
            raise UnsupportedImage(f"{name}: {bps}-bit TIFF samples in separate planes, "
                                   "which cv2 reads from memory it never wrote")
        if lay.compression == 7:
            raise UnsupportedImage(f"{name}: a {bps}-bit JPEG TIFF")
        img = _samples(data, lay, keep_partial=False)
        if img is None:
            raise CorruptImage(f"{name}: a TIFF strip or tile that fails to decode")
        if depth == 32:
            img = img.view(np.float32)
        out = img[:, :, 0] if channels == 1 else img[:, :, [2, 1, 0, 3][:channels]]
    o = lay.orientation
    if 5 <= o <= 8 and lay.w != lay.h:
        raise CorruptImage(f"{name}: TIFF orientation {o} of a non-square image")
    if 5 <= o <= 8:
        out = out.swapaxes(0, 1)
    for axis in {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(o, ()):
        out = np.flip(out, axis)
    return np.ascontiguousarray(out)
