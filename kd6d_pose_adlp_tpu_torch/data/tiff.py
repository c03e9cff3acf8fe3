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
    inverted; 16-bit grey over 3 or 4 samples is OpenCV's fixed-point grey
    of the first three, float grey keeps its samples. Any strip or tile
    that fails gives None.
  - The Orientation tag turns the result as EXIF orientations turn a JPEG;
    5 to 8 give None unless the image is square, as in cv2.

A file is decided in the order that libtiff 4.7 and cv2's grfmt_tiff.cpp
decide it, and fails (`native.CorruptImage`: cv2 gives None) at the first
step where they fail:
  1. TIFFReadDirectory (`_Layout`): the entry count, SamplesPerPixel and
     Compression first, then the tags that size the image and the rest in
     the file's order (a tag's first entry; unknown tags and codec tags of
     another codec ignored; a bad size, planar, strip, sample or
     ExtraSamples tag fails the directory, a bad Photometric, Orientation,
     FillOrder, Predictor or ColorMap is ignored), extra samples added for
     channels the photometric has no colour for, a palette without its
     ColorMap read as grey or RGB, strip arrays read up to the strip count
     and byte counts estimated where missing or implausible, and the JPEG
     subsampling taken from the first strip.
  2. cv2's readHeader (`_header`): the photometric, the channels (3 where
     SamplesPerPixel is missing and the photometric is not grey), bits
     read as 8 past 8 bits for a photometric above RGB, and the type; then
     the image size (`native.ImageSizeError` where cv2.imread raises) and
     readData's limits on a strip or tile.
  3. The codec's and predictor's set-up (`_codec`), and for the 8-bit
     reads TIFFRGBAImageOK and TIFFRGBAImageBegin (`_rgba_ok`).
  4. The read: a strip or tile outside the file, or whose JPEG header
     disagrees with the IFD (size, components, precision, sampling), gives
     None; one whose data fails to decode is read as described above.

`native.UnsupportedImage`, naming the file and the feature, is raised only
where every check of these steps passes and the strips or tiles lie in the
file, for what the port does not decode: CCITT, LogLuv, ThunderScan and
NeXT compressions (old-style JPEG, LZMA, ZSTD, WebP, Pixar log and the
others that cv2's libtiff is built without read as None); signed, 32-bit
integer and 64-bit samples; 16-bit or float separate planes, and 16-bit or
float samples where SamplesPerPixel is missing (cv2 reads both from memory
it never wrote); CMYK, Lab and YCbCr without JPEG; JPEG of 12 bits;
old-style LZW.
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
# LERC, Pixar log, old-style JPEG) read as None; a number libtiff does not know reads as
# uncompressed
_UNPORTED = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 32771: "CCITT RLEW", 32766: "NeXT", 32809: "ThunderScan", 34676: "SGI LogL",
             34677: "SGI LogLuv"}
_NOT_CONFIGURED = {6, 34661, 34925, 50000, 50001, 50002, 34887, 32909}
# the codecs that take a Predictor tag (libtiff's _TIFFCheckFieldIsValidForCodec)
_PREDICTED = (5, 8, 32946)
_BITREV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
# TIFFTAG numbers
(_WIDTH, _LENGTH, _BPS, _COMPRESSION, _PHOTOMETRIC, _FILLORDER, _STRIPOFFSETS, _ORIENTATION,
 _SPP, _ROWSPERSTRIP, _STRIPBYTECOUNTS, _MINSAMPLE, _MAXSAMPLE, _PLANAR, _PREDICTOR, _COLORMAP,
 _TILEWIDTH, _TILELENGTH, _TILEOFFSETS, _TILEBYTECOUNTS, _INKSET, _EXTRASAMPLES, _SAMPLEFORMAT,
 _SMIN, _SMAX, _JPEGTABLES, _YCBCRSUBSAMPLING) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 280, 281, 284, 317, 320, 322, 323, 324,
    325, 332, 338, 339, 340, 341, 347, 530)
# the colours of a photometric (libtiff's _TIFFGetMaxColorChannels)
_COLOURS = {0: 1, 1: 1, 3: 1, 2: 3, 6: 3, 8: 3, 9: 3, 10: 3, 32845: 3, 4: 4, 5: 4}


def is_tiff(data: bytes) -> bool:
    return data[:4] in SIGNATURES


def _ifd(data: bytes, name: str):
    """(byte order, {tag: (type, count, value field)} of the first IFD's
    entries in the file's order (a tag's first: libtiff ignores the others),
    the IFD's size in bytes with its out-of-line values, or None where an
    entry has a type of no known size); CorruptImage where libtiff's
    TIFFFetchDirectory fails."""
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
    if not 0 < n <= 4096:
        raise CorruptImage(f"{name}: a TIFF IFD of {n} entries")
    if first + n * size > len(data):
        raise CorruptImage(f"{name}: the first TIFF IFD is cut")
    entries, space = {}, (16 if big else 8) + first - off + n * size + inline
    for i in range(n):
        e = data[first + i * size:first + (i + 1) * size]
        tag, typ = struct.unpack(order + "HH", e[:4])
        count = struct.unpack(order + cfmt, e[4:4 + inline])[0]
        if space is not None:
            space = None if typ not in _SIZES else space + (
                _SIZES[typ] * count if _SIZES[typ] * count > inline else 0)
        if tag not in entries:
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

    def ints(self, tag: int, limit=None, hi=None):
        """The integer values of `tag` (the first `limit`); _Bad if libtiff
        cannot read them as unsigned integers of at most `hi`."""
        typ = self.entries[tag][0]
        raw = self.raw(tag, limit) if typ in _INT_TYPES else None
        if raw is None:
            raise _Bad(tag)
        vals = struct.unpack(self.order + _INT_TYPES[typ] * (len(raw) // _SIZES[typ]), raw)
        if any(v < 0 or (hi is not None and v > hi) for v in vals):
            raise _Bad(tag)
        return list(vals)

    def one(self, tag: int, hi: int = 0xFFFF) -> int:
        """TIFFReadDirEntryShort (`hi` 0xFFFF) or Long: one value."""
        if self.entries[tag][1] != 1:
            raise _Bad(tag)
        return self.ints(tag, hi=hi)[0]

    def per_sample(self, tag: int, spp: int) -> int:
        """TIFFReadDirEntryPersampleShort after TIFFReadDirEntryShort: one
        value, or at least `spp` values whose first `spp` are equal."""
        count = self.entries[tag][1]
        if count == 1:
            return self.one(tag)
        vals = self.ints(tag, hi=0xFFFF) if count >= spp else []
        if not vals or len(set(vals[:spp])) != 1:
            raise _Bad(tag)
        return vals[0]

    def bytes(self, tag: int) -> bytes:
        """TIFFReadDirEntryByteArray."""
        if self.entries[tag][0] in (1, 2, 7):
            raw = self.raw(tag)
            if raw is None:
                raise _Bad(tag)
            return raw
        return bytes(self.ints(tag, hi=0xFF))

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


def _howmany(x: int, y: int) -> int:
    """libtiff's TIFFhowmany_32: 0 where x + y - 1 overflows."""
    return (x + y - 1) // y if x < 0xFFFFFFFF - (y - 1) else 0


class _Layout:
    """The first IFD as libtiff's TIFFReadDirectory takes it, step by step
    in its order; CorruptImage where it fails."""

    def __init__(self, data: bytes, name: str):
        self.order, entries, space = _ifd(data, name)
        self.name = name
        t = _Tags(self.order, entries, data, name)

        def strict(read, tag, *args, **kw):
            try:
                return read(tag, *args, **kw)
            except _Bad:
                raise CorruptImage(f"{name}: TIFF tag {tag} unreadable") from None

        def lenient(tag, default, ok=lambda v: True):
            if tag not in entries:
                return default
            try:
                v = t.one(tag)
            except _Bad:
                return default
            return v if ok(v) else default

        # SamplesPerPixel, then Compression (one value, or one a sample)
        self.spp_tag = _SPP in entries
        self.spp = strict(t.one, _SPP) if self.spp_tag else 1
        if self.spp == 0:
            raise CorruptImage(f"{name}: a TIFF of 0 samples a pixel")
        self.compression = strict(t.per_sample, _COMPRESSION, self.spp) \
            if _COMPRESSION in entries else 1
        # the first pass, in the file's order: the tags that size the image
        w = h = None
        self.planar, self.extra, rps, tiled = 1, [], None, False
        tile = [0, 0]                                    # TileWidth, TileLength
        for tag in entries:
            if tag in (_WIDTH, _LENGTH, _TILEWIDTH, _TILELENGTH, _ROWSPERSTRIP):
                v = strict(t.one, tag, hi=0xFFFFFFFF)
                if tag == _WIDTH:
                    w = v
                elif tag == _LENGTH:
                    h = v
                elif tag == _ROWSPERSTRIP:
                    if v == 0:
                        raise CorruptImage(f"{name}: TIFF RowsPerStrip 0")
                    rps = v
                    if not tiled:                        # sets the tile size too
                        tile = [w or 0, v]
                else:
                    tile[tag - _TILEWIDTH], tiled = v, True
            elif tag == _PLANAR:
                self.planar = strict(t.one, tag)
                if self.planar not in (1, 2):
                    raise CorruptImage(f"{name}: TIFF PlanarConfig {self.planar}")
            elif tag == _EXTRASAMPLES:
                vals = strict(t.ints, tag, hi=0xFFFF)
                vals = [2 if v == 999 else v for v in vals]      # Corel's unassociated alpha
                if len(vals) > self.spp or any(v > 2 for v in vals):
                    raise CorruptImage(f"{name}: TIFF ExtraSamples {vals}")
                self.extra = vals
        if w is None and h is None:
            raise CorruptImage(f"{name}: the TIFF IFD lacks ImageWidth and ImageLength")
        self.w, self.h, self.tiled = w or 0, h or 0, tiled
        planes = self.spp if self.planar == 2 else 1
        if tiled:
            self.cw, self.ch = tile
            dx = self.w if self.cw == 0xFFFFFFFF else self.cw
            dy = self.h if self.ch == 0xFFFFFFFF else self.ch
            self.across = _howmany(self.w, dx) if dx else 0
            self.per_plane = self.across * _howmany(self.h, dy) if dy else 0
        else:
            self.cw, self.across = self.w, 1
            self.ch = self.h if rps is None or rps == 0xFFFFFFFF else rps
            self.per_plane = 1 if rps is None or rps == 0xFFFFFFFF else _howmany(self.h, rps)
        n = self.per_plane * planes
        if not 0 < n <= 0x7FFFFFFF:
            raise CorruptImage(f"{name}: a TIFF of {n} strips or tiles")
        if _STRIPOFFSETS not in entries and _TILEOFFSETS not in entries:
            raise CorruptImage(f"{name}: the TIFF IFD lacks its strip or tile offsets")
        # the second pass, in the file's order: the rest
        self.bps, self.sf, self.colormap, bps_read = 1, 1, None, False
        arrays = {}
        for tag in entries:
            if tag in (_BPS, _SAMPLEFORMAT, _MINSAMPLE, _MAXSAMPLE):
                v = strict(t.per_sample, tag, self.spp)
                if tag == _BPS:
                    self.bps, bps_read = v, True
                elif tag == _SAMPLEFORMAT:
                    if not 1 <= v <= 6:
                        raise CorruptImage(f"{name}: TIFF sample format {v}")
                    self.sf = v
            elif tag in (_SMIN, _SMAX):
                typ, count, _ = entries[tag]
                if count != self.spp or typ not in (1, 3, 4, 5, 6, 8, 9, 10, 11, 12, 16, 17) \
                        or t.raw(tag) is None:
                    raise CorruptImage(f"{name}: TIFF tag {tag} unreadable")
            elif tag in (_STRIPOFFSETS, _TILEOFFSETS, _STRIPBYTECOUNTS, _TILEBYTECOUNTS):
                # the strile arrays, read up to the strip count, padded with 0
                vals = strict(t.ints, tag, n)
                if len(vals) < n and n > 1_000_000:
                    raise CorruptImage(f"{name}: a TIFF strip array of {len(vals)} of {n} values")
                arrays[tag in (_STRIPOFFSETS, _TILEOFFSETS)] = (vals + [0] * n)[:n]
            elif tag == _COLORMAP:
                # ignored before BitsPerSample, past 24 bits or of another count
                if bps_read and self.bps <= 24 and entries[tag][1] == 3 << self.bps:
                    try:
                        self.colormap = t.ints(tag, hi=0xFFFF)
                    except _Bad:
                        pass
        self.offsets, counts = arrays[True], arrays.get(False)
        self.photometric = lenient(_PHOTOMETRIC, None)
        self.orientation = lenient(_ORIENTATION, 1, lambda v: 1 <= v <= 8)
        self.fillorder = lenient(_FILLORDER, 1, lambda v: v in (1, 2))
        self.inkset = lenient(_INKSET, 1)
        self.predictor = lenient(_PREDICTOR, 1) if self.compression in _PREDICTED else 1
        self.jpegtables = None
        if self.compression == 7 and _JPEGTABLES in entries:
            try:
                self.jpegtables = t.bytes(_JPEGTABLES) or None
            except _Bad:
                pass
        self.ycbcr = None
        if entries.get(_YCBCRSUBSAMPLING, (0, 0))[1] == 2:
            try:
                self.ycbcr = tuple(t.ints(_YCBCRSUBSAMPLING, hi=0xFFFF))
            except _Bad:
                pass
        ph = self.photometric
        # channels the photometric has no colour for are extra samples
        colours = _COLOURS.get(0 if ph is None else ph, 0)
        if colours and self.spp - len(self.extra) > colours:
            self.extra = self.extra + [0] * (self.spp - colours - len(self.extra))
        if ph == 3 and self.colormap is None:           # a palette without its ColorMap
            if self.bps < 8:
                raise CorruptImage(f"{name}: a TIFF palette without a ColorMap")
            self.photometric = 2 if self.spp == 3 else 1
        # byte counts: estimated where missing or implausible
        row_bytes = ((self.cw if tiled else self.w) * (1 if self.planar == 2 else self.spp)
                     * self.bps + 7) // 8
        estimate = counts is None
        if counts is None:
            if (self.planar == 1 and n > 1) or (self.planar == 2 and n != self.spp):
                raise CorruptImage(f"{name}: the TIFF IFD lacks its strip or tile byte counts")
        elif n == 1 and not tiled:
            off, size = self.offsets[0], len(data)
            estimate = (counts[0] == 0 and off != 0) or (self.compression == 1 and (
                (off <= size and counts[0] > size - off) or counts[0] < row_bytes * self.h))
        elif self.planar == 1 and n > 2 and self.compression == 1 and counts[0] != counts[1] \
                and counts[0] and counts[1]:
            estimate = True
        if estimate:
            if self.compression != 1 and space is None:
                raise CorruptImage(f"{name}: a TIFF IFD entry of an unknown type")
            counts = self._estimate(len(data), space, row_bytes, n, planes)
        self.counts = counts
        if self.compression == 7 and ph == 6 and self.planar == 1 and self.spp == 3 \
                and self.ycbcr is None:
            sof = _jpeg_sof(data[self.offsets[0]:self.offsets[0] + self.counts[0]])
            if sof is not None and len(sof[3]) == 3 and sof[3][0][0] in (1, 2, 4) and \
                    sof[3][0][1] in (1, 2, 4) and all(c == (1, 1) for c in sof[3][1:]):
                self.ycbcr = sof[3][0]
        # a zero scanline, tile or strip size fails the directory
        sub = self.ycbcr or (2, 2)
        if self.w == 0 or self.h == 0 or self.bps == 0 or (
                self.photometric == 6 and self.planar == 1 and self.spp == 3
                and not (sub[0] in (1, 2, 4) and sub[1] in (1, 2, 4))):
            raise CorruptImage(f"{name}: a TIFF of a zero scanline, strip or tile size")

    def _estimate(self, size: int, space: int, row_bytes: int, n: int, planes: int):
        """libtiff's EstimateStripByteCounts."""
        if self.compression != 1:
            left = (size if size < space else size - space) // planes
            counts = [left] * n
            if self.offsets[-1] + left > size:
                counts[-1] = max(size - self.offsets[-1], 0)
            return counts
        if self.tiled:
            return [row_bytes * self.ch] * n
        return [row_bytes * (self.h // self.per_plane)] * n

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


def _jpeg_sof(raw: bytes):
    """(precision, height, width, [(h, v) sampling a component]) of the
    first frame header of a JPEG stream, or None where none comes before a
    scan or the stream's end."""
    if raw[:2] != b"\xff\xd8":
        return None
    pos = 2
    while pos + 4 <= len(raw):
        if raw[pos] != 0xFF:
            pos += 1
            continue
        marker = raw[pos + 1]
        if marker in (0xFF, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2 - (marker == 0xFF)
            continue
        if marker in (0xD9, 0xDA):
            return None
        n = struct.unpack(">H", raw[pos + 2:pos + 4])[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            body = raw[pos + 4:pos + 2 + n]
            if len(body) < 6 or len(body) < 6 + 3 * body[5]:
                return None
            p, h, w, nc = struct.unpack(">BHHB", body[:6])
            return p, h, w, [(body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15) for i in range(nc)]
        pos += 2 + n
    return None


def _jpeg_tables(tables: bytes):
    """The marker segments of a JPEGTables stream as libjpeg's tables-only
    header read takes them (JPEGSetupDecode): bytes between segments
    skipped, a segment cut by the stream's end filled with the fake EOI
    bytes libjpeg reads there; None where it is no tables-only stream (no
    SOI, or a frame or scan header)."""
    if tables[:2] != b"\xff\xd8":
        return None
    out, pos = [], 2
    while pos + 1 < len(tables):
        if tables[pos] != 0xFF or tables[pos + 1] == 0xFF:
            pos += 1
            continue
        marker = tables[pos + 1]
        if marker == 0xD9:
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xCC) or marker == 0xDA:
            return None
        n = struct.unpack(">H", (tables[pos + 2:pos + 4] + b"\xff\xd9")[:2])[0]
        seg = tables[pos:pos + 2 + n]
        out.append(seg + (b"\xff\xd9" * n)[:2 + n - len(seg)])
        pos += 2 + n
    return b"".join(out)


def _jpeg_chunk(data: bytes, lay: _Layout, k: int, rows: int, cols: int, nsamp: int, y0: int):
    """A JPEG strip or tile decoded as libtiff's JPEG codec does it:
    (rows, cols, nsamp) uint8 (RGB order), or None where JPEGPreDecode
    fails: the stream's frame is wider or taller than the strip (a last
    strip may be taller), or its components, precision or sampling differ
    from the IFD's. A smaller frame fills the top left and leaves zeros."""
    off, cnt = lay.offsets[k], lay.counts[k] if k < len(lay.counts) else 0
    if cnt <= 0 or off + cnt > len(data):
        return None
    raw = data[off:off + cnt]
    sof = _jpeg_sof(raw)
    if sof is None:
        return None
    prec, fh, fw, comps = sof
    seg_w, seg_h = (lay.cw, lay.ch) if lay.tiled else (lay.w, min(lay.h - y0, lay.ch))
    if (fw > seg_w or fh > seg_h) and not (
            fw == seg_w and fh > seg_h and y0 + seg_h == lay.h and not lay.tiled):
        return None
    sampling = (lay.ycbcr or (2, 2)) if lay.photometric == 6 and lay.planar == 1 else (1, 1)
    if len(comps) != nsamp or prec != lay.bps or comps[0] != sampling or any(
            c != (1, 1) for c in comps[1:]):
        return None
    if lay.jpegtables is not None:
        tables = _jpeg_tables(lay.jpegtables)
        if tables is None:
            return None
        raw = b"\xff\xd8" + tables + raw[2:]
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
    img = img.reshape(img.shape[0], img.shape[1], -1)
    block = np.zeros((rows, cols, nsamp), np.uint8)
    n, m = min(rows, img.shape[0]), min(cols, img.shape[1])
    block[:n, :m] = img[:n, :m]
    return block


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
                block = _jpeg_chunk(data, lay, k, rows, cols, nsamp, y0)
                if block is None:
                    if p == 0 or not keep_partial:
                        return None
                    continue
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


def _rgba_ok(lay: _Layout):
    """TIFFRGBAImageOK, then TIFFRGBAImageBegin's choice of a routine:
    False where libtiff refuses the file, the name of the feature where it
    reads one the port does not, else True."""
    ph, bps, spp, comp = lay.photometric, lay.bps, lay.spp, lay.compression
    if bps not in (1, 2, 4, 8, 16) or lay.sf == 3:
        return False
    colours = spp - len(lay.extra)
    contig = lay.planar == 1 or spp == 1
    if ph in (0, 1, 3) and lay.planar == 1 and spp != 1 and bps < 8:
        return False
    if (ph == 2 and colours < 3) or (ph == 5 and (lay.inkset != 1 or spp < 4)) or (
            ph == 8 and (spp != 3 or colours != 3 or bps not in (8, 16))) or (
            ph == 32844 and comp != 34676) or (ph == 32845 and (
                comp not in (34676, 34677) or lay.planar != 1 or spp != 3 or colours != 3)):
        return False
    if ph in (32844, 32845):
        return "SGI Log"
    if ph == 6 and comp == 7 and contig:                 # libjpeg gives RGB
        ph = 2
    if ph in (0, 1):
        return True
    if ph == 2:
        return bps in (8, 16)
    if not contig:
        if ph == 5 and bps == 8 and spp == 4:
            return "CMYK"
        if ph == 6 and bps == 8 and spp == 3 and (lay.ycbcr or (2, 2)) == (1, 1):
            return "YCbCr without JPEG"
        return False
    if ph == 3:
        return bps != 16
    if ph == 5:
        return "CMYK" if bps == 8 else False
    if ph == 6:
        hs, vs = lay.ycbcr or (2, 2)
        ok = bps == 8 and spp == 3 and (hs, vs) in (
            (4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))
        return "YCbCr without JPEG" if ok else False
    if ph == 8:
        return "CIELab"
    return False


def _codec(lay: _Layout):
    """The codec's and the predictor's set-up (TIFFStartStrip's
    setupdecode): False where libtiff fails it, the name of the codec where
    cv2's libtiff decodes one the port does not, else True."""
    comp, bps, sf, pred = lay.compression, lay.bps, lay.sf, lay.predictor
    if comp in _NOT_CONFIGURED:
        return False
    if comp in (2, 3, 4, 32771):                         # Fax3SetupState
        ok = bps == 1 and (lay.spp == 1 or lay.planar == 2)
    elif comp in (32766, 32809):                         # NeXT 2 bits, ThunderScan 4
        ok = bps == (2 if comp == 32766 else 4)
    elif comp in (34676, 34677):                         # LogLuvSetupDecode
        ok = lay.photometric in (32844, 32845)
    else:                                                # cv2 sets LogLuv's float format
        ok = lay.photometric != 32845
    if not ok:
        return False
    if comp in _UNPORTED:
        return f"compression {_UNPORTED[comp]}"
    if pred == 1 or (pred == 2 and bps in (8, 16, 32, 64)) or (
            pred == 3 and sf == 3 and bps in (16, 24, 32, 64)):
        return True
    return False                                         # PredictorSetup


def _readable(data: bytes, lay: _Layout, keep_partial: bool) -> bool:
    """Whether cv2 reads every strip or tile of the first plane, for a file
    the port reads no further: each lies in the file (TIFFFillStrip), and
    its JPEG header agrees with the IFD, or (not `keep_partial`) its data
    decodes; a codec the port lacks is judged by the first alone."""
    nsamp = 1 if lay.planar == 2 else lay.spp
    for i in range(lay.per_plane):
        rows, cols = lay.chunk_shape(i)
        if lay.compression in _UNPORTED:
            o, c = lay.offsets[i], lay.counts[i]
            ok = 0 < c and o + c <= len(data)
        elif lay.compression == 7:
            ok = _jpeg_chunk(data, lay, i, rows, cols, nsamp, (i // lay.across) * lay.ch) \
                is not None
        else:
            buf, ok = _decode_chunk(data, lay, i, rows, cols, nsamp, keep_partial)
            ok = buf is not None and (ok or keep_partial)
        if not ok:
            return False
    return True


def _header(lay: _Layout, color: bool):
    """cv2's readHeader: (channels, depth) of the image it reads into, the
    samples a pixel it takes (`ncn`), and the feature the port leaves out
    where cv2 reads one (else None); CorruptImage where it refuses the
    file."""
    name, ph, sf = lay.name, lay.photometric, lay.sf
    if ph is None:
        raise CorruptImage(f"{name}: a TIFF without a readable Photometric tag")
    grey = ph in (0, 1)
    ncn = lay.spp if lay.spp_tag else (1 if grey else 3)
    bps = lay.bps
    if ph == 32845:                                      # LogLuv: float RGB
        return (3, 8) if color else (3, 32), ncn, "SGI LogLuv"
    if bps > 8 and (ph > 2 or ncn not in (1, 3, 4)):
        bps = 8
    unported = None
    if bps == 4 and ph == 3:
        pass
    elif bps in (1, 8) and (bps == 8 or sf in (1, 2)):
        pass
    elif (bps == 16 and sf == 1) or (bps == 32 and sf == 3):
        pass
    elif (bps in (10, 12, 14, 16) and sf == 2) or (bps in (10, 12, 14) and sf == 1) \
            or (bps == 32 and sf in (1, 2)) or (bps == 64 and sf == 3):
        unported = f"samples of {bps} bits, sample format {sf}"
    else:
        raise CorruptImage(f"{name}: TIFF samples of {bps} bits, sample format {sf}, "
                           "which cv2 refuses")
    if color:
        kind = 3, 8
    elif ph == 3 or bps == 4:
        kind = 1 if bps == 1 else 3, 8
    elif bps <= 8:
        kind = 1 if grey or ncn == 2 else ncn, 8
    else:
        kind = 1 if grey and bps == 16 else ncn, bps
    return kind, ncn, unported


def decode(data: bytes, name: str = "<bytes>", color: bool = False) -> np.ndarray:
    """The TIFF's first page as cv2.imread gives it (IMREAD_UNCHANGED, or
    IMREAD_COLOR with `color`); raises CorruptImage where that gives None."""
    lay = _Layout(data, name)                            # 1. TIFFReadDirectory
    (channels, depth), ncn, unported = _header(lay, color)     # 2. readHeader, readData
    check_size(lay.w, lay.h, name)
    tw, th = lay.cw or lay.w, lay.ch or lay.h
    # readData's buffer: RGBA for the 8-bit reads, else the samples as stored
    if not (0 < tw <= 1 << 24 and 0 < th <= 1 << 24) or ncn > 4 or lay.bps > 64 or \
            tw * th * (4 if depth == 8 else ncn * max(1, lay.bps // 8)) >= 1 << 30:
        raise CorruptImage(f"{name}: a TIFF strip or tile of {tw}x{th}, {ncn} samples, "
                           "which cv2 refuses")
    steps = [_rgba_ok(lay)] if depth == 8 else []        # 3. TIFFRGBAImageOK, set-up
    steps.append(_codec(lay))
    if False in steps:
        raise CorruptImage(f"{name}: libtiff refuses TIFF photometric {lay.photometric}, "
                           f"{lay.bps}-bit samples, compression {lay.compression}, "
                           f"predictor {lay.predictor}")
    if depth > 8 and lay.planar == 2 and lay.spp > 1:
        unported = unported or f"{lay.bps}-bit samples in separate planes, which cv2 reads " \
                               "from memory it never wrote"
    if depth > 8 and ncn != lay.spp:
        unported = unported or f"{lay.bps}-bit samples without SamplesPerPixel, which cv2 " \
                               "reads from memory it never wrote"
    unported = unported or next((s for s in steps if isinstance(s, str)), None)
    if unported is not None:                             # 4. the read, as far as it goes
        if not _readable(data, lay, keep_partial=depth == 8):
            raise CorruptImage(f"{name}: a TIFF strip or tile that cv2 fails to read")
        raise UnsupportedImage(f"{name}: TIFF {unported}")
    ph, bps, spp = lay.photometric, lay.bps, lay.spp
    if depth == 8:
        # libtiff's grey and palette routines skip a clipped tile's row by
        # bytes, not samples
        skew = (lay.planar == 1 or spp == 1) and ph in (0, 1, 3) and bps in (8, 16)
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
        img = _samples(data, lay, keep_partial=False)
        if img is None:
            raise CorruptImage(f"{name}: a TIFF strip or tile that fails to decode")
        if channels == 1 and spp > 1:                    # OpenCV's fixed-point grey of RGB
            v = img[:, :, :3].astype(np.int64)
            out = ((v[:, :, 0] * 4899 + v[:, :, 1] * 9617 + v[:, :, 2] * 1868 + 8192)
                   >> 14).astype(img.dtype)
        else:
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
