"""PyTorch port, TIFF (`data/tiff.py` over `csrc/rasters.cpp`), the raster
format `cv2.imread` reads beyond PNG and JPEG that the port decodes, against
the cv2 the tests run with (OpenCV 5, libtiff 4.7) on files written in the
test: by cv2, by PIL (compressions, palette, bilevel) and by hand with
`struct` where neither writes them (tiles, separate planes, predictor 3,
BigTIFF, odd bit depths and alpha, palettes, orientations, fill order). Then
cut and bit-flipped copies, the OpenEXR signature (None: that cv2 has no
OpenEXR), what raises (the formats the port does not decode and the TIFF
features left out), and `bop.read_image`, `BackgroundBank`,
`BOPPoseDataset.sample` (slow and fast) and one `PrefetchLoader` batch
against the JAX package's on a tree of TIFF frames and TIFF backgrounds
under .jpg and .png names.

Tolerances: every decode is bit-equal to cv2's under IMREAD_UNCHANGED
(`imread.read`) and IMREAD_COLOR (`imread.read_color`), dtype and shape
included, None where cv2 gives None, and `native.ImageSizeError` where
cv2.imread raises; `read_image` and the background bank are bit-equal to
JAX's; samples have equal images and masks and the poses of
tests/test_torch_port_bop.py (R atol 1e-6, T rtol 1e-6, bbox_trans atol
1e-4). The damaged copies are held to cv2 the same way: bit flips in the
strips and tiles, seeded bit flips in the first IFD's count and entries,
whole-file mutations (cuts, flips, inserted and deleted bytes), and one
case of each kind of IFD damage the flips met, where `UnsupportedImage` is
allowed only where cv2 gives an image and the message names a feature the
port leaves out (`UNPORTED`); and a tree whose frame and background have a
damaged IFD, against the JAX package, which redraws where cv2 gives None.
"""
import dataclasses
import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from kd6d_pose_adlp_tpu import config as jcfg  # noqa: E402
from kd6d_pose_adlp_tpu.data import bop as jbop  # noqa: E402
from kd6d_pose_adlp_tpu.data import pipeline as jpipe  # noqa: E402
from kd6d_pose_adlp_tpu.data import transforms as JT  # noqa: E402
from kd6d_pose_adlp_tpu_torch import config as tcfg  # noqa: E402
from kd6d_pose_adlp_tpu_torch import make_bop_dataset  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import bop as tbop  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import imread, native, tiff  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import pipeline as tpipe  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import transforms as TT  # noqa: E402
from test_torch_port_jpeg import digest  # noqa: E402
from test_torch_port_pool import one_torch_thread  # noqa: E402,F401 (autouse fixture)

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_port_fixtures_rasters")
FIXTURE_BUDGET = 1536 * 1024
H, W = 37, 53


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def _pil(img, fmt, mode=None, **kw) -> bytes:
    from PIL import Image

    bio = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img, mode)).save(bio, fmt, **kw)
    return bio.getvalue()


def _cv2(ext, img, params=()) -> bytes:
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok
    return buf.tobytes()


def packbits(b: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(b):
        j = i
        while j + 1 < len(b) and b[j + 1] == b[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), b[i]])
            i = j + 1
            continue
        j = i
        while j < len(b) and j - i < 128 and not (j + 1 < len(b) and b[j + 1] == b[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + b[i:j]
        i = j
    return bytes(out)


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW as libtiff's encoder writes it (9 to 12 bits, MSB first,
    the width grown one code after the decoder's early change)."""
    out, acc, bits, nbits = bytearray(), 0, 0, 9

    def put(code):
        nonlocal acc, bits
        acc, bits = (acc << nbits) | code, bits + nbits
        while bits >= 8:
            bits -= 8
            out.append((acc >> bits) & 255)

    def grow(nxt):
        nonlocal nbits
        nbits = {512: 10, 1024: 11, 2048: 12}.get(nxt, nbits)

    table, nxt, w = {bytes([i]): i for i in range(256)}, 258, b""
    put(256)
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc], nxt = nxt, nxt + 1
        grow(nxt)
        if nxt == 4094:
            put(256)
            table, nxt, nbits = {bytes([i]): i for i in range(256)}, 258, 9
        w = bytes([c])
    if w:
        put(table[w])
        grow(nxt + 1)
    put(257)
    if bits:
        out.append((acc << (8 - bits)) & 255)
    return bytes(out)


_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 16: "Q"}


def tiff_bytes(img, *, order="<", big=False, photometric=None, comp=1, pred=1, rps=None,
               tile=None, planar=1, extra=None, bits=None, sample_format=None, colormap=None,
               orientation=None, fillorder=None, extra_tags=()) -> bytes:
    """A one-IFD TIFF of the (h, w) or (h, w, spp) samples `img` (the IFD
    after the data, as libtiff writes it)."""
    img = np.asarray(img)
    img = img[:, :, None] if img.ndim == 2 else img
    h, w, spp = img.shape
    bits = bits or img.dtype.itemsize * 8
    photometric = (2 if spp >= 3 else 1) if photometric is None else photometric
    words = {1: np.uint8, 2: np.uint16, 4: np.uint32}.get(img.dtype.itemsize)

    def encode(block):
        if bits < 8:
            rows = [np.packbits(((r.reshape(-1)[:, None] >> np.arange(bits - 1, -1, -1)) & 1)
                                .reshape(-1).astype(np.uint8)).tobytes() for r in block]
            raw = b"".join(rows)
        elif pred == 3:                          # byte planes, most significant first
            raw = b""
            for r in block:
                planes = np.frombuffer(r.astype(">f4").tobytes(), np.uint8).reshape(-1, 4).T
                p = planes.reshape(-1).copy()
                p[block.shape[2]:] = p[block.shape[2]:] - planes.reshape(-1)[:-block.shape[2]]
                raw += p.tobytes()
        else:
            b = block.view(words)
            if pred == 2:
                b = b.copy()
                b[:, 1:] = block.view(words)[:, 1:] - block.view(words)[:, :-1]
            raw = np.ascontiguousarray(b).astype(np.dtype(words).newbyteorder(order)).tobytes()
        if fillorder == 2:
            raw = bytes(int(f"{x:08b}"[::-1], 2) for x in raw)
        return {1: lambda r: r, 5: tiff_lzw, 8: zlib.compress, 32946: zlib.compress,
                32773: packbits}[comp](raw)

    chunks = []
    for p in (range(spp) if planar == 2 else [None]):
        sel = slice(p, p + 1) if p is not None else slice(None)
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw, 1 if p is not None else spp), img.dtype)
                    src = img[ty:ty + th, tx:tx + tw, sel]
                    blk[:src.shape[0], :src.shape[1]] = src
                    chunks.append(encode(blk))
        else:
            for y in range(0, h, rps or h):
                chunks.append(encode(img[y:y + (rps or h), :, sel]))
    off_type = 16 if big else 4
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [comp]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if pred != 1:
        tags[317] = (3, [pred])
    if sample_format or img.dtype.kind == "f":
        tags[339] = (3, [sample_format or 3] * spp)
    for tag, val in ((338, extra), (320, colormap), (274, orientation), (266, fillorder)):
        if val is not None:
            tags[tag] = (3, list(val) if tag in (338, 320) else [val])
    tags.update(dict(extra_tags))
    data, offs, pos = bytearray(), [], 16 if big else 8
    for c in chunks:
        offs.append(pos)
        data += c + b"\0" * (len(c) % 2)
        pos += len(c) + len(c) % 2
    counts = [len(c) for c in chunks]
    if tile:
        tags.update({322: (3, [tile[0]]), 323: (3, [tile[1]]), 324: (off_type, offs),
                     325: (off_type, counts)})
    else:
        tags.update({278: (4, [rps or h]), 273: (off_type, offs), 279: (off_type, counts)})
    ifd_off, es, inline = pos, 20 if big else 12, 8 if big else 4
    ext_pos = ifd_off + (8 if big else 2) + len(tags) * es + (8 if big else 4)
    entries, ext = b"", bytearray()
    for t in sorted(tags):
        typ, vals = tags[t]
        payload = vals if isinstance(vals, bytes) else b"".join(
            struct.pack(order + _TIFF_TYPES[typ], v) for v in vals)
        cnt = len(payload) if isinstance(vals, bytes) else len(vals)
        if len(payload) <= inline:
            val = payload.ljust(inline, b"\0")
        else:
            val = struct.pack(order + ("Q" if big else "I"), ext_pos + len(ext))
            ext += payload + b"\0" * (len(payload) % 2)
        entries += struct.pack(order + "HH" + ("Q" if big else "I"), t, typ, cnt) + val
    ifd = struct.pack(order + ("Q" if big else "H"), len(tags)) + entries + b"\0" * inline
    magic = b"II" if order == "<" else b"MM"
    head = magic + (struct.pack(order + "HHHQ", 43, 8, 0, ifd_off) if big
                    else struct.pack(order + "HI", 42, ifd_off))
    return bytes(head + data + ifd + ext)


def _smooth(rng, h, w, c):
    base = rng.integers(0, 256, (h // 20 + 2, w // 20 + 2, c)).astype(np.uint8)
    return cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC).reshape(h, w, c)


# ---------------------------------------------------------------------------
# against cv2
# ---------------------------------------------------------------------------

def _write(tmp_path, data: bytes, name: str) -> str:
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return p


def _same_read(path: str, color: bool, flag: int):
    """One read of `path` against cv2.imread's under `flag` (None, or
    ImageSizeError where cv2 raises)."""
    try:
        want = cv2.imread(path, flag)
    except cv2.error:
        with pytest.raises(native.ImageSizeError, match="size"):
            imread.read(path, color=color)
        return None
    got = imread.read(path, color=color)
    if want is None:
        assert got is None, (path, flag, got.dtype, got.shape)
        return None
    assert got is not None, (path, flag, want.dtype, want.shape)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), (path, flag, got.dtype,
                                                                 got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=f"{path} flag {flag}")
    return want


def _same_as_cv2(path: str):
    """Both reads of `path` against cv2.imread's (None, or ImageSizeError
    where cv2 raises); returns cv2's IMREAD_UNCHANGED read."""
    first = _same_read(path, False, cv2.IMREAD_UNCHANGED)
    _same_read(path, True, cv2.IMREAD_COLOR)
    return first


def _rng(name: str):
    return np.random.default_rng(int(hashlib.sha256(name.encode()).hexdigest()[:8], 16))


def _tiff_kinds():
    rng = _rng("tiff")
    u8 = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    u16 = rng.integers(0, 65536, (H, W, 4), dtype=np.uint16)
    f32 = rng.normal(0, 2, (H, W, 4)).astype(np.float32)
    k = {}
    for ch in (1, 3, 4):
        for a in (u8, u16, f32):
            k[f"cv2_{a.dtype}_{ch}"] = lambda a=a, ch=ch: _cv2(".tif", a[:, :, :ch] if ch > 1
                                                               else a[:, :, 0])
    layouts = {"none": {}, "lzw": dict(comp=5), "lzw_pred": dict(comp=5, pred=2, rps=8),
               "deflate_pred": dict(comp=8, pred=2, rps=5), "adobe": dict(comp=32946),
               "packbits": dict(comp=32773, rps=3), "be_lzw_pred": dict(order=">", comp=5, pred=2),
               "bigtiff": dict(big=True, comp=8), "big_be": dict(big=True, order=">"),
               "tiles": dict(tile=(16, 16), comp=5, pred=2), "planes8": dict(planar=2, comp=8),
               "planes8_tiles": dict(planar=2, tile=(16, 32), comp=32773),
               "fillorder2": dict(fillorder=2, comp=5)}
    for lname, kw in layouts.items():
        for ch in (1, 3, 4):
            for a in (u8, u16, f32):
                if ("planes" in lname and a.dtype != np.uint8 and ch > 1) or \
                        (a is f32 and "pred" in lname and kw.get("pred") == 2):
                    continue
                k[f"{lname}_{a.dtype}_{ch}"] = lambda a=a, ch=ch, kw=kw: tiff_bytes(
                    a[:, :, :ch], **kw)
    for kw in (dict(pred=3, comp=8), dict(pred=3, comp=5, rps=4), dict(pred=3, order=">", comp=8),
               dict(pred=3, tile=(16, 16), comp=8)):
        k["pred3_" + "_".join(f"{a}{b}" for a, b in kw.items() if a != "pred")] = \
            lambda kw=kw: tiff_bytes(f32[:, :, :3], **kw)
    for ex in (0, 1, 2):
        for a in (u8, u16):
            k[f"rgba_extra{ex}_{a.dtype}"] = lambda a=a, ex=ex: tiff_bytes(a, extra=[ex])
            k[f"greyalpha_extra{ex}_{a.dtype}"] = lambda a=a, ex=ex: tiff_bytes(
                a[:, :, :2], photometric=1, extra=[ex])
            k[f"greyalpha_tiles_{ex}_{a.dtype}"] = lambda a=a, ex=ex: tiff_bytes(
                a[:, :, :2], photometric=1, extra=[ex], tile=(16, 16))
            k[f"greyalpha_planes_{ex}_{a.dtype}"] = lambda a=a, ex=ex: tiff_bytes(
                a[:, :, :2], photometric=1, extra=[ex], planar=2)
    k["grey16_tiles"] = lambda: tiff_bytes(u16[:, :, 0], tile=(16, 16), comp=5, pred=2)
    k["miniswhite16"] = lambda: tiff_bytes(u16[:, :, 0], photometric=0)
    for bits in (1, 2, 4, 8):
        v = rng.integers(0, 1 << bits, (H, W), dtype=np.uint8)
        for ph in (0, 1):
            k[f"grey{bits}_ph{ph}"] = lambda v=v, bits=bits, ph=ph: tiff_bytes(
                v, bits=bits, photometric=ph, comp=5, rps=4)
        for wide in (False, True):
            cmap = rng.integers(0, 65536 if wide else 256, 3 * (1 << bits))
            k[f"palette{bits}_{'16' if wide else '8'}bit_map"] = \
                lambda v=v, bits=bits, cmap=cmap: tiff_bytes(v, bits=bits, photometric=3,
                                                             colormap=cmap)
            k[f"palette{bits}_tiles_{wide}"] = lambda v=v, bits=bits, cmap=cmap: tiff_bytes(
                v, bits=bits, photometric=3, colormap=cmap, tile=(16, 16), comp=32773)
    for o in range(1, 9):
        k[f"orientation{o}"] = lambda o=o: tiff_bytes(u8[:, :, :3], orientation=o)
        k[f"orientation{o}_square16"] = lambda o=o: tiff_bytes(u16[:20, :20, :3], orientation=o)
        k[f"orientation{o}_square_float"] = lambda o=o: tiff_bytes(f32[:20, :20, :1],
                                                                   orientation=o)
    img = u8[:, :, :3]
    for comp in ("tiff_lzw", "tiff_deflate", "tiff_adobe_deflate", "packbits", "jpeg", "raw"):
        k[f"pil_rgb_{comp}"] = lambda comp=comp: _pil(img, "TIFF", compression=comp)
        k[f"pil_grey_{comp}"] = lambda comp=comp: _pil(u8[:, :, 0], "TIFF", compression=comp)
    k["pil_jpeg_q90_640x480"] = lambda: _pil(_smooth(rng, 480, 640, 3), "TIFF",
                                             compression="jpeg", quality=90)
    k["pil_palette"] = lambda: _pil(_pil_image(img).convert("P"), "TIFF",
                                    compression="tiff_lzw")
    k["pil_bilevel"] = lambda: _pil(u8[:, :, 0] > 128, "TIFF")
    k["pil_rgba_lzw"] = lambda: _pil(u8, "TIFF", compression="tiff_lzw")
    k["pil_I16"] = lambda: _pil(u16[:, :, 0], "TIFF", compression="tiff_lzw")
    k["pil_F_deflate"] = lambda: _pil(f32[:, :, 0], "TIFF", compression="tiff_deflate")
    k["cv2_lzw_pred_640x480"] = lambda: _cv2(".tif", _smooth(rng, 480, 640, 3))
    return k


def _pil_image(a):
    from PIL import Image

    return Image.fromarray(a)


KINDS = _tiff_kinds()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_reads_equal_cv2(tmp_path, kind):
    _same_as_cv2(_write(tmp_path, KINDS[kind](), kind + ".tif"))


# ---------------------------------------------------------------------------
# damage, OpenEXR, what raises
# ---------------------------------------------------------------------------

DAMAGE_SOURCES = ("lzw_pred_uint8_3", "deflate_pred_uint16_3", "pred3_comp8", "packbits_uint8_1",
                  "tiles_uint8_4", "planes8_uint8_3", "pil_rgb_jpeg", "grey1_ph0")
FLIPS = 12
COPIES = 100
# the features data/tiff.py leaves out, as its UnsupportedImage messages
# name them: a damaged copy may raise it only where cv2 gives an image
UNPORTED = ("CCITT", "ThunderScan", "NeXT", "SGI Log", "sample format", "separate planes",
            "without SamplesPerPixel", "CMYK", "CIELab", "YCbCr without JPEG",
            "old-style (pre-TIFF 5.0) LZW", "12-bit")


def test_cut_and_flipped_copies_read_as_cv2(tmp_path):
    """Each source cut at two thirds, and FLIPS copies with 1-3 bits
    flipped (seeded) in its strips or tiles."""
    n_none = n_read = 0
    for kind in DAMAGE_SOURCES:
        data = KINDS[kind]()
        rng = _rng(f"damage tiff {kind}")
        lay = tiff._Layout(data, kind)
        spans = [(o, min(o + c, len(data))) for o, c in zip(lay.offsets, lay.counts)]
        copies = {"cut": data[:len(data) * 2 // 3]}
        for i in range(FLIPS):
            d = bytearray(data)
            for _ in range(int(rng.integers(1, 4))):
                a, b = spans[int(rng.integers(0, len(spans)))]
                d[int(rng.integers(a, b))] ^= 1 << int(rng.integers(0, 8))
            copies[f"flip{i}"] = bytes(d)
        for tag, d in copies.items():
            got = _same_as_cv2(_write(tmp_path, d, f"{kind}_{tag}.tif"))
            n_none += got is None
            n_read += got is not None
    print(f"{n_read} damaged copies read, {n_none} None")
    assert n_read > 0 and n_none > 0


def _as_cv2_or_unported(path: str):
    """`_same_as_cv2`, except that a read may raise UnsupportedImage where
    cv2 gives an image under that flag and the message names a feature of
    `UNPORTED`; returns cv2's IMREAD_UNCHANGED read, or "unsupported"."""
    first = None
    for color, flag in ((False, cv2.IMREAD_UNCHANGED), (True, cv2.IMREAD_COLOR)):
        try:
            want = _same_read(path, color, flag)
        except native.UnsupportedImage as e:
            assert cv2.imread(path, flag) is not None, (path, flag, str(e))
            assert any(f in str(e) for f in UNPORTED), str(e)
            want = "unsupported"
        first = want if flag == cv2.IMREAD_UNCHANGED else first
    return first


def _ifd_span(data: bytes):
    """(byte order, offset of the first IFD, its entry count)."""
    order = "<" if data[:2] == b"II" else ">"
    ifd = struct.unpack(order + "I", data[4:8])[0]
    return order, ifd, struct.unpack(order + "H", data[ifd:ifd + 2])[0]


_SWEEPS = {}


def _sweep_copies(kind: str) -> dict:
    """The damaged copies of `kind` drawn from one np.random.default_rng(20)
    over DAMAGE_SOURCES in order, COPIES a source: ("ifd", i) flips one bit
    at a uniform position in the first IFD's count and 12-byte entries;
    ("mutate", i) is test_torch_port_damaged._mutate's cut, byte or bit
    flip, inserted or deleted bytes anywhere in the file."""
    if not _SWEEPS:
        from test_torch_port_damaged import _mutate

        for sweep in ("ifd", "mutate"):
            rng = np.random.default_rng(20)
            for src in DAMAGE_SOURCES:
                data = KINDS[src]()
                _, ifd, n = _ifd_span(data)
                for i in range(COPIES):
                    if sweep == "ifd":
                        d = bytearray(data)
                        d[int(rng.integers(ifd, ifd + 2 + 12 * n))] ^= 1 << int(rng.integers(8))
                        d = bytes(d)
                    else:
                        d = _mutate(rng, data)
                    _SWEEPS.setdefault(src, {})[(sweep, i)] = d
    return _SWEEPS[kind]


@pytest.mark.parametrize("kind", DAMAGE_SOURCES)
def test_ifd_bit_flips_read_as_cv2(tmp_path, kind):
    """COPIES copies of each source with one bit flipped in its first IFD
    (the seeded draws of `_sweep_copies`) read as cv2 reads them."""
    got = [_as_cv2_or_unported(_write(tmp_path, d, f"{kind}_ifd{i}.tif"))
           for (sweep, i), d in _sweep_copies(kind).items() if sweep == "ifd"]
    n_none, n_unported = sum(g is None for g in got), sum(isinstance(g, str) for g in got)
    print(f"{kind}: {len(got) - n_none - n_unported} IFD-flipped copies read, {n_none} None, "
          f"{n_unported} unsupported")
    assert len(got) == COPIES


@pytest.mark.parametrize("kind", DAMAGE_SOURCES)
def test_whole_file_mutations_read_as_cv2(tmp_path, kind):
    """COPIES seeded whole-file mutations of each source read as cv2 reads
    them."""
    got = [_as_cv2_or_unported(_write(tmp_path, d, f"{kind}_mut{i}.tif"))
           for (sweep, i), d in _sweep_copies(kind).items() if sweep == "mutate"]
    assert len(got) == COPIES


def _patch(data: bytes, tag: int, field: str, value) -> bytes:
    """`data` with the `field` ("tag", "type", "count" or "value", the last
    as 4 bytes or a number) of `tag`'s first IFD entry set to `value`."""
    order, ifd, n = _ifd_span(data)
    for i in range(n):
        p = ifd + 2 + 12 * i
        if struct.unpack(order + "H", data[p:p + 2])[0] == tag:
            at, fmt = {"tag": (0, "H"), "type": (2, "H"), "count": (4, "I"),
                       "value": (8, "I")}[field]
            raw = value if isinstance(value, bytes) else struct.pack(order + fmt, value)
            return data[:p + at] + raw + data[p + at + len(raw):]
    raise KeyError(tag)


def _insert_in_tables(data: bytes) -> bytes:
    """Four bytes inserted inside the JPEGTables stream's last Huffman
    table, the count left as it was: its end is cut, junk follows."""
    order, ifd, n = _ifd_span(data)
    off = next(struct.unpack(order + "I", data[p + 8:p + 12])[0]
               for p in range(ifd + 2, ifd + 2 + 12 * n, 12)
               if struct.unpack(order + "H", data[p:p + 2])[0] == 347)
    at = off + 177
    return data[:at] + bytes([0x8B, 0x33, 0x78, 0x45]) + data[at:]


# one case of each kind of IFD damage the sweeps met: (source, how) and
# whether cv2 gives an image ("image"), None, or an image the port leaves
# out ("unsupported")
IFD_CASES = {
    "g4_on_8bit_rgb": ("lzw_pred_uint8_3", (259, "value", 4), None),
    "g3_on_jpeg": ("pil_rgb_jpeg", (259, "value", 3), None),
    "old_style_jpeg": ("pil_rgb_jpeg", (259, "value", 6), None),
    "ycbcr_without_jpeg": ("lzw_pred_uint8_3", (262, "value", 6), "unsupported"),
    "separated_one_sample": ("packbits_uint8_1", (262, "value", 5), None),
    "sampleformat_lost_275": ("pred3_comp8", (339, "tag", 275), None),
    "sampleformat_lost_371": ("pred3_comp8", (339, "tag", 371), None),
    "sampleformat_lost_33107": ("pred3_comp8", (339, "tag", 33107), None),
    "jpeg_wider_ifd": ("pil_rgb_jpeg", (256, "value", 0x1035), "image"),
    "jpeg_taller_strip": ("pil_rgb_jpeg", (278, "value", 0x24), None),
    "spp_lost_uint16": ("deflate_pred_uint16_3", (277, "tag", 8469), "unsupported"),
    "spp_lost_float": ("pred3_comp8", (277, "tag", 309), "unsupported"),
    "compression_count_129": ("planes8_uint8_3", (259, "count", 129), None),
    "compression_count_65": ("planes8_uint8_3", (259, "count", 65), None),
    "compression_count_33": ("tiles_uint8_4", (259, "count", 33), None),
    "compression_lost_tiles": ("tiles_uint8_4", (259, "tag", 258), None),
    "photometric_unknown": ("deflate_pred_uint16_3", (262, "value", 0x8002), None),
    "photometric_ycbcr_float": ("pred3_comp8", (262, "value", 6), None),
    "photometric_miniswhite_rgb16": ("deflate_pred_uint16_3", (262, "value", 0), "image"),
    "photometric_miniswhite_tiles": ("tiles_uint8_4", (262, "value", 0), "image"),
    "compression_lost_strips": ("lzw_pred_uint8_3", (259, "tag", 16643), "image"),
    "bytecounts_past_file": ("planes8_uint8_3", (279, "value", 0x800017B4), None),
    "bytecounts_none": ("pred3_comp8", (279, "count", 0), "image"),
    "rows_per_strip_over_1gib": ("grey1_ph0", (278, "value", 0x800025), None),
    "bits_12_packbits": ("packbits_uint8_1", (258, "value", 12), None),
    "jpeg_tables_cut": ("pil_rgb_jpeg", _insert_in_tables, "image"),
}


@pytest.mark.parametrize("case", sorted(IFD_CASES))
def test_each_kind_of_ifd_damage_reads_as_cv2(tmp_path, case):
    kind, how, expect = IFD_CASES[case]
    data = KINDS[kind]()
    data = how(data) if callable(how) else _patch(data, *how)
    got = _as_cv2_or_unported(_write(tmp_path, data, case + ".tif"))
    assert (got if got is None or isinstance(got, str) else "image") == expect, case


def test_openexr_reads_as_none(tmp_path):
    """This cv2 is built without OpenEXR: the signature gives None, and
    read_image raises FileNotFoundError as the JAX package's does."""
    p = _write(tmp_path, b"\x76\x2f\x31\x01" + bytes(range(60)), "frame.exr")
    assert cv2.imread(p, cv2.IMREAD_UNCHANGED) is None and cv2.imread(p) is None
    assert imread.read(p) is None and imread.read_color(p) is None
    for read_image in (tbop.read_image, jbop.read_image):
        with pytest.raises(FileNotFoundError):
            read_image(p)


def test_what_raises_names_the_file_and_feature(tmp_path):
    """UnsupportedImage for the formats the port does not decode (cv2
    writes each of them here) and the TIFF features left out, naming the
    file and the format or feature; ImageSizeError where cv2.imread
    raises."""
    rng = _rng("raises")
    u8 = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    u16 = rng.integers(0, 65536, (H, W, 3), dtype=np.uint16)
    cases = {f"{ext[1:]}_as.png": (_cv2(ext, u8 if ext != ".hdr" else u8.astype(np.float32)), fmt)
             for fmt, ext in (("BMP", ".bmp"), ("Radiance", ".hdr"), ("Sun raster", ".ras"),
                              ("PNM", ".ppm"), ("PNM", ".pam"), ("PFM", ".pfm"),
                              ("GIF", ".gif"))}
    cases.update({"a.webp": (b"RIFF\x10\0\0\0WEBPVP8 " + bytes(40), "WebP"),
             "b.jp2": (b"\0\0\0\x0cjP  \r\n\x87\n" + bytes(40), "JPEG 2000"),
             "c.j2k": (b"\xff\x4f\xff\x51" + bytes(40), "JPEG 2000"),
             "d.avif": (b"\0\0\0\x1cftypavif\0\0\0\0avifmif1miaf" + bytes(40), "AVIF"),
             "e.tif": (_pil(rng.integers(0, 2, (H, W)).astype(bool), "TIFF",
                            compression="group4"), "CCITT Group 4"),
             "f.tif": (tiff_bytes(u16, planar=2), "separate planes"),
             "g.tif": (tiff_bytes(u16[:, :, 0].view(np.int16), sample_format=2),
                       "sample format 2")})
    for name, (data, what) in cases.items():
        p = _write(tmp_path, data, name)
        assert cv2.imread(p, cv2.IMREAD_UNCHANGED) is not None or name in ("a.webp", "b.jp2",
                                                                           "c.j2k", "d.avif")
        with pytest.raises(native.UnsupportedImage, match=f"{name}.*{what}"):
            imread.read(p)
        with pytest.raises(native.UnsupportedImage, match=name):
            tbop.read_image(p)
    # compressions cv2's libtiff is built without read as None, not raise
    from PIL import Image

    bio = io.BytesIO()
    Image.fromarray(u16[:, :, 0].astype(np.uint8)).save(bio, "TIFF", compression="lzma")
    assert _same_as_cv2(_write(tmp_path, bio.getvalue(), "lzma.tif")) is None
    p = _write(tmp_path, tiff_bytes(u16[:1, :8, 0], extra_tags=(
        (256, (4, [1 << 21])), (257, (4, [1])))), "wide.tif")
    with pytest.raises(cv2.error):
        cv2.imread(p)
    with pytest.raises(native.ImageSizeError, match="wide.tif"):
        imread.read(p)


# ---------------------------------------------------------------------------
# the BOP pipeline against the JAX package
# ---------------------------------------------------------------------------

def _palette_tiff(img: np.ndarray, colours: int, **kw) -> bytes:
    """An 8-bit palette TIFF of the BGR image `img` quantized to `colours`."""
    q = _pil_image(img[:, :, ::-1]).quantize(colours)
    pal = np.zeros((256, 3), np.uint16)
    pal[:colours] = np.asarray(q.getpalette()[:3 * colours]).reshape(colours, 3)
    return tiff_bytes(np.asarray(q), photometric=3, colormap=(pal.T * 257).reshape(-1), **kw)


def _backgrounds(d, rng) -> list:
    """TIFF backgrounds under .jpg / .png names."""
    os.makedirs(d, exist_ok=True)
    img = _smooth(rng, 90, 120, 3)
    files = {"grey_tiff_as.jpg": tiff_bytes(img[:, :, 0], comp=5, rps=16),
             "palette_tiff_as.png": _palette_tiff(img, 32, comp=32773, tile=(32, 32)),
             "rgba_tiff_as.png": tiff_bytes(np.dstack([img, img[:, :, :1]]), extra=[2], comp=8),
             "float_tiff_as.png": tiff_bytes(img.astype(np.float32) / 255, comp=8, pred=3),
             "tiff16_as.jpg": tiff_bytes(img.astype(np.uint16) * 257, comp=5, pred=2)}
    paths = []
    for name, data in sorted(files.items()):
        paths.append(os.path.join(d, name))
        with open(paths[-1], "wb") as f:
            f.write(data)
    return paths


def test_background_bank_on_the_new_formats_matches_jax(tmp_path):
    d = tmp_path / "bg"
    paths = _backgrounds(str(d), _rng("bank"))
    assert imread.read_color(str(d / "float_tiff_as.png")) is None      # drawn again
    port, jax_bank = TT.BackgroundBank(str(d)), JT.BackgroundBank(str(d))
    assert port.files == jax_bank.files and len(port.files) == len(paths)
    for shape in ((480, 640), (128, 128)):
        img = np.random.default_rng(1).integers(0, 256, (*shape, 3), dtype=np.uint8)
        mask = np.zeros(shape, np.int32)
        mask[shape[0] // 4:shape[0] // 2, shape[1] // 3:shape[1] // 2] = 1
        for seed in range(24):
            r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
            np.testing.assert_array_equal(port(img, mask, r_port), jax_bank(img, mask, r_jax))
            assert r_port.bit_generator.state == r_jax.bit_generator.state


def _frame_files(img: np.ndarray) -> dict:
    """The tree's frames: (name -> bytes) of an 8-bit grey LZW TIFF, a
    16-bit RGB Deflate TIFF with predictor 2, an 8-bit palette PackBits
    TIFF in tiles and a float TIFF holding the frame's pixel values."""
    grey = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    return {"000000.tif": _cv2(".tif", grey),                   # LZW, predictor 2
            "000001.tif": tiff_bytes(img[:, :, ::-1].astype(np.uint16) * 257, comp=8, pred=2,
                                     rps=16),
            "000002.tif": _palette_tiff(img, 64, comp=32773, tile=(64, 64)),
            "000003.tif": tiff_bytes(img[:, :, ::-1].astype(np.float32), comp=8, pred=3,
                                     rps=32)}


@pytest.fixture(scope="module")
def raster_tree(tmp_path_factory):
    """make_bop_dataset's tree (three classes) with its four train frames
    as the TIFFs of `_frame_files`, and TIFF backgrounds."""
    root = tmp_path_factory.mktemp("raster_bop")
    yaml_path = make_bop_dataset.write_dataset(str(root), n_train=4, n_test=1, n_fg=3,
                                               single_class=None, seed=6)
    scene = root / "train" / "000001"
    names = []
    for j in range(4):
        img = cv2.imread(str(scene / "rgb" / f"{j:06d}.png"), cv2.IMREAD_UNCHANGED)
        name = sorted(_frame_files(img))[j]
        with open(scene / "rgb" / name, "wb") as f:
            f.write(_frame_files(img)[name])
        names.append(f"train/000001/rgb/{name}")
    with open(root / "raster_list.txt", "w") as f:
        f.write("\n".join(names))
    _backgrounds(str(root / "bg"), _rng("tree backgrounds"))
    return yaml_path, str(root / "raster_list.txt"), str(root / "bg"), [str(root / n)
                                                                      for n in names]


def test_read_image_on_the_frames_equals_jax(raster_tree):
    _, _, _, frames = raster_tree
    kinds = []
    for p in frames:
        got, want = tbop.read_image(p), jbop.read_image(p)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), p
        np.testing.assert_array_equal(got, want, err_msg=p)
        assert not got.flags.writeable
        kinds.append(str(got.dtype))
    assert kinds == ["uint8", "uint8", "uint8", "float32"]     # float passes through as float


def _cfg_pair(yaml_path, list_file, bg_dir, fast):
    pair = []
    for m in (jcfg, tcfg):
        cfg = m.load_yaml_config(yaml_path)
        pair.append(cfg.replace(model=m.ModelConfig(input_res=128),
                                data=dataclasses.replace(cfg.data, train_list=list_file,
                                                         fast_pipeline=fast),
                                solver=dataclasses.replace(m.SolverConfig(max_objs=2,
                                                                          ims_per_batch=2),
                                                           aug_background_dir=bg_dir)))
    return pair


@pytest.mark.parametrize("fast", [False, True], ids=["slow", "fast"])
def test_samples_on_the_raster_tree_match_jax(raster_tree, fast):
    yaml_path, list_file, bg_dir, _ = raster_tree
    jc, tc = _cfg_pair(yaml_path, list_file, bg_dir, fast)
    jds = jpipe.BOPPoseDataset(jc, list_file, train=True)
    tds = tpipe.BOPPoseDataset(tc, list_file, train=True)
    n = 0
    for seed in (1, 2, 3):
        for idx in range(4):
            got, want = tds.sample(idx, seed=seed), jds.sample(idx, seed=seed)
            assert (got is None) == (want is None), (idx, seed)
            if got is None:
                continue
            n += 1
            for key in ("image", "mask"):
                assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
                np.testing.assert_array_equal(got[key], want[key])
            np.testing.assert_array_equal(got["class_ids"], want["class_ids"])
            np.testing.assert_allclose(got["rotations"], want["rotations"], atol=1e-6)
            np.testing.assert_allclose(got["translations"], want["translations"], rtol=1e-6)
            np.testing.assert_allclose(got["bbox_trans"], want["bbox_trans"], atol=1e-4)
    assert n >= 8


def test_one_loader_batch_matches_jax(raster_tree):
    yaml_path, list_file, bg_dir, _ = raster_tree
    jc, tc = _cfg_pair(yaml_path, list_file, bg_dir, False)
    its = [iter(pipe.PrefetchLoader(pipe.BOPPoseDataset(c, list_file, train=True), batch_size=2,
                                    train=True, num_threads=1, seed=3))
           for pipe, c in ((tpipe, tc), (jpipe, jc))]
    (tb, tm), (jb, jm) = next(its[0]), next(its[1])
    for it in its:
        it.close()
    np.testing.assert_array_equal(tb.images.numpy(), np.asarray(jb.images))
    np.testing.assert_array_equal(tb.class_ids.numpy(), np.asarray(jb.class_ids))
    np.testing.assert_allclose(tb.bbox_trans.numpy(), np.asarray(jb.bbox_trans), atol=1e-4)


def _g4_frame(img: np.ndarray) -> bytes:
    """The frame as an 8-bit grey LZW TIFF whose Compression reads CCITT
    Group 4 (one bit flipped): cv2 gives None (Group 4 takes 1-bit samples)."""
    return _patch(tiff_bytes(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), comp=5, rps=16), 259,
                  "value", 4)


def _float_without_format(img: np.ndarray) -> bytes:
    """A float Deflate TIFF with predictor 3 whose SampleFormat tag reads
    275 (one bit flipped): cv2 gives None (predictor 3 takes floats)."""
    return _patch(tiff_bytes(img.astype(np.float32) / 255, comp=8, pred=3), 339, "tag", 275)


@pytest.fixture(scope="module")
def damaged_raster_tree(tmp_path_factory):
    """raster_tree with a fifth train frame of a damaged IFD (`_g4_frame`)
    and, among the TIFF backgrounds, one of a damaged IFD
    (`_float_without_format`)."""
    root = tmp_path_factory.mktemp("damaged_raster_bop")
    yaml_path = make_bop_dataset.write_dataset(str(root), n_train=5, n_test=1, n_fg=3,
                                               single_class=None, seed=6)
    scene = root / "train" / "000001"
    names = []
    for j in range(5):
        img = cv2.imread(str(scene / "rgb" / f"{j:06d}.png"), cv2.IMREAD_UNCHANGED)
        files = _frame_files(img)
        name = sorted(files)[j] if j < 4 else f"{j:06d}.tif"
        with open(scene / "rgb" / name, "wb") as f:
            f.write(files[name] if j < 4 else _g4_frame(img))
        names.append(f"train/000001/rgb/{name}")
    with open(root / "raster_list.txt", "w") as f:
        f.write("\n".join(names))
    rng = _rng("damaged tree backgrounds")
    _backgrounds(str(root / "bg"), rng)
    with open(root / "bg" / "float_no_format_as.png", "wb") as f:
        f.write(_float_without_format(_smooth(rng, 90, 120, 3)))
    for p in (scene / "rgb" / "000004.tif", root / "bg" / "float_no_format_as.png"):
        assert _same_as_cv2(str(p)) is None and cv2.imread(str(p)) is None
    return yaml_path, str(root / "raster_list.txt"), str(root / "bg")


@pytest.mark.parametrize("fast", [False, True], ids=["slow", "fast"])
def test_samples_on_the_damaged_tree_match_jax(damaged_raster_tree, fast):
    """Samples of every frame under three seeds equal JAX's, None (a redraw)
    for the damaged frame in both, with the damaged background in the bank."""
    yaml_path, list_file, bg_dir = damaged_raster_tree
    jc, tc = _cfg_pair(yaml_path, list_file, bg_dir, fast)
    jds = jpipe.BOPPoseDataset(jc, list_file, train=True)
    tds = tpipe.BOPPoseDataset(tc, list_file, train=True)
    n = 0
    for seed in (1, 2, 3):
        for idx in range(5):
            got, want = tds.sample(idx, seed=seed), jds.sample(idx, seed=seed)
            assert (got is None) == (want is None), (idx, seed)
            assert idx < 4 or got is None
            if got is None:
                continue
            n += 1
            for key in ("image", "mask"):
                assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
                np.testing.assert_array_equal(got[key], want[key])
            np.testing.assert_array_equal(got["class_ids"], want["class_ids"])
            np.testing.assert_allclose(got["rotations"], want["rotations"], atol=1e-6)
            np.testing.assert_allclose(got["translations"], want["translations"], rtol=1e-6)
            np.testing.assert_allclose(got["bbox_trans"], want["bbox_trans"], atol=1e-4)
    assert n >= 8


def test_one_loader_epoch_on_the_damaged_tree_matches_jax(damaged_raster_tree):
    """One epoch of the loader (three batches of two over the five frames,
    the damaged one redrawn) equals JAX's, and so does the background bank
    that skips the damaged background."""
    yaml_path, list_file, bg_dir = damaged_raster_tree
    port, jax_bank = TT.BackgroundBank(bg_dir), JT.BackgroundBank(bg_dir)
    assert port.files == jax_bank.files
    img = np.random.default_rng(4).integers(0, 256, (128, 128, 3), dtype=np.uint8)
    mask = np.zeros((128, 128), np.int32)
    mask[40:80, 30:70] = 1
    for seed in range(12):
        r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(port(img, mask, r_port), jax_bank(img, mask, r_jax))
        assert r_port.bit_generator.state == r_jax.bit_generator.state
    jc, tc = _cfg_pair(yaml_path, list_file, bg_dir, False)
    its = [iter(pipe.PrefetchLoader(pipe.BOPPoseDataset(c, list_file, train=True), batch_size=2,
                                    train=True, num_threads=1, seed=5))
           for pipe, c in ((tpipe, tc), (jpipe, jc))]
    for _ in range(3):
        (tb, _), (jb, _) = next(its[0]), next(its[1])
        np.testing.assert_array_equal(tb.images.numpy(), np.asarray(jb.images))
        np.testing.assert_array_equal(tb.class_ids.numpy(), np.asarray(jb.class_ids))
        np.testing.assert_allclose(tb.bbox_trans.numpy(), np.asarray(jb.bbox_trans), atol=1e-4)
    for it in its:
        it.close()


# ---------------------------------------------------------------------------
# the committed fixtures (chip_smoke's (e) and (f))
# ---------------------------------------------------------------------------

def fixture_manifest(root: str, read, read_color) -> dict:
    """{"files": {path: {"read", "read_color"}}} of the fixtures under
    `root` (None where a read gives None)."""
    files = {}
    for sub in ("frames", "backgrounds", "damaged"):
        for f in sorted(os.listdir(os.path.join(root, sub))):
            p = os.path.join(root, sub, f)
            files[f"{sub}/{f}"] = {k: None if a is None else digest(a)
                                   for k, a in (("read", read(p)), ("read_color", read_color(p)))}
    return dict(files=files)


def cv2_manifest(root: str) -> dict:
    return fixture_manifest(root, lambda p: cv2.imread(p, cv2.IMREAD_UNCHANGED), cv2.imread)


# (name, SyntheticPoseDataset index): train frames 7-9 of chip_smoke's tree
FRAMES = (("frames/train_000007.tif", 1007), ("frames/train_000008.tif", 1008),
          ("frames/train_000009.tif", 1009))
# the damaged-IFD fixtures (each under 20 KB): a train frame (id 10 of
# chip_smoke's (e)) and two backgrounds
IFD_FIXTURES = ("damaged/train_000010_g4.tif", "damaged/bg_14_no_format.png",
                "damaged/bg_16_miniswhite.jpg")


def write_raster_fixtures(root: str = FIXTURES) -> dict:
    """Write the raster fixtures and their manifest under `root`: three
    640x480 frames (an 8-bit grey LZW TIFF, a 16-bit RGB Deflate TIFF with
    predictor 2, an 8-bit palette PackBits TIFF in tiles) of the renderer's
    frames, blurred so that they cost few bytes; TIFF backgrounds of at most
    160x120 under .jpg / .png names; damaged copies (cut, bit-flipped in the
    data and in the IFD)."""
    from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset

    for sub in ("frames", "backgrounds", "damaged"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    ds = SyntheticPoseDataset(n_fg=15, single_class=0, seed=0)
    imgs = [cv2.GaussianBlur(np.ascontiguousarray(ds.sample_internal(i)["img"][:, :, ::-1]),
                             (9, 9), 0) for _, i in FRAMES]
    frames = {FRAMES[0][0]: tiff_bytes(cv2.cvtColor(imgs[0], cv2.COLOR_BGR2GRAY), comp=5,
                                       rps=16),
              FRAMES[1][0]: tiff_bytes(imgs[1][:, :, ::-1].astype(np.uint16) * 257, comp=8,
                                       pred=2, rps=16),
              FRAMES[2][0]: _palette_tiff(imgs[2], 64, comp=32773, tile=(64, 64))}
    rng = np.random.default_rng(20)
    small = _smooth(rng, 120, 160, 3)
    bgs = {"backgrounds/bg_14.png": tiff_bytes(small[:60, :80, ::-1].astype(np.float32) / 255,
                                               comp=8, pred=3),
           "backgrounds/bg_15.jpg": tiff_bytes(small[:, :, ::-1], comp=5, pred=2, tile=(32, 32))}
    damaged = {"damaged/bg_15_flipped.jpg": _flip(bgs["backgrounds/bg_15.jpg"], 1000, 3),
               "damaged/bg_15_cut.jpg": bgs["backgrounds/bg_15.jpg"][:len(
                   bgs["backgrounds/bg_15.jpg"]) * 2 // 3],
               # one bit flipped in the IFD: a frame whose Compression reads
               # CCITT Group 4 and a float background without SampleFormat
               # (None), a background in clipped tiles whose Photometric reads
               # MinIsWhite (grey of its first sample, inverted)
               IFD_FIXTURES[0]: _g4_frame(cv2.resize(imgs[0], (160, 120),
                                                          interpolation=cv2.INTER_AREA)),
               IFD_FIXTURES[1]: _float_without_format(small[:60, :80, ::-1] * 1.0),
               IFD_FIXTURES[2]: _patch(tiff_bytes(small[:60, :80, ::-1], comp=5, pred=2,
                                                  tile=(32, 32)), 262, "value", 0)}
    for rel, data in {**frames, **bgs, **damaged}.items():
        with open(os.path.join(root, rel), "wb") as f:
            f.write(data)
    manifest = cv2_manifest(root)
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _flip(data: bytes, pos: int, bit: int) -> bytes:
    d = bytearray(data)
    d[pos] ^= 1 << bit
    return bytes(d)


def test_the_raster_fixtures_manifest_is_cv2s():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        committed = json.load(f)
    assert cv2_manifest(FIXTURES) == committed
    assert fixture_manifest(FIXTURES, imread.read, imread.read_color) == committed
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(FIXTURES)
                for f in fs)
    assert total <= FIXTURE_BUDGET, total
    assert sorted(name for name, _ in FRAMES) == sorted(f for f in committed["files"]
                                                        if f.startswith("frames/"))
    none = {rel for rel, v in committed["files"].items() if v["read_color"] is None}
    assert none == {"backgrounds/bg_14.png", "damaged/bg_15_cut.jpg", *IFD_FIXTURES[:2]}
    assert all(os.path.getsize(os.path.join(FIXTURES, rel)) < 20 * 1024 for rel in IFD_FIXTURES)


if __name__ == "__main__":
    m = write_raster_fixtures()
    print(json.dumps({k: len(v) for k, v in m.items()}))
