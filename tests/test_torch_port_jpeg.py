"""PyTorch port, JPEG reading (`kd6d_pose_adlp_tpu_torch/data/jpeg.py` over
`csrc/jpeg.cpp`, and `data/imread.py`'s PNG-or-JPEG reads) against
`cv2.imread`, on images encoded in the test by `cv2.imencode` and PIL, and
the committed fixtures under `tests/torch_port_fixtures/` that
`chip_smoke.py` checks on the card.

Tolerances: every decode is bit-equal to cv2's (IMREAD_UNCHANGED and
IMREAD_COLOR), and so is `bop.read_image` to the JAX package's; damaged
files read as cv2 reads them (tests/test_torch_port_damaged.py holds the
kinds of damage). What the decoder does not support raises UnsupportedImage
(a ValueError) naming the file.

The fixtures: JPEG encodings of frames of the `make_bop_dataset` tree that
chip_smoke's bop phase writes (`SyntheticPoseDataset(n_fg=15,
single_class=0, seed=0)`, train frames 1000 + j, test frames j; two of them
progressive), background JPEGs and PNGs (among them a progressive, a CMYK
and an EXIF-turned JPEG, a palette + tRNS and an Adam7 PNG), damaged copies
of some of them (`damaged/`, written by tests/test_torch_port_damaged.py),
and `manifest.json`: cv2's SHA-256 of every fixture under both reads (None
where cv2 gives None) and of each data-plane primitive case (`CASES`).
`write_fixtures`
makes them (`PYTHONPATH=. python tests/test_torch_port_jpeg.py` writes them
anew);
`test_the_committed_manifest_is_cv2s` recomputes the manifest with cv2 from
the committed files, so the digests the card is held to stay honest.
"""
import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from kd6d_pose_adlp_tpu.data import bop as jbop  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import bop as tbop  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import imread, jpeg, native, png  # noqa: E402
from test_torch_port_pool import one_torch_thread  # noqa: E402,F401 (autouse fixture)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_port_fixtures")
FIXTURE_BUDGET = 768 * 1024
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111,
            "411": 0x411111}

# (name, SyntheticPoseDataset index, quality, sampling, restart interval,
#  progressive)
FRAMES = (("frames/train_000000.jpg", 1000, 75, "420", 0, False),
          ("frames/train_000001.jpg", 1001, 75, "422", 0, False),
          ("frames/train_000002.jpg", 1002, 50, "444", 0, False),
          ("frames/train_000003.jpg", 1003, 75, "420", 0, True),
          ("frames/test_000000.jpg", 0, 75, "420", 4, False),
          ("frames/test_000001.jpg", 1, 75, "440", 0, False),
          ("frames/test_000002.jpg", 2, 60, "444", 5, True))
FRAME = "frames/train_000000.jpg"
# data-plane primitive cases: ops applied in turn to read_color(input)
CASES = tuple(
    [dict(input=FRAME, ops=[["bgr2hsv"]]),
     dict(input=FRAME, ops=[["bgr2hsv"], ["hsv2bgr"]])]
    + [dict(input=FRAME, ops=[["gaussian_blur7", s]]) for s in (0.0, -1.0, 0.37, 0.93)]
    + [dict(input=FRAME, ops=[["box_blur", k]]) for k in (5, 7, 9, 11)]
    + [dict(input=FRAME, ops=[["f32_affine", 0.37, -11.0], ["normalize_minmax"]]),
       dict(input=FRAME, ops=[["f32_affine", 0.0, 3.5], ["normalize_minmax"]]),
       dict(input=FRAME, ops=[["f64_affine", 0.63, 3.5], ["normalize_minmax"]]),
       dict(input="backgrounds/bg_0.jpg", ops=[["resize_linear", 640, 480]]),
       dict(input="backgrounds/bg_0.jpg", ops=[["resize_linear", 256, 256]]),
       dict(input="backgrounds/bg_1.jpg", ops=[["resize_linear", 640, 480]]),
       dict(input="backgrounds/bg_2.png", ops=[["resize_linear", 128, 128]]),
       dict(input="backgrounds/bg_3.png", ops=[["resize_linear", 333, 251]])])

CV2_OPS = {
    "bgr2hsv": lambda a: cv2.cvtColor(a, cv2.COLOR_BGR2HSV),
    "hsv2bgr": lambda a: cv2.cvtColor(a, cv2.COLOR_HSV2BGR),
    "gaussian_blur7": lambda a, s: cv2.GaussianBlur(a, (7, 7), s),
    "box_blur": lambda a, k: cv2.blur(a, (k, k)),
    "normalize_minmax": lambda a: cv2.normalize(a, None, alpha=0, beta=255,
                                                norm_type=cv2.NORM_MINMAX),
    "resize_linear": lambda a, w, h: cv2.resize(a, (w, h)),
    "f32_affine": lambda a, s, t: a.astype(np.float32) * np.float32(s) + np.float32(t),
    "f64_affine": lambda a, s, t: a.astype(np.float64) * s + t,
}


def digest(a: np.ndarray) -> str:
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype} {a.shape}".encode() + a.tobytes()).hexdigest()


def fixture_manifest(root: str, read, read_color, ops) -> dict:
    """{"files": {path: {"read", "read_color"}}, "cases": [...]} for the
    fixtures under `root`, by the given readers and primitives; a read
    that gives None (a damaged fixture cv2 cannot read) has the digest
    None."""
    files = {}
    for sub in ("frames", "backgrounds", "damaged"):
        if not os.path.isdir(os.path.join(root, sub)):
            continue
        for f in sorted(os.listdir(os.path.join(root, sub))):
            p = os.path.join(root, sub, f)
            got = read(p), read_color(p)
            files[f"{sub}/{f}"] = dict(zip(("read", "read_color"),
                                           (None if a is None else digest(a) for a in got)))
    cases = []
    for case in CASES:
        a = read_color(os.path.join(root, case["input"]))
        for op in case["ops"]:
            a = ops[op[0]](a, *op[1:])
        cases.append(dict(case, sha256=digest(a)))
    return dict(files=files, cases=cases)


def cv2_manifest(root: str) -> dict:
    return fixture_manifest(root, lambda p: cv2.imread(p, cv2.IMREAD_UNCHANGED), cv2.imread,
                            CV2_OPS)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def png_bytes(px, ctype, depth, interlace=0, palette=None, trns=None, rng=None,
              extra=b"") -> bytes:
    """A PNG written by hand: samples `px` ((H, W) or (H, W, C) in file
    order: RGB, grey + alpha, palette indices) of colour type `ctype` at
    `depth` bits, Adam7 when `interlace`, with PLTE / tRNS bodies and
    `extra` chunks after IHDR. With `rng` each row gets a random filter
    type over its raw bytes, so a reader's unfiltering is exercised (cv2
    and the port must undo the same filters)."""
    px = np.asarray(px)
    h, w = px.shape[:2]
    ch = PNG_CHANNELS[ctype]
    px = px.reshape(h, w, ch)

    def rows(p):
        ph, pw = p.shape[:2]
        if depth == 16:
            r = p.astype(">u2").reshape(ph, pw * ch).view(np.uint8)
        elif depth == 8:
            r = p.astype(np.uint8).reshape(ph, pw * ch)
        else:                                    # sub-byte samples, MSB first
            per = 8 // depth
            v = np.zeros((ph, -(-pw // per) * per), np.uint8)
            v[:, :pw] = p[:, :, 0]
            v = v.reshape(ph, -1, per)
            r = np.zeros(v.shape[:2], np.uint8)
            for i in range(per):
                r |= (v[:, :, i] << (8 - depth * (i + 1))).astype(np.uint8)
        kinds = rng.integers(0, 5, ph) if rng is not None else np.zeros(ph, int)
        return b"".join(bytes([int(kinds[y])]) + r[y].tobytes() for y in range(ph))

    if interlace:
        raw = b"".join(rows(px[y0::dy, x0::dx]) for x0, y0, dx, dy in ADAM7
                       if px[y0::dy, x0::dx].size)
    else:
        raw = rows(px)
    out = png.SIGNATURE + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                         interlace)) + extra
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += png_chunk(b"tRNS", trns)
    return out + png_chunk(b"IDAT", zlib.compress(raw)) + png_chunk(b"IEND", b"")


def with_exif(data: bytes, orientation: int) -> bytes:
    """A JPEG or PNG file's bytes with an EXIF block of one orientation: an
    APP1 segment after SOI, or an eXIf chunk after IHDR."""
    if data[:8] == png.SIGNATURE:
        return data[:33] + png_chunk(b"eXIf", _exif(orientation)[6:]) + data[33:]
    body = _exif(orientation)
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


def _smooth(rng, h, w, c):
    """Smooth colour fields: backgrounds that cost few bytes."""
    base = rng.integers(0, 256, (h // 40 + 2, w // 40 + 2, c)).astype(np.uint8)
    return cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC).reshape(h, w, c)


def write_fixtures(root: str = FIXTURES) -> dict:
    """Write the fixtures and their manifest under `root` (cv2 encodes and
    hashes)."""
    from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset

    for sub in ("frames", "backgrounds"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    ds = SyntheticPoseDataset(n_fg=15, single_class=0, seed=0)
    for name, index, quality, sampling, rst, progressive in FRAMES:
        img = ds.sample_internal(index)["img"][:, :, ::-1]
        ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img), [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
            cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
            cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
        assert ok
        with open(os.path.join(root, name), "wb") as f:
            f.write(buf.tobytes())
    rng = np.random.default_rng(17)
    bg = os.path.join(root, "backgrounds")
    # 1280x960: the slow path's 640x480 frame is an exact 2x downscale
    cv2.imwrite(os.path.join(bg, "bg_0.jpg"), _smooth(rng, 960, 1280, 3),
                [cv2.IMWRITE_JPEG_QUALITY, 75])
    cv2.imwrite(os.path.join(bg, "bg_1.jpg"), _smooth(rng, 240, 320, 1)[:, :, 0],
                [cv2.IMWRITE_JPEG_QUALITY, 90])
    bgra = np.concatenate([_smooth(rng, 150, 200, 3), _smooth(rng, 150, 200, 1)], axis=2)
    cv2.imwrite(os.path.join(bg, "bg_2.png"), bgra)
    cv2.imwrite(os.path.join(bg, "bg_3.png"), _smooth(rng, 96, 120, 3).astype(np.uint16) * 257)
    # progressive, CMYK and EXIF-turned JPEG, palette + tRNS and Adam7 PNG, from
    # their own generator so the older files keep their bytes
    from PIL import Image

    rng = np.random.default_rng(18)
    cv2.imwrite(os.path.join(bg, "bg_4.jpg"), _smooth(rng, 180, 240, 3),
                [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    bio = io.BytesIO()
    Image.fromarray(_smooth(rng, 90, 120, 4), "CMYK").save(bio, "JPEG", quality=85)
    with open(os.path.join(bg, "bg_5.jpg"), "wb") as f:
        f.write(bio.getvalue())
    pal = Image.fromarray(_smooth(rng, 100, 140, 3)).quantize(16)
    bio = io.BytesIO()
    pal.save(bio, "PNG", bits=4, transparency=3)
    with open(os.path.join(bg, "bg_6.png"), "wb") as f:
        f.write(bio.getvalue())
    with open(os.path.join(bg, "bg_7.png"), "wb") as f:
        f.write(png_bytes(_smooth(rng, 75, 101, 3), 2, 8, interlace=1, rng=rng))
    ok, buf = cv2.imencode(".jpg", _smooth(rng, 160, 96, 3), [cv2.IMWRITE_JPEG_QUALITY, 80])
    with open(os.path.join(bg, "bg_8.jpg"), "wb") as f:
        f.write(with_exif(buf.tobytes(), 6))
    manifest = cv2_manifest(root)
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------

def test_the_committed_manifest_is_cv2s():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        committed = json.load(f)
    assert cv2_manifest(FIXTURES) == committed
    port_ops = dict(CV2_OPS, bgr2hsv=native.bgr2hsv, hsv2bgr=native.hsv2bgr,
                    gaussian_blur7=native.gaussian_blur7, box_blur=native.box_blur,
                    normalize_minmax=native.normalize_minmax,
                    resize_linear=lambda a, w, h: native.resize_linear(a, (w, h)))
    assert fixture_manifest(FIXTURES, imread.read, imread.read_color, port_ops) == committed
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(FIXTURES)
                for f in fs)
    assert total <= FIXTURE_BUDGET, total
    assert {c["input"] for c in committed["cases"]} <= set(committed["files"])
    assert sorted(name for name, *_ in FRAMES) == sorted(f for f in committed["files"]
                                                         if f.startswith("frames/"))


# ---------------------------------------------------------------------------
# decoding against cv2
# ---------------------------------------------------------------------------

def _textured(rng, h, w, c=3):
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, c)).astype(np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC).reshape(h, w, c)
    img = np.clip(img.astype(int) + rng.integers(-30, 31, img.shape), 0, 255).astype(np.uint8)
    return img if c > 1 else img[:, :, 0]


def _both_reads_equal(tmp_path, data: bytes, name="a.jpg"):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    for got, flag in ((jpeg.read(p), cv2.IMREAD_UNCHANGED),
                      (imread.read_color(p), cv2.IMREAD_COLOR)):
        want = cv2.imread(p, flag)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape, (got.shape,
                                                                                 want.shape)
        np.testing.assert_array_equal(got, want)


SIZES = ((1, 1), (7, 9), (17, 33), (480, 640))


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_read_equals_cv2(tmp_path, quality, sampling):
    rng = np.random.default_rng(quality)
    for h, w in SIZES:
        for rst in (0, 2):
            ok, buf = cv2.imencode(".jpg", _textured(rng, h, w), [
                cv2.IMWRITE_JPEG_QUALITY, quality,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
            _both_reads_equal(tmp_path, buf.tobytes())


def test_grey_and_pil_optimized_tables_equal_cv2(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    for h, w in SIZES:
        for q in (50, 100):
            ok, buf = cv2.imencode(".jpg", _textured(rng, h, w, 1), [cv2.IMWRITE_JPEG_QUALITY, q])
            _both_reads_equal(tmp_path, buf.tobytes())
    for h, w in ((7, 9), (31, 45), (480, 640)):
        for subsampling in (0, 1, 2):              # PIL's 4:4:4, 4:2:2, 4:2:0
            bio = io.BytesIO()
            Image.fromarray(_textured(rng, h, w)[:, :, ::-1]).save(
                bio, "JPEG", quality=80, optimize=True, subsampling=subsampling)
            _both_reads_equal(tmp_path, bio.getvalue())
            bio = io.BytesIO()
            Image.fromarray(_textured(rng, h, w, 1)).save(bio, "JPEG", quality=70, optimize=True)
            _both_reads_equal(tmp_path, bio.getvalue())


def _segments(data: bytes):
    """(marker, start, end) of each marker segment before the first scan."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((data[pos + 1], pos, pos + 2 + n))
        pos += 2 + n
    return out


def test_colour_space_markers_equal_cv2(tmp_path):
    """Adobe APP14 transform 0 and the component ids 'R', 'G', 'B' read as
    RGB without conversion; Adobe transform 1 as YCbCr."""
    rng = np.random.default_rng(5)
    ok, buf = cv2.imencode(".jpg", _textured(rng, 24, 40), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]])
    data = buf.tobytes()
    app0 = [(s, e) for m, s, e in _segments(data) if m == 0xE0]
    assert app0
    s, e = app0[0]
    for transform in (0, 1):
        adobe = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes([0, 100, 0, 0, 0, 0,
                                                                         transform])
        _both_reads_equal(tmp_path, data[:s] + adobe + data[e:])
    no_jfif = bytearray(data[:s] + data[e:])
    sof = [(st, en) for m, st, en in _segments(bytes(no_jfif)) if m == 0xC0][0][0]
    for k, cid in enumerate(b"RGB"):             # SOF component ids, then the SOS's
        assert no_jfif[sof + 10 + 3 * k] == k + 1
        no_jfif[sof + 10 + 3 * k] = cid
    sos = bytes(no_jfif).index(b"\xff\xda")
    for k, cid in enumerate(b"RGB"):
        assert no_jfif[sos + 5 + 2 * k] == k + 1
        no_jfif[sos + 5 + 2 * k] = cid
    _both_reads_equal(tmp_path, bytes(no_jfif))


def _exif(orientation: int) -> bytes:
    tiff = (b"II*\x00" + struct.pack("<IH", 8, 1) + struct.pack("<HHI", 0x0112, 3, 1)
            + struct.pack("<HHI", orientation, 0, 0))
    return b"Exif\x00\x00" + tiff


def test_exif_orientation(tmp_path):
    rng = np.random.default_rng(6)
    ok, buf = cv2.imencode(".jpg", _textured(rng, 16, 24))
    data = buf.tobytes()
    for o in (1, 6):
        body = _exif(o)
        p = str(tmp_path / f"o{o}.jpg")
        with open(p, "wb") as f:
            f.write(data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:])
        np.testing.assert_array_equal(jpeg.read(p), cv2.imread(p, cv2.IMREAD_UNCHANGED))
        if o == 6:
            assert cv2.imread(p).shape == (24, 16, 3)     # cv2 turns it, and so does the port
        np.testing.assert_array_equal(imread.read_color(p), cv2.imread(p))
    # a PNG's eXIf chunk turns it too
    p = str(tmp_path / "o6.png")
    cv2.imwrite(p, _textured(rng, 16, 24))
    with open(p, "rb") as f:
        data = f.read()
    with open(p, "wb") as f:
        f.write(with_exif(data, 6))
    assert cv2.imread(p).shape == (24, 16, 3)
    np.testing.assert_array_equal(imread.read_color(p), cv2.imread(p))
    np.testing.assert_array_equal(imread.read(p), cv2.imread(p, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("kind", ["bgr8", "grey8", "bgra8", "greyalpha8", "bgr16", "grey16"])
def test_read_color_of_png_equals_cv2(tmp_path, kind):
    rng = np.random.default_rng(len(kind))
    p = str(tmp_path / "a.png")
    if kind == "greyalpha8":                     # cv2 writes no grey + alpha: by hand
        ga = rng.integers(0, 256, (5, 6, 2), dtype=np.uint8)
        import zlib
        raw = b"".join(b"\0" + ga[y].tobytes() for y in range(5))

        def chunk(k, d):
            return struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))
        with open(p, "wb") as f:
            f.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", 6, 5, 8, 4, 0, 0, 0))
                    + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    else:
        shape = {"bgr8": (9, 11, 3), "grey8": (9, 11), "bgra8": (9, 11, 4),
                 "bgr16": (9, 11, 3), "grey16": (9, 11)}[kind]
        dtype = np.uint16 if kind.endswith("16") else np.uint8
        cv2.imwrite(p, rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype))
    got, want = imread.read_color(p), cv2.imread(p)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_unsupported_files_raise_naming_the_file(tmp_path):
    """Damaged files that once raised read as cv2 reads them (libjpeg's
    recovery: a progressive file smoothed where its last scans are missing,
    cut data padded with a fake EOI); arithmetic-coded, lossless and 12-bit
    frames and other formats still raise UnsupportedImage naming the file."""
    rng = np.random.default_rng(7)
    img = _textured(rng, 32, 48)
    ok, base = cv2.imencode(".jpg", img)
    base = base.tobytes()
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    prog = prog.tobytes()
    # cut before its last scan, the final refinement of the luma AC bands,
    # and closed by EOI: libjpeg smooths the blocks
    last_scan = prog.rindex(b"\xff\xda")
    sof = [s for m, s, _ in _segments(base) if m == 0xC0][0]

    def sof_patched(marker=None, precision=None):
        d = bytearray(base)
        if marker is not None:
            d[sof + 1] = marker
        if precision is not None:
            d[sof + 4] = precision
        return bytes(d)

    recovered = {"smoothing": prog[:last_scan] + b"\xff\xd9",
                 "truncated_progressive": prog[:len(prog) // 2],
                 "truncated": base[:len(base) // 2],
                 "no_eoi": base[:-2]}
    for name, data in recovered.items():
        p = str(tmp_path / f"{name}.jpg")
        with open(p, "wb") as f:
            f.write(data)
        for got, flag in ((jpeg.read(p), cv2.IMREAD_UNCHANGED),
                          (imread.read_color(p), cv2.IMREAD_COLOR)):
            want = cv2.imread(p, flag)
            assert want is not None and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(tbop.read_image(p), jbop.read_image(p), err_msg=name)
    cases = {"arithmetic": (sof_patched(marker=0xC9), "arithmetic"),
             "lossless": (sof_patched(marker=0xC3), "lossless"),
             "12bit": (sof_patched(precision=12), "12-bit"),
             "not_a_jpeg": (b"GIF89a" + base[6:], "not a JPEG")}
    for name, (data, what) in cases.items():
        p = str(tmp_path / f"{name}.jpg")
        with open(p, "wb") as f:
            f.write(data)
        for read in (jpeg.read, imread.read_color, tbop.read_image):
            with pytest.raises(native.UnsupportedImage,
                               match=f"{name}.jpg.*{what}|{what}.*{name}.jpg"
                               if name != "not_a_jpeg" else f"{name}.jpg"):
                read(p)


def test_read_image_on_jpeg_frames_equals_jax(tmp_path):
    rng = np.random.default_rng(8)
    for name, img in (("c.jpg", _textured(rng, 48, 64)), ("g.jpg", _textured(rng, 48, 64, 1)),
                      ("png_named.jpg", None)):
        p = str(tmp_path / name)
        if img is None:                          # a PNG with a .jpg name: by signature
            cv2.imwrite(str(tmp_path / "x.png"), _textured(rng, 8, 8))
            os.replace(str(tmp_path / "x.png"), p)
        else:
            cv2.imwrite(p, img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        got, want = tbop.read_image(p), jbop.read_image(p)
        assert got.shape == want.shape == (got.shape[0], got.shape[1], 3)
        np.testing.assert_array_equal(got, want)
        assert not got.flags.writeable


if __name__ == "__main__":
    m = write_fixtures()
    print(f"wrote {len(m['files'])} fixtures and {len(m['cases'])} cases under {FIXTURES}")
