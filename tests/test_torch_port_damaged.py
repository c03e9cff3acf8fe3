"""PyTorch port, damaged image files (`data/imread.py` over `csrc/jpeg.cpp`
and `data/png.py`) against `cv2.imread` on the file, and the BOP pipeline on
a tree with a damaged frame, mask and background against the JAX package,
which reads every image with cv2.imread and treats its None as a skip.

Tolerances: every read of a damaged file equals cv2's bit for bit under
IMREAD_UNCHANGED and IMREAD_COLOR (dtype and shape included), or gives None
where cv2 gives None; UnsupportedImage is raised only for the kinds the
port does not decode (arithmetic-coded, lossless or 12-bit JPEG, another
format by its signature), even where a mutation makes one. On the damaged
tree, `read_image`, `get_single_bop_annotation` and the background bank are
bit-equal to JAX's (a FileNotFoundError where JAX raises one), samples
slow and fast, train and eval, match as in tests/test_torch_port_bop.py
(None included), and the loader's epoch yields JAX's frames.

`write_damaged_fixtures` derives the committed damaged fixtures
(`tests/torch_port_fixtures/damaged/`, each under 20 KB) from the committed
frames and backgrounds with a seed, and rewrites the manifest with cv2's
digests (`PYTHONPATH=. python tests/test_torch_port_damaged.py`).
"""
import os
import shutil
import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from kd6d_pose_adlp_tpu.data import bop as jbop  # noqa: E402
from kd6d_pose_adlp_tpu.data import pipeline as jpipe  # noqa: E402
from kd6d_pose_adlp_tpu.data import transforms as JT  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import bop as tbop  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import imread, native  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import pipeline as tpipe  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import transforms as TT  # noqa: E402
from test_torch_port_bop import _assert_samples_match, _cfg_pair, _cv2_tree  # noqa: E402
from test_torch_port_jpeg import (  # noqa: E402
    FIXTURES, SAMPLING, _segments, _textured, cv2_manifest, png_bytes, png_chunk)
from test_torch_port_pool import one_torch_thread  # noqa: E402,F401 (autouse fixture)

DAMAGED = os.path.join(FIXTURES, "damaged")
# what a read may still raise UnsupportedImage for: the three JPEG processes,
# and a signature cv2 reads and the port does not decode (every format but
# PNG, JPEG and TIFF, which test_torch_port_rasters.py holds to cv2)
UNSUPPORTED = ("arithmetic", "lossless", "12-bit", "a format cv2 reads and the port does not")


def _write(tmp_path, data: bytes, name: str) -> str:
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return p


def _same_as_cv2(path: str):
    """Both reads of `path` against cv2.imread's; returns cv2's
    IMREAD_UNCHANGED read (None where it gives None)."""
    for color, flag in ((False, cv2.IMREAD_UNCHANGED), (True, cv2.IMREAD_COLOR)):
        want, got = cv2.imread(path, flag), imread.read(path, color=color)
        if want is None:
            assert got is None, (path, flag, got.shape)
            continue
        assert got is not None, (path, flag, want.shape)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), (path, flag)
        np.testing.assert_array_equal(got, want, err_msg=f"{path} flag {flag}")
    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


def _jpeg(img, progressive=False, rst=0, sampling="420", quality=75) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                                         cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    return buf.tobytes()


def _first_scan(data: bytes):
    """(start of the first SOS, end of its entropy-coded data)."""
    sos = data.index(b"\xff\xda")
    p = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    while not (data[p] == 0xFF and data[p + 1] not in (0, 0xFF, *range(0xD0, 0xD8))):
        p += 1
    return sos, p


# --- a baseline file of one scan per component, which cv2 does not write ---

ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
          27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
          44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)


def _std_dht() -> bytes:
    """The DHT segments of cv2's encoder (the standard tables of K.3)."""
    data = _jpeg(np.zeros((8, 8, 3), np.uint8), quality=50)
    return b"".join(data[s:e] for m, s, e in _segments(data) if m == 0xC4)


def _huffman_codes(dht: bytes, tc: int) -> dict:
    """{symbol: (code, length)} of table class/id byte `tc` in `dht`."""
    p = 0
    while p < len(dht):
        n = struct.unpack(">H", dht[p + 2:p + 4])[0]
        q, end = p + 4, p + 2 + n
        while q < end:
            bits, count = dht[q + 1:q + 17], sum(dht[q + 1:q + 17])
            if dht[q] == tc:
                vals, codes, code, k = dht[q + 17:q + 17 + count], {}, 0, 0
                for length in range(1, 17):
                    for _ in range(bits[length - 1]):
                        codes[vals[k]] = (code, length)
                        code, k = code + 1, k + 1
                    code <<= 1
                return codes
            q += 17 + count
        p = end
    raise KeyError(tc)


def sequential_scans_jpeg(ycc: np.ndarray, q: int = 6) -> bytes:
    """A baseline JPEG of the (H, W, 3) YCbCr image `ycc` at 4:4:4 with one
    scan per component (non-interleaved), a flat quantizer `q` and the
    standard Huffman tables (table 0 for every component)."""
    h, w = ycc.shape[:2]
    bw, bh = -(-w // 8), -(-h // 8)
    pix = np.pad(ycc.astype(np.float64) - 128, ((0, 8 * bh - h), (0, 8 * bw - w), (0, 0)),
                 mode="edge")
    x = np.arange(8)
    m = np.cos((2 * x[None, :] + 1) * x[:, None] * np.pi / 16) * np.where(
        x[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    dht = _std_dht()
    dc, ac = _huffman_codes(dht, 0x00), _huffman_codes(dht, 0x10)
    out = (b"\xff\xd8" + b"\xff\xdb" + struct.pack(">HB", 67, 0) + bytes([q] * 64)
           + b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, h, w, 3)
           + b"".join(bytes([c + 1, 0x11, 0]) for c in range(3)) + dht)
    for c in range(3):
        acc, n, buf, pred = 0, 0, bytearray(), 0

        def put(code, length):
            nonlocal acc, n
            acc, n = (acc << length) | code, n + length
            while n >= 8:
                byte = (acc >> (n - 8)) & 0xFF
                buf.extend(b"\xff\x00" if byte == 0xFF else bytes([byte]))
                n -= 8

        def value(table, sym, v):
            s = int(abs(v)).bit_length()
            put(*table[sym | s])
            if s:
                put(v if v >= 0 else v + (1 << s) - 1, s)

        for by in range(bh):
            for bx in range(bw):
                f = np.round(m @ pix[8 * by:8 * by + 8, 8 * bx:8 * bx + 8, c] @ m.T / q)
                z = [int(f.flat[ZIGZAG[k]]) for k in range(64)]
                value(dc, 0, z[0] - pred)
                pred, run = z[0], 0
                for v in z[1:]:
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        put(*ac[0xF0])
                        run -= 16
                    value(ac, run << 4, v)
                    run = 0
                if run:
                    put(*ac[0x00])
        if n:
            put((1 << (8 - n)) - 1, 8 - n)
        out += b"\xff\xda" + struct.pack(">HBBBBBB", 8, 1, c + 1, 0x00, 0, 63, 0) + bytes(buf)
    return out + b"\xff\xd9"


# ---------------------------------------------------------------------------
# each kind of damage against cv2.imread
# ---------------------------------------------------------------------------

def _kind_files(kind: str, rng) -> list:
    """[(file name, bytes)] of one kind of damage."""
    img = _textured(rng, 64, 96)
    base, prog = _jpeg(img), _jpeg(img, progressive=True)
    n, m = len(base), len(prog)
    if kind == "baseline_cut":
        return [(f"cut{f}.jpg", base[:n * f // 100]) for f in (30, 50, 70, 90)]
    if kind == "no_eoi":
        return [("base.jpg", base[:-2]), ("prog.jpg", prog[:-2])]
    if kind == "progressive_cut":
        return [(f"cut{f}.jpg", prog[:m * f // 100]) for f in (30, 50, 70, 90)]
    if kind == "zeros_before_eoi":
        return [("base.jpg", base[:-2] + bytes(10) + base[-2:]),
                ("prog.jpg", prog[:-2] + bytes(10) + prog[-2:])]
    if kind == "flipped_entropy_byte":
        return [(f"{name}.jpg", d[:len(d) // 2] + bytes([d[len(d) // 2] ^ 0x5A])
                 + d[len(d) // 2 + 1:]) for name, d in (("base", base), ("prog", prog))]
    if kind == "restart_marker":
        out = []
        for progressive in (False, True):
            d = _jpeg(img, progressive=progressive, rst=2)
            rst = [i for i in range(len(d) - 1) if d[i] == 0xFF and 0xD0 <= d[i + 1] <= 0xD7]
            j = rst[len(rst) // 2]
            for delta in (1, 2, 4, -1):
                out.append((f"p{int(progressive)}_{delta}.jpg", d[:j + 1]
                            + bytes([0xD0 + ((d[j + 1] - 0xD0 + delta) & 7)]) + d[j + 2:]))
            out.append((f"p{int(progressive)}_missing.jpg", d[:j] + d[j + 2:]))
        return out
    if kind == "bad_huffman_code":
        # a run of all-one bits (FF 00 pairs): codes longer than 16 bits
        return [(f"{name}.jpg", d[:len(d) // 2] + b"\xff\x00" * 8 + d[len(d) // 2:])
                for name, d in (("base", base), ("prog", prog))]
    if kind == "sequential_scans_cut":
        ycc = cv2.cvtColor(img, cv2.COLOR_BGR2YCrCb)[:, :, [0, 2, 1]]
        d = sequential_scans_jpeg(ycc)
        scans = [i for i in range(len(d) - 1) if d[i:i + 2] == b"\xff\xda"]
        return [("whole.jpg", d), ("two_scans.jpg", d[:scans[2]] + b"\xff\xd9"),
                ("one_scan.jpg", d[:scans[1]]), ("half_a_scan.jpg", d[:scans[1] // 2 + 300])]
    if kind == "progressive_without_dc_scan":
        sos, end = _first_scan(prog)
        return [("no_dc.jpg", prog[:sos] + prog[end:])]
    if kind == "header_cut":
        return [(f"cut{k}.jpg", base[:k]) for k in (4, 30, 100, 160, 300)]
    if kind == "header_errors":
        sof = [s for mk, s, _ in _segments(base) if mk == 0xC0][0]
        return [("two_soi.jpg", base[:sof] + b"\xff\xd8" + base[sof:]),
                ("unknown_marker.jpg", base[:sof] + b"\xff\x02\x00\x04ab" + base[sof:]),
                ("hierarchical.jpg", base[:sof + 1] + b"\xc5" + base[sof + 2:]),
                ("zero_height.jpg", base[:sof + 5] + b"\x00\x00" + base[sof + 7:])]
    px = rng.integers(0, 256, (16, 20, 3))
    png = png_bytes(px, 2, 8, rng=rng)
    idat = png.index(b"IDAT") - 4
    iend = png.index(b"IEND") - 4
    if kind == "png_cut":
        return [("idat.png", png[:idat + 40]), ("no_iend.png", png[:iend]),
                ("iend.png", png[:iend + 6]), ("signature.png", png[:8])]
    if kind == "png_crc":
        bad = bytearray(png)
        bad[iend - 1] ^= 1                        # IDAT's CRC
        text = png_chunk(b"tEXt", b"k\0v")
        return [("idat.png", bytes(bad)),
                ("text.png", png[:33] + text[:-1] + bytes([text[-1] ^ 1]) + png[33:]),
                ("iend.png", png[:-1] + bytes([png[-1] ^ 1]))]
    if kind == "png_trns_dropped":
        return [("with_alpha.png", png_bytes(rng.integers(0, 256, (4, 5, 4)), 6, 8,
                                             trns=b"\0\1\0\2\0\3")),
                ("long.png", png_bytes(rng.integers(0, 2, (4, 5)), 3, 1,
                                       palette=[[1, 2, 3], [4, 5, 6]], trns=b"\1\2\3")),
                ("out_of_range.png", png_bytes(rng.integers(0, 4, (4, 5)), 0, 2,
                                               trns=struct.pack(">H", 4)))]
    if kind == "png_no_plte":
        return [("no_plte.png", png_bytes(rng.integers(0, 2, (4, 5)), 3, 1))]
    if kind == "png_zlib":
        body = zlib.compress(bytes(16 * 61))
        return [("bad_adler.png", png[:idat] + png_chunk(b"IDAT", body[:-1] + bytes([body[-1] ^ 1]))
                 + png[iend:]),
                ("unended.png", png[:idat] + png_chunk(b"IDAT", body[:-4]) + png[iend:])]
    if kind == "empty":
        return [("empty.jpg", b""), ("empty.png", b""), ("text.jpg", b"not an image at all")]
    raise KeyError(kind)


# kind -> what cv2.imread gives: an image for every file, None for every file
KINDS = {"baseline_cut": "image", "no_eoi": "image", "progressive_cut": "image",
         "zeros_before_eoi": "image", "flipped_entropy_byte": "image",
         "restart_marker": "image", "bad_huffman_code": "image",
         "sequential_scans_cut": "image", "progressive_without_dc_scan": "image",
         "header_cut": None, "header_errors": None, "png_cut": None, "png_crc": "idat.png",
         "png_trns_dropped": "image", "png_no_plte": None, "png_zlib": None, "empty": None}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_damage_reads_as_cv2_reads_it(tmp_path, kind):
    """Each kind of damage reads as cv2.imread reads the file, and cv2 gives
    the image (libjpeg or libpng recovers) or None (it stops) as listed."""
    for name, data in _kind_files(kind, np.random.default_rng(sorted(KINDS).index(kind))):
        want = _same_as_cv2(_write(tmp_path, data, name))
        expect = KINDS[kind]
        if expect not in ("image", None):        # None only for the file named
            expect = None if name == expect else "image"
        assert (want is None) == (expect is None), (kind, name)
    if kind == "png_trns_dropped":
        shapes = [imread.read(str(tmp_path / n)).shape for n in
                  ("with_alpha.png", "long.png", "out_of_range.png")]
        assert shapes == [(4, 5, 4), (4, 5, 3), (4, 5)]


def _mutate(rng, data: bytes) -> bytes:
    p = int(rng.integers(0, len(data)))
    kind = int(rng.integers(5))
    if kind == 0:
        return data[:p]
    if kind == 1:
        return data[:p] + bytes([int(rng.integers(256))]) + data[p + 1:]
    if kind == 2:
        return data[:p] + bytes([data[p] ^ (1 << int(rng.integers(8)))]) + data[p + 1:]
    k = int(rng.integers(1, 17))
    if kind == 3:
        ins = bytes(k) if rng.random() < 0.5 else bytes(rng.integers(0, 256, k).astype(np.uint8))
        return data[:p] + ins + data[p:]
    return data[:p] + data[p + k:]


SWEEP = ("baseline", "restart", "progressive", "progressive_restart", "444", "png")


@pytest.mark.parametrize("source", SWEEP)
def test_mutation_sweep_equals_cv2(tmp_path, source):
    """50 seeded mutations (cuts, byte and bit flips, inserted and deleted
    bytes) of each source, 300 in all: every one reads as cv2 reads it, and
    UnsupportedImage only for a kind the port does not decode."""
    rng = np.random.default_rng(SWEEP.index(source) + 190)
    img = _textured(rng, 40, 56)
    data = {"baseline": lambda: _jpeg(img),
            "restart": lambda: _jpeg(img, rst=1, sampling="422"),
            "progressive": lambda: _jpeg(img, progressive=True),
            "progressive_restart": lambda: _jpeg(img, progressive=True, rst=2, sampling="444"),
            "444": lambda: _jpeg(img, sampling="444", quality=90),
            # a long comment: damage there drops the chunk and keeps the image
            "png": lambda: png_bytes(img[:, :, ::-1], 2, 8, rng=rng, extra=png_chunk(
                b"tEXt", b"Comment\0" + bytes(rng.integers(32, 127, 4000).astype(np.uint8))))
            }[source]()
    name = "m.png" if source == "png" else "m.jpg"
    decoded = none = unsupported = 0
    for _ in range(50):
        p = _write(tmp_path, _mutate(rng, data), name)
        try:
            decoded += _same_as_cv2(p) is not None
            none += cv2.imread(p, cv2.IMREAD_UNCHANGED) is None
        except native.UnsupportedImage as e:
            assert any(what in str(e) for what in UNSUPPORTED), str(e)
            unsupported += 1
    print(f"{source}: {decoded} decoded, {none} None, {unsupported} unsupported")
    assert decoded + none + unsupported == 50


# ---------------------------------------------------------------------------
# the committed damaged fixtures
# ---------------------------------------------------------------------------

def write_damaged_fixtures(root: str = FIXTURES) -> dict:
    """Derive the damaged fixtures from the committed ones (cuts at fixed
    fractions, flips and a wrong restart marker at seeded positions in the
    entropy-coded data) and rewrite the manifest with cv2's digests."""
    import json

    def src(rel):
        with open(os.path.join(root, rel), "rb") as f:
            return f.read()

    rng = np.random.default_rng(19)
    out = {"train_000000_cut.jpg": src("frames/train_000000.jpg")[:14700],
           "train_000003_cut.jpg": src("frames/train_000003.jpg")[:19000],
           "empty.jpg": b"",
           "bg_0_cut.jpg": src("backgrounds/bg_0.jpg")[:18500],
           "bg_7_cut.png": src("backgrounds/bg_7.png")[:10000]}
    d = bytearray(src("frames/test_000000.jpg")[:17500])
    rst = [i for i in range(8000, len(d) - 1) if d[i] == 0xFF and 0xD0 <= d[i + 1] <= 0xD7]
    j = rst[int(rng.integers(len(rst)))]
    d[j + 1] = 0xD0 + ((d[j + 1] - 0xD0 + 2) & 7)
    out["test_000000_rst_cut.jpg"] = bytes(d)
    # three bits flipped in the data of the last scan (the final luma
    # refinement), none making or breaking an FF byte
    d = bytearray(src("backgrounds/bg_4.jpg"))
    last = bytes(d).rindex(b"\xff\xda")
    start = last + 2 + struct.unpack(">H", d[last + 2:last + 4])[0]
    flips = 0
    while flips < 3:
        p, bit = int(rng.integers(start + 1, len(d) - 2)), 1 << int(rng.integers(7))
        if 0xFF not in (d[p - 1], d[p], d[p] ^ bit):
            d[p] ^= bit
            flips += 1
    out["bg_4_flipped.jpg"] = bytes(d)
    os.makedirs(os.path.join(root, "damaged"), exist_ok=True)
    for name, data in out.items():
        with open(os.path.join(root, "damaged", name), "wb") as f:
            f.write(data)
    manifest = cv2_manifest(root)
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def test_the_damaged_fixtures_are_derived_and_small(tmp_path):
    """The committed damaged fixtures are what `write_damaged_fixtures`
    derives from the committed frames and backgrounds, each under 20 KB,
    and the manifest's None digests are exactly where cv2 gives None."""
    import json

    shutil.copytree(FIXTURES, str(tmp_path / "f"))
    shutil.rmtree(str(tmp_path / "f" / "damaged"))
    manifest = write_damaged_fixtures(str(tmp_path / "f"))
    names = sorted(os.listdir(DAMAGED))
    assert names == sorted(os.listdir(str(tmp_path / "f" / "damaged"))) and len(names) == 7
    for name in names:
        with open(os.path.join(DAMAGED, name), "rb") as f, \
                open(str(tmp_path / "f" / "damaged" / name), "rb") as g:
            assert f.read() == g.read(), name
        assert os.path.getsize(os.path.join(DAMAGED, name)) < 20 * 1024
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        assert json.load(f) == manifest
    nones = sorted(rel for rel, v in manifest["files"].items() if v["read"] is None)
    assert nones == ["damaged/bg_7_cut.png", "damaged/empty.jpg"]
    for rel in manifest["files"]:
        if rel.startswith("damaged/"):
            _same_as_cv2(os.path.join(FIXTURES, rel))


# ---------------------------------------------------------------------------
# the BOP pipeline on a damaged tree against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def damaged_tree(tmp_path_factory):
    """A cv2-written tree of 4 frames with two objects each (as
    tests/test_torch_port_bop.py's), damaged: frame 0's second mask cut
    inside IDAT, frame 1 a baseline JPEG cut short, frame 2 an empty PNG,
    frame 3 a progressive JPEG cut short; beside it a background directory
    of the committed backgrounds and damaged ones (cut, flipped, empty)."""
    base = tmp_path_factory.mktemp("damaged_bop")
    lst = _cv2_tree(base / "tree", 4, 2, seed=9)
    scene = base / "tree" / "train" / "000001"
    mask = scene / "mask_visib" / "000000_000001.png"
    mask.write_bytes(mask.read_bytes()[:60])
    for j, progressive in ((1, False), (3, True)):
        png = scene / "rgb" / f"{j:06d}.png"
        data = _jpeg(cv2.imread(str(png)), progressive=progressive, quality=90)
        (scene / "rgb" / f"{j:06d}.jpg").write_bytes(data[:len(data) * 11 // 20])
        png.unlink()
    (scene / "rgb" / "000002.png").write_bytes(b"")
    names = ["000000.png", "000001.jpg", "000002.png", "000003.jpg"]
    lst.write_text("\n".join(f"train/000001/rgb/{n}" for n in names))
    bg = base / "bg"
    bg.mkdir()
    for f in ("bg_1.jpg", "bg_4.jpg", "bg_6.png"):
        shutil.copy(os.path.join(FIXTURES, "backgrounds", f), bg / f)
    for f in sorted(os.listdir(DAMAGED)):
        shutil.copy(os.path.join(DAMAGED, f), bg / f)
    return dict(damaged=lst, bg=str(bg), frames=[str(scene / "rgb" / n) for n in names])


def test_frames_masks_and_backgrounds_match_jax(damaged_tree):
    for p in damaged_tree["frames"]:
        try:
            want = jbop.read_image(p)
        except FileNotFoundError:
            with pytest.raises(FileNotFoundError):
                tbop.read_image(p)
            continue
        np.testing.assert_array_equal(tbop.read_image(p), want, err_msg=p)
    assert not os.path.getsize(damaged_tree["frames"][2])
    obj2cls = {"1": 0}
    for p in damaged_tree["frames"]:
        got, want = tbop.get_single_bop_annotation(p, obj2cls), \
            jbop.get_single_bop_annotation(p, obj2cls)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=p)
    assert len(tbop.get_single_bop_annotation(damaged_tree["frames"][0], obj2cls)[2]) == 1
    port, jax_bank = TT.BackgroundBank(damaged_tree["bg"]), JT.BackgroundBank(damaged_tree["bg"])
    assert port.files == jax_bank.files
    img = np.random.default_rng(1).integers(0, 256, (120, 160, 3), dtype=np.uint8)
    mask = np.zeros((120, 160), np.int32)
    mask[30:60, 40:80] = 1
    for seed in range(40):
        r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(port(img, mask, r_port), jax_bank(img, mask, r_jax))
        assert r_port.bit_generator.state == r_jax.bit_generator.state


@pytest.mark.parametrize("fast", [False, True], ids=["slow", "fast"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_samples_on_the_damaged_tree_match_jax(damaged_tree, fast, train):
    solver = dict(aug_background_dir=damaged_tree["bg"]) if train else {}
    jc, tc = _cfg_pair(damaged_tree, "damaged", fast, **solver)
    jds = jpipe.BOPPoseDataset(jc, jc.data.train_list, train=train)
    tds = tpipe.BOPPoseDataset(tc, tc.data.train_list, train=train)
    nones = []
    for seed in (1, 2, 3):
        for idx in range(4):
            got, want = tds.sample(idx, seed=seed), jds.sample(idx, seed=seed)
            _assert_samples_match(got, want, train)
            if got is None:
                nones.append(idx)
    assert set(nones) == {2}                    # the empty frame only


def test_the_loader_finishes_its_epoch_as_jax(damaged_tree):
    jc, tc = _cfg_pair(damaged_tree, "damaged")
    for train in (False, True):
        jds = jpipe.BOPPoseDataset(jc, jc.data.train_list, train=train)
        tds = tpipe.BOPPoseDataset(tc, tc.data.train_list, train=train)
        jl = jpipe.PrefetchLoader(jds, 2, train=train, num_threads=1, seed=3)
        tl = tpipe.PrefetchLoader(tds, 2, train=train, num_threads=1, seed=3)
        jit, tit = iter(jl), iter(tl)
        n = 0
        for (tb, tm), (jb, jm) in zip(tit, jit):
            assert [m["filename"] for m in tm] == [m["filename"] for m in jm]
            np.testing.assert_array_equal(tb.class_ids.numpy(), jb.class_ids)
            n += 1
            if train and n == 4:                 # past the epoch of 4 frames
                break
        tit.close()
        jit.close()
        assert n == (4 if train else 2)


if __name__ == "__main__":
    m = write_damaged_fixtures()
    print(f"wrote {sum(r.startswith('damaged/') for r in m['files'])} damaged fixtures under "
          f"{os.path.join(FIXTURES, 'damaged')}")
