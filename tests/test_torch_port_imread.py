"""PyTorch port, the rest of `cv2.imread` on the files the JAX package reads
(`data/imread.py` over `data/png.py` and `csrc/jpeg.cpp`): progressive JPEG,
CMYK and YCCK JPEG, palette, sub-8-bit, tRNS and Adam7 PNG, and EXIF
orientations 2-8, against this machine's cv2 (libjpeg-turbo and libpng) on
files encoded in the test by cv2, PIL and by hand; then `bop.read_image`,
`BackgroundBank` and `BOPPoseDataset.sample` on such files against the JAX
package's, which reads them with cv2.

Tolerances: every decode is bit-equal to cv2's under IMREAD_UNCHANGED
(`imread.read`) and IMREAD_COLOR (`imread.read_color`), dtype and shape
included; `read_image` and the background bank are bit-equal to JAX's;
samples, slow and fast, have equal images and masks, and the poses of
tests/test_torch_port_bop.py (R atol 1e-6, T rtol 1e-6, bbox_trans atol
1e-4: EPnP's ~1e-13 difference from cv2 may flip a float32 rounding).
The chunks that libpng only warns of and drops read as if absent, as in
cv2 (tests/test_torch_port_damaged.py holds the damaged files).
"""
import dataclasses
import io
import os
import shutil
import struct

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
from kd6d_pose_adlp_tpu_torch.data import imread, jpeg, native  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import pipeline as tpipe  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import transforms as TT  # noqa: E402
from test_torch_port_jpeg import (  # noqa: E402
    FIXTURES, PNG_CHANNELS, SAMPLING, _segments, _textured, png_bytes, with_exif)
from test_torch_port_pool import one_torch_thread  # noqa: E402,F401 (autouse fixture)

SIZES = ((1, 1), (7, 9), (37, 53), (480, 640))
# (H, W) for PNGs: Adam7 passes are empty below 8 pixels on a side
PNG_SIZES = ((1, 1), (3, 5), (7, 6), (13, 17), (37, 53))


def _write(tmp_path, data: bytes, name: str) -> str:
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return p


def _equals_cv2(tmp_path, data: bytes, name: str = "a.jpg"):
    """Both reads of the file `data` bit-equal to cv2's; returns the
    IMREAD_UNCHANGED read."""
    p = _write(tmp_path, data, name)
    reads = [(imread.read(p), cv2.IMREAD_UNCHANGED), (imread.read_color(p), cv2.IMREAD_COLOR)]
    if data[:3] == jpeg.SIGNATURE:
        reads.append((jpeg.read(p), cv2.IMREAD_UNCHANGED))
    for got, flag in reads:
        want = cv2.imread(p, flag)
        assert want is not None
        assert (got.dtype, got.shape) == (want.dtype, want.shape), (name, flag, got.dtype,
                                                                     got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} flag {flag}")
    return reads[0][0]


def _pil(img, fmt="JPEG", mode=None, **kw) -> bytes:
    from PIL import Image

    bio = io.BytesIO()
    Image.fromarray(img, mode).save(bio, fmt, **kw)
    return bio.getvalue()


# ---------------------------------------------------------------------------
# JPEG: progressive, CMYK, YCCK
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_progressive_equals_cv2(tmp_path, quality, sampling):
    rng = np.random.default_rng(quality + int(sampling))
    for h, w in SIZES:
        for rst in (0, 2):
            ok, buf = cv2.imencode(".jpg", _textured(rng, h, w), [
                cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
            data = buf.tobytes()
            assert any(m == 0xC2 for m, _, _ in _segments(data))
            _equals_cv2(tmp_path, data)


def test_pil_progressive_optimized_equals_cv2(tmp_path):
    """PIL's progressive files with optimized Huffman tables (a DHT before
    each scan), colour at 4:4:4, 4:2:2, 4:2:0, and grey."""
    rng = np.random.default_rng(11)
    for h, w in ((7, 9), (37, 53), (480, 640)):
        for subsampling in (0, 1, 2):
            _equals_cv2(tmp_path, _pil(_textured(rng, h, w)[:, :, ::-1], quality=80,
                                       progressive=True, optimize=True,
                                       subsampling=subsampling))
        _equals_cv2(tmp_path, _pil(_textured(rng, h, w, 1), quality=70, progressive=True,
                                   optimize=True))


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
def test_cmyk_and_ycck_equal_cv2(tmp_path, progressive):
    """PIL's CMYK file (Adobe APP14, transform 0, inverted channels) reads as
    (H, W, 3) BGR under both flags; patched to transform 2 it is YCCK, and
    without its Adobe marker straight CMYK, as libjpeg decides."""
    rng = np.random.default_rng(12 + progressive)
    for h, w in ((1, 1), (16, 16), (37, 53)):
        cmyk = np.concatenate([_textured(rng, h, w).reshape(h, w, 3),
                               _textured(rng, h, w, 1).reshape(h, w, 1)], axis=2)
        data = bytearray(_pil(cmyk, mode="CMYK", quality=85, progressive=progressive))
        app14 = [(s, e) for m, s, e in _segments(bytes(data)) if m == 0xEE]
        assert app14 and bytes(data[app14[0][0] + 4:app14[0][0] + 9]) == b"Adobe"
        s, e = app14[0]
        assert data[e - 1] == 0
        assert _equals_cv2(tmp_path, bytes(data)).shape == (h, w, 3)
        data[e - 1] = 2                          # YCCK
        _equals_cv2(tmp_path, bytes(data))
        _equals_cv2(tmp_path, bytes(data[:s] + data[e:]))


# ---------------------------------------------------------------------------
# PNG: palette, sub-8-bit grey, tRNS, Adam7
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette_png_equals_cv2(tmp_path, depth):
    """Palette images with and without tRNS (BGRA with it), written by PIL
    and by hand; the hand-written one has indices past its PLTE (black and
    opaque in libpng) and a tRNS shorter than the palette."""
    rng = np.random.default_rng(20 + depth)
    from PIL import Image

    frame = _textured(rng, 29, 41)
    for trns in (None, 0):
        im = Image.fromarray(frame).quantize(1 << depth)
        bio = io.BytesIO()
        im.save(bio, "PNG", bits=depth, **({} if trns is None else dict(transparency=trns)))
        got = _equals_cv2(tmp_path, bio.getvalue(), "p.png")
        assert got.shape == (29, 41, 3 if trns is None else 4)
    n = max(1, (1 << depth) - 2)
    for h, w in PNG_SIZES:
        px = rng.integers(0, 1 << depth, (h, w))
        pal = rng.integers(0, 256, (n, 3))
        for trns in (None, bytes(rng.integers(0, 256, max(1, n - 1)).astype(np.uint8))):
            _equals_cv2(tmp_path, png_bytes(px, 3, depth, palette=pal, trns=trns, rng=rng),
                        "h.png")


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_sub8_grey_png_equals_cv2(tmp_path, depth):
    """Grey at 1, 2 and 4 bits scales to 0-255 (a 1-bit file reads {0,
    255}); a grey tRNS adds no alpha."""
    rng = np.random.default_rng(30 + depth)
    for h, w in PNG_SIZES:
        px = rng.integers(0, 1 << depth, (h, w))
        for trns in (None, struct.pack(">H", (1 << depth) - 1)):
            got = _equals_cv2(tmp_path, png_bytes(px, 0, depth, trns=trns, rng=rng), "g.png")
            assert got.shape == (h, w)
        got = _equals_cv2(tmp_path, png_bytes(px, 0, depth), "g0.png")   # unfiltered rows
        np.testing.assert_array_equal(got, px * (255 // ((1 << depth) - 1)))
    px = rng.integers(0, 256, (9, 11))
    _equals_cv2(tmp_path, png_bytes(px, 0, 8, trns=struct.pack(">H", 7), rng=rng), "g8.png")


@pytest.mark.parametrize("depth", [8, 16])
def test_rgb_trns_png_equals_cv2(tmp_path, depth):
    """RGB + tRNS reads as BGRA: alpha 0 where a pixel is the tRNS colour,
    full elsewhere."""
    rng = np.random.default_rng(40 + depth)
    top = (1 << depth) - 1
    palette = np.array([[top, 0, top], [0, top, 0], [7, 8, 9], [top, top, top]])
    for h, w in PNG_SIZES:
        px = palette[rng.integers(0, 4, (h, w))]
        key = struct.pack(">HHH", top, 0, top)
        _equals_cv2(tmp_path, png_bytes(px, 2, depth, trns=key, rng=rng), "t.png")
        got = _equals_cv2(tmp_path, png_bytes(px, 2, depth, trns=key), "t0.png")
        assert got.shape == (h, w, 4)
        np.testing.assert_array_equal(got[:, :, 3] == 0, (px == [top, 0, top]).all(axis=2))


@pytest.mark.parametrize("ctype, depth", [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8),
                                          (2, 16), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8),
                                          (4, 16), (6, 8), (6, 16)])
def test_adam7_png_equals_cv2(tmp_path, ctype, depth):
    """Adam7 for every colour type at every depth, each pass's rows under
    random filter types, with images under 8 pixels on a side whose passes
    are empty."""
    rng = np.random.default_rng(50 + 17 * ctype + depth)
    ch = PNG_CHANNELS[ctype]
    for h, w in PNG_SIZES:
        px = rng.integers(0, 1 << depth, (h, w, ch))
        kw = {}
        if ctype == 3:
            kw = dict(palette=rng.integers(0, 256, (1 << depth, 3)),
                      trns=bytes(rng.integers(0, 256, 1 << (depth - 1)).astype(np.uint8)))
        got = _equals_cv2(tmp_path, png_bytes(px, ctype, depth, interlace=1, rng=rng, **kw),
                          "i.png")
        assert got.shape[:2] == (h, w)


@pytest.mark.parametrize("what, make", [
    ((4, 5, 4), lambda r: png_bytes(r.integers(0, 256, (4, 5, 4)), 6, 8, trns=b"\0\1\0\2\0\3")),
    ((4, 5, 3), lambda r: png_bytes(r.integers(0, 2, (4, 5)), 3, 1, palette=[[1, 2, 3], [4, 5, 6]],
                                    trns=b"\1\2\3")),
    ((4, 5), lambda r: png_bytes(r.integers(0, 4, (4, 5)), 0, 2, trns=struct.pack(">H", 4))),
    (None, lambda r: png_bytes(r.integers(0, 2, (4, 5)), 3, 1)),
], ids=["trns_with_alpha", "long_trns", "trns_out_of_range", "no_plte"])
def test_what_libpng_drops_raises_naming_the_file(tmp_path, what, make):
    """Chunks that libpng warns of and drops read as if they were absent (a
    tRNS beside an alpha channel, longer than the palette, or out of range
    in a grey image), bit-equal to cv2 and to JAX's `read_image`; a palette
    image without its PLTE reads as None where cv2 gives None, and
    `read_image` raises FileNotFoundError naming the file, as JAX's does."""
    p = _write(tmp_path, make(np.random.default_rng(60)), "bad.png")
    want = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    if what is None:
        assert want is None and imread.read(p) is None and imread.read_color(p) is None
        for read in (tbop.read_image, jbop.read_image):
            with pytest.raises(FileNotFoundError, match="bad.png"):
                read(p)
        return
    assert want.shape == what
    got = _equals_cv2(tmp_path, open(p, "rb").read(), "bad.png")
    assert got.shape == what
    np.testing.assert_array_equal(tbop.read_image(p), jbop.read_image(p))


# ---------------------------------------------------------------------------
# EXIF orientation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientations_equal_cv2(tmp_path, orientation):
    """read_color turns the image as cv2 does (JPEG APP1, PNG eXIf, grey
    and colour); read, as IMREAD_UNCHANGED, never turns it."""
    rng = np.random.default_rng(70 + orientation)
    for img in (_textured(rng, 16, 24), _textured(rng, 9, 5, 1)):
        ok, j = cv2.imencode(".jpg", img)
        ok, p = cv2.imencode(".png", img)
        for data, name in ((j.tobytes(), "o.jpg"), (p.tobytes(), "o.png"),
                           (png_bytes(img[:, :, ::-1] if img.ndim == 3 else img,
                                      2 if img.ndim == 3 else 0, 8, interlace=1), "a.png")):
            unturned = _equals_cv2(tmp_path, with_exif(data, orientation), name)
            assert unturned.shape[:2] == img.shape[:2]
            turned = imread.read_color(str(tmp_path / name))
            assert turned.shape[:2] == (img.shape[:2] if orientation < 5 else img.shape[1::-1])


# ---------------------------------------------------------------------------
# the BOP pipeline against the JAX package on the new kinds of file
# ---------------------------------------------------------------------------

def _new_kinds(d, rng) -> list:
    """One file of each new kind under the directory `d`; their paths."""
    os.makedirs(d, exist_ok=True)
    files = {}
    img = _textured(rng, 48, 64)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    files["progressive.jpg"] = buf.tobytes()
    cmyk = np.concatenate([img, _textured(rng, 48, 64, 1)[:, :, None]], axis=2)
    files["cmyk.jpg"] = _pil(cmyk, mode="CMYK")
    ycck = bytearray(files["cmyk.jpg"])
    ycck[[e for m, s, e in _segments(bytes(ycck)) if m == 0xEE][0] - 1] = 2
    files["ycck.jpg"] = bytes(ycck)
    ok, buf = cv2.imencode(".jpg", img[:40], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    files["exif6.jpg"] = with_exif(buf.tobytes(), 6)
    pal = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (30, 50))
    files["palette.png"] = png_bytes(idx, 3, 4, palette=pal, rng=rng)
    files["palette_trns.png"] = png_bytes(idx, 3, 4, palette=pal, trns=bytes(range(0, 250, 25)),
                                          rng=rng)
    files["grey1.png"] = png_bytes(rng.integers(0, 2, (33, 47)), 0, 1, rng=rng)
    files["grey2_trns.png"] = png_bytes(rng.integers(0, 4, (33, 47)), 0, 2,
                                        trns=struct.pack(">H", 2), rng=rng)
    files["rgb16_trns.png"] = png_bytes(rng.integers(0, 2, (21, 35, 3)) * 65535, 2, 16,
                                        trns=struct.pack(">HHH", 65535, 0, 65535), rng=rng)
    files["adam7_rgba.png"] = png_bytes(rng.integers(0, 256, (27, 31, 4)), 6, 8, interlace=1,
                                        rng=rng)
    files["adam7_exif8.png"] = with_exif(png_bytes(img[:20, :30, ::-1], 2, 8, interlace=1,
                                                   rng=rng), 8)
    paths = []
    for name, data in sorted(files.items()):
        paths.append(os.path.join(d, name))
        with open(paths[-1], "wb") as f:
            f.write(data)
    return paths


def test_read_image_on_new_kinds_equals_jax(tmp_path):
    for p in _new_kinds(str(tmp_path), np.random.default_rng(80)):
        got, want = tbop.read_image(p), jbop.read_image(p)
        assert (got.dtype, got.shape) == (want.dtype, want.shape) and got.shape[2] == 3, p
        np.testing.assert_array_equal(got, want, err_msg=p)
        assert not got.flags.writeable


def test_background_bank_on_new_kinds_matches_jax(tmp_path):
    d = tmp_path / "bg"
    paths = _new_kinds(str(d), np.random.default_rng(81))
    for f in sorted(os.listdir(os.path.join(FIXTURES, "backgrounds"))):
        if f >= "bg_4":                          # the committed fixtures of the new kinds
            shutil.copy(os.path.join(FIXTURES, "backgrounds", f), d / f)
    port, jax_bank = TT.BackgroundBank(str(d)), JT.BackgroundBank(str(d))
    assert port.files == jax_bank.files and len(port.files) == len(paths) + 5
    for shape in ((480, 640), (128, 128)):
        img = np.random.default_rng(1).integers(0, 256, (*shape, 3), dtype=np.uint8)
        mask = np.zeros(shape, np.int32)
        mask[shape[0] // 4:shape[0] // 2, shape[1] // 3:shape[1] // 2] = 1
        for seed in range(24):
            r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
            got, want = port(img, mask, r_port), jax_bank(img, mask, r_jax)
            np.testing.assert_array_equal(got, want)
            assert r_port.bit_generator.state == r_jax.bit_generator.state


@pytest.fixture(scope="module")
def new_kinds_tree(tmp_path_factory):
    """make_bop_dataset's tree (three classes) with its train frames as
    progressive JPEGs (cv2 at 4:2:0 with restarts, PIL optimized at 4:4:4),
    and its masks rewritten as 1-bit grey, Adam7 1-bit grey, 4-bit grey +
    tRNS and (frame 2) 1-bit palette PNGs: a palette mask reads with colour
    channels, and both packages leave its frame out."""
    root = tmp_path_factory.mktemp("new_kinds_bop")
    yaml_path = make_bop_dataset.write_dataset(str(root), n_train=4, n_test=1, n_fg=3,
                                               single_class=None, seed=5)
    scene = root / "train" / "000001"
    names = []
    for j in range(4):
        img = cv2.imread(str(scene / "rgb" / f"{j:06d}.png"), cv2.IMREAD_UNCHANGED)
        if j % 2 == 0:
            ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                                 cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
            data = buf.tobytes()
        else:
            data = _pil(np.ascontiguousarray(img[:, :, ::-1]), quality=85, progressive=True,
                        optimize=True, subsampling=0)
        with open(scene / "rgb" / f"{j:06d}.jpg", "wb") as f:
            f.write(data)
        names.append(f"train/000001/rgb/{j:06d}.jpg")
        mpath = scene / "mask_visib" / f"{j:06d}_000000.png"
        bits = (cv2.imread(str(mpath), cv2.IMREAD_UNCHANGED) == 255).astype(np.uint8)
        rng = np.random.default_rng(j)
        mask = (png_bytes(bits, 0, 1, rng=rng), png_bytes(bits, 0, 1, interlace=1, rng=rng),
                png_bytes(bits, 3, 1, palette=[[0, 0, 0], [255, 255, 255]], rng=rng),
                png_bytes(bits * 15, 0, 4, trns=struct.pack(">H", 0), rng=rng))[j]
        with open(mpath, "wb") as f:
            f.write(mask)
    with open(root / "new_kinds_list.txt", "w") as f:
        f.write("\n".join(names))
    return yaml_path, str(root / "new_kinds_list.txt")


@pytest.mark.parametrize("fast", [False, True], ids=["slow", "fast"])
def test_samples_on_new_kinds_match_jax(new_kinds_tree, fast):
    yaml_path, list_file = new_kinds_tree
    pair = []
    for m in (jcfg, tcfg):
        cfg = m.load_yaml_config(yaml_path)
        pair.append(cfg.replace(model=m.ModelConfig(input_res=128),
                                data=dataclasses.replace(cfg.data, train_list=list_file,
                                                         fast_pipeline=fast),
                                solver=m.SolverConfig(max_objs=2, ims_per_batch=2)))
    jds = jpipe.BOPPoseDataset(pair[0], list_file, train=True)
    tds = tpipe.BOPPoseDataset(pair[1], list_file, train=True)
    n = 0
    for seed in (1, 2):
        for idx in range(4):
            got, want = tds.sample(idx, seed=seed), jds.sample(idx, seed=seed)
            assert (got is None) == (want is None) == (idx == 2), (idx, seed)
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
    assert n == 6
