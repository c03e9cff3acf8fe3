"""PyTorch port, the BOP host pipeline (`kd6d_pose_adlp_tpu_torch/data/`:
`png`, `native` over `csrc/dataplane.cpp`, `transforms`, `bop`,
`pipeline`, `loaders`; `utils/pnp`; `make_bop_dataset`) against the JAX
package's, which reads with cv2, on BOP trees written on the fly: one the
way tests/test_data_pipeline.py writes it (cv2, K0 != the internal K,
single- and multi-object scenes) and one by the port's `make_bop_dataset`
(the procedural renderer's 640x480 frames, three classes).

Tolerances, with the largest difference measured on this CPU beside them:
  PNG decode, png_unfilter, the data plane's      bit-equal
    warps and normalisation, grayscale, the
    seeded augmentations, annotations, frames,
    sample_internal, the make_bop_dataset tree
  EPnP against cv2.solvePnP(SOLVEPNP_EPNP), on     R atol 1e-10, T rtol 1e-10
    SSR-warped projections of random poses         (8.6e-14, 4.4e-13)
  remap_poses' float32 poses against JAX's         R atol 1e-6, T rtol 1e-6
                                                   (one float32 rounding)
  BOPPoseDataset samples, slow and fast, train     class ids, metas, eval crops
    and eval: R, T, bbox_trans                     equal; R atol 1e-6, T rtol
                                                   1e-6, bbox_trans atol 1e-4;
                                                   train images and masks equal
                                                   on >= 99.9% of pixels, images
                                                   within 1 LSB elsewhere (all
                                                   80 samples of the three
                                                   trees bit-equal: 0 everywhere)
The tolerances leave room for a float32 rounding of a pose that EPnP's
~1e-13 difference from cv2 could flip on another CPU. Run with -s to print
the measured values.
"""
import dataclasses
import importlib.util
import json
import os
import shutil
import struct
import threading
import time
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from kd6d_pose_adlp_tpu import config as jcfg  # noqa: E402
from kd6d_pose_adlp_tpu.data import bop as jbop  # noqa: E402
from kd6d_pose_adlp_tpu.data import loaders as jloaders  # noqa: E402
from kd6d_pose_adlp_tpu.data import native as jnative  # noqa: E402
from kd6d_pose_adlp_tpu.data import pipeline as jpipe  # noqa: E402
from kd6d_pose_adlp_tpu.data import transforms as JT  # noqa: E402
from kd6d_pose_adlp_tpu.data.synthetic import SyntheticPoseDataset as JSynth  # noqa: E402
from kd6d_pose_adlp_tpu.utils import geometry as jgeo  # noqa: E402
from kd6d_pose_adlp_tpu_torch import config as tcfg  # noqa: E402
from kd6d_pose_adlp_tpu_torch import make_bop_dataset  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import bop as tbop  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import loaders as tloaders  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import native, png  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import pipeline as tpipe  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import transforms as TT  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset  # noqa: E402
from kd6d_pose_adlp_tpu_torch.utils.mesh import mesh_bbox_corners  # noqa: E402
from kd6d_pose_adlp_tpu_torch.utils.pnp import solve_pnp_epnp  # noqa: E402
from test_torch_port_pool import one_torch_thread  # noqa: E402,F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K0 = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], np.float64)
CORNERS = np.array([[x, y, z] for x in (-40, 40) for y in (-30, 30)
                    for z in (-50, 50)], np.float32)
RES = 128


# ---------------------------------------------------------------------------
# the trees
# ---------------------------------------------------------------------------

def _write_ply(path, verts):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")


def _cv2_tree(root, n_img, objs_per_img, seed):
    """A BOP tree written with cv2 as tests/test_data_pipeline.py does:
    gray frames with a painted box per object, K0 as the camera."""
    (root / "models").mkdir(parents=True)
    _write_ply(root / "models" / "obj_000001.ply", CORNERS)
    with open(root / "bbox.json", "w") as f:
        json.dump([mesh_bbox_corners(CORNERS).tolist()], f)
    scene = root / "train" / "000001"
    (scene / "rgb").mkdir(parents=True)
    (scene / "mask_visib").mkdir()
    rng = np.random.default_rng(seed)
    cam, gt, names = {}, {}, []
    offsets = ((-120.0, 0.0), (130.0, 20.0))
    for i in range(n_img):
        img = np.full((480, 640, 3), 70, np.uint8)
        gt[str(i)] = []
        for j in range(objs_per_img):
            R = jgeo.quaternion2rotation(rng.normal(size=4))
            if objs_per_img == 1:
                T = np.array([rng.uniform(-50, 50), rng.uniform(-40, 40), rng.uniform(700, 1000)])
            else:
                T = np.array([offsets[j][0], offsets[j][1], 850.0])
            kp = jgeo.project_points(K0, R, T, CORNERS.astype(np.float64))
            hull = cv2.convexHull(kp.astype(np.float32)).astype(np.int32)
            cv2.fillConvexPoly(img, hull, (30 + 80 * j, 200, 90))
            mask = np.zeros((480, 640), np.uint8)
            cv2.fillConvexPoly(mask, hull, 255)
            cv2.imwrite(str(scene / "mask_visib" / f"{i:06d}_{j:06d}.png"), mask)
            gt[str(i)].append({"cam_R_m2c": R.reshape(-1).tolist(),
                               "cam_t_m2c": T.reshape(-1).tolist(), "obj_id": 1})
        # texture, so bilinear warps and the noise augmentation see gradients
        img = np.clip(img + rng.integers(-20, 21, img.shape), 0, 255).astype(np.uint8)
        cv2.imwrite(str(scene / "rgb" / f"{i:06d}.png"), img)
        cam[str(i)] = {"cam_K": K0.reshape(-1).tolist(), "depth_scale": 1.0}
        names.append(f"train/000001/rgb/{i:06d}.png")
    with open(scene / "scene_camera.json", "w") as f:
        json.dump(cam, f)
    with open(scene / "scene_gt.json", "w") as f:
        json.dump(gt, f)
    with open(root / "train_list.txt", "w") as f:
        f.write("\n".join(names))
    return root / "train_list.txt"


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("bop")
    single = _cv2_tree(base / "single", 4, 1, seed=0)
    multi = _cv2_tree(base / "multi", 2, 2, seed=5)
    yaml_path = make_bop_dataset.write_dataset(str(base / "port"), n_train=4, n_test=3,
                                               n_fg=3, single_class=None, seed=3)
    return dict(single=single, multi=multi, port=yaml_path, base=base)


def _cfg_pair(trees, tree: str, fast=False, **solver):
    """(JAX config, port config) of one tree at RES, B=2, two object slots."""
    out = []
    for m in (jcfg, tcfg):
        if tree == "port":
            cfg = m.load_yaml_config(trees["port"])
        else:
            root = os.path.dirname(trees[tree])
            cfg = m.Config(data=m.DataConfig(
                train_list=str(trees[tree]), mesh_dir=os.path.join(root, "models") + "/",
                bbox_file=os.path.join(root, "bbox.json"), n_class=2,
                mesh_diameters=(float(np.linalg.norm([80, 60, 100])),), symmetry_types=()))
        cfg = cfg.replace(
            model=m.ModelConfig(input_res=RES),
            data=dataclasses.replace(cfg.data, fast_pipeline=fast),
            solver=m.SolverConfig(max_objs=2, ims_per_batch=2, **solver),
            test=m.TestConfig(ims_per_batch=2))
        out.append(cfg)
    return out


def _list(cfg, train):
    return cfg.data.train_list if train else (cfg.data.valid_list or cfg.data.test_list
                                              or cfg.data.train_list)


# ---------------------------------------------------------------------------
# 1. PNG reading and writing
# ---------------------------------------------------------------------------

def _filter_types(path):
    """The filter type byte of every IDAT row of a PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype] * depth // 8
    raw = zlib.decompress(idat)
    return {raw[r * (stride + 1)] for r in range(h)}


@pytest.mark.parametrize("shape, dtype", [((37, 41, 3), np.uint8), ((37, 41), np.uint8),
                                          ((37, 41, 4), np.uint8), ((37, 41), np.uint16),
                                          ((37, 41, 3), np.uint16)],
                         ids=["bgr8", "grey8", "bgra8", "grey16", "bgr16"])
def test_png_read_equals_cv2(tmp_path, shape, dtype):
    rng = np.random.default_rng(sum(shape) + np.dtype(dtype).itemsize)
    a = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    a[10:14] = a[9]                             # rows the Up filter suits
    p = str(tmp_path / "a.png")
    # compression level 3: libpng chooses a filter per row (cv2's default
    # of Sub only would leave four filters untested)
    cv2.imwrite(p, a, [cv2.IMWRITE_PNG_COMPRESSION, 3])
    got, want = png.read(p), cv2.imread(p, cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if shape == (37, 41, 3) and dtype == np.uint8:
        assert _filter_types(p) == {0, 1, 2, 3, 4}
    png.write(p, a)
    back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(png.read(p), a)


def test_png_grey_alpha_and_what_raises(tmp_path):
    rng = np.random.default_rng(0)

    def raw_png(path, body, w, h, depth, ctype, interlace=0, extra=b""):
        def chunk(kind, data):
            return struct.pack(">I", len(data)) + kind + data + struct.pack(
                ">I", zlib.crc32(kind + data))
        with open(path, "wb") as f:
            f.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(
                ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)) + extra
                + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))

    ga = rng.integers(0, 256, (5, 6, 2), dtype=np.uint8)
    p = str(tmp_path / "ga.png")
    raw_png(p, b"".join(b"\0" + ga[y].tobytes() for y in range(5)), 6, 5, 8, 4)
    np.testing.assert_array_equal(png.read(p), cv2.imread(p, cv2.IMREAD_UNCHANGED))
    def trns(body):
        return struct.pack(">I", len(body)) + b"tRNS" + body + struct.pack(
            ">I", zlib.crc32(b"tRNS" + body))

    plte = struct.pack(">I", 6) + b"PLTE" + bytes(range(6)) + struct.pack(
        ">I", zlib.crc32(b"PLTE" + bytes(range(6))))
    # what once raised here decodes as cv2 reads it (tests/test_torch_port_imread.py
    # holds each kind at every depth); a broken variant of each raises where
    # cv2 gives None, and the tRNS libpng drops reads as cv2 reads it
    decodes = {"palette": (8, 3, 0, plte), "bit depth 4": (4, 0, 0, b""),
               "interlaced": (8, 0, 1, b""), "tRNS": (8, 0, 0, trns(b"\0\0"))}
    cases = {"palette": (8, 3, 0, b""), "bit depth 4": (4, 2, 0, b""),
             "interlaced": (8, 0, 2, b""), "tRNS": (8, 0, 0, trns(b"\0"))}
    for name, (depth, ctype, interlace, extra) in decodes.items():
        p = str(tmp_path / f"ok {name}.png")
        raw_png(p, bytes(rng.integers(0, 2, 64, dtype=np.uint8)), 4, 4, depth, ctype,
                interlace, extra)
        want = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        assert want is not None
        np.testing.assert_array_equal(png.read(p), want)
    for name, (depth, ctype, interlace, extra) in cases.items():
        p = str(tmp_path / f"{name}.png")
        raw_png(p, b"\0" * 64, 4, 4, depth, ctype, interlace, extra)
        if name == "tRNS":                       # libpng drops a grey tRNS of one byte
            np.testing.assert_array_equal(png.read(p), cv2.imread(p, cv2.IMREAD_UNCHANGED))
            continue
        assert cv2.imread(p, cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(ValueError, match=os.path.basename(p)):
            png.read(p)
    with open(str(tmp_path / "ga.png"), "rb") as f:
        data = bytearray(f.read())
    data[-20] ^= 0xFF                            # flipped bits in IDAT
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_png_unfilter_matches_its_plain_version(bpp):
    rng = np.random.default_rng(bpp)
    rows, stride = 23, 7 * bpp
    raw = rng.integers(0, 256, (rows, stride + 1), dtype=np.uint8)
    raw[:, 0] = rng.integers(0, 5, rows)
    np.testing.assert_array_equal(native.png_unfilter(raw, rows, stride, bpp),
                                  png.unfilter_plain(raw, rows, stride, bpp))
    raw[4, 0] = 5
    with pytest.raises(ValueError, match="row 4 has filter type 5"):
        native.png_unfilter(raw, rows, stride, bpp)


# ---------------------------------------------------------------------------
# 2. the data plane
# ---------------------------------------------------------------------------

def test_data_plane_equals_jax_native():
    assert jnative.get_lib() is not None       # JAX's native path, not its cv2 fallback
    assert native.library_path().parent.name == "_build"
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    mask = rng.integers(-1, 4, (480, 640)).astype(np.int32)
    for k in range(6):
        M = np.asarray(JT.random_ssr_matrix(rng, 0.2, 0.3, 40.0, 640, 480), np.float64)
        if k % 2:
            M = np.vstack([jgeo.dzi_affine(rng.uniform(0, 640, 2), rng.uniform(50, 700),
                                           256), [0, 0, 1]]) @ M
        out_wh = (256, 256) if k % 2 else (640, 480)
        border = (128, 128, 128) if k % 3 else (0, 0, 0)
        np.testing.assert_array_equal(TT.warp_image(img, M, out_wh, border),
                                      JT.warp_image(img, M, out_wh, border))
        np.testing.assert_array_equal(TT.warp_mask(mask, M, out_wh),
                                      JT.warp_mask(mask, M, out_wh))
    np.testing.assert_array_equal(TT.normalize_fast(img), JT.normalize_fast(img))
    np.testing.assert_allclose(TT.normalize_fast(img), TT.normalize(img), atol=1e-5)


# ---------------------------------------------------------------------------
# 3-4. EPnP and the transforms
# ---------------------------------------------------------------------------

def _ssr_projections(rng, K_src):
    corners = np.array([[x, y, z] for x in (-40, 45) for y in (-30, 33)
                        for z in (-50, 52)], np.float64)
    R = jgeo.quaternion2rotation(rng.normal(size=4)).astype(np.float64)
    T = np.array([rng.uniform(-100, 100), rng.uniform(-80, 80), rng.uniform(600, 1100)])
    M3 = np.asarray(JT.random_ssr_matrix(rng, 0.05, 0.05, 10.0, 640, 480), np.float64)
    pts = M3 @ K_src @ (R @ corners.T + T.reshape(3, 1))
    return corners, (pts[:2] / (pts[2:] + 1e-8)).T


def test_epnp_matches_cv2():
    K = np.asarray(tcfg.DataConfig().internal_K_np(), np.float64)
    rng = np.random.default_rng(0)
    worst = [0.0, 0.0]
    for i in range(60):
        corners, xy = _ssr_projections(rng, K0 if i % 2 else K)
        ok, rvec, tvec = cv2.solvePnP(corners.reshape(-1, 1, 3), xy.reshape(-1, 1, 2), K,
                                      None, flags=cv2.SOLVEPNP_EPNP)
        R, T = solve_pnp_epnp(corners, xy, K)
        np.testing.assert_allclose(R, cv2.Rodrigues(rvec)[0], rtol=0, atol=1e-10)
        np.testing.assert_allclose(T, tvec.reshape(3), rtol=1e-10)
        worst = [max(worst[0], float(np.abs(R - cv2.Rodrigues(rvec)[0]).max())),
                 max(worst[1], float(np.abs(T / tvec.reshape(3) - 1).max()))]
    print(f"EPnP vs cv2 over 60 poses: R max |diff| {worst[0]:.2e}, T max rel {worst[1]:.2e}")
    with pytest.raises(ValueError, match="n >= 4"):
        solve_pnp_epnp(corners[:3], xy[:3], K)


def test_transforms_match_jax():
    K = np.asarray(tcfg.DataConfig().internal_K_np(), np.float32)
    for seed in range(4):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(TT.random_ssr_matrix(a, 0.05, 0.05, 10.0, 640, 480),
                                      JT.random_ssr_matrix(b, 0.05, 0.05, 10.0, 640, 480))
        Rs = [jgeo.quaternion2rotation(a.normal(size=4)).astype(np.float32) for _ in range(2)]
        Ts = [np.array([10.0, -20.0, 800.0 + 50 * i], np.float32) for i in range(2)]
        M = (JT.random_ssr_matrix(a, 0.05, 0.05, 10.0, 640, 480)
             @ JT.internal_frame_matrix(720, 540, 640, 480))
        kp = [CORNERS, CORNERS * 1.2]
        (tR, tT), (jR, jT) = (TT.remap_poses(K0.astype(np.float32), Rs, Ts, kp, K, M),
                              JT.remap_poses(K0.astype(np.float32), Rs, Ts, kp, K, M))
        for r1, r2, t1, t2 in zip(tR, jR, tT, jT):
            assert r1.dtype == t1.dtype == np.float32
            np.testing.assert_allclose(r1, r2, atol=1e-6)
            np.testing.assert_allclose(t1, t2, rtol=1e-6)
        img = a.integers(0, 256, (60, 80, 3), dtype=np.uint8)
        mask = np.zeros((60, 80), np.int32)
        mask[10:40, 20:70] = 1

        def augs(mod):
            r = np.random.default_rng(100 + seed)
            return (mod.distort_noise(img, r, 0.1), *mod.random_occlusion(img, mask, r, 0.8),
                    mod.grayscalize(img))

        for x, y in zip(augs(TT), augs(JT)):
            np.testing.assert_array_equal(x, y)
    big = np.random.default_rng(9).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    np.testing.assert_array_equal(TT.grayscalize(big), JT.grayscalize(big))
    # cv2's grey is 15-bit fixed point; the 14-bit one (1868, 9617, 4899)
    # often cited misses it
    i = big.astype(np.int64)
    g14 = (i[..., 0] * 1868 + i[..., 1] * 9617 + i[..., 2] * 4899 + 8192) >> 14
    print(f"14-bit grey differs from cv2's on {(g14 != JT.grayscalize(big)[..., 0]).mean():.2%}"
          " of pixels")


# ---------------------------------------------------------------------------
# 5. annotations, frames, the renderer's frames and the tree
# ---------------------------------------------------------------------------

def test_annotations_and_frames_match_jax(trees, tmp_path):
    yaml = tcfg.load_yaml_config(trees["port"])
    for lst, obj2cls in ((trees["single"], {"1": 0}), (trees["multi"], {"1": 0}),
                         (yaml.data.train_list, {str(i + 1): i for i in range(3)}),
                         (yaml.data.test_list, {str(i + 1): i for i in range(3)})):
        paths = tbop.read_image_list(str(lst))
        assert paths == jbop.read_image_list(str(lst))
        for p in paths:
            np.testing.assert_array_equal(tbop.read_image(p), jbop.read_image(p))
            for x, y in zip(tbop.get_single_bop_annotation(p, obj2cls),
                            jbop.get_single_bop_annotation(p, obj2cls)):
                if isinstance(x, list):
                    assert len(x) == len(y)
                    for u, v in zip(x, y):
                        np.testing.assert_array_equal(u, v)
                else:
                    np.testing.assert_array_equal(x, y)
    # the uint16, grey and alpha frames
    rng = np.random.default_rng(1)
    frames = {"u16": rng.integers(0, 65536, (30, 40, 3), dtype=np.uint16),
              "grey": rng.integers(0, 256, (30, 40), dtype=np.uint8),
              "grey16": rng.integers(0, 65536, (30, 40), dtype=np.uint16),
              "alpha": rng.integers(0, 256, (30, 40, 4), dtype=np.uint8)}
    for name, a in frames.items():
        p = str(tmp_path / f"{name}.png")
        cv2.imwrite(p, a)
        got = tbop.read_image(p)
        assert got.shape == (30, 40, 3) and got.dtype == np.uint8 and not got.flags.writeable
        np.testing.assert_array_equal(got, jbop.read_image(p))


def test_sample_internal_and_the_tree_match_jax(trees, tmp_path):
    for kw in (dict(single_class=0), dict(single_class=None), dict(classes=(1, 2))):
        t, j = SyntheticPoseDataset(n_fg=3, seed=3, **kw), JSynth(n_fg=3, seed=3, **kw)
        for i in (0, 1000, 7):
            a, b = t.sample_internal(i), j.sample_internal(i)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the JAX script's tree (cv2 PNGs) against the port's: the same files,
    # JSONs equal, PNGs decoding to the same arrays
    spec = importlib.util.spec_from_file_location(
        "jax_make_bop", os.path.join(REPO, "scripts", "make_bop_dataset.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    jroot, troot = tmp_path / "jax", os.path.dirname(trees["port"])
    ds = JSynth(n_fg=3, single_class=None, seed=3)
    script.write_split(ds, str(jroot), "train", range(4), index_base=1000)
    script.write_split(ds, str(jroot), "test", range(3), index_base=0)
    n = 0
    for dirpath, _, files in os.walk(jroot):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), jroot)
            mine = os.path.join(troot, rel)
            if f.endswith(".json"):
                with open(os.path.join(dirpath, f)) as x, open(mine) as y:
                    assert json.load(x) == json.load(y), rel
            else:
                np.testing.assert_array_equal(
                    png.read(mine), cv2.imread(os.path.join(dirpath, f), cv2.IMREAD_UNCHANGED))
            n += 1
    assert n == 2 * (4 + 3) + 4                 # frames, masks and two JSONs a split


# ---------------------------------------------------------------------------
# 6. samples
# ---------------------------------------------------------------------------

def _assert_samples_match(got, want, train):
    assert (got is None) == (want is None)
    if got is None:
        return
    np.testing.assert_array_equal(got["class_ids"], want["class_ids"])
    np.testing.assert_allclose(got["rotations"], want["rotations"], atol=1e-6)
    np.testing.assert_allclose(got["translations"], want["translations"], rtol=1e-6)
    np.testing.assert_allclose(got["bbox_trans"], want["bbox_trans"], atol=1e-4)
    assert got["meta"].keys() == want["meta"].keys()
    for k, v in want["meta"].items():
        if isinstance(v, list):
            for x, y in zip(got["meta"][k], v):
                np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            np.testing.assert_array_equal(got["meta"][k], v, err_msg=k)
    assert got["image"].dtype == want["image"].dtype == np.uint8
    assert got["mask"].dtype == want["mask"].dtype == np.int32
    if not train:
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["mask"], want["mask"])
        np.testing.assert_array_equal(got["bbox_trans"], want["bbox_trans"])
        return
    for k in ("image", "mask"):
        same = got[k] == want[k]
        assert same.mean() >= 0.999, (k, same.mean())
    d = np.abs(got["image"].astype(int) - want["image"].astype(int))
    assert d.max() <= 1


def _bit_equal(got, want):
    return all(np.array_equal(got[k], want[k]) for k in
               ("image", "mask", "class_ids", "rotations", "translations", "bbox_trans"))


@pytest.mark.parametrize("tree", ["single", "port"])
@pytest.mark.parametrize("fast", [False, True], ids=["slow", "fast"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_samples_match_jax(trees, tree, fast, train):
    solver = dict(aug_noise=0.05, aug_occlusion=0.5) if train and tree == "single" else {}
    jc, tc = _cfg_pair(trees, tree, fast, **solver)
    jds = jpipe.BOPPoseDataset(jc, _list(jc, train), train=train)
    tds = tpipe.BOPPoseDataset(tc, _list(tc, train), train=train)
    assert len(tds) == len(jds)
    n = n_equal = 0
    for seed in (1, 2):
        for idx in range(4):
            got, want = tds.sample(idx, seed=seed), jds.sample(idx, seed=seed)
            _assert_samples_match(got, want, train)
            n += got is not None
            n_equal += got is not None and _bit_equal(got, want)
            if got is not None:
                res = tc.model.input_res
                assert got["image"].shape == (res, res, 3) and got["mask"].shape == (res, res)
                assert list(got["class_ids"][1:]) == [-1] * (tc.solver.max_objs - 1)
    assert n >= 6
    print(f"{tree} {'fast' if fast else 'slow'} {'train' if train else 'eval'}: "
          f"{n_equal} of {n} samples bit-equal to JAX's")


@pytest.mark.parametrize("fast", [False, True], ids=["slow", "fast"])
def test_focus_obj_on_the_multi_object_tree(trees, fast):
    jc, tc = _cfg_pair(trees, "multi", fast)
    for train in (False, True):
        jds = jpipe.BOPPoseDataset(jc, _list(jc, train), train=train)
        tds = tpipe.BOPPoseDataset(tc, _list(tc, train), train=train)
        assert tds.eval_items() == jds.eval_items() == [(0, 0), (0, 1), (1, 0), (1, 1)]
        for i, j in tds.eval_items():
            got, want = tds.sample(i, seed=1, focus_obj=j), jds.sample(i, seed=1, focus_obj=j)
            _assert_samples_match(got, want, train)
            print(f"multi {'fast' if fast else 'slow'} train={train} item {(i, j)}: "
                  f"bit-equal {_bit_equal(got, want)}")
            assert got["meta"]["filename"].endswith(f"#obj{j}")
            assert (got["mask"] == 1).sum() > 30


# ---------------------------------------------------------------------------
# 7-8. the loader and the bundle
# ---------------------------------------------------------------------------

def _batches_equal(tb, jb, exact=True):
    for f in jb._fields:
        a, b = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        if exact or f in ("class_ids",):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=1e-4 if f == "bbox_trans" else 1e-6,
                                       rtol=1e-6, err_msg=f)


def test_prefetch_loader_matches_jax_and_stops(trees):
    jc, tc = _cfg_pair(trees, "port")
    jds = jpipe.BOPPoseDataset(jc, jc.data.train_list, train=True)
    tds = tpipe.BOPPoseDataset(tc, tc.data.train_list, train=True)
    before = threading.active_count()
    jit = iter(jpipe.PrefetchLoader(jds, 2, train=True, num_threads=1, seed=4))
    tit = iter(tpipe.PrefetchLoader(tds, 2, train=True, num_threads=1, seed=4))
    for _ in range(5):                          # past the first epoch of 4 images
        (tb, tm), (jb, jm) = next(tit), next(jit)
        assert [m["filename"] for m in tm] == [m["filename"] for m in jm]
        np.testing.assert_array_equal(tb.class_ids.numpy(), jb.class_ids)
        np.testing.assert_allclose(tb.rotations.numpy(), jb.rotations, atol=1e-6)
        same = tb.images.numpy() == jb.images
        assert same.mean() >= 0.999
    tit.close()
    jit.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


def test_prefetch_loader_eval_yields_every_batch_and_raises_a_failure():
    class SlowDS:
        def __len__(self):
            return 7

        def sample(self, idx, seed=0, focus_obj=None):
            time.sleep(0.01)  # widen the exhaustion/put race window
            return dict(image=np.full((4, 4, 3), idx, np.uint8),
                        mask=np.zeros((4, 4), np.int32),
                        class_ids=np.zeros((1,), np.int32),
                        rotations=np.eye(3, dtype=np.float32)[None],
                        translations=np.zeros((1, 3), np.float32),
                        bbox_trans=np.eye(2, 3, dtype=np.float32),
                        meta=dict(filename=f"{idx}"))

    for trial in range(3):
        got = list(tpipe.PrefetchLoader(SlowDS(), batch_size=2, train=False, num_threads=3,
                                        depth=2, seed=trial))
        assert len(got) == 4
        assert sorted(int(b.images[0, 0, 0, 0]) for b, _ in got) == [0, 2, 4, 6]

    class Broken(SlowDS):
        def sample(self, idx, seed=0, focus_obj=None):
            raise RuntimeError("decoder gone")

    with pytest.raises(RuntimeError, match="decoder gone"):
        list(tpipe.PrefetchLoader(Broken(), batch_size=2, train=False, num_threads=2))


@pytest.mark.parametrize("fast", [False, True], ids=["slow", "fast"])
def test_bundle_matches_jax(trees, fast):
    jc, tc = _cfg_pair(trees, "port", fast)
    jd = jloaders.build(jc, kind="bop", eval_limit=3)
    td = tloaders.build(tc, kind="bop", eval_limit=3, device="cpu")
    assert td.cfg is None and jd.cfg is None
    for k in ("K", "inv_K", "kp3d", "diameters"):
        np.testing.assert_array_equal(getattr(td.consts, k).numpy(),
                                      np.asarray(getattr(jd.consts, k)), err_msg=k)
    assert len(td.meshes) == len(jd.meshes) == 3
    for a, b in zip(td.meshes, jd.meshes):
        np.testing.assert_array_equal(a, b)
    n = 0
    for (tb, tm), (jb, jm) in zip(td.eval_batches(), jd.eval_batches()):
        _batches_equal(tb, jb)
        assert [m["filename"] for m in tm] == [m["filename"] for m in jm]
        for a, b in zip(tm, jm):
            for k in ("K", "width", "height", "class_ids", "rotations", "translations"):
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        n += 1
    assert n == 2                                # 3 items, the last chunk padded
    it = td.train_iter(num_threads=2, shard=(0, 2))
    b = next(it)
    assert b.images.shape == (2, RES, RES, 3) and b.images.dtype.is_floating_point is False
    it.close()


# ---------------------------------------------------------------------------
# 9. what once raised loads; what the decoders do not support still raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aug", [dict(aug_color_h=0.1), dict(aug_sharpen=0.2),
                                 dict(aug_smooth=0.5), dict(aug_background_dir="/bg")],
                         ids=["hsv", "sharpen", "smooth", "background"])
def test_unported_augmentations_raise(trees, aug, tmp_path):
    """The four augmentations that raised NotImplementedError until the
    data plane had cv2's arithmetic now load and give JAX's samples (the
    background from a progressive JPEG, which the port decodes as cv2
    does, and from one cut before its last scan, which both smooth)."""
    if "aug_background_dir" in aug:
        bg = tmp_path / "bg"
        bg.mkdir()
        ok, buf = cv2.imencode(".jpg", np.full((48, 64, 3), 90, np.uint8),
                               [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        (bg / "progressive.jpg").write_bytes(buf.tobytes())
        aug = dict(aug_background_dir=str(bg))
    jc, tc = _cfg_pair(trees, "single", **aug)
    tds = tpipe.BOPPoseDataset(tc, tc.data.train_list, train=True)
    tpipe.BOPPoseDataset(tc, tc.data.train_list, train=False)
    jds = jpipe.BOPPoseDataset(jc, jc.data.train_list, train=True)
    for seed in (1, 2):
        for idx in range(4):
            got, want = tds.sample(idx, seed=seed), jds.sample(idx, seed=seed)
            np.testing.assert_array_equal(got["image"], want["image"])
            np.testing.assert_array_equal(got["mask"], want["mask"])
    if "aug_background_dir" in aug:
        # cut before its last scan and closed: cv2 smooths it, and so does the port
        data = buf.tobytes()
        (tmp_path / "bg" / "progressive.jpg").write_bytes(
            data[:data.rindex(b"\xff\xda")] + b"\xff\xd9")
        assert cv2.imread(str(tmp_path / "bg" / "progressive.jpg")) is not None
        for seed in range(8):                   # the bank fires at p = 0.5
            got, want = tds.sample(0, seed=seed), jds.sample(0, seed=seed)
            np.testing.assert_array_equal(got["image"], want["image"])
            np.testing.assert_array_equal(got["mask"], want["mask"])


def test_jpeg_frames_raise(trees, tmp_path):
    """JPEG frames, which raised until the port had a decoder, now load as
    the JAX package reads them, progressive ones too, and so does a
    progressive frame cut before its last scan (libjpeg smooths it), from
    the dataset and the loader too; a frame in another format raises
    UnsupportedImage (a ValueError) naming the file, where cv2 would read
    it; a missing frame is skipped."""
    src = os.path.join(os.path.dirname(trees["single"]), "train", "000001", "rgb")
    rgb = tmp_path / "train" / "000001" / "rgb"
    shutil.copytree(os.path.dirname(src), str(rgb.parent))
    img = cv2.imread(os.path.join(src, "000000.png"))
    cv2.imwrite(str(rgb / "000000.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    lst = tmp_path / "list.txt"
    lst.write_text("train/000001/rgb/000000.jpg\n")
    jc, tc = _cfg_pair(trees, "single")
    tds = tpipe.BOPPoseDataset(tc, str(lst), train=False)
    jds = jpipe.BOPPoseDataset(jc, str(lst), train=False)
    _assert_samples_match(tds.sample(0, seed=1), jds.sample(0, seed=1), train=False)
    ok, buf = cv2.imencode(".jpg", cv2.imread(os.path.join(src, "000003.png")),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    (rgb / "000003.jpg").write_bytes(buf.tobytes())       # a path not yet cached
    lst.write_text("train/000001/rgb/000003.jpg\n")
    tds = tpipe.BOPPoseDataset(tc, str(lst), train=False)
    jds = jpipe.BOPPoseDataset(jc, str(lst), train=False)
    _assert_samples_match(tds.sample(0, seed=1), jds.sample(0, seed=1), train=False)
    data = buf.tobytes()
    cut = data[:data.rindex(b"\xff\xda")] + b"\xff\xd9"
    (tmp_path / "p.jpg").write_bytes(cut)
    np.testing.assert_array_equal(tbop.read_image(str(tmp_path / "p.jpg")),
                                  jbop.read_image(str(tmp_path / "p.jpg")))
    # through the dataset and the loader, train and eval, the cut frame
    # loads as in JAX and a frame in another format raises naming it
    (rgb / "000001.jpg").write_bytes(cut)
    cv2.imwrite(str(rgb / "000002.bmp"), img)
    for name in ("000001.jpg", "000002.bmp"):
        lst.write_text(f"train/000001/rgb/{name}\n")
        assert cv2.imread(str(rgb / name)) is not None      # the JAX package reads it
        for train in (True, False):
            tds = tpipe.BOPPoseDataset(tc, str(lst), train=train)
            if name.endswith(".jpg"):
                jds = jpipe.BOPPoseDataset(jc, str(lst), train=train)
                _assert_samples_match(tds.sample(0, seed=1), jds.sample(0, seed=1), train)
                its = [iter(pipe.PrefetchLoader(ds, batch_size=2, train=train, num_threads=1))
                       for pipe, ds in ((tpipe, tds), (jpipe, jds))]
                (tb, _), (jb, _) = next(its[0]), next(its[1])
                np.testing.assert_array_equal(tb.class_ids.numpy(), jb.class_ids)
                for it in its:
                    it.close()
                continue
            what = "a BMP file"
            with pytest.raises(native.UnsupportedImage, match=f"{name}: .*{what}"):
                tds.sample(0, seed=1)
            with pytest.raises(native.UnsupportedImage, match=f"{name}: .*{what}"):
                next(iter(tpipe.PrefetchLoader(tds, batch_size=2, train=train, num_threads=1)))
    lst.write_text("train/000001/rgb/missing.jpg\n")
    assert tpipe.BOPPoseDataset(tc, str(lst), train=True).sample(0, seed=1) is None


def test_data_path_imports_no_image_library():
    pkg = os.path.join(REPO, "kd6d_pose_adlp_tpu_torch")
    files = [os.path.join(pkg, "data", f) for f in os.listdir(os.path.join(pkg, "data"))
             if f.endswith(".py")] + [os.path.join(pkg, "utils", "pnp.py"),
                                      os.path.join(pkg, "make_bop_dataset.py")]
    for path in files:
        with open(path) as f:
            for line in f:
                words = line.split()
                assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                            and words[1].split(".")[0] in ("cv2", "PIL", "torchvision")), (
                    path, line)
