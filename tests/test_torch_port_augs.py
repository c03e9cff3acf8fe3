"""PyTorch port, the cv2-arithmetic augmentations: the data plane's
primitives (`csrc/cvarith.cpp` through `data/native.py`) against cv2 on
random images, the augmentations of `data/transforms.py` (`distort_hsv`,
`distort_smooth`, `pencil_sharpen`, `BackgroundBank`) against their twins in
the JAX package under one seed, and `BOPPoseDataset.sample` with every
augmentation on, on JPEG frames, against the JAX package's.

Tolerances:
  cvtColor BGR<->HSV, GaussianBlur 7x7, blur, normalize     bit-equal
    (float32 / float64 outputs too), resize INTER_LINEAR
  the augmentations, and the generator's state after them    bit-equal
  samples, slow and fast, train, every augmentation on:      image and mask
    JPEG frames and the fixture backgrounds                  equal; R atol
                                                             1e-6, T rtol 1e-6,
                                                             bbox_trans atol 1e-4
The pose bounds are tests/test_torch_port_bop.py's: EPnP's ~1e-13 difference
from cv2 may flip a float32 rounding.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from kd6d_pose_adlp_tpu import config as jcfg  # noqa: E402
from kd6d_pose_adlp_tpu.data import pipeline as jpipe  # noqa: E402
from kd6d_pose_adlp_tpu.data import transforms as JT  # noqa: E402
from kd6d_pose_adlp_tpu_torch import config as tcfg  # noqa: E402
from kd6d_pose_adlp_tpu_torch import make_bop_dataset  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import native  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import pipeline as tpipe  # noqa: E402
from kd6d_pose_adlp_tpu_torch.data import transforms as TT  # noqa: E402
from test_torch_port_pool import one_torch_thread  # noqa: E402,F401 (autouse fixture)

BACKGROUNDS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_port_fixtures",
                           "backgrounds")
RES = 128
# (H, W): row tails of cvtColor's 32-pixel vector loop, tiny images, frames
SHAPES = ((1, 1), (2, 3), (5, 4), (13, 9), (31, 33), (97, 131), (128, 128), (480, 640))
EVERY_AUG = dict(aug_color_h=0.1, aug_color_s=0.3, aug_color_v=0.3, aug_sharpen=0.5,
                 aug_smooth=1.0, aug_noise=0.02, aug_occlusion=0.5,
                 aug_background_dir=BACKGROUNDS)


def _img(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape,
                                                                 want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# 1. the primitives against cv2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_hsv_round_trip_matches_cv2(shape):
    a = _img(sum(shape), *shape)
    _equal(native.bgr2hsv(a), cv2.cvtColor(a, cv2.COLOR_BGR2HSV))
    _equal(native.hsv2bgr(a), cv2.cvtColor(a, cv2.COLOR_HSV2BGR))   # H up to 255 too
    hsv = cv2.cvtColor(a, cv2.COLOR_BGR2HSV)
    _equal(native.hsv2bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gaussian_blur7_matches_cv2(shape):
    a = _img(sum(shape) + 1, *shape)
    sigmas = [0.0, -1.0, 1e-4, 0.5, 0.999, 1.7, 3.3] + list(
        np.random.default_rng(0).uniform(0, 1, 20 if shape == (97, 131) else 3))
    for sigma in sigmas:
        _equal(native.gaussian_blur7(a, sigma), cv2.GaussianBlur(a, (7, 7), sigma))


@pytest.mark.parametrize("ksize", [5, 7, 9, 11])
def test_box_blur_matches_cv2(ksize):
    for shape in SHAPES:
        a = _img(ksize + sum(shape), *shape)
        _equal(native.box_blur(a, ksize), cv2.blur(a, (ksize, ksize)))
    with pytest.raises(ValueError, match="odd ksize"):
        native.box_blur(a, 4)


def test_normalize_minmax_matches_cv2():
    for shape in SHAPES:
        a = _img(sum(shape) + 2, *shape)
        blurred = cv2.blur(a, (5, 5)).astype(np.float32)
        for x in (a / (blurred + 0.01), a - blurred, a * 0.3 + 7.0, np.full(a.shape, 3.5)):
            for dt in (np.float32, np.float64):
                x = x.astype(dt)
                want = cv2.normalize(x, None, alpha=0, beta=255, norm_type=cv2.NORM_MINMAX)
                _equal(native.normalize_minmax(x), want)
    assert not native.normalize_minmax(np.full((4, 4), 2.0)).any()      # max == min: 0


def test_resize_linear_matches_cv2():
    for shape in SHAPES:
        a = _img(sum(shape) + 3, *shape)
        h, w = shape
        for out in ((640, 480), (256, 256), (128, 128), (37, 29), (1, 1), (w, h),
                    (2 * w, 2 * h), (max(w // 2, 1), max(h // 2, 1)), (3 * w + 1, h + 5)):
            _equal(native.resize_linear(a, out), cv2.resize(a, out))
    a = _img(9, 960, 1280)                        # cv2's exact 2x downscale
    _equal(native.resize_linear(a, (640, 480)), cv2.resize(a, (640, 480)))
    for bad in (a[:, :, 0], a[:0]):
        with pytest.raises(ValueError, match="non-empty"):
            native.resize_linear(bad, (4, 4))


# ---------------------------------------------------------------------------
# 2. the augmentations against the JAX package's, under one seed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, args", [("distort_hsv", (0.1, 0.3, 0.3)),
                                        ("distort_hsv", (0.0, 0.5, 0.0)),
                                        ("distort_hsv", (0.5, 0.0, 1.0)),
                                        ("distort_smooth", (1.0,)),
                                        ("pencil_sharpen", (0.9,)),
                                        ("pencil_sharpen", (0.5,))],
                         ids=["hsv", "hsv_s", "hsv_hv", "smooth", "sharpen", "sharpen_half"])
def test_augmentation_matches_jax(name, args):
    for shape in ((480, 640), (128, 128), (97, 131)):
        img = _img(len(name) + shape[1], *shape)
        for seed in range(12):
            r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
            got = getattr(TT, name)(img, r_port, *args)
            want = getattr(JT, name)(img, r_jax, *args)
            _equal(got, want)
            assert r_port.bit_generator.state == r_jax.bit_generator.state   # draws alike


def test_background_bank_matches_jax(tmp_path):
    d = tmp_path / "bg"
    shutil.copytree(BACKGROUNDS, d)
    shutil.copy(d / "bg_1.jpg", d / "upper.JPG")     # not listed: the suffix is case-sensitive
    (d / "notes.txt").write_text("x")
    port, jax_bank = TT.BackgroundBank(str(d)), JT.BackgroundBank(str(d))
    assert port.files == jax_bank.files and len(port.files) == 9
    rng = np.random.default_rng(0)
    for shape in ((480, 640), (128, 128)):
        img = _img(1, *shape)
        mask = np.zeros(shape, np.int32)
        mask[shape[0] // 4:shape[0] // 2, shape[1] // 3:shape[1] // 2] = 1
        mask[:3, :3] = -1
        for seed in range(16):
            r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
            _equal(port(img, mask, r_port), jax_bank(img, mask, r_jax))
            assert r_port.bit_generator.state == r_jax.bit_generator.state
    # a listed file that has gone: cv2.imread gives None, the bank draws again
    os.remove(d / "bg_0.jpg")
    for seed in range(8):
        r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
        _equal(port(img, mask, r_port), jax_bank(img, mask, r_jax))
        assert r_port.bit_generator.state == r_jax.bit_generator.state
    # no directory, or an empty one: no draw
    for empty in (None, str(tmp_path / "missing"), str(tmp_path)):
        r = np.random.default_rng(rng.integers(1 << 30))
        before = r.bit_generator.state
        assert TT.BackgroundBank(empty)(img, mask, r) is img
        assert r.bit_generator.state == before


# ---------------------------------------------------------------------------
# 3. samples with every augmentation on, on JPEG frames
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    """make_bop_dataset's tree (three classes) with its train frames
    re-encoded as JPEG (4:2:0 and 4:4:4) and listed by their .jpg names."""
    root = tmp_path_factory.mktemp("jpeg_bop")
    yaml_path = make_bop_dataset.write_dataset(str(root), n_train=4, n_test=1, n_fg=3,
                                               single_class=None, seed=3)
    names = []
    for j in range(4):
        rgb = root / "train" / "000001" / "rgb"
        img = cv2.imread(str(rgb / f"{j:06d}.png"), cv2.IMREAD_UNCHANGED)
        sampling = 0x221111 if j % 2 == 0 else 0x111111
        cv2.imwrite(str(rgb / f"{j:06d}.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, 85,
                                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
        names.append(f"train/000001/rgb/{j:06d}.jpg")
    with open(root / "jpeg_list.txt", "w") as f:
        f.write("\n".join(names))
    return yaml_path, str(root / "jpeg_list.txt")


@pytest.mark.parametrize("fast", [False, True], ids=["slow", "fast"])
def test_samples_with_every_augmentation_match_jax(jpeg_tree, fast, monkeypatch):
    yaml_path, jpeg_list = jpeg_tree
    calls = dict.fromkeys(("bgr2hsv", "gaussian_blur7", "box_blur", "resize_linear",
                           "jpeg_decode"), 0)
    for name in calls:                          # each augmentation's primitive runs
        def counted(*a, _f=getattr(native, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(native, name, counted)
    pair = []
    for m in (jcfg, tcfg):
        cfg = m.load_yaml_config(yaml_path)
        cfg = cfg.replace(model=m.ModelConfig(input_res=RES),
                          data=dataclasses.replace(cfg.data, train_list=jpeg_list,
                                                   fast_pipeline=fast),
                          solver=m.SolverConfig(max_objs=2, ims_per_batch=2, **EVERY_AUG))
        pair.append(cfg)
    jds = jpipe.BOPPoseDataset(pair[0], jpeg_list, train=True)
    tds = tpipe.BOPPoseDataset(pair[1], jpeg_list, train=True)
    n = 0
    for seed in (1, 2, 3):
        for idx in range(4):
            got, want = tds.sample(idx, seed=seed), jds.sample(idx, seed=seed)
            assert (got is None) == (want is None)
            if got is None:
                continue
            n += 1
            _equal(got["image"], want["image"])
            _equal(got["mask"], want["mask"])
            np.testing.assert_array_equal(got["class_ids"], want["class_ids"])
            np.testing.assert_allclose(got["rotations"], want["rotations"], atol=1e-6)
            np.testing.assert_allclose(got["translations"], want["translations"], rtol=1e-6)
            np.testing.assert_allclose(got["bbox_trans"], want["bbox_trans"], atol=1e-4)
            assert got["image"].shape == (RES, RES, 3)
    assert n >= 10
    assert all(calls.values()), calls
