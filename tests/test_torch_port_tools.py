"""PyTorch port, the tools (`kd6d_pose_adlp_tpu_torch/ops/boxes.py`,
`utils/profiling.py`, `tools/visualizer.py`) against the JAX package's
`ops/boxes.py`, `utils/profiling.py` and `tools/visualizer.py`, on the CPU,
on seeded numpy inputs.

Tolerances:
  box_iou                                  rtol 1e-6
  nms, ml_nms keep-masks (seeds, valid)    equal
  grad_param_ratios                        rtol 1e-6
  draw_bounding_box, draw_pose_axes,       every pixel the port draws within 1
    draw_2d_keypoints, draw_mesh_contour   px (Chebyshev) of one JAX's cv2
                                           draws, and the other way round
  draw_mesh_contour's hull                 JAX's (cv2.convexHull's) vertex set
  per_depth_series                         JAX's plotted series (matplotlib's
                                           lines, read back), equal
  the PNGs                                 decode through data/png.read; the
                                           points at the pixels of
                                           `to_pixels`, in the blended colours
"""
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu.ops import boxes as jboxes
from kd6d_pose_adlp_tpu.tools import visualizer as jvis
from kd6d_pose_adlp_tpu.utils import profiling as jprof
from kd6d_pose_adlp_tpu_torch.data import png
from kd6d_pose_adlp_tpu_torch.ops import boxes as tboxes
from kd6d_pose_adlp_tpu_torch.tools import visualizer as tvis
from kd6d_pose_adlp_tpu_torch.utils import profiling as tprof
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)

H, W = 120, 160
K = np.array([[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1]])


def _boxes(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return (b, rng.random(n).astype(np.float32), rng.integers(0, 3, n),
            rng.random(n) > 0.25)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_iou_and_nms_match_jax(seed):
    b, s, lab, valid = _boxes(seed)
    want = np.asarray(jboxes.box_iou(jnp.asarray(b), jnp.asarray(b[:7])))
    got = tboxes.box_iou(torch.from_numpy(b), torch.from_numpy(b[:7])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    tb, ts = torch.from_numpy(b), torch.from_numpy(s)
    for v in (None, valid):
        jv, tv = (None, None) if v is None else (jnp.asarray(v), torch.from_numpy(v))
        keep = tboxes.nms(tb, ts, 0.3, tv).numpy()
        np.testing.assert_array_equal(keep, np.asarray(jboxes.nms(jnp.asarray(b),
                                                                  jnp.asarray(s), 0.3, jv)))
        assert 0 < keep.sum() < len(b)
        ml = tboxes.ml_nms(tb, ts, torch.from_numpy(lab), 0.3, tv).numpy()
        np.testing.assert_array_equal(ml, np.asarray(jboxes.ml_nms(
            jnp.asarray(b), jnp.asarray(s), jnp.asarray(lab), 0.3, jv)))
        assert ml.sum() >= keep.sum()          # other labels never suppress


def test_grad_param_ratios_match_jax():
    rng = np.random.default_rng(3)
    shapes = [(8, 3, 3, 3), (8,), (16, 8), (1,)]
    grads = [rng.normal(size=s).astype(np.float32) * 1e-3 for s in shapes]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    want = jprof.grad_param_ratios([jnp.asarray(g) for g in grads],
                                   [jnp.asarray(p) for p in params])
    got = tprof.grad_param_ratios([torch.from_numpy(g) for g in grads],
                                  [torch.from_numpy(p) for p in params])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(32, 32)
    with tprof.trace(str(tmp_path / "prof")) as prof:
        (a @ a).sum()
    path = prof.trace_path
    assert os.path.dirname(path) == str(tmp_path / "prof") and path.endswith(".pt.trace.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def _pose(seed: int):
    rng = np.random.default_rng(seed)
    R = cv2.Rodrigues(rng.normal(size=3) * 0.8)[0]
    T = np.array([rng.uniform(-40, 40), rng.uniform(-30, 30), rng.uniform(350, 500)])
    return R, T


def _near(a: np.ndarray, b: np.ndarray) -> bool:
    """Every pixel set in `a` is within 1 px (Chebyshev) of one set in b."""
    grown = cv2.dilate(b.astype(np.uint8), np.ones((3, 3), np.uint8)) > 0
    return bool((~a | grown).all())


def _drawn(img: np.ndarray) -> np.ndarray:
    return (img != 0).any(-1)


def _corners(half: float = 40.0) -> np.ndarray:
    return np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                     for z in (-half, half)], np.float64)


# the last case puts part of the object off the image (clipped lines)
@pytest.mark.parametrize("seed, shift", [(0, 0.0), (1, 0.0), (2, 0.0), (3, 90.0)])
def test_draws_match_jax(seed, shift):
    R, T = _pose(seed)
    T = T + np.array([shift, 0, 0])
    base = np.zeros((H, W, 3), np.uint8)
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(300, 3)) * np.array([30, 20, 40])
    kp = rng.uniform(-10, 170, (12, 2))
    sc = rng.random(12)
    bt = np.array([[0.9, 0.05, 4.0], [-0.05, 0.9, 3.0]])
    cases = {
        "box": (lambda m: m.draw_bounding_box(base, R, T, _corners(), K),),
        "box_trans": (lambda m: m.draw_bounding_box(base, R, T, _corners(), K,
                                                    bbox_trans=bt),),
        "axes": (lambda m: m.draw_pose_axes(base, R, T, K),),
        "keypoints": (lambda m: m.draw_2d_keypoints(base, kp, radius=3, scores=sc),),
        "contour": (lambda m: m.draw_mesh_contour(base, R, T, K, verts),),
    }
    for name, (draw,) in cases.items():
        want, got = draw(jvis), draw(tvis)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        a, b = _drawn(got), _drawn(want)
        assert b.any(), name
        assert _near(a, b) and _near(b, a), name
        # the colours are JAX's
        assert {tuple(c) for c in got[a]} <= {tuple(c) for c in want[b]}, name


def test_hull_has_cv2s_vertex_set():
    for seed in range(4):
        pts = np.random.default_rng(seed).normal(size=(200, 2)).astype(np.float32) * 50
        want = {tuple(p) for p in cv2.convexHull(pts).reshape(-1, 2)}
        got = {tuple(p) for p in tvis.convex_hull(pts).astype(np.float32)}
        assert got == want, seed


RESULTS = [
    # bins with and without entries, a metric missing in a bin
    dict(adi_per_depth=[{"ADI.10d": 50.0, "ADI.02d": 10.0}, {}, {"ADI.10d": 70.0}],
         rep_per_depth=[{"REP05px": 20.0}, {}, {"REP05px": 30.0, "REP10px": 60.0}],
         depth_range=[512.5, 1103.25001]),
    dict(adi_per_depth=[{"ADI.10d": 100.0}], rep_per_depth=[{"REP05px": 90.0}],
         depth_range=[700.0, 700.00001]),
]


def _jax_series(results: dict, tmp_path):
    """(xs, rep, adi) as JAX's vis_accuracy_per_depth hands them to
    matplotlib: the panels' lines, read off the figure it saves."""
    import matplotlib.figure
    seen = {}
    save = matplotlib.figure.Figure.savefig

    def grab(fig, *a, **kw):
        seen["series"] = [{ln.get_label(): (np.asarray(ln.get_xdata()),
                                            list(ln.get_ydata())) for ln in ax.get_lines()}
                          for ax in fig.axes]
        return save(fig, *a, **kw)

    matplotlib.figure.Figure.savefig = grab
    try:
        assert jvis.vis_accuracy_per_depth(results, str(tmp_path / "j.png"))
    finally:
        matplotlib.figure.Figure.savefig = save
    return seen["series"]


@pytest.mark.parametrize("i", range(len(RESULTS)))
def test_per_depth_series_match_jax(i, tmp_path):
    rep_lines, adi_lines = _jax_series(RESULTS[i], tmp_path)
    xs, rep, adi = tvis.per_depth_series(RESULTS[i])
    for got, want in ((rep, rep_lines), (adi, adi_lines)):
        assert list(got) == list(want)                     # names, in plotting order
        for k, (wx, wy) in want.items():
            np.testing.assert_array_equal(xs, wx)
            assert got[k] == wy, k
    path = tvis.vis_accuracy_per_depth(RESULTS[i], str(tmp_path / "d" / "acc.png"))
    img = png.read(path)
    assert img.shape == tvis.DEPTH_SIZE + (3,)
    # the first curve's markers, in the first colour of the cycle
    box = (60, 30, tvis.DEPTH_SIZE[1] // 2 - 21, tvis.DEPTH_SIZE[0] - 41)
    ys = list(rep.values())[0]
    pts = tvis.to_pixels(np.stack([xs, ys], 1), tvis.data_limits(xs),
                         tvis.data_limits([v for c in rep.values() for v in c]), box)
    for x, y in np.rint(pts).astype(int):
        assert tuple(img[y, x]) in {tvis.CYCLE[j] for j in range(len(rep))}


def test_cloud_png_holds_the_points(tmp_path):
    s = np.array([[0.1, 0.2], [0.5, 0.9]])
    t = np.array([[0.9, 0.1], [0.3, 0.6], [0.7, 0.5]])
    sw, tw = np.array([1.0, 0.0]), np.array([0.2, 1.0, 0.5])
    path = tvis.vis_kd_clouds(s, t, sw, tw, 12, str(tmp_path / "vis"), loss=0.5)
    assert path == str(tmp_path / "vis" / "12_img_2d.png")
    img = png.read(path)
    assert img.shape == tvis.CLOUD_SIZE + (3,)
    ss, tt, s_area, t_area, xlim, ylim = tvis.cloud_series(s, t, sw, tw)
    np.testing.assert_allclose(s_area, 10 + 200 * sw / (sw.max() + 1e-9))   # JAX's sizes
    np.testing.assert_allclose(t_area, 10 + 200 * tw / (tw.max() + 1e-9))
    # y points down: the smaller y is higher in the image
    ps = tvis.to_pixels(s, xlim, ylim, tvis.CLOUD_BOX, invert_y=True)
    assert ps[0, 1] < ps[1, 1]
    for pts, color in ((ps, (128, 192, 128)),
                       (tvis.to_pixels(t, xlim, ylim, tvis.CLOUD_BOX, invert_y=True),
                        (128, 128, 255))):
        for x, y in np.rint(pts).astype(int):
            assert tuple(img[y, x]) == color, (x, y, img[y, x])
    # a larger weight draws a larger marker
    r = tvis.marker_radius(t_area)
    assert r[1] > r[2] > r[0]
