"""PyTorch port, the device warp (`kd6d_pose_adlp_tpu_torch/ops/warp.py`),
`data/transforms.internal_frame_matrix` and the raw-frame endpoint
(`engine/serving.build_frame_infer_fn`), against the JAX package's
`ops/warp.py` and `build_frame_infer_fn` on the same seeded numpy inputs.

Tolerances, with the largest difference measured on this CPU beside them:
  dzi_affine_rows, compose_affine, invert_affine   atol 1e-6 + rtol 1e-6
                                                   (max 0 / 2.4e-7 / 0)
  internal_frame_matrix                            equal
  frame_to_crop at JAX's three windows:
    bbox_trans                                     rtol 1e-5, atol 1e-5
                                                   (max 1.5e-5 of ~1e2)
    uint8 crops vs JAX's jitted warp               <= 1 LSB (71 of 98,304
                                                   values, 0.07%, in the
                                                   interior window; none
                                                   in the other two)
  the frame endpoint at 64² on JAX's draws:
    crops vs JAX's warp op by op / jitted          equal / <= 1 LSB (11
                                                   of 36,864 values off by 1)
    the crop endpoint on JAX's jitted crops        kp2d atol 1e-2 px (2.1e-4),
                                                   score atol 1e-5 (3.0e-8)
    the port's frame endpoint (JAX's frame-vs-     kp2d, score rtol 1e-3 /
      crop bound, tests/test_warp_device.py)       atol 0.5 (0.035 px, 5.8e-6)
    cls, valid, vote_valid                         equal
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.data import transforms as jT
from kd6d_pose_adlp_tpu.data.synthetic import SyntheticPoseDataset as JSynth
from kd6d_pose_adlp_tpu.engine.serving import build_frame_infer_fn as j_build_frame
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu.ops import warp as jwarp
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.data import transforms as tT
from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
from kd6d_pose_adlp_tpu_torch.engine.serving import SINGLE_KEYS, build_frame_infer_fn
from kd6d_pose_adlp_tpu_torch.ops import warp
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_serving import TEST, _randomize_bn

RES, SEED = 64, 7
FRAME_HW = (120, 160)


def test_affine_helpers_match_jax():
    rng = np.random.default_rng(0)
    centers = np.array([[320.0, 240.0], [100.5, 411.25], [-20.0, 600.0]], np.float32)
    scales = np.array([192.0, 97.5, 300.0], np.float32)
    got = warp.dzi_affine_rows(torch.from_numpy(centers), torch.from_numpy(scales), 256)
    want = jwarp.dzi_affine_rows(jnp.asarray(centers), jnp.asarray(scales), 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    A = rng.normal(size=(4, 2, 3)).astype(np.float32)
    A[:, 0, 0] += 2.0
    A[:, 1, 1] += 2.0
    Bm = rng.normal(size=(4, 2, 3)).astype(np.float32)
    np.testing.assert_allclose(
        warp.compose_affine(torch.from_numpy(A), torch.from_numpy(Bm)).numpy(),
        np.asarray(jwarp.compose_affine(jnp.asarray(A), jnp.asarray(Bm))), rtol=1e-6, atol=1e-6)
    inv = warp.invert_affine(torch.from_numpy(A))
    np.testing.assert_allclose(inv.numpy(), np.asarray(jwarp.invert_affine(jnp.asarray(A))),
                               rtol=1e-6, atol=1e-6)
    eye = np.broadcast_to(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (4, 2, 3))
    np.testing.assert_allclose(warp.compose_affine(torch.from_numpy(A), inv).numpy(), eye,
                               atol=1e-5)


@pytest.mark.parametrize("w, h", [(500, 375), (640, 480), (480, 640), (1280, 720)])
def test_internal_frame_matrix_matches_jax(w, h):
    np.testing.assert_array_equal(tT.internal_frame_matrix(w, h, 640, 480),
                                  jT.internal_frame_matrix(w, h, 640, 480))


@pytest.mark.parametrize("center, scale", [
    ((320.0, 240.0), 200.0),     # fully interior window
    ((30.0, 40.0), 260.0),       # spills past the raw image AND the frame edge
    ((620.0, 455.0), 180.0),     # bottom-right, past the internal frame
])
def test_frame_to_crop_matches_jax(center, scale):
    """JAX's windows (tests/test_warp_device.py:55-59) on a 375x500 frame at
    128²: bbox_trans within rtol 1e-5 (max |diff| 1.5e-5), crops within
    1 LSB of JAX's jitted warp, fewer than 5% off (measured: 71 of 98,304
    values, 0.07%, in the interior window, none in the other two)."""
    rng = np.random.default_rng(7)
    h, w = 375, 500
    W, H, res = 640, 480, 128
    raw = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    M_int = np.asarray(jT.internal_frame_matrix(w, h, W, H)[:2], np.float32)
    c = np.asarray([center, (center[0] + 7.25, center[1] - 3.5)], np.float32)
    s = np.asarray([scale, scale * 0.75], np.float32)
    jc, jb = jax.jit(lambda f, c, s: jwarp.frame_to_crop(
        f, jnp.asarray(M_int), c, s, res, internal_wh=(W, H)))(raw, c, s)
    tc, tb = warp.frame_to_crop(torch.from_numpy(raw), torch.from_numpy(M_int),
                                torch.from_numpy(c), torch.from_numpy(s), res,
                                internal_wh=(W, H))
    assert tc.dtype == torch.uint8 and tc.shape == (2, res, res, 3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)
    diff = np.abs(tc.numpy().astype(np.int32) - np.asarray(jc).astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.05, (diff > 0).mean()


@pytest.fixture(scope="module")
def frame_endpoints():
    jc = jcfg.Config(model=jcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES),
                     test=jcfg.TestConfig(**TEST))
    tc = tcfg.Config(model=tcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES),
                     test=tcfg.TestConfig(**TEST))
    ds = SyntheticPoseDataset(n_fg=15, input_res=RES, seed=0)
    jds = JSynth(n_fg=15, input_res=RES, seed=0)
    jnet = JPoseNet(cfg=jc.model, n_fg=15)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)))
    variables = _randomize_bn(variables, np.random.default_rng(0))
    j_infer = jax.jit(j_build_frame(jc, jds.consts(), variables, FRAME_HW))
    consts = ds.consts(device="cpu")
    t_infer = build_frame_infer_fn(tc, consts, from_jax_variables(variables), FRAME_HW,
                                   device="cpu")
    return j_infer, t_infer, tc, consts


def _frames(B=3):
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (B, *FRAME_HW, 3), dtype=np.uint8)
    centers = np.array([[320.0, 240.0], [280.0, 300.0], [40.0, 60.0]], np.float32)[:B]
    scales = np.array([220.0, 180.0, 300.0], np.float32)[:B]
    return frames, centers, scales


def test_frame_endpoint_matches_jax(frame_endpoints):
    """The raw-frame endpoint at 64² (random-BN darknet_tiny_h, lowered
    confidence_th) on 3 raw 120x160 frames, JAX's RANSAC draws injected.

    The port's crops equal JAX's warp run op by op (measured: equal) and
    are within 1 LSB of its jitted warp, which rounds 11 of 36,864 crop
    values one step apart (FMA contraction in the fused program, as JAX's
    tests/test_warp_device.py:146-149 says). Fed JAX's jitted crops, the
    port's crop endpoint gives JAX's frame endpoint's votes (kp2d atol
    1e-2 px, measured 2.1e-4; score atol 1e-5, measured 3.0e-8; masks
    equal). The port's own frame endpoint is held to JAX's frame-vs-crop
    bound for those rounding steps: kp2d rtol 1e-3 / atol 0.5 px (measured
    0.035), score the same (5.8e-6), masks equal. R and T finite, R
    orthonormal (random-weight votes make EPnP ill-conditioned)."""
    from kd6d_pose_adlp_tpu_torch.engine.serving import build_infer_fn
    from test_torch_port_serving import _jax_gumbel

    j_infer, t_infer, cfg, consts = frame_endpoints
    frames, centers, scales = _frames()
    ids = np.array([0, 4, -1], np.int32)
    want = jax.device_get(j_infer(jnp.asarray(frames), jnp.asarray(centers),
                                  jnp.asarray(scales), jnp.asarray(ids),
                                  jnp.asarray(SEED, jnp.uint32)))
    timings = {}
    got = t_infer(frames, centers, scales, ids, gumbel=_jax_gumbel(SEED), timings=timings)
    assert list(got) == list(SINGLE_KEYS) and timings["warp_s"] >= 0

    M_int = jnp.asarray(jT.internal_frame_matrix(FRAME_HW[1], FRAME_HW[0], 640, 480)[:2])
    args = (jnp.asarray(frames), jnp.asarray(centers), jnp.asarray(scales))
    j_eager, _ = jwarp.frame_to_crop(args[0], M_int, args[1], args[2], RES)
    j_jit, j_bt = jax.jit(lambda f, c, s: jwarp.frame_to_crop(f, M_int, c, s, RES))(*args)
    tcrops, _ = t_infer.crops(frames, centers, scales)
    np.testing.assert_array_equal(tcrops.numpy(), np.asarray(j_eager))
    assert np.abs(tcrops.numpy().astype(int) - np.asarray(j_jit).astype(int)).max() <= 1

    vv = want["vote_valid"]
    assert vv[:2].any(axis=1).all(), "lower confidence_th: some image cast no vote"
    on_jax_crops = build_infer_fn(cfg, consts, t_infer.model, device="cpu")(
        np.array(j_jit), np.array(j_bt), ids, gumbel=_jax_gumbel(SEED))
    for out, kp_tol, s_tol in ((on_jax_crops, dict(atol=1e-2), dict(atol=1e-5)),
                               (got, dict(rtol=1e-3, atol=0.5), dict(rtol=1e-3, atol=0.5))):
        np.testing.assert_array_equal(out["vote_valid"].numpy(), vv)
        np.testing.assert_array_equal(out["valid"].numpy(), want["valid"])
        np.testing.assert_array_equal(out["cls"].numpy(), want["cls"])
        np.testing.assert_allclose(out["score"].numpy(), want["score"], **s_tol)
        np.testing.assert_allclose(out["kp2d"].numpy()[vv], want["kp2d"][vv], **kp_tol)
    np.testing.assert_array_equal(got["valid"].numpy(), [True, True, False])
    R, T = got["R"].numpy(), got["T"].numpy()
    assert np.isfinite(R).all() and np.isfinite(T).all()
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-4)


def test_frame_endpoint_is_the_crop_endpoint_on_its_crops(frame_endpoints):
    """The frame endpoint equals `build_infer_fn` fed the warp's own crops
    and crop affines, with the same seed: every output equal."""
    _, t_infer, cfg, consts = frame_endpoints
    frames, centers, scales = _frames(2)
    ids = np.array([1, 2], np.int32)
    crops, bt = t_infer.crops(frames, centers, scales)
    from kd6d_pose_adlp_tpu_torch.engine.serving import build_infer_fn
    crop_fn = build_infer_fn(cfg, consts, t_infer.model, device="cpu")
    a = t_infer(frames, centers, scales, ids, seed=11)
    b = crop_fn(crops, bt, ids, seed=11)
    for k in SINGLE_KEYS:
        assert torch.equal(a[k], b[k]), k
