"""PyTorch port, RANSAC, voting and the pose postprocess
(`kd6d_pose_adlp_tpu_torch/ops/epnp.py`, `ops/voting.py`,
`engine/postprocess.py`) against the JAX package on the same seeded numpy
inputs; RANSAC's Gumbel draws are JAX's, handed to the port.

Tolerances, with the largest difference measured on this CPU beside them:
  ransac_epnp, JAX draws: n_in             equal
                          vs JAX R / T     0.1 deg / 0.5 mm  (3.4e-5 deg, 3.8e-6 mm)
                          vs ground truth  1 deg             (0.25 deg)
  vote_cells: valid                        equal
              score, box_size, kp2d        atol 1e-4, rtol 1e-5, 1e-3 px (0, 0, 0)
  planted scene: vote_valid, n_inliers     equal
                 score                     atol 1e-5 (0)
                 vs JAX                    0.1 deg / 0.5 mm (4.4e-5 deg, 1.8e-4 mm)
                 vs ground truth           3 deg / 15 mm  (0.77 deg, 6.7 mm)
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.data.batch import Batch, TaskConsts
from kd6d_pose_adlp_tpu.engine.postprocess import build_postprocess
from kd6d_pose_adlp_tpu.models import anchors as anchor_lib
from kd6d_pose_adlp_tpu.models import coder
from kd6d_pose_adlp_tpu.ops import epnp as jep
from kd6d_pose_adlp_tpu.ops.voting import vote_cells as j_vote_cells
from kd6d_pose_adlp_tpu.utils import geometry as geo
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.data.batch import TaskConsts as TTaskConsts
from kd6d_pose_adlp_tpu_torch.engine.postprocess import (
    build_postprocess as t_build_postprocess)
from kd6d_pose_adlp_tpu_torch.ops import epnp as tep
from kd6d_pose_adlp_tpu_torch.ops.voting import vote_cells as t_vote_cells

K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]],
             np.float32)
t = torch.from_numpy


def _rot_deg(Ra, Rb):
    """Angle between two rotations from the chord |Ra - Rb|_F = 2 sqrt(2)
    sin(angle / 2): stable near 0, where arccos of the fp32 trace floors at
    a few hundredths of a degree."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0))))


def _scene(rng, n=24, noise=0.0):
    R = geo.quaternion2rotation(rng.normal(size=4)).astype(np.float32)
    T = np.array([rng.uniform(-80, 80), rng.uniform(-60, 60),
                  rng.uniform(600, 1100)], np.float32)
    pts3d = rng.uniform(-60, 60, size=(n, 3)).astype(np.float32)
    pts2d = geo.project_points(K, R, T, pts3d).astype(np.float32)
    pts2d += rng.normal(scale=noise, size=pts2d.shape).astype(np.float32)
    return R, T, pts3d, pts2d


def test_ransac_epnp_with_jax_draws():
    """Outlier-contaminated correspondences, masked slots, JAX's Gumbel
    hypotheses injected: same inlier count, same pose."""
    rng = np.random.default_rng(1)
    B, N, iters = 2, 48, 16
    P3, P2, V, gt = [], [], [], []
    for _ in range(B):
        R, T, p3, p2 = _scene(rng, n=N, noise=0.5)
        p2[:8] += rng.uniform(-60, 60, size=(8, 2)).astype(np.float32)   # outliers
        v = np.ones(N, bool)
        v[-6:] = False                                                    # padding
        P3.append(p3), P2.append(p2), V.append(v), gt.append((R, T))
    P3, P2, V = np.stack(P3), np.stack(P2), np.stack(V)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    gumbel = np.stack([np.array(jax.random.gumbel(k, (iters, N))) for k in keys])
    Rj, Tj, nj = jax.vmap(lambda a, b, c, k: jep.ransac_epnp(
        a, b, c, jnp.asarray(K), k, iters=iters))(
        jnp.asarray(P3), jnp.asarray(P2), jnp.asarray(V), keys)
    R, T, n = tep.ransac_epnp(t(P3), t(P2), t(V), t(K), iters=iters,
                              gumbel=t(gumbel))
    np.testing.assert_array_equal(n.numpy(), np.asarray(nj))
    for i in range(B):
        assert _rot_deg(np.asarray(Rj[i]), R[i].numpy()) < 0.1
        assert np.linalg.norm(np.asarray(Tj[i]) - T[i].numpy()) < 0.5
        assert _rot_deg(gt[i][0], R[i].numpy()) < 1.0


# ---------------------------------------------------------------------------
# voting
# ---------------------------------------------------------------------------

def test_vote_cells_match_jax_including_ties():
    RES, STRIDES, SIZES = 128, (8, 16, 32, 64), (32, 64, 128, 256, 512)
    rng = np.random.default_rng(2)
    B, A = 3, anchor_lib.make_anchors(RES, STRIDES, SIZES[:4]).shape[0]
    scores = rng.uniform(0.0, 0.3, (B, A)).astype(np.float32)
    scores[0, 10] = scores[0, 20] = scores[0, 30] = 0.9      # planted tie, level 0
    scores[1, 270] = scores[1, 300] = 0.8                    # tie, level 1
    scores[2] = np.minimum(scores[2], 0.05)                  # no candidate at all
    pred16 = rng.normal(0.0, 0.3, (B, A, 16)).astype(np.float32)
    kw = dict(input_res=RES, strides=STRIDES, all_sizes=SIZES, confidence_th=0.1,
              positive_num=10, positive_lambda=1.0, max_votes=16)
    want = j_vote_cells(jnp.asarray(scores), jnp.asarray(pred16), **kw)
    got = t_vote_cells(t(scores), t(pred16), **kw)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid[:2].any() and not valid[2].any()
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), atol=1e-4)
    np.testing.assert_allclose(got.box_size.numpy(), np.asarray(want.box_size),
                               rtol=1e-5)
    np.testing.assert_allclose(got.kp2d.numpy()[valid], np.asarray(want.kp2d)[valid],
                               atol=1e-3)


# ---------------------------------------------------------------------------
# the postprocess on a planted scene
# ---------------------------------------------------------------------------

def test_postprocess_planted_scene_matches_jax_and_ground_truth():
    """GT-encoded noisy keypoints at every cell, ~30 hot cells for the GT
    class (the scene of tests/test_postprocess_parity.py)."""
    RES, STRIDES, SIZES, N_FG = 128, (8, 16, 32, 64), (32, 64, 128, 256, 512), 15
    iters, max_votes, lhm = 16, 16, 2
    rng = np.random.default_rng(0)
    kp3d = np.stack([np.array([[sx * (30 + c), sy * 25, sz * 40]
                               for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                              np.float32) for c in range(N_FG)])
    cls_gt = 3
    R_gt = geo.quaternion2rotation(rng.normal(size=4)).astype(np.float32)
    T_gt = np.array([20.0, -15.0, 820.0], np.float32)
    proj = geo.project_points(K, R_gt, T_gt, kp3d[cls_gt])
    Mc = geo.dzi_affine(np.asarray(proj).mean(0), 260.0, RES)
    kp_crop = geo.apply_affine(Mc, proj)
    anchors = anchor_lib.make_anchors(RES, STRIDES, SIZES[:4])
    A = anchors.shape[0]
    logits = np.full((A, N_FG), -8.0, np.float32)
    hot = rng.choice(A, 30, replace=False)
    logits[hot, cls_gt] = rng.uniform(-1.5, 3.0, size=30)
    noisy = kp_crop[None] + rng.normal(scale=1.0, size=(A, 8, 2)).astype(np.float32)
    enc = np.asarray(coder.encode(jnp.asarray(noisy), jnp.asarray(anchors)))
    reg = np.tile(enc[:, None, :], (1, N_FG, 1)).reshape(A, N_FG * 16)

    cfg = jcfg.Config(model=jcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES),
                      solver=jcfg.SolverConfig(max_objs=2, max_pos=32),
                      test=jcfg.TestConfig(max_votes=max_votes, ransac_iters=iters,
                                           lhm_iters=lhm))
    post = build_postprocess(cfg, TaskConsts.create(K, kp3d, np.full(N_FG, 150.0)))
    batch = Batch(images=jnp.zeros((1, RES, RES, 3)),
                  mask=jnp.zeros((1, RES, RES), jnp.int32),
                  class_ids=jnp.asarray([[cls_gt, -1]], jnp.int32),
                  rotations=jnp.zeros((1, 2, 3, 3)), translations=jnp.zeros((1, 2, 3)),
                  bbox_trans=jnp.asarray(Mc)[None])
    key = jax.random.PRNGKey(0)
    want = jax.device_get(post(jnp.asarray(logits)[None], jnp.asarray(reg)[None],
                               batch, key))
    gumbel = np.array(jax.random.gumbel(jax.random.split(key, 1)[0],
                                          (iters, max_votes * 8)))[None]

    tc = tcfg.Config(model=tcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES),
                     solver=tcfg.SolverConfig(max_objs=2, max_pos=32),
                     test=tcfg.TestConfig(max_votes=max_votes, ransac_iters=iters,
                                          lhm_iters=lhm))
    tpost = t_build_postprocess(tc, TTaskConsts.create(K, kp3d, np.full(N_FG, 150.0),
                                                       device="cpu"))
    got = tpost(t(logits)[None], t(reg)[None], torch.tensor([cls_gt]), t(Mc)[None],
                gumbel=t(gumbel))
    assert bool(got["valid"][0]) and bool(want["valid"][0])
    np.testing.assert_array_equal(got["vote_valid"].numpy(), want["vote_valid"])
    np.testing.assert_array_equal(got["n_inliers"].numpy(), want["n_inliers"])
    np.testing.assert_allclose(got["score"].numpy(), want["score"], atol=1e-5)
    R, T = got["R"][0].numpy(), got["T"][0].numpy()
    assert _rot_deg(want["R"][0], R) < 0.1
    assert np.linalg.norm(want["T"][0] - T) < 0.5
    assert _rot_deg(R_gt, R) < 3.0
    assert np.linalg.norm(T_gt - T) < 15.0

    # a negative class id marks the image invalid
    neg = tpost(t(logits)[None], t(reg)[None], torch.tensor([-1]), t(Mc)[None],
                gumbel=t(gumbel))
    assert not bool(neg["valid"][0])
