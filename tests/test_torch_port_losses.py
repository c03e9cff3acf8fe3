"""PyTorch port, loss assembly (`kd6d_pose_adlp_tpu_torch/ops/ssc.py`,
`ops/focal.py`, `ops/object_space.py`, `engine/losses.py`,
`engine/steps.teacher_knowledge`) against the JAX package on the same
seeded inputs, with SSC's uniform draw taken from JAX's key.

Scenes: synthetic 64² crops (darknet_tiny_h, 4 levels, 85 cells) with a
second, painted object per image, so SSC sees two GTs. Tolerances, with the
largest difference measured on this CPU beside them:
  SSC labels and matched GT                  bit-equal
  prepare_targets corners (mm / px)          rtol 1e-6, atol 1e-4 (max 6.1e-5 px)
  focal / object-space / image-space values  rtol 1e-5
  their gradients                            rtol 1e-4, atol 1e-6
  KD clouds                                  rtol 1e-6, atol 1e-6; slot order exact
  kd_ot_loss and pose_losses values          rtol 2e-4
  gradients through the Sinkhorn term        rtol 1e-3, atol 1e-6 on the logits;
                                             cosine >= 0.99 on the keypoints
                                             (near-one-hot plan, as in the
                                             Sinkhorn file)
  teacher votes                              slots and validity exact,
                                             keypoints atol 1e-3 px
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.data.batch import Batch as JBatch
from kd6d_pose_adlp_tpu.data.synthetic import SyntheticPoseDataset as JSynth
from kd6d_pose_adlp_tpu.engine import losses as jl
from kd6d_pose_adlp_tpu.engine.steps import teacher_knowledge as j_teacher_knowledge
from kd6d_pose_adlp_tpu.ops import ssc as jssc
from kd6d_pose_adlp_tpu.ops.focal import sigmoid_focal_loss as j_focal
from kd6d_pose_adlp_tpu.ops.object_space import (image_space_loss as j_img_loss,
                                                 object_space_loss as j_obj_loss)
from kd6d_pose_adlp_tpu.ops.voting import Votes as JVotes
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.data.batch import Batch, TaskConsts
from kd6d_pose_adlp_tpu_torch.engine import losses as tl
from kd6d_pose_adlp_tpu_torch.engine.steps import teacher_knowledge
from kd6d_pose_adlp_tpu_torch.ops import ssc
from kd6d_pose_adlp_tpu_torch.ops.focal import sigmoid_focal_loss
from kd6d_pose_adlp_tpu_torch.ops.object_space import image_space_loss, object_space_loss
from kd6d_pose_adlp_tpu_torch.ops.voting import Votes

RES = 64
B = 4
N_FG = 15


def _cfgs(**kd):
    kw = dict(model=dict(input_res=RES), solver=dict(max_pos=32),
              kd=dict(max_teacher_cells=16, **kd))
    mk = lambda m: m.Config(model=m.ModelConfig(**kw["model"]),
                            solver=m.SolverConfig(**kw["solver"]),
                            kd=m.KDConfig(**kw["kd"]))
    return mk(jcfg), mk(tcfg)


@pytest.fixture(scope="module")
def data():
    ds = JSynth(input_res=RES, seed=3)
    jb = ds.batch(range(B), train=True)
    jb = jb._replace(**{k: np.array(v) for k, v in jb._asdict().items()})
    # a second object per image: a painted square with its own class and a
    # shifted copy of the first pose
    for i in range(B):
        r0 = 8 + 9 * i
        jb.mask[i, r0:r0 + 20, 40:60] = 2
        jb.class_ids[i, 1] = (jb.class_ids[i, 0] + 3) % N_FG
        jb.rotations[i, 1] = jb.rotations[i, 0]
        jb.translations[i, 1] = jb.translations[i, 0] + np.float32([40.0, -30.0, 60.0])
    tb = Batch.from_numpy(**jb._asdict())
    jc = ds.consts()
    tc = TaskConsts.create(np.asarray(jc.K), np.asarray(jc.kp3d),
                           np.asarray(jc.diameters), device="cpu")
    return jb, tb, jc, tc


def _uniform(key, cfg):
    G = 8
    return jax.random.uniform(key, (B, cfg.model.num_cells, G))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssc_assign_is_bit_equal(data, seed):
    jb, tb, jc, tc = data
    jcf, tcf = _cfgs()
    key = jax.random.PRNGKey(seed)
    m = jcf.model
    corners = np.asarray(jc.kp3d)[np.clip(jb.class_ids, 0, None)]
    from kd6d_pose_adlp_tpu.models import coder as jcoder
    kp2d = np.asarray(jcoder.project_corners(jc.K, jb.rotations, jb.translations,
                                             corners, jb.bbox_trans[:, None]))
    jl_, jm = jssc.ssc_assign(key, jb.mask, jb.class_ids, kp2d, input_res=m.input_res,
                              strides=m.level_strides, sizes=m.level_sizes)
    u = torch.from_numpy(np.asarray(_uniform(key, jcf)))
    tl_, tm = ssc.ssc_assign(tb.mask, tb.class_ids, torch.from_numpy(kp2d),
                             input_res=m.input_res, strides=m.level_strides,
                             sizes=m.level_sizes, uniform=u)
    np.testing.assert_array_equal(tl_.numpy(), np.asarray(jl_))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    labels = tl_.numpy()
    assert (labels > 0).any() and (labels == -1).any() and (labels == 0).any()
    # both GTs get positives somewhere in the batch
    assert set(np.unique(tm.numpy()[labels > 0])) == {0, 1}


def test_ssc_generator_draw_is_seeded(data):
    _, tb, _, tc = data
    _, tcf = _cfgs()
    outs = [tl.prepare_targets(tb, tc, tcf, generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(outs[0].labels, outs[1].labels)
    with pytest.raises(ValueError):
        tl.prepare_targets(tb, tc, tcf, uniform=torch.zeros((1, 2, 3)))


def test_prepare_targets_match(data):
    jb, tb, jc, tc = data
    jcf, tcf = _cfgs()
    key = jax.random.PRNGKey(4)
    want = jl.prepare_targets(key, jb, jc, jcf)
    got = tl.prepare_targets(tb, tc, tcf, uniform=torch.from_numpy(
        np.asarray(_uniform(key, jcf))))
    for name in ("labels", "cls_idx", "pos_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("kp3d_cam", "kp2d_tgt"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=1e-6,
                                   atol=1e-4, err_msg=name)


def test_focal_value_and_gradient(data):
    rng = np.random.default_rng(0)
    logits = rng.normal(-2, 2, (B, 85, N_FG)).astype(np.float32)
    labels = rng.integers(-1, N_FG + 1, (B, 85)).astype(np.int32)
    jv, jg = jax.value_and_grad(lambda z: j_focal(z, jnp.asarray(labels)))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    tv = sigmoid_focal_loss(t, torch.from_numpy(labels))
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", ["3D", "2D"])
def test_regression_losses_value_and_gradient(data, kind):
    jb, tb, jc, tc = data
    jcf, tcf = _cfgs()
    key = jax.random.PRNGKey(6)
    tgt = jl.prepare_targets(key, jb, jc, jcf)
    rng = np.random.default_rng(1)
    # predictions near the targets, in the internal frame
    from kd6d_pose_adlp_tpu.models import coder as jcoder
    inv = jcoder.invert_bbox_trans(jb.bbox_trans)[:, None]
    tgt_int = np.asarray(jnp.einsum("bxij,bakj->baki", inv[..., :2], tgt.kp2d_tgt)
                         + inv[..., None, :, 2])
    pred = (tgt_int + rng.normal(0, 3.0, tgt_int.shape)).astype(np.float32)
    pos = np.asarray(tgt.pos_mask)
    if kind == "3D":
        jf = lambda p: j_obj_loss(p, tgt.kp3d_cam, tgt.cls_idx, pos, jc.inv_K, jc.diameters)
        tf = lambda p: object_space_loss(p, torch.from_numpy(np.asarray(tgt.kp3d_cam)),
                                         torch.from_numpy(np.asarray(tgt.cls_idx)),
                                         torch.from_numpy(pos), tc.inv_K, tc.diameters)
    else:
        jf = lambda p: j_img_loss(p, jnp.asarray(tgt_int), pos)
        tf = lambda p: image_space_loss(p, torch.from_numpy(tgt_int), torch.from_numpy(pos))
    jv, jg = jax.value_and_grad(jf)(jnp.asarray(pred))
    t = torch.from_numpy(pred).requires_grad_(True)
    tv = tf(t)
    tv.backward()
    assert float(jv) > 0
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


def _votes(seed, T=16):
    rng = np.random.default_rng(seed)
    kp = rng.uniform(150, 450, (B, T, 8, 2)).astype(np.float32)
    score = rng.uniform(0.1, 0.9, (B, T)).astype(np.float32)
    valid = rng.uniform(size=(B, T)) < 0.7
    valid[0] = False                      # one image with an empty teacher cloud
    score = np.where(valid, score, 0).astype(np.float32)
    box = rng.uniform(50, 90, (B,)).astype(np.float32)
    return (JVotes(kp2d=jnp.asarray(kp), score=jnp.asarray(score),
                   valid=jnp.asarray(valid), box_size=jnp.asarray(box)),
            Votes(kp2d=torch.from_numpy(kp), score=torch.from_numpy(score),
                  valid=torch.from_numpy(valid), box_size=torch.from_numpy(box)))


def _targets(seed, n_pos=(40, 5, 0, 20)):
    """Targets with more positives than max_pos in image 0 (the compaction
    keeps the first 32 by cell index) and none in image 2."""
    rng = np.random.default_rng(seed)
    A = 85
    pos = np.zeros((B, A), bool)
    for i, n in enumerate(n_pos):
        pos[i, rng.choice(A, n, replace=False)] = True
    labels = np.where(pos, 3, 0).astype(np.int32)
    cls_idx = rng.integers(0, N_FG, (B, A)).astype(np.int32)
    kp3d = rng.normal(0, 40, (B, A, 8, 3)).astype(np.float32) + np.float32([0, 0, 800])
    kp2d = rng.uniform(0, RES, (B, A, 8, 2)).astype(np.float32)
    j = jl.Targets(labels=jnp.asarray(labels), cls_idx=jnp.asarray(cls_idx),
                   kp3d_cam=jnp.asarray(kp3d), kp2d_tgt=jnp.asarray(kp2d),
                   pos_mask=jnp.asarray(pos))
    t = tl.Targets(labels=torch.from_numpy(labels),
                   cls_idx=torch.from_numpy(cls_idx).to(torch.int64),
                   kp3d_cam=torch.from_numpy(kp3d), kp2d_tgt=torch.from_numpy(kp2d),
                   pos_mask=torch.from_numpy(pos))
    return j, t


def _student(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(-1, 1.5, (B, 85, N_FG)).astype(np.float32)
    pred_xy = rng.uniform(150, 450, (B, 85, 8, 2)).astype(np.float32)
    return logits, pred_xy


@pytest.mark.parametrize("weighted_ot", [True, False])
def test_build_kd_clouds_match_with_tie_order(weighted_ot):
    jcf, tcf = _cfgs(weighted_ot=weighted_ot)
    jt, tt = _targets(0)
    jv, tv = _votes(1)
    logits, pred_xy = _student(2)
    want = jl.build_kd_clouds(jnp.asarray(logits), jnp.asarray(pred_xy), jt, jv, jcf)
    got = tl.build_kd_clouds(torch.from_numpy(logits), torch.from_numpy(pred_xy), tt, tv, tcf)
    for name, g, w in zip(("x", "y", "a", "b", "img_valid"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(w).astype(np.float32),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert got[4].tolist() == [False, True, False, True]


def test_kd_ot_loss_value_and_gradient():
    jcf, tcf = _cfgs()
    jt, tt = _targets(3)
    jv, tv = _votes(4)
    logits, pred_xy = _student(5)
    jval, (jgl, jgp) = jax.value_and_grad(
        lambda z, p: jl.kd_ot_loss(z, p, jt, jv, jcf), argnums=(0, 1))(
        jnp.asarray(logits), jnp.asarray(pred_xy))
    tz = torch.from_numpy(logits).requires_grad_(True)
    tp = torch.from_numpy(pred_xy).requires_grad_(True)
    tval = tl.kd_ot_loss(tz, tp, tt, tv, tcf)
    tval.backward()
    assert float(jval) > 0
    np.testing.assert_allclose(float(tval), float(jval), rtol=2e-4)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jgl), rtol=1e-3, atol=1e-6)
    g, w = tp.grad.numpy().reshape(-1), np.asarray(jgp).reshape(-1)
    assert np.linalg.norm(w) > 0
    assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.99


@pytest.mark.parametrize("teacher_class", ["gt", "pred"])
def test_teacher_knowledge_matches(data, teacher_class):
    jb, tb, _, _ = data
    jcf, tcf = _cfgs()
    rng = np.random.default_rng(7)
    t_cls = rng.normal(-3.0, 1.5, (B, 85, N_FG)).astype(np.float32)
    t_reg = rng.normal(0, 0.3, (B, 85, N_FG * 16)).astype(np.float32)
    want = j_teacher_knowledge(jnp.asarray(t_cls), jnp.asarray(t_reg), jb, jcf, 16,
                               teacher_class=teacher_class)
    got = teacher_knowledge(torch.from_numpy(t_cls), torch.from_numpy(t_reg), tb, tcf, 16,
                            teacher_class=teacher_class)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.any()
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), rtol=1e-6)
    np.testing.assert_allclose(got.box_size.numpy(), np.asarray(want.box_size), rtol=1e-5)
    np.testing.assert_allclose(got.kp2d.numpy(), np.asarray(want.kp2d), atol=1e-3, rtol=0)


def test_pose_losses_with_teacher_match(data):
    """The whole loss assembly: SSC targets from JAX's key, focal,
    object-space and the Sinkhorn KD term against teacher votes."""
    jb, tb, jc, tc = data
    jcf, tcf = _cfgs()
    key = jax.random.PRNGKey(9)
    logits, _ = _student(6)
    reg = np.random.default_rng(8).normal(0, 0.5, (B, 85, N_FG * 16)).astype(np.float32)
    jv, tv = _votes(10)

    def jf(z, r):
        out = jl.pose_losses(key, z, r, jb, jc, jcf, teacher=(jv, 640.0, 480.0))
        return out.loss_cls + out.loss_reg + out.loss_kd, out

    (_, jout), (jgz, jgr) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(reg))
    tz = torch.from_numpy(logits).requires_grad_(True)
    tr = torch.from_numpy(reg).requires_grad_(True)
    out = tl.pose_losses(tz, tr, tb, tc, tcf, teacher=(tv, 640.0, 480.0),
                         uniform=torch.from_numpy(np.asarray(_uniform(key, jcf))))
    (out.loss_cls + out.loss_reg + out.loss_kd).backward()
    assert float(out.loss_kd) > 0 and int(out.num_pos) == int(jout.num_pos) > 0
    for name in ("loss_cls", "loss_reg", "loss_kd"):
        np.testing.assert_allclose(float(getattr(out, name)), float(getattr(jout, name)),
                                   rtol=2e-4, err_msg=name)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jgz), rtol=1e-3, atol=1e-6)
    g, w = tr.grad.numpy().reshape(-1), np.asarray(jgr).reshape(-1)
    assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.99
