"""PyTorch port, the dense binary-code (zebra) head without its train step
(`kd6d_pose_adlp_tpu_torch/ops/binary_code.py`, `data/synthetic.consts(
code_bits=...)`, `models/head.code_pred`, `engine/zebra.py`) against
`kd6d_pose_adlp_tpu` on the same seeded inputs, at tests/test_zebra.py's
`_cfg()`: darknet_tiny_h, 128², code_bits 8, max_pos 16, B=2. JAX's SSC
draw (`ops/ssc.py:115`) and its per-image RANSAC Gumbel draws
(`zebra.py:420`, `ops/epnp.py:269`) are handed to the port.

Near-ties: an argmin over vertices (the nearest vertex of a target, the
decode cost) may pick another index on the CPU than XLA's where the best
two values lie within float rounding. Indices are compared exactly wherever
the best and second-best values (float64, from the same inputs) differ by
more than 1e-5 relative; elsewhere the differing indices are counted and
reported (printed, `-s` shows them), never hidden by a wider bound.

Tolerances, with the largest difference measured on this CPU beside them:
  build_codes, sample_box_surface vs JAX      exact arrays
  consts(code_bits=8) vs JAX's                 exact
  decode_vertex, seeded soft bits vs JAX       equal away from near-ties
                                               (1 near-tie, 0 flips in 2,048)
  code_bce vs JAX                              rtol 1e-6 (8.4e-8)
           vs the float64 oracle               rtol 1e-5 (JAX's own bound)
  zebra_targets: labels, sidx, s_valid,
      cls_idx                                  exact
    code_tgt, pt3d                             exact away from near-ties
                                               (0 near-ties in 32 slots)
    off_tgt                                    atol 1e-4 (9.5e-7)
  select_cell_codes vs JAX                     exact
  zebra_losses, each term, with and without
      the teacher arm                          rtol 1e-4 (2.2e-7)
  the zebra PoseNet, eval, fp32: cls, reg,
      code vs flax                             atol 1e-4 (3.2e-6)
    bf16: |port - jax_bf16| <= 2 |jax_bf16 - jax_fp32| + 1e-3 per output
      (test_torch_port_precision.py's bound; 0.74, 0.98 and 1.19x JAX's gap)
  dense postprocess vs JAX, JAX's draws (oracle outputs with jittered
      offsets and a third of the codes wrong):
      n_inliers, valid, pt_valid, cls          equal
      pt2d                                     atol 1e-3 px (0)
      score                                    rtol 1e-6 (0)
      R / T                                    0.1 deg / 0.5 mm (2.5e-3 deg,
                                               1.0e-3 mm)
  oracle round trip (tests/test_zebra.py:155)  |R - R_gt| < 0.02, |T - T_gt|
                                               < 5 mm (7.0e-6, 0.014 mm)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.data.synthetic import SyntheticPoseDataset as JSynth
from kd6d_pose_adlp_tpu.data.synthetic import make_box_corners
from kd6d_pose_adlp_tpu.engine import zebra as jz
from kd6d_pose_adlp_tpu.models import anchors as janchors
from kd6d_pose_adlp_tpu.models import coder as jcoder
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu.ops import binary_code as jbc
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
from kd6d_pose_adlp_tpu_torch.engine import zebra as tz
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
from kd6d_pose_adlp_tpu_torch.ops import binary_code as tbc
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables
from test_torch_port_network import _randomize
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_postprocess import _rot_deg

RES = 128
B = 2
N_BITS = 8
N_FG = 15
NEAR_TIE = 1e-5
t = torch.from_numpy


def _cfg(m, **model):
    """tests/test_zebra.py's `_cfg()` in package `m` (jcfg or tcfg)."""
    return m.Config(model=m.ModelConfig(backbone="darknet_tiny_h", input_res=RES,
                                        code_bits=N_BITS, **model),
                    solver=m.SolverConfig(ims_per_batch=B, max_iter=4, max_pos=16))


def _near_ties(values: np.ndarray) -> np.ndarray:
    """(...,) bool: the two smallest of values (..., V) lie within NEAR_TIE
    relative of each other."""
    v = np.sort(values, axis=-1)
    return (v[..., 1] - v[..., 0]) <= NEAR_TIE * np.maximum(np.abs(v[..., 0]), 1e-30)


def _assert_equal_but_near_ties(got, want, tie, what):
    """Indices equal wherever `tie` is False; the flips at near-ties are
    reported."""
    got, want = np.asarray(got), np.asarray(want)
    flips = got != want
    assert not (flips & ~tie).any(), (what, np.argwhere(flips & ~tie))
    print(f"{what}: {int(tie.sum())} near-ties, {int(flips.sum())} flips "
          f"of {got.size}")
    return flips


# ---------------------------------------------------------------------------
# codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_fg,n_per_axis,n_bits", [(2, 5, 10), (15, 6, 16), (15, 4, 8)])
def test_codes_and_surface_equal_jax(n_fg, n_per_axis, n_bits):
    for corners in make_box_corners(n_fg):
        v = tbc.sample_box_surface(corners, n_per_axis)
        np.testing.assert_array_equal(v, jbc.sample_box_surface(corners, n_per_axis))
        codes = tbc.build_codes(v, n_bits)
        np.testing.assert_array_equal(codes, jbc.build_codes(v, n_bits))
        assert v.shape == (6 * n_per_axis ** 2 - 12 * n_per_axis + 8, 3)
        assert set(np.unique(codes)) <= {0.0, 1.0}
        if len(v) <= 2 ** n_bits:       # prefix-unique, root split balanced
            assert len({tuple(c) for c in codes.astype(int)}) == len(v)
        assert abs(codes[:, 0].sum() - len(v) / 2) <= 0.5


def test_build_codes_handles_duplicate_vertices():
    """A group of equal points has no principal axis; JAX's fallback there
    calls `ndarray.ptp`, which NumPy 2 removed. The port's splits such a
    group by index, and every row still gets its own code."""
    same = np.tile(np.float32([[1.0, 2.0, 3.0]]), (4, 1))
    np.testing.assert_array_equal(tbc.build_codes(same, 2),
                                  [[0, 0], [0, 1], [1, 0], [1, 1]])
    v = tbc.sample_box_surface(make_box_corners(1)[0], 5)
    v = np.concatenate([v, v[:10], v[3:4]])                   # 11 duplicates
    codes = tbc.build_codes(v, 10)
    assert len({tuple(c) for c in codes.astype(int)}) == len(v)
    assert abs(codes[:, 0].sum() - len(v) / 2) <= 0.5


def test_decode_tree_walk_and_msb_dominance():
    v = tbc.sample_box_surface(make_box_corners(2)[0], 5)
    codes = t(tbc.build_codes(v, 10))
    np.testing.assert_array_equal(tbc.decode_vertex(codes, codes).numpy(), np.arange(len(v)))
    # a query that agrees with row 1 on bits (0, 1) and with row 2 on (1, 2, 3)
    c = torch.tensor([[0, 0, 0, 0], [0, 0, 1, 1], [1, 0, 0, 0]], dtype=torch.float32)
    assert int(tbc.decode_vertex(torch.tensor([[0.0, 0.0, 1.0, 1.0]]), c)[0]) == 1
    # per-image codes (B, V, nb) against (B, K, nb) queries
    cb = torch.stack([codes, codes.flip(0)])
    got = tbc.decode_vertex(cb[:, :7], cb)
    np.testing.assert_array_equal(got.numpy(), np.tile(np.arange(7), (2, 1)))


def test_decode_soft_bits_match_jax_but_near_ties():
    rng = np.random.default_rng(0)
    v = tbc.sample_box_surface(make_box_corners(3)[2], 6)
    codes = tbc.build_codes(v, 16)
    # sigmoid of logits spread like a trained head's: mostly confident bits
    p = 1.0 / (1.0 + np.exp(-rng.normal(0.0, 4.0, (2048, 16)))).astype(np.float32)
    want = np.asarray(jbc.decode_vertex(jnp.asarray(p), jnp.asarray(codes)))
    got = tbc.decode_vertex(t(p), t(codes)).numpy()
    w = 2.0 ** -np.arange(16)
    cost = (p.astype(np.float64)[:, None, :] * (w - 2 * codes * w)).sum(-1) + (codes * w).sum(-1)
    _assert_equal_but_near_ties(got, want, _near_ties(cost), "decode_vertex")


def test_code_bce_matches_jax_and_the_oracle():
    rng = np.random.default_rng(0)
    z = rng.normal(0.0, 3.0, (5, 7, 16)).astype(np.float32)
    tgt = rng.random((5, 7, 16)).astype(np.float32)
    tgt[:2] = tgt[:2] > 0.5
    w = rng.random((5, 7)).astype(np.float32)
    w[1, :3] = 0.0
    got = float(tbc.code_bce(t(z), t(tgt), t(w)))
    np.testing.assert_allclose(got, float(jbc.code_bce(jnp.asarray(z), jnp.asarray(tgt),
                                                       jnp.asarray(w))), rtol=1e-6)
    zd = z.astype(np.float64)
    ref = (np.logaddexp(0.0, zd) - zd * tgt).sum(-1)          # -t log p - (1-t) log(1-p)
    np.testing.assert_allclose(got, (ref * w).sum(), rtol=1e-5)


def test_consts_with_codes_equal_jax():
    jc = JSynth(input_res=RES, single_class=0, seed=0).consts(code_bits=N_BITS)
    tc = SyntheticPoseDataset(input_res=RES, single_class=0, seed=0).consts(
        device="cpu", code_bits=N_BITS)
    for name in tc._fields:
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                      err_msg=name)
    assert tc.verts.shape == (N_FG, 152, 3) and tc.vert_codes.shape == (N_FG, 152, N_BITS)
    plain = SyntheticPoseDataset(input_res=RES).consts(device="cpu")
    assert plain.verts is None and plain.vert_codes is None
    assert plain.to("cpu").verts is None


# ---------------------------------------------------------------------------
# targets and losses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """JAX's and the port's batch (train crops) and consts, JAX's SSC draw
    and its targets, at the test config."""
    jds = JSynth(input_res=RES, single_class=0, seed=0)
    tds = SyntheticPoseDataset(input_res=RES, single_class=0, seed=0)
    jb, tb = jds.batch(range(B), train=True), tds.batch(range(B), train=True)
    jc, tc = jds.consts(code_bits=N_BITS), tds.consts(device="cpu", code_bits=N_BITS)
    jcf, tcf = _cfg(jcfg), _cfg(tcfg)
    key = jax.random.PRNGKey(0)
    uniform = t(np.array(jax.random.uniform(key, (B, jcf.model.num_cells,
                                                  jcf.solver.max_objs))))
    jt = jax.device_get(jz.zebra_targets(key, jb, jc, jcf))
    return dict(jb=jb, tb=tb, jc=jc, tc=tc, jcf=jcf, tcf=tcf, key=key, uniform=uniform,
                jt=jt)


def _nearest_vertex_ties(s, tgt):
    """(B, P) bool near-ties of the nearest-vertex argmin, in float64 from
    the batch's poses and affines."""
    jb, jc, m = s["jb"], s["jc"], s["jcf"].model
    anchors = janchors.make_anchors(m.input_res, m.level_strides, m.level_sizes)
    K = np.asarray(jc.K, np.float64)
    tie = np.zeros(tgt.sidx.shape, bool)
    for b in range(B):
        for p in range(tgt.sidx.shape[1]):
            g = 0   # single-object scenes: every positive matches GT 0
            verts = np.asarray(jc.verts, np.float64)[int(tgt.cls_idx[b, p])]
            cam = verts @ np.asarray(jb.rotations[b, g], np.float64).T + jb.translations[b, g]
            uv = cam @ K.T
            xy = uv[:, :2] / uv[:, 2:]
            bt = np.asarray(jb.bbox_trans[b], np.float64)
            crop = xy @ bt[:, :2].T + bt[:, 2]
            d2 = ((crop - anchors[int(tgt.sidx[b, p]), :2]) ** 2).sum(-1)
            tie[b, p] = _near_ties(d2)
    return tie


def test_zebra_targets_match_jax(scene):
    s = scene
    jt = s["jt"]
    tt = tz.zebra_targets(s["tb"], s["tc"], s["tcf"], uniform=s["uniform"])
    for k in ("labels", "sidx", "s_valid", "cls_idx"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(), np.asarray(getattr(jt, k)),
                                      err_msg=k)
    assert (jt.s_valid.sum(1) >= 6).all()
    v = np.asarray(jt.s_valid)
    tie = _nearest_vertex_ties(s, jt) & v
    # the vertex each side picked, found by its 3D point
    verts = np.asarray(s["jc"].verts)[np.asarray(jt.cls_idx)]    # (B,P,V,3)
    def pick(pt3d):
        return np.abs(verts - np.asarray(pt3d)[:, :, None]).sum(-1).argmin(-1)

    flips = _assert_equal_but_near_ties(np.where(v, pick(tt.pt3d.numpy()), 0),
                                        np.where(v, pick(jt.pt3d), 0), tie, "zebra_targets")
    same = v & ~flips
    np.testing.assert_array_equal(tt.code_tgt.numpy()[same], np.asarray(jt.code_tgt)[same])
    np.testing.assert_array_equal(tt.pt3d.numpy()[same], np.asarray(jt.pt3d)[same])
    np.testing.assert_allclose(tt.off_tgt.numpy()[same], np.asarray(jt.off_tgt)[same],
                               atol=1e-4)


def test_zebra_targets_geometry(scene):
    """tests/test_zebra.py:73 on the port's targets: the corresponded
    vertex's projection is the nearest one to the cell's anchor centre,
    the offset target reconstructs it and pt3d is that vertex."""
    s = scene
    tt = tz.zebra_targets(s["tb"], s["tc"], s["tcf"], uniform=s["uniform"])
    m = s["tcf"].model
    anchors = janchors.make_anchors(m.input_res, m.level_strides, m.level_sizes)
    assert bool(tt.s_valid.any())
    for b in range(B):
        for p in np.flatnonzero(tt.s_valid[b].numpy())[:5]:
            c = int(tt.cls_idx[b, p])
            verts = s["tc"].verts[c]
            proj = jcoder.project_corners(s["jc"].K, jnp.asarray(s["jb"].rotations[b, 0]),
                                          jnp.asarray(s["jb"].translations[b, 0]),
                                          jnp.asarray(verts.numpy()),
                                          jnp.asarray(s["jb"].bbox_trans[b]))
            proj = np.asarray(proj)
            center, wh = anchors[int(tt.sidx[b, p]), :2], anchors[int(tt.sidx[b, p]), 2:]
            d = np.linalg.norm(proj - center, axis=-1)
            rec = center + tt.off_tgt[b, p].numpy() * wh
            assert np.linalg.norm(proj[d.argmin()] - rec) < 1e-2
            assert np.linalg.norm(verts[d.argmin()].numpy() - tt.pt3d[b, p].numpy()) < 1e-4


def test_select_cell_codes_is_exact():
    rng = np.random.default_rng(4)
    A, P = 300, 16
    code_pred = rng.normal(size=(B, A, N_FG * (N_BITS + 2))).astype(np.float32)
    sidx = rng.integers(0, A, (B, P))
    cls_idx = rng.integers(0, N_FG, (B, P))
    want = jz.select_cell_codes(jnp.asarray(code_pred), jnp.asarray(sidx),
                                jnp.asarray(cls_idx), N_FG, N_BITS)
    got = tz.select_cell_codes(t(code_pred), t(sidx), t(cls_idx), N_FG, N_BITS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (B, P, N_BITS) and got[1].shape == (B, P, 2)


@pytest.mark.parametrize("with_teacher", [False, True])
def test_zebra_losses_match_jax(scene, with_teacher):
    s = scene
    rng = np.random.default_rng(5)
    A = s["jcf"].model.num_cells
    cls_logits = rng.normal(-2.0, 1.5, (B, A, N_FG)).astype(np.float32)
    code_pred = rng.normal(0.0, 2.0, (B, A, N_FG * (N_BITS + 2))).astype(np.float32)
    teacher = None
    if with_teacher:
        teacher = (rng.normal(0.0, 3.0, code_pred.shape).astype(np.float32),
                   rng.normal(0.0, 1.0, cls_logits.shape).astype(np.float32))
    want = jz.zebra_losses(s["key"], jnp.asarray(cls_logits), jnp.asarray(code_pred),
                           s["jb"], s["jc"], s["jcf"], N_FG,
                           teacher_codes=None if teacher is None else
                           tuple(jnp.asarray(a) for a in teacher))
    got = tz.zebra_losses(t(cls_logits), t(code_pred), s["tb"], s["tc"], s["tcf"], N_FG,
                          teacher_codes=None if teacher is None else
                          tuple(t(a) for a in teacher), uniform=s["uniform"])
    assert int(got.num_pos) == int(want.num_pos) > 0
    for k in ("loss_cls", "loss_code", "loss_off", "loss_kd"):
        np.testing.assert_allclose(float(getattr(got, k)), float(getattr(want, k)),
                                   rtol=1e-4, err_msg=k)
    assert (float(got.loss_kd) > 0) is with_teacher


# ---------------------------------------------------------------------------
# the network's code output
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zebra_nets():
    """flax zebra PoseNets in fp32 and bf16 with one randomized variable
    tree, and a batch of images."""
    nets = {dt: JPoseNet(cfg=_cfg(jcfg, compute_dtype=dt).model, n_fg=N_FG)
            for dt in ("float32", "bfloat16")}
    v = jax.jit(nets["float32"].init)(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)))
    v = _randomize(v, np.random.default_rng(0))
    x = np.random.default_rng(1).normal(size=(B, RES, RES, 3)).astype(np.float32)
    return nets, v, x


def test_zebra_posenet_fp32_matches_flax(zebra_nets):
    nets, v, x = zebra_nets
    assert "code_pred" in v["params"]["head"]
    want = jax.jit(lambda v_, x_: nets["float32"].apply(v_, x_, train=False))(v, x)
    net = PoseNet(_cfg(tcfg).model, n_fg=N_FG).eval()
    net.load_state_dict(from_jax_variables(v), strict=True)
    with torch.no_grad():
        got = net(t(x))
    assert len(got) == 3 and got[2].shape == (B, net.cfg.num_cells, N_FG * (N_BITS + 2))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_zebra_posenet_bf16_within_the_jax_yardstick(zebra_nets):
    nets, v, x = zebra_nets
    j32, j16 = (jax.jit(lambda v_, x_, n=nets[dt]: n.apply(v_, x_, train=False))(v, x)
                for dt in ("float32", "bfloat16"))
    net = PoseNet(_cfg(tcfg, compute_dtype="bfloat16").model, n_fg=N_FG).eval()
    net.load_state_dict(from_jax_variables(v), strict=True)
    with torch.no_grad():
        got = net(t(x))
    for name, g, w16, w32 in zip(("cls", "reg", "code"), got, j16, j32):
        assert g.dtype == torch.float32, name
        gap = float(np.abs(np.asarray(w16, np.float32) - np.asarray(w32)).max())
        err = float(np.abs(g.numpy() - np.asarray(w16, np.float32)).max())
        assert err <= 2 * gap + 1e-3, (name, err, gap)


# ---------------------------------------------------------------------------
# the dense postprocess
# ---------------------------------------------------------------------------

def _oracle_outputs(tgt, rng=None):
    """Network outputs that decode to the targets: each positive slot's cell
    at logit +10 for its class (the rest -10), its code as saturated logits
    and its offset (tests/test_zebra.py:155). With `rng`, the offsets are
    jittered (0.5 px in a 32-px anchor) and a third of the slots get a
    wrong leading code bit, so RANSAC meets outliers."""
    Bn, A = tgt.labels.shape
    cls_logits = np.full((Bn, A, N_FG), -10.0, np.float32)
    code_pred = np.zeros((Bn, A, N_FG * (N_BITS + 2)), np.float32)
    for b in range(Bn):
        for p in np.flatnonzero(np.asarray(tgt.s_valid[b])):
            a, c = int(tgt.sidx[b, p]), int(tgt.cls_idx[b, p])
            cls_logits[b, a, c] = 10.0
            code = np.array(tgt.code_tgt[b, p], np.float32)
            off = np.array(tgt.off_tgt[b, p], np.float32)
            if rng is not None:
                off += rng.normal(0.0, 0.5 / 32, 2).astype(np.float32)
                if rng.random() < 1 / 3:
                    code[0] = 1.0 - code[0]
            base = c * (N_BITS + 2)
            code_pred[b, a, base:base + N_BITS] = (2.0 * code - 1.0) * 10.0
            code_pred[b, a, base + N_BITS:base + N_BITS + 2] = off
    return cls_logits, code_pred


@pytest.fixture(scope="module")
def eval_scene():
    """Eval crops (tests/test_zebra.py:155's), their targets and consts."""
    jds = JSynth(input_res=RES, single_class=0, seed=0)
    tds = SyntheticPoseDataset(input_res=RES, single_class=0, seed=0)
    jb, tb = jds.batch(range(B), train=False), tds.batch(range(B), train=False)
    jc = jds.consts(code_bits=N_BITS)
    tc = tds.consts(device="cpu", code_bits=N_BITS)
    jt = jax.device_get(jz.zebra_targets(jax.random.PRNGKey(0), jb, jc, _cfg(jcfg)))
    assert (jt.s_valid.sum(1) >= 6).all(), "need >= 6 positives for PnP"
    return jb, tb, jc, tc, jt


def test_dense_postprocess_matches_jax_with_its_draws(eval_scene):
    jb, tb, jc, tc, jt = eval_scene
    jcf, tcf = _cfg(jcfg), _cfg(tcfg)
    cls_logits, code_pred = _oracle_outputs(jt, np.random.default_rng(6))
    rng = jax.random.PRNGKey(3)
    want = jax.device_get(jz.build_zebra_postprocess(jcf, jc, N_FG)(
        jnp.asarray(cls_logits), jnp.asarray(code_pred), jb, rng))
    t_ = jcf.test
    gumbel = np.stack([np.asarray(jax.random.gumbel(r, (t_.ransac_iters, t_.max_votes)))
                       for r in jax.random.split(rng, B)])
    got = tz.build_zebra_postprocess(tcf, tc, N_FG)(
        t(cls_logits), t(code_pred), tb.class_ids[:, 0], tb.bbox_trans, gumbel=t(gumbel))
    assert set(got) == set(want)
    for k in ("n_inliers", "valid", "pt_valid", "cls"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    pv = np.asarray(want["pt_valid"])
    assert pv.any(1).all() and (np.asarray(want["n_inliers"]) < pv.sum(1)).any()
    np.testing.assert_allclose(got["pt2d"].numpy()[pv], np.asarray(want["pt2d"])[pv],
                               atol=1e-3)
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), rtol=1e-6)
    for b in range(B):
        assert _rot_deg(got["R"][b].numpy(), want["R"][b]) < 0.1
        assert np.linalg.norm(got["T"][b].numpy() - want["T"][b]) < 0.5


def test_dense_postprocess_oracle_roundtrip(eval_scene):
    """Perfect per-cell predictions recover the ground-truth pose (tests/
    test_zebra.py:155), RANSAC's draws from a generator."""
    _, tb, _, tc, jt = eval_scene
    cls_logits, code_pred = _oracle_outputs(jt)
    post = tz.build_zebra_postprocess(_cfg(tcfg), tc, N_FG)
    out = post(t(cls_logits), t(code_pred), tb.class_ids[:, 0], tb.bbox_trans,
               generator=torch.Generator().manual_seed(3))
    assert out["valid"].all()
    for b in range(B):
        assert float((out["R"][b] - tb.rotations[b, 0]).abs().max()) < 0.02
        assert float((out["T"][b] - tb.translations[b, 0]).abs().max()) < 5.0


def test_dense_postprocess_marks_padded_images(eval_scene):
    """A negative class id solves class 0 and reports the image invalid."""
    _, tb, _, tc, jt = eval_scene
    cls_logits, code_pred = _oracle_outputs(jt)
    post = tz.build_zebra_postprocess(
        _cfg(tcfg).replace(test=dataclasses.replace(_cfg(tcfg).test, ransac_iters=8)), tc,
        N_FG)
    ids = tb.class_ids[:, 0].clone()
    ids[1] = -1
    out = post(t(cls_logits), t(code_pred), ids, tb.bbox_trans,
               generator=torch.Generator().manual_seed(0))
    assert out["valid"].tolist() == [True, False] and out["cls"].tolist() == [0, 0]
