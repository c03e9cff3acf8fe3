"""PyTorch port, the evaluation slice: host metrics, geometry and mesh
readers, the device pose-diff scorer, the streaming (`engine/evaluator.
valid`) and one-pass (`engine/eval_scan.ScanEvaluator`) evaluators, the K
remap, the real network through `valid`, the synthetic loader, loose weight
loading, the evaluation CLI and the train loop's `eval_fn` hook; each
against the JAX package on the same seeded numpy inputs (or against the
port's own oracle where said), on the CPU. The multi-class postprocess,
`detection_stats` and `infer(mode="multi")` are in
test_torch_port_eval_multi.py (each file compiles its own JAX postprocess,
~40 s on one core, so the two run side by side).

The scenes are the JAX eval tests' (`tests/test_eval_scan.py`): RES 64,
3 classes, single-class synthetic scenes of class 1, batches of 4, 16
RANSAC hypotheses over at most 16 votes, 2 LHM steps (the JAX side's
compile time grows with them). Fabricated network outputs decode
exactly to the ground-truth corners; JAX's RANSAC draws (chunk key i of
`_host_key_splitter(PRNGKey(0))`, split per image) are handed to the port
through `gumbel_fn`.

Tolerances, with the largest difference measured on this CPU beside them:
  geometry (float64)                          atol 1e-12  (0)
  metrics, pose diffs and result numbers      atol 1e-9   (0); tables equal
  PLY / BOP readers                           equal
  device scorer vs host oracle and JAX scorer rtol 2e-4, atol 1e-3
                                              (relative 1.3e-5 / 8.4e-6)
  fabricated outputs: logits / regression     equal / atol 1e-5 (9.5e-7)
  streaming, port vs JAX: R                   atol 1e-4   (1.7e-6)
                          T                   rtol 1e-3   (1.4e-5)
                          score               atol 1e-5   (0)
                          valid, classes, table equal
  remap, port vs JAX host remap               R atol 1e-4, T rtol 1e-4
                                              (JAX without cv2: 6.2e-7, 2.2e-6;
                                               with cv2: 5.3e-15, 2.1e-14)
  scan refit vs host remap                    R atol 5e-3, T rtol 2e-3 + 0.5 mm
                                              (no cv2: 3.2e-6 / 8.5e-4 mm;
                                               cv2: 1.4e-6 / 6.9e-4 mm)
  scan vs streaming in the port               R atol 1e-4, T rtol 1e-4 (0, 0); tables equal
  real network: kp2d where votes are valid    atol 1e-2 px (1.8e-4 px)
              R orthonormality                atol 1e-4 (3.6e-7)
  loaders: images                             atol 1e-6 (0)
"""
import dataclasses
import json
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.data.batch import Batch as JBatch
from kd6d_pose_adlp_tpu.data.synthetic import SyntheticPoseDataset as JSynth
from kd6d_pose_adlp_tpu.engine import evaluator as jev
from kd6d_pose_adlp_tpu.engine.postprocess import build_postprocess as j_build_postprocess
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu.utils import geometry as jgeo
from kd6d_pose_adlp_tpu.utils import mesh as jmesh
from kd6d_pose_adlp_tpu.utils import metrics as JM
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
from kd6d_pose_adlp_tpu_torch.engine import eval_scan as tes
from kd6d_pose_adlp_tpu_torch.engine import evaluator as tev
from kd6d_pose_adlp_tpu_torch.engine.postprocess import build_postprocess
from kd6d_pose_adlp_tpu_torch.engine.serving import network_fn
from kd6d_pose_adlp_tpu_torch.models import anchors as t_anchors
from kd6d_pose_adlp_tpu_torch.models import coder as t_coder
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
from kd6d_pose_adlp_tpu_torch.utils import geometry as tgeo
from kd6d_pose_adlp_tpu_torch.utils import mesh as tmesh
from kd6d_pose_adlp_tpu_torch.utils import metrics as TM
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables

from test_train_e2e import _fabricated_outputs as _j_fabricated

RES, N_FG, BS, N_IMG = 64, 3, 4, 12
TEST = dict(max_votes=16, ransac_iters=16, lhm_iters=2, confidence_th=0.0105)
ITERS, NV = TEST["ransac_iters"], TEST["max_votes"] * 8
SYM = {1: ("Z", 180)}


def _cfgs():
    """(JAX, port) configs, field for field the same: the JAX eval tests'
    small_cfg with confidence_th lowered so that random-weight cells vote
    (fabricated outputs are far from it either way)."""
    out = []
    for c in (jcfg, tcfg):
        out.append(c.Config(
            model=c.ModelConfig(backbone="darknet_tiny_h", input_res=RES),
            solver=c.SolverConfig(ims_per_batch=BS, base_lr=1e-3, max_iter=50,
                                  max_objs=2, max_pos=32),
            test=c.TestConfig(**TEST)))
    return out


def _eval_cfg(cfg, diameters, sym=()):
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, n_class=N_FG + 1, mesh_diameters=tuple(np.asarray(diameters)),
        symmetry_types=tuple(sym)))


def _metas(ds, idx, K=None):
    metas = []
    for i in idx:
        s = ds.sample(i, train=False)
        metas.append(dict(filename=f"img_{i}.png", K=s["meta"]["K"] if K is None else K,
                          width=s["meta"]["width"], height=s["meta"]["height"],
                          class_ids=[s["meta"]["cls"]], rotations=[s["meta"]["R"]],
                          translations=[s["meta"]["T"]]))
    return metas


def _t_fabricated(batch, consts, cfg, multi=False):
    """The port's counterpart, built with the port's coder and anchors;
    multi=True encodes every object slot at its own instance-mask cells
    (the JAX tests' `_fabricated_outputs_multi`)."""
    m = cfg.model
    anchors = torch.from_numpy(t_anchors.make_anchors(m.input_res, m.level_strides,
                                                      m.level_sizes))
    A = anchors.shape[0]
    B, G = batch.class_ids.shape
    cx = anchors[:, 0].clamp(0, m.input_res - 1).long()
    cy = anchors[:, 1].clamp(0, m.input_res - 1).long()
    inst = batch.mask[:, cy, cx]                                       # (B, A)
    logits = torch.full((B, A, N_FG), -12.0)
    reg = torch.zeros((B, A, N_FG, 16))
    bi, ai = torch.arange(B)[:, None], torch.arange(A)[None, :]
    for g in range(G if multi else 1):
        cls_g = batch.class_ids[:, g].long().clamp_min(0)
        kp2d = t_coder.project_corners(consts.K, batch.rotations[:, g],
                                       batch.translations[:, g], consts.kp3d[cls_g],
                                       batch.bbox_trans)
        enc = t_coder.encode(kp2d[:, None].expand(B, A, 8, 2), anchors[None])
        if multi:
            on = (inst == g + 1) & (batch.class_ids[:, g:g + 1] >= 0)
            logits[bi, ai, cls_g[:, None]] = torch.maximum(
                logits[bi, ai, cls_g[:, None]],
                torch.where(on, torch.tensor(4.0), torch.tensor(-12.0)))
            reg[bi, ai, cls_g[:, None]] = torch.where(on[..., None], enc,
                                                      reg[bi, ai, cls_g[:, None]])
        else:
            reg[bi, ai, cls_g[:, None]] = enc
            logits[bi, ai, cls_g[:, None]] = torch.where(
                inst > 0, torch.tensor(4.0), torch.tensor(-12.0))
    return logits, reg.reshape(B, A, N_FG * 16)


def _jax_chunk_keys(n):
    next_key = jev._host_key_splitter(jax.random.PRNGKey(0))
    return [next_key() for _ in range(n)]


def _gumbel(key, B):
    return np.stack([np.asarray(jax.random.gumbel(k, (ITERS, NV)))
                     for k in jax.random.split(key, B)])


def _jax_gumbel_fn(n, B=BS, multi=False):
    """JAX's draws of chunk i: (B, iters, V*8), or (n_fg, B, iters, V*8)
    for the multi postprocess (its per-class keys split from the chunk's)."""
    keys = _jax_chunk_keys(n)
    if multi:
        draws = [np.stack([_gumbel(kc, B) for kc in jax.random.split(k, N_FG)])
                 for k in keys]
    else:
        draws = [_gumbel(k, B) for k in keys]
    return lambda i: torch.from_numpy(draws[i])


@pytest.fixture(scope="module")
def env():
    jc, tc = _cfgs()
    jds = JSynth(n_fg=N_FG, input_res=RES, max_objs=2, single_class=1, seed=7)
    ds = SyntheticPoseDataset(n_fg=N_FG, input_res=RES, max_objs=2, single_class=1, seed=7)
    jconsts, tconsts = jds.consts(), ds.consts(device="cpu")
    jce = _eval_cfg(jc, jconsts.diameters, SYM.items())
    tce = _eval_cfg(tc, tconsts.diameters.numpy(), SYM.items())
    meshes = [np.asarray(jconsts.kp3d[c]) for c in range(N_FG)]
    chunks = [list(range(s, s + BS)) for s in range(0, N_IMG, BS)]
    jb = [(jds.batch(idx, train=False), _metas(jds, idx)) for idx in chunks]
    tb = [(ds.batch(idx, train=False), _metas(ds, idx)) for idx in chunks]
    # strongly typed, as the network's outputs are, so that one compiled JAX
    # postprocess serves both (jnp.full's weak type would force a second)
    jouts = [tuple(jnp.asarray(np.asarray(o)) for o in _j_fabricated(b, jconsts, jc))
             for b, _ in jb]
    touts = [_t_fabricated(b, tconsts, tc) for b, _ in tb]
    jpost = j_build_postprocess(jce, jconsts)
    return dict(jc=jc, tc=tc, jce=jce, tce=tce, jds=jds, ds=ds, jconsts=jconsts,
                tconsts=tconsts, meshes=meshes, jb=jb, tb=tb, jouts=jouts, touts=touts,
                jpost=jpost, gumbel_fn=_jax_gumbel_fn(len(chunks)))


def _iter_forward(outs):
    it = iter(outs)
    return lambda images: next(it)


def _port_valid(env, batches=None, outs=None, **kw):
    return tev.valid(env["tce"], env["tconsts"], _iter_forward(outs or env["touts"]),
                     build_postprocess(env["tce"], env["tconsts"]),
                     iter(batches or env["tb"]), env["meshes"], verbose=False, **kw)


def _port_scan(env, batches=None, outs=None, **kw):
    outs = outs or env["touts"]
    sev = tes.ScanEvaluator(env["tce"], env["tconsts"], None, env["meshes"],
                            forward=lambda images, i: outs[i])
    sev.prepare(iter(batches or env["tb"]))
    return sev.run(verbose=False, **kw)


def _jax_valid(env, batches=None, outs=None):
    it = iter(outs or env["jouts"])
    return jev.valid(env["jce"], env["jconsts"], None, lambda v, im: next(it),
                     env["jpost"], iter(batches or env["jb"]), env["meshes"],
                     verbose=False)


def _assert_preds_close(got, want, r_atol=1e-4, t_rtol=1e-3, t_atol=0.0):
    assert set(got) == set(want)
    n = 0
    for fn, w in want.items():
        g = got[fn]
        assert g["meta"] == w["meta"], fn
        assert len(g["pred"]) == len(w["pred"]), fn
        for gp, wp in zip(g["pred"], w["pred"]):
            assert gp[1] == wp[1]
            np.testing.assert_allclose(gp[0], wp[0], atol=1e-5)
            np.testing.assert_allclose(gp[2], wp[2], atol=r_atol)
            np.testing.assert_allclose(gp[3], wp[3], rtol=t_rtol, atol=t_atol)
            n += 1
    return n


def _random_poses(rng, n, euler2mat):
    Rs = np.stack([euler2mat(*rng.uniform(-3, 3, 3)) for _ in range(n)])
    Ts = rng.uniform([-50, -50, 400], [50, 50, 900], (n, 3))
    return Rs.astype(np.float64), Ts.astype(np.float64)


# ---------------------------------------------------------------------------
# 1-3: host numpy modules
# ---------------------------------------------------------------------------

def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    for axes in tgeo._AXES2TUPLE:
        for _ in range(4):
            ang = rng.uniform(-3, 3, 3)
            Mt, Mj = tgeo.euler2mat(*ang, axes=axes), jgeo.euler2mat(*ang, axes=axes)
            np.testing.assert_allclose(Mt, Mj, atol=1e-12, rtol=0)
            np.testing.assert_allclose(tgeo.mat2euler(Mt, axes), jgeo.mat2euler(Mj, axes),
                                       atol=1e-12, rtol=0)
    # gimbal lock takes the other branch of mat2euler
    lock = tgeo.euler2mat(0.3, np.pi / 2, 0.2, "sxyz")
    np.testing.assert_allclose(tgeo.mat2euler(lock), jgeo.mat2euler(lock), atol=1e-12)
    specs = [spec for _, spec in tcfg.DataConfig().symmetry_types] + [()]
    for _ in range(8):
        R = tgeo.quaternion2rotation(rng.normal(size=4))
        np.testing.assert_allclose(tgeo.rotation2quaternion(R),
                                   jgeo.rotation2quaternion(R), atol=1e-12)
        for spec in specs:
            np.testing.assert_array_equal(tgeo.pose_symmetry_handling(R, spec),
                                          jgeo.pose_symmetry_handling(R, spec))


def _metric_scene(seed=1, n=30):
    """JAX test_eval_scan's predictions dict: every 5th image a miss, class 1
    symmetric, meshes of unequal sizes."""
    rng = np.random.default_rng(seed)
    meshes = [rng.uniform(-40, 40, (m, 3)) for m in (20, 33, 17)]
    diam = [float(np.linalg.norm(m.max(0) - m.min(0))) for m in meshes]
    K = np.array([[572.4, 0, 325.2], [0, 573.5, 242.0], [0, 0, 1.0]])
    gtR, gtT = _random_poses(rng, n, tgeo.euler2mat)
    pT = gtT + rng.normal(0, 1.5, (n, 3))
    dR, _ = _random_poses(rng, n, tgeo.euler2mat)
    pR = np.matmul(gtR, np.eye(3) + 0.01 * (dR - np.eye(3)))
    preds = {}
    for i in range(n):
        c = int(i % N_FG)
        pred = [] if i % 5 == 4 else [[0.9, c, pR[i].tolist(), pT[i].reshape(3, 1).tolist(), []]]
        preds[f"img_{i}.png"] = {
            "meta": {"K": K.tolist(), "width": 640, "height": 480, "class_ids": [c],
                     "rotations": [gtR[i].tolist()], "translations": [gtT[i].tolist()]},
            "pred": pred}
    return meshes, diam, K, preds, (gtR, gtT, pR, pT)


def _assert_results_equal(got, want, atol=1e-9):
    assert TM.format_accuracy_table(got) == JM.format_accuracy_table(want)
    np.testing.assert_allclose(got["depth_range"], want["depth_range"], atol=atol)
    for g in ("adi_per_class", "auc_per_class", "rep_per_class", "adi_per_depth",
              "rep_per_depth"):
        assert len(got[g]) == len(want[g])
        for a, b in zip(got[g], want[g]):
            assert set(a) == set(b), g
            for k in a:
                np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=(g, k))


def test_metrics_match_jax():
    meshes, diam, K, preds, (gtR, gtT, pR, pT) = _metric_scene()
    for c in range(N_FG):
        for sym in (False, True):
            a = TM.compute_pose_diff(meshes[c], K, gtR[c], gtT[c], pR[c], pT[c], is_sym=sym)
            b = JM.compute_pose_diff(meshes[c], K, gtR[c], gtT[c], pR[c], pT[c], is_sym=sym)
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)
            a = TM.compute_pose_diff_batch(meshes[c], K, gtR, gtT, pR, pT, is_sym=sym)
            b = JM.compute_pose_diff_batch(meshes[c], K, gtR, gtT, pR, pT, is_sym=sym)
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)
    errs = np.random.default_rng(2).uniform(0, 150, 57)
    assert TM.auc_metric(errs, 100.0) == JM.auc_metric(errs, 100.0)
    assert TM.auc_metric([], 100.0) == JM.auc_metric([], 100.0) == 0.0
    got = TM.evaluate_pose_predictions(preds, N_FG + 1, meshes, diam, SYM)
    want = JM.evaluate_pose_predictions(preds, N_FG + 1, meshes, diam, SYM)
    _assert_results_equal(got, want)
    assert (TM.THRESHOLDS_ADI, TM.THRESHOLDS_REP, TM.INF) == \
        (JM.THRESHOLDS_ADI, JM.THRESHOLDS_REP, JM.INF)


def _write_ply(path, verts, binary, extra_face=True):
    n = len(verts)
    head = ["ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0",
            f"element vertex {n}", "property float x", "property float y",
            "property float z", "property uchar red", "property double nx"]
    if extra_face:
        head += ["element face 1", "property list uchar int vertex_indices"]
    head.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        for i, v in enumerate(verts):
            if binary:
                f.write(struct.pack("<fffBd", *v, i % 256, 0.5))
            else:
                f.write(f"{v[0]} {v[1]} {v[2]} {i % 256} 0.5\n".encode())
        if extra_face:
            f.write(struct.pack("<Biii", 3, 0, 1, 2) if binary else b"3 0 1 2\n")


def test_mesh_readers_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    models = tmp_path / "models"
    models.mkdir()
    info = {}
    for obj, binary in ((1, False), (2, True), (5, True)):
        v = rng.uniform(-50, 50, (40 + obj, 3)).astype(np.float32)
        _write_ply(models / f"obj_{obj:06d}.ply", v, binary)
        mn, mx = v.min(0), v.max(0)
        info[str(obj)] = {"diameter": float(np.linalg.norm(mx - mn)),
                          "min_x": float(mn[0]), "min_y": float(mn[1]), "min_z": float(mn[2]),
                          "size_x": float(mx[0] - mn[0]), "size_y": float(mx[1] - mn[1]),
                          "size_z": float(mx[2] - mn[2])}
    (models / "models_info.json").write_text(json.dumps(info))
    tm, tmap = tmesh.load_bop_meshes(str(models))
    jm, jmap = jmesh.load_bop_meshes(str(models))
    assert tmap == jmap == {"1": 0, "2": 1, "5": 2}
    for a, b, (obj, spec) in zip(tm, jm, sorted(info.items(), key=lambda kv: int(kv[0]))):
        np.testing.assert_array_equal(a, b)
        corners = tmesh.mesh_bbox_corners(a)
        np.testing.assert_array_equal(corners, jmesh.mesh_bbox_corners(b))
        np.testing.assert_allclose(corners.min(0), [spec["min_x"], spec["min_y"],
                                                    spec["min_z"]], atol=1e-5)
    bbox = np.stack([tmesh.mesh_bbox_corners(m) for m in tm])
    (tmp_path / "bbox.json").write_text(json.dumps(bbox.tolist()))
    np.testing.assert_array_equal(tmesh.load_bbox_3d(str(tmp_path / "bbox.json")),
                                  jmesh.load_bbox_3d(str(tmp_path / "bbox.json")))


# ---------------------------------------------------------------------------
# 4: the device scorer (on CPU tensors)
# ---------------------------------------------------------------------------

def test_device_scorer_matches_host_oracle_and_jax():
    from kd6d_pose_adlp_tpu.engine.eval_scan import build_pose_diff_scorer as j_scorer
    rng = np.random.default_rng(0)
    meshes = [rng.uniform(-40, 40, (m, 3)) for m in (8, 30, 17)]
    n = 11
    cls = rng.integers(0, 3, n)
    K = np.tile(np.array([[572.4, 0, 325.2], [0, 573.5, 242.0], [0, 0, 1.0]]), (n, 1, 1))
    gtR, gtT = _random_poses(rng, n, tgeo.euler2mat)
    dR, _ = _random_poses(rng, n, tgeo.euler2mat)
    pR = np.matmul(gtR, np.eye(3) + 0.02 * (dR - np.eye(3)))
    pT = gtT + rng.normal(0, 2.0, (n, 3))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    scorer = tes.build_pose_diff_scorer(meshes, [1], chunk=4, device="cpu")
    e3, e2 = scorer(torch.as_tensor(cls), f32(K), f32(gtR), f32(gtT), f32(pR), f32(pT))
    e3, e2 = e3.numpy(), e2.numpy()
    j3, j2 = j_scorer(meshes, [1], chunk=4)(
        jnp.asarray(cls, jnp.int32), *(jnp.asarray(a, jnp.float32)
                                       for a in (K, gtR, gtT, pR, pT)))
    np.testing.assert_allclose(e3, np.asarray(j3), rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(e2, np.asarray(j2), rtol=2e-4, atol=1e-3)
    for c in range(3):
        sel = cls == c
        h3, h2 = TM.compute_pose_diff_batch(meshes[c], K[sel], gtR[sel], gtT[sel], pR[sel],
                                            pT[sel], is_sym=c == 1)
        np.testing.assert_allclose(e3[sel], h3, rtol=2e-4, atol=1e-3)
        np.testing.assert_allclose(e2[sel], h2, rtol=2e-4, atol=1e-3)

    m2, diam, _, preds, _ = _metric_scene()
    dev = tes.evaluate_pose_predictions_device(preds, N_FG + 1, m2, diam, SYM, device="cpu")
    host = JM.evaluate_pose_predictions(preds, N_FG + 1, m2, diam, SYM)
    assert TM.format_accuracy_table(dev) == JM.format_accuracy_table(host)
    np.testing.assert_allclose(dev["depth_range"], host["depth_range"])


# ---------------------------------------------------------------------------
# 5-7: the evaluators on fabricated outputs
# ---------------------------------------------------------------------------

def test_fabricated_outputs_match_jax(env):
    for (jl, jr), (tl, tr) in zip(env["jouts"], env["touts"]):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


def test_streaming_valid_matches_jax(env):
    want = _jax_valid(env)
    got = _port_valid(env, gumbel_fn=env["gumbel_fn"])
    assert _assert_preds_close(got["predictions"], want["predictions"]) == N_IMG
    assert got["table"] == want["table"]
    adi = got["adi_per_class"][1].get("ADI.10d")
    assert adi is not None and adi > 0.0, got["table"]


@pytest.mark.parametrize("cv2_present", [False, True])
def test_remap_path(env, monkeypatch, cv2_present):
    """A different native K on every image: the port's host remap (its
    float64 EPnP, `utils/pnp`, with or without cv2 installed) against JAX's
    cv2 branch and against its branch without cv2, and the scan path's
    batched EPnP refit against the port's host remap."""
    if cv2_present:
        pytest.importorskip("cv2")
    else:
        from kd6d_pose_adlp_tpu.ops import epnp as jep
        monkeypatch.setitem(sys.modules, "cv2", None)
        # JAX's branch without cv2, compiled once instead of op by op
        monkeypatch.setattr(jep, "epnp", jax.jit(jep.epnp))
    K2 = np.asarray(env["jconsts"].K, np.float64).copy()
    K2[0, 0] *= 1.07
    K2[1, 1] *= 0.93
    K2[0, 2] += 11.0
    idx = [list(range(s, s + BS)) for s in (0, 4)]
    tb = [(env["ds"].batch(i, train=False), _metas(env["ds"], i, K2)) for i in idx]
    K_int = np.asarray(env["jconsts"].K, np.float64)
    rng = np.random.default_rng(4)
    for c in range(N_FG):
        R = tgeo.quaternion2rotation(rng.normal(size=4))
        T = np.array([10.0, -20.0, 800.0])
        corners = np.asarray(env["jconsts"].kp3d[c], np.float64)
        Rt, Tt = tev.remap_pose_host(K_int, R, T, corners, K2)
        Rj, Tj = jev.remap_pose_host(K_int, R, T, corners, K2)
        np.testing.assert_allclose(Rt, Rj, atol=1e-4)
        np.testing.assert_allclose(Tt, Tj, rtol=1e-4)
    outs = env["touts"][:2]
    host = _port_valid(env, batches=tb, outs=outs, gumbel_fn=env["gumbel_fn"])
    scan = _port_scan(env, batches=tb, outs=outs, gumbel_fn=env["gumbel_fn"])
    assert _assert_preds_close(scan["predictions"], host["predictions"], r_atol=5e-3,
                               t_rtol=2e-3, t_atol=0.5) == 2 * BS
    assert scan["table"] == host["table"]


def test_scan_matches_streaming_in_the_port(env):
    """Seeded draws (no injection): the scan evaluator draws chunk by chunk
    in the streaming evaluator's order, so predictions and tables match;
    overlap is a scheduling change only."""
    a = _port_valid(env, seed=5, overlap=True)
    b = _port_valid(env, seed=5, overlap=False)
    assert a["predictions"] == b["predictions"] and a["table"] == b["table"]
    scan = _port_scan(env, seed=5)
    assert _assert_preds_close(scan["predictions"], a["predictions"], r_atol=1e-4,
                               t_rtol=1e-4) == N_IMG
    assert scan["table"] == a["table"]
    host_metrics = _port_scan(env, seed=5)  # a second run gives the same
    assert host_metrics["predictions"] == scan["predictions"]
    assert scan["adi_per_class"][1]["ADI.10d"] > 0.0


def test_scan_evaluator_logs_and_writes(env, tmp_path):
    class Logger:   # ScalarLogger's interface (its optional TensorBoard import is slow)
        def __init__(self):
            self.records = []

        def log(self, step, scalars):
            self.records.append((step, scalars))

    logger = Logger()
    r = _port_scan(env, seed=1, step=7, working_dir=str(tmp_path), logger=logger)
    with open(tmp_path / "preds.json") as f:
        assert json.load(f) == json.loads(json.dumps(r["predictions"]))
    (step, rec), = logger.records
    assert step == 7 and rec["ADI/class_01"] == r["adi_per_class"][1]["ADI.10d"]
    assert rec["REP/all_class"] == r["rep_per_class"][1]["REP05px"]
    # a second evaluator on the first's staged eval set gives the same
    sev = tes.ScanEvaluator(env["tce"], env["tconsts"], None, env["meshes"],
                            forward=lambda images, i: env["touts"][i])
    with pytest.raises(RuntimeError):
        sev.share_staged(tes.ScanEvaluator(env["tce"], env["tconsts"], None, env["meshes"]))
    sev.share_staged(tes.ScanEvaluator(env["tce"], env["tconsts"], None, env["meshes"],
                                       forward=None).prepare(iter(env["tb"])))
    assert sev.run(seed=1, step=7, verbose=False)["predictions"] == r["predictions"]
    with pytest.raises(RuntimeError):
        tes.ScanEvaluator(env["tce"], env["tconsts"], None, env["meshes"],
                          forward=lambda im, i: None).run()


# ---------------------------------------------------------------------------
# 8: the real network at RES 64
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def real_net(env):
    from kd6d_pose_adlp_tpu.engine.steps import build_forward
    jnet = JPoseNet(cfg=env["jc"].model, n_fg=N_FG)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 2.0, a.shape) if np.asarray(a).min() > 0.5
                   else rng.normal(0.0, 0.3, a.shape)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    variables = {"params": variables["params"], "batch_stats": stats}
    net = PoseNet(env["tc"].model, n_fg=N_FG)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    return jnet, variables, build_forward(env["jc"], jnet), net.eval()


def _recording(pp, store, to_np):
    def wrapped(*a, **kw):
        out = pp(*a, **kw)
        store.append({k: to_np(v) for k, v in out.items()})
        return out
    return wrapped


def test_real_network_valid_matches_jax(env, real_net):
    jnet, variables, jfwd, net = real_net
    jraw, traw = [], []
    jb, tb = env["jb"][:2], env["tb"][:2]
    jev.valid(env["jce"], env["jconsts"], variables, jfwd,
              _recording(env["jpost"], jraw, np.asarray), iter(jb), env["meshes"],
              verbose=False)
    got = tev.valid(env["tce"], env["tconsts"], network_fn(net),
                    _recording(build_postprocess(env["tce"], env["tconsts"]), traw,
                               lambda v: v.numpy()),
                    iter(tb), env["meshes"], verbose=False, gumbel_fn=env["gumbel_fn"])
    for w, g in zip(jraw, traw):
        vv = w["vote_valid"]
        assert vv.any(axis=1).all(), "lower confidence_th: some image cast no vote"
        np.testing.assert_array_equal(g["vote_valid"], vv)
        np.testing.assert_array_equal(g["valid"], w["valid"])
        np.testing.assert_array_equal(g["cls"], w["cls"])
        np.testing.assert_allclose(g["kp2d"][vv], w["kp2d"][vv], atol=1e-2)
        R = g["R"]
        assert np.isfinite(R).all() and np.isfinite(g["T"]).all()
        np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                                   np.broadcast_to(np.eye(3), R.shape), atol=1e-4)
    assert len(got["predictions"]) == 2 * BS
    assert net.training is False


# ---------------------------------------------------------------------------
# 10-12: loaders, loose loading and the CLI, the train loop's eval hook
# ---------------------------------------------------------------------------

def test_synthetic_loader_matches_jax(tmp_path):
    from kd6d_pose_adlp_tpu.data import loaders as jloaders
    from kd6d_pose_adlp_tpu_torch import make_bop_dataset
    from kd6d_pose_adlp_tpu_torch.data import loaders
    jc, tc = _cfgs()
    jc = jc.replace(test=dataclasses.replace(jc.test, ims_per_batch=4))
    tc = tc.replace(test=dataclasses.replace(tc.test, ims_per_batch=4))
    jd = jloaders.build(jc, kind="synthetic", eval_limit=6)
    td = loaders.build(tc, kind="synthetic", eval_limit=6, device="cpu")
    assert td.cfg.data.mesh_diameters == jd.cfg.data.mesh_diameters
    for a, b in zip(td.meshes, jd.meshes):
        np.testing.assert_array_equal(a, b)
    n = 0
    for (tb, tm), (jb, jm) in zip(td.eval_batches(), jd.eval_batches()):
        np.testing.assert_allclose(tb.images.numpy(), jb.images, atol=1e-6, rtol=0)
        for f in JBatch._fields[1:]:
            np.testing.assert_array_equal(getattr(tb, f).numpy(), getattr(jb, f), err_msg=f)
        for a, b in zip(tm, jm):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        n += 1
    assert n == 2       # 6 images, the second chunk padded by wrapping
    tt, jt = next(td.train_iter()), next(jd.train_iter())
    np.testing.assert_array_equal(tt.class_ids.numpy(), jt.class_ids)
    # the BOP source on a tree the port's make_bop_dataset writes: JAX's
    # task constants and eval batches (3 (image, object) items, one chunk)
    yaml_path = make_bop_dataset.write_dataset(str(tmp_path / "bop"), n_train=2, n_test=3,
                                               n_fg=N_FG, single_class=None, seed=2)
    jd = jloaders.build(jcfg.load_yaml_config(yaml_path).replace(
        model=jc.model, solver=jc.solver, test=jc.test), kind="bop", eval_limit=6)
    td = loaders.build(tcfg.load_yaml_config(yaml_path).replace(
        model=tc.model, solver=tc.solver, test=tc.test), kind="bop", eval_limit=6,
        device="cpu")
    np.testing.assert_array_equal(td.consts.kp3d.numpy(), np.asarray(jd.consts.kp3d))
    (tb, tm), = td.eval_batches()
    (jb, jm), = jd.eval_batches()
    for f in JBatch._fields:
        np.testing.assert_array_equal(getattr(tb, f).numpy(), getattr(jb, f), err_msg=f)
    assert [m["filename"] for m in tm] == [m["filename"] for m in jm]
    # the single_class / classes fields draw from the JAX stream
    for kw in (dict(single_class=1), dict(classes=(0, 2))):
        t_ds = SyntheticPoseDataset(n_fg=N_FG, input_res=RES, max_objs=2, seed=7, **kw)
        j_ds = JSynth(n_fg=N_FG, input_res=RES, max_objs=2, seed=7, **kw)
        for i in range(3):
            a, b = t_ds.sample(i, train=False), j_ds.sample(i, train=False)
            for k in ("image", "mask", "class_ids", "rotations", "translations", "bbox_trans"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=(kw, k))


def test_load_params_loose_and_the_cli(tmp_path, capsys, monkeypatch):
    from kd6d_pose_adlp_tpu_torch import evaluate
    from kd6d_pose_adlp_tpu_torch.data import loaders
    from kd6d_pose_adlp_tpu_torch.models.pose_net import init_pose_net
    from kd6d_pose_adlp_tpu_torch.utils.checkpoint import load_params_loose
    cfg = tcfg.Config(model=tcfg.ModelConfig(input_res=RES, use_higher_levels=False))
    src = init_pose_net(PoseNet(cfg.model, n_fg=N_FG), torch.Generator().manual_seed(1))
    sd = src.state_dict()
    keys = list(sd)
    partial = {k: sd[k] for k in keys[: len(keys) // 2]}
    bad = keys[1]
    partial[bad] = torch.zeros(tuple(sd[bad].shape) + (2,))       # shape mismatch
    partial["not.a.key"] = torch.zeros(3)                          # dropped
    torch.save(partial, tmp_path / "partial.pt")
    dst = init_pose_net(PoseNet(cfg.model, n_fg=N_FG), torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    n = load_params_loose(str(tmp_path / "partial.pt"), dst)
    assert n == len(keys) // 2 - 1
    after = dst.state_dict()
    for k in keys:
        want = sd[k] if (k in partial and k != bad) else before[k]
        assert torch.equal(after[k], want), k

    torch.save(sd, tmp_path / "w.pt")
    (tmp_path / "cfg.yaml").write_text(
        "MODEL:\n  BACKBONE: 'darknet_tiny_h'\n  INPUT_RES: 64\n  USE_HIGHER_LEVELS: False\n"
        "DATASETS:\n  N_CLASS: 4\n")
    args = ["--config_file", str(tmp_path / "cfg.yaml"), "--weight_file",
            str(tmp_path / "w.pt"), "--data", "synthetic", "--cpu",
            "--ims_per_batch", "4", "--working_dir", str(tmp_path / "eval")]
    # the first 6 images of the 64-image split: the CLI's TestConfig solves
    # 128 hypotheses over 512 points per image, seconds per chunk on a CPU
    build = loaders.build
    monkeypatch.setattr(loaders, "build",
                        lambda cfg, kind, device: build(cfg, kind, eval_limit=6, device=device))
    r = evaluate.main(args)
    out = capsys.readouterr().out
    assert f"loaded {len(keys)} tensors from" in out
    assert "ADI.10d" in out and r["table"] in out
    with open(tmp_path / "eval" / "preds.json") as f:
        assert len(json.load(f)) == 6
    r2 = evaluate.main(args + ["--eval_mode", "stream"])
    assert r2["table"] == r["table"]
    # bfloat16 by default, as test.py; float32 the other choice
    assert evaluate.parse_args(["--weight_file", "w"]).compute_dtype == "bfloat16"
    with pytest.raises(SystemExit):
        evaluate.parse_args(["--weight_file", "w", "--compute_dtype", "float16"])
    # --data bop on a tree the port's make_bop_dataset writes (3 classes, 2
    # test images), the same weights
    from test_torch_port_bop_cli import write_smoke_tree
    bop_yaml = write_smoke_tree(str(tmp_path / "bop"), n_train=2, n_test=2, n_fg=N_FG)
    r3 = evaluate.main(["--config_file", bop_yaml] + args[2:] + ["--data", "bop"])
    out = capsys.readouterr().out
    assert f"loaded {len(keys)} tensors from" in out and r3["table"] in out
    with open(tmp_path / "eval" / "preds.json") as f:
        assert sorted(json.load(f)) == [str(tmp_path / "bop" / "test" / "000001" / "rgb" /
                                            f"{i:06d}.png#obj0") for i in range(2)]
    assert evaluate.parse_args(["--weight_file", "w"]).device == "cuda"


def test_train_calls_eval_fn_at_val_freq_and_the_last_step(tmp_path):
    from kd6d_pose_adlp_tpu_torch.engine.loop import train
    cfg = tcfg.Config(model=tcfg.ModelConfig(input_res=RES, use_higher_levels=False),
                      data=tcfg.DataConfig(n_class=N_FG + 1),
                      solver=tcfg.SolverConfig(ims_per_batch=2, max_iter=3, val_freq=2,
                                               max_objs=2, max_pos=16))
    ds = SyntheticPoseDataset(n_fg=N_FG, input_res=RES, max_objs=2, seed=0)
    calls = []

    def eval_fn(state, step):
        calls.append((step, state.step))

    state, hist = train(cfg, ds.consts(device="cpu"),
                        (ds.batch(range(2 * i, 2 * i + 2)) for i in range(3)),
                        device="cpu", log_every=1, eval_fn=eval_fn, verbose=False,
                        working_dir=str(tmp_path))
    assert calls == [(2, 2), (3, 3)]
    assert [h["step"] for h in hist] == [1, 2, 3]
