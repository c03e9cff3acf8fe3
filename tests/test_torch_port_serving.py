"""PyTorch port, the serving slice as a whole: `kd6d_pose_adlp_tpu_torch.
engine.serving.build_infer_fn(device="cpu")` against the JAX
`build_infer_fn` on the same weights (converted by `from_jax_variables`), the
same uint8 crops, crop affines and class ids, with JAX's RANSAC Gumbel draws
handed to the port.

Both configs lower `confidence_th` so that random-weight cells do vote.
Random-weight votes make EPnP ill-conditioned, so R and T are only checked
for being finite and R for being orthonormal here; pose parity is held by
the planted-scene test in test_torch_port_postprocess.py.

Tolerances, with the largest difference measured on this CPU beside them:
  network cls / reg                     atol 1e-4   (max 2.0e-6)
  score                                 atol 1e-5   (max 5.2e-8)
  cls, valid, vote_valid                equal
  kp2d where vote_valid                 atol 1e-2 px (max 1.2e-4 px)
  R orthonormality                      atol 1e-4   (max 2.4e-7)
  centered_bbox_trans                   equal
  uint8 request crops vs JAX renderings within half a grey level
The network runs in full fp32 whatever the caller's TF32 flags: a stub
network records the flags it is called under.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.data.synthetic import SyntheticPoseDataset as JSynth
from kd6d_pose_adlp_tpu.engine.serving import build_infer_fn as j_build_infer_fn
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
from kd6d_pose_adlp_tpu_torch.engine.serving import SINGLE_KEYS, build_infer_fn
from kd6d_pose_adlp_tpu_torch.ops import conv_fused
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables
from kd6d_pose_adlp_tpu_torch.utils.precision import full_fp32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, B, SEED = 64, 3, 7
TEST = dict(confidence_th=0.0105, max_votes=16, ransac_iters=16, lhm_iters=2)


def _randomize_bn(variables, rng):
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    stats = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 2.0, a.shape) if a.min() > 0.5
                   else rng.normal(0.0, 0.3, a.shape)).astype(np.float32), stats)
    return {"params": variables["params"], "batch_stats": stats}


@pytest.fixture(scope="module")
def endpoints():
    jc = jcfg.Config(model=jcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES),
                     test=jcfg.TestConfig(**TEST))
    tc = tcfg.Config(model=tcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES),
                     test=tcfg.TestConfig(**TEST))
    ds = SyntheticPoseDataset(n_fg=15, input_res=RES, seed=0)
    jds = JSynth(n_fg=15, input_res=RES, seed=0)
    jnet = JPoseNet(cfg=jc.model, n_fg=15)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)))
    variables = _randomize_bn(variables, np.random.default_rng(0))
    j_infer = jax.jit(j_build_infer_fn(jc, jds.consts(), variables))
    t_infer = build_infer_fn(tc, ds.consts(device="cpu"), from_jax_variables(variables),
                             device="cpu")
    req = ds.requests(range(B))
    return jnet, variables, j_infer, t_infer, req


def _jax_gumbel(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    n = TEST["max_votes"] * 8
    return torch.from_numpy(np.stack([np.array(jax.random.gumbel(k, (TEST["ransac_iters"], n)))
                                      for k in keys]))


def _run_both(endpoints, class_ids):
    _, _, j_infer, t_infer, req = endpoints
    want = jax.device_get(j_infer(jnp.asarray(req["images"]), jnp.asarray(req["bbox_trans"]),
                                  jnp.asarray(class_ids, jnp.int32),
                                  jnp.asarray(SEED, jnp.uint32)))
    got = t_infer(req["images"], req["bbox_trans"], class_ids, gumbel=_jax_gumbel(SEED))
    return want, got


def test_infer_matches_jax(endpoints):
    jnet, variables, _, t_infer, req = endpoints
    conv_fused.reset_launch_counts()
    want, got = _run_both(endpoints, req["class_ids"])
    assert list(got) == list(SINGLE_KEYS)

    # the network outputs under the endpoint
    jc_, jr_ = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        variables, jnp.asarray(req["images"]))
    with torch.no_grad():
        tc_, tr_ = t_infer.model(torch.from_numpy(req["images"]))
    np.testing.assert_allclose(tc_.numpy(), np.asarray(jc_), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr_.numpy(), np.asarray(jr_), atol=1e-4, rtol=0)

    vv = want["vote_valid"]
    assert vv.any(axis=1).all(), "lower confidence_th: some image cast no vote"
    np.testing.assert_array_equal(got["vote_valid"].numpy(), vv)
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(got["cls"].numpy(), want["cls"])
    np.testing.assert_allclose(got["score"].numpy(), want["score"], atol=1e-5)
    np.testing.assert_allclose(got["kp2d"].numpy()[vv], want["kp2d"][vv], atol=1e-2)
    R, T = got["R"].numpy(), got["T"].numpy()
    assert np.isfinite(R).all() and np.isfinite(T).all()
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-4)
    # dtypes of the JAX endpoint
    assert got["cls"].dtype == torch.int32 and got["n_inliers"].dtype == torch.int32
    assert got["valid"].dtype == torch.bool
    # the CPU path ran the plain conv versions: no kernel launches
    assert not conv_fused.launches


def test_negative_class_id_is_invalid(endpoints):
    ids = np.array([-1, 4, -3], np.int32)
    want, got = _run_both(endpoints, ids)
    np.testing.assert_array_equal(got["valid"].numpy(), [False, True, False])
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(got["cls"].numpy(), [0, 4, 0])


def test_seeded_draws_are_reproducible(endpoints):
    *_, t_infer, req = endpoints
    a = t_infer(req["images"], req["bbox_trans"], req["class_ids"], seed=3)
    b = t_infer(req["images"], req["bbox_trans"], req["class_ids"], seed=3)
    for k in SINGLE_KEYS:
        assert torch.equal(a[k], b[k]), k


def test_centered_bbox_trans_matches_jax():
    from kd6d_pose_adlp_tpu.engine.serving import centered_bbox_trans as j_centered
    from kd6d_pose_adlp_tpu_torch.engine.serving import centered_bbox_trans
    np.testing.assert_array_equal(centered_bbox_trans(3, RES), j_centered(3, RES))


def test_entry_points_default_to_the_card():
    """build_infer_fn defaults to device="cuda" and never drops to the CPU."""
    cfg = tcfg.Config(model=tcfg.ModelConfig(input_res=RES))
    ds = SyntheticPoseDataset(n_fg=15, input_res=RES, seed=0)
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
    net = PoseNet(cfg.model)
    if torch.cuda.is_available():
        infer = build_infer_fn(cfg, ds.consts(), net)
        assert next(infer.model.parameters()).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            build_infer_fn(cfg, ds.consts(device="cpu"), net)


@pytest.mark.parametrize("train", [False, True])
def test_synthetic_scenes_match_jax(train):
    """Same numpy RNG stream, sample for sample; the uint8 request crops are
    the same renderings."""
    ds, jds = SyntheticPoseDataset(input_res=RES, seed=5), JSynth(input_res=RES, seed=5)
    for i in range(3):
        a, b = ds.sample(i, train), jds.sample(i, train)
        for k in ("image", "mask", "class_ids", "rotations", "translations",
                  "bbox_trans"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    req = ds.requests(range(3), train=train)
    img01 = np.stack([jds.sample(i, train)["image"] for i in range(3)])
    from kd6d_pose_adlp_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    img01 = img01 * IMAGENET_STD + IMAGENET_MEAN
    np.testing.assert_allclose(req["images"][..., ::-1] / 255.0, img01, atol=0.5 / 255 + 1e-6)
    jc, tc = jds.consts(), ds.consts(device="cpu")
    for name in ("K", "inv_K", "kp3d", "diameters"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), err_msg=name)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import kd6d_pose_adlp_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'kd6d_pose_adlp_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith(p.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok") and int(out.stdout.split()[1]) > 20


class _FlagRecorder(torch.nn.Module):
    """A stand-in network that records (matmul, cuDNN) allow_tf32 as it is
    called and returns outputs that cast no vote."""

    def __init__(self, cells: int, n_fg: int = 15):
        super().__init__()
        self.cells, self.n_fg, self.seen = cells, n_fg, []

    def forward(self, images):
        self.seen.append((torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32))
        B = images.shape[0]
        return (torch.full((B, self.cells, self.n_fg), -20.0),
                torch.zeros((B, self.cells, self.n_fg * 16)))


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_network_runs_in_full_fp32_under_tf32_defaults(monkeypatch, mode):
    """With both TF32 flags on (cuDNN's is on by PyTorch's default), the
    endpoint's network call, inside infer and as infer.network, sees both
    off, and both are on again afterwards."""
    cfg = tcfg.Config(model=tcfg.ModelConfig(input_res=RES), test=tcfg.TestConfig(**TEST))
    ds = SyntheticPoseDataset(n_fg=15, input_res=RES, seed=0)
    stub = _FlagRecorder(cfg.model.num_cells)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    infer = build_infer_fn(cfg, ds.consts(device="cpu"), stub, mode=mode, device="cpu")
    req = ds.requests(range(2))
    out = infer(req["images"], req["bbox_trans"], req["class_ids"])
    assert not out["valid"].any()
    assert stub.seen == [(False, False)]
    cls, reg = infer.network(req["images"])
    assert cls.shape == (2, cfg.model.num_cells, 15)
    assert stub.seen == [(False, False), (False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError):
        with full_fp32():
            raise ValueError("restored on an exception too")
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
