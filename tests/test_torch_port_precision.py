"""PyTorch port, bfloat16 compute, remat and the CLIs at the JAX package's
default flags (`kd6d_pose_adlp_tpu_torch/models/blocks.py`,
`ops/conv_fused.py`, `engine/steps.py`, `train_kd.py`, `evaluate.py`)
against `kd6d_pose_adlp_tpu` at 64², B=2, no P6/P7.

The bf16 yardstick: a bf16 network rounds at other places than flax's
(the eval stem's K2 keeps its sum in fp32, XLA fuses differently), so the
port in bf16 is held to JAX's own bf16 error, max |port_bf16 - jax_bf16|
<= 2 max |jax_bf16 - jax_fp32| + 1e-3, on the logits and the regression
(measured on this CPU: 0.81-1.27x JAX's gap) and on the train-mode BN
statistics, which stay float32. Other tolerances, the largest difference
measured beside them:
  K2 / K3 plain versions in bf16 vs the Pallas kernels in interpret mode
      one bf16 rounding, |port - pallas| <= 2^-7 |pallas| + 1e-3 (bit-equal)
  one remat step vs the plain step, parameters and BN statistics  1e-6 (0)
"""
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu.ops import conv_pallas as jconv
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch import evaluate, train_kd
from kd6d_pose_adlp_tpu_torch.data import loaders
from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
from kd6d_pose_adlp_tpu_torch.engine import steps
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
from kd6d_pose_adlp_tpu_torch.ops import conv_fused as cf
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables
from test_torch_port_network import _randomize
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)

RES = 64
N_FG = 15
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "smoke.yaml")


@pytest.fixture(scope="module")
def flax_nets():
    """{backbone: ({dtype: flax PoseNet}, randomized variables)}."""
    out = {}
    for i, bb in enumerate(("darknet_tiny_h", "darknet_tiny")):
        nets = {dt: JPoseNet(cfg=jcfg.ModelConfig(backbone=bb, input_res=RES,
                                                  use_higher_levels=False,
                                                  compute_dtype=dt), n_fg=N_FG)
                for dt in ("float32", "bfloat16")}
        v = jax.jit(nets["float32"].init)(jax.random.PRNGKey(i), jnp.zeros((1, RES, RES, 3)))
        out[bb] = (nets, _randomize(v, np.random.default_rng(i)))
    return out


def _stats(tree):
    flat = jax.tree_util.tree_leaves_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in flat}


@pytest.mark.parametrize("backbone", ["darknet_tiny_h", "darknet_tiny"])
@pytest.mark.parametrize("train", [False, True])
def test_bf16_network_within_the_jax_yardstick(flax_nets, backbone, train):
    """The bf16 port against flax's bf16 network, measured by flax's own
    bf16-vs-fp32 gap; outputs float32; train-mode BN statistics float32
    and held the same way."""
    nets, v = flax_nets[backbone]
    x = np.random.default_rng(1).integers(0, 256, (2, RES, RES, 3), dtype=np.uint8)
    out, stats = {}, {}
    for dt, n in nets.items():
        if train:
            (c, r), mut = jax.jit(lambda vv, a: n.apply(vv, a, train=True,
                                                        mutable=["batch_stats"]))(
                v, jnp.asarray(x))
            stats[dt] = _stats(mut["batch_stats"])
        else:
            c, r = jax.jit(lambda vv, a: n.apply(vv, a, train=False))(v, jnp.asarray(x))
        out[dt] = (np.asarray(c), np.asarray(r))
    net = PoseNet(tcfg.ModelConfig(backbone=backbone, input_res=RES,
                                   use_higher_levels=False, compute_dtype="bfloat16"),
                  n_fg=N_FG)
    net.load_state_dict(from_jax_variables(v), strict=True)
    net.train(train)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for g, j16, j32 in zip(got, out["bfloat16"], out["float32"]):
        assert g.dtype == torch.float32
        assert np.abs(g.numpy() - j16).max() <= 2 * np.abs(j16 - j32).max() + 1e-3
    if train:
        want = from_jax_variables({"params": v["params"],
                                   "batch_stats": stats_tree(stats["bfloat16"], v)})
        ref32 = from_jax_variables({"params": v["params"],
                                    "batch_stats": stats_tree(stats["float32"], v)})
        sd = net.state_dict()
        for k in want:
            if k.endswith(("running_mean", "running_var")):
                assert sd[k].dtype == torch.float32, k
                gap = (want[k] - ref32[k]).abs().max()
                assert (sd[k] - want[k]).abs().max() <= 2 * gap + 1e-3, k


def stats_tree(flat, variables):
    """The batch_stats tree of `variables` with the leaves of `flat`
    (keyed by tree path)."""
    leaves = jax.tree_util.tree_leaves_with_path(variables["batch_stats"])
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(variables["batch_stats"]),
        [flat[jax.tree_util.keystr(p)] for p, _ in leaves])


# the last six are the edges of the bf16 serving instances' tiling (spans of
# 64 columns; tiles of 1,024 at the stem, 256 at s2): at the stem a ragged
# second tile with M = 1,147 odd and B = 1 (W + 2 = 31, 3 mod 4) and the
# other residues of W + 2 mod 4 (0, 1, 2); at s2 a map narrower than one
# span (M = 15, odd, B = 1) and a ragged third tile (M = 544)
@pytest.mark.parametrize("B, C, O, H, W", [(1, 3, 8, 8, 8), (2, 8, 16, 6, 5),
                                           (1, 12, 8, 4, 6), (1, 16, 32, 5, 5),
                                           (1, 3, 32, 8, 8), (1, 32, 64, 6, 6),
                                           (1, 20, 72, 5, 7),
                                           (1, 3, 8, 37, 29), (2, 3, 8, 5, 2),
                                           (1, 3, 8, 6, 3), (2, 3, 8, 3, 4),
                                           (1, 8, 16, 3, 3), (2, 8, 16, 17, 30)])
@pytest.mark.parametrize("form", ["flat", "stacked"])
def test_bf16_plain_versions_match_pallas_interpret(B, C, O, H, W, form):
    """K2's and K3's plain versions on bf16 slabs against the Pallas kernels
    run in interpret mode (as tests/test_conv_pallas.py:85 runs them):
    bf16 out, within one bf16 rounding; the CPU wrapper is the plain
    version and counts no launch."""
    rng = np.random.default_rng(C * 10 + O)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    k = (rng.normal(size=(3, 3, C, O)) / np.sqrt(9 * C)).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, (O, 1)).astype(np.float32)
    bi = rng.normal(0, 0.1, (O, 1)).astype(np.float32)
    jx = jconv.nhwc_to_flat(jnp.asarray(x, jnp.bfloat16))
    jw = jconv.pack_weights(jnp.asarray(k)).astype(jnp.bfloat16)
    tx = cf.nhwc_to_flat(torch.from_numpy(x).to(torch.bfloat16))
    tw = cf.pack_weights(torch.from_numpy(k)).to(torch.bfloat16)
    tsc, tbi = torch.from_numpy(sc), torch.from_numpy(bi)
    cf.reset_launch_counts()
    if form == "flat":
        want = jconv.conv3x3_bn_act_flat(jx, jw, jnp.asarray(sc), jnp.asarray(bi), H=H,
                                         W=W, interpret=True)
        plain = cf.conv3x3_bn_act_flat_plain(tx, tw, tsc, tbi, H=H, W=W)
        got = cf.conv3x3_bn_act_flat(tx, tw, tsc, tbi, H=H, W=W)
    else:
        want = jconv.conv3x3_bn_act_stacked(jconv.stack_taps(jx, H, W), jw, jnp.asarray(sc),
                                            jnp.asarray(bi), interpret=True)
        ts = cf.stack_taps(tx, H, W)
        plain = cf.conv3x3_bn_act_stacked_plain(ts, tw, tsc, tbi)
        got = cf.conv3x3_bn_act_stacked(ts, tw, tsc, tbi)
    assert want.dtype == jnp.bfloat16 and got.dtype == plain.dtype == torch.bfloat16
    assert torch.equal(got, plain) and not cf.launches
    w32 = np.asarray(want, np.float32)
    assert (np.abs(got.float().numpy() - w32) <= 2.0 ** -7 * np.abs(w32) + 1e-3).all()


def test_wrappers_refuse_mixed_types():
    x = torch.zeros((1, 3, 6 * 6 + 2), dtype=torch.bfloat16)
    w = torch.zeros((9, 8, 3))
    one = torch.ones((8, 1))
    with pytest.raises(TypeError, match="wmat"):
        cf.conv3x3_bn_act_flat(x, w, one, one, H=4, W=4)
    with pytest.raises(TypeError, match="scale"):
        cf.conv3x3_bn_act_flat(x, w.to(torch.bfloat16), one.to(torch.bfloat16), one,
                               H=4, W=4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cf.conv3x3_bn_act_flat(x.half(), w.half(), one, one, H=4, W=4)


def _step(remat: bool, contexts=None, monkeypatch=None):
    """One KD-free train step of a bf16 darknet_tiny_h from seeded weights,
    batch and SSC draw; returns the student's state_dict after it."""
    cfg = tcfg.Config(model=tcfg.ModelConfig(input_res=RES, use_higher_levels=False,
                                             compute_dtype="bfloat16", remat=remat),
                      solver=tcfg.SolverConfig(ims_per_batch=2))
    if contexts is not None:
        monkeypatch.setattr(steps, "_remat_contexts", contexts)
    ds = SyntheticPoseDataset(input_res=RES, seed=5)
    net = init_pose_net(PoseNet(cfg.model, n_fg=N_FG), torch.Generator().manual_seed(0))
    opt = steps.make_optimizer(cfg)
    state = steps.create_train_state(cfg, net, opt)
    step = steps.build_train_step(cfg, None, ds.consts(device="cpu"), net, None, opt,
                                  distill=False)
    u = torch.rand((2, cfg.model.num_cells, ds.max_objs),
                   generator=torch.Generator().manual_seed(3))
    state, m = step(state, ds.batch(range(2)), uniform=u)
    assert all(np.isfinite(float(v)) for v in m.values())
    return {k: v.clone() for k, v in net.state_dict().items()}


def _max_diff(a, b, stats: bool):
    keys = [k for k in a if k.endswith(("running_mean", "running_var")) == stats
            and not k.endswith("num_batches_tracked")]
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in keys)


def test_remat_step_equals_the_plain_step():
    """remat=True re-runs the student forward in the backward pass
    (torch.utils.checkpoint): parameters and BN running statistics equal the
    plain step's within 1e-6 (JAX's tests/test_train_e2e.py:46), and each BN
    counted one update."""
    plain, remat = _step(False), _step(True)
    assert _max_diff(remat, plain, stats=False) <= 1e-6
    assert _max_diff(remat, plain, stats=True) <= 1e-6
    counts = {int(v) for k, v in remat.items() if k.endswith("num_batches_tracked")}
    assert counts == {1}


def test_the_remat_check_fails_when_bn_updates_twice(monkeypatch):
    """Without the recompute context that freezes the BN statistics, the
    re-run forward updates them a second time: the check above fails."""
    plain = _step(False)
    twice = _step(True, lambda: (contextlib.nullcontext(), contextlib.nullcontext()),
                  monkeypatch)
    assert _max_diff(twice, plain, stats=True) > 1e-6
    assert _max_diff(twice, plain, stats=False) <= 1e-6
    counts = {int(v) for k, v in twice.items() if k.endswith("num_batches_tracked")}
    assert counts == {2}


def test_the_clis_at_their_jax_defaults(tmp_path, capsys, monkeypatch):
    """train_kd.main with only --remat added to the defaults (bf16, the
    teacher's BN folded after loading), then evaluate.main at its default
    bf16 on the run's final.ckpt, both on the CPU; the eval stem's K2 runs
    on bf16 slabs."""
    build = loaders.build
    monkeypatch.setattr(loaders, "build",
                        lambda cfg, kind, device: build(cfg, kind, eval_limit=2, device=device))
    dtypes = []
    plain = cf.conv3x3_bn_act_flat_plain
    monkeypatch.setattr(cf, "conv3x3_bn_act_flat_plain",
                        lambda x, *a, **k: dtypes.append(x.dtype) or plain(x, *a, **k))
    teacher = init_pose_net(PoseNet(tcfg.ModelConfig(input_res=RES,
                                                     use_higher_levels=False)),
                            torch.Generator().manual_seed(1))
    torch.save(teacher.state_dict(), tmp_path / "teacher.pt")
    wd = tmp_path / "run"
    state, hist = train_kd.main(["--cpu", "--config_file", SMOKE, "--data", "synthetic",
                                 "--max_iters", "2", "--backbone_t", "darknet_tiny_h",
                                 "--weight_file_t", str(tmp_path / "teacher.pt"),
                                 "--remat", "--working_dir", str(wd)])
    out = capsys.readouterr().out
    assert "teacher: BN folded into conv weights" in out and "--- evaluate teacher ---" in out
    assert state.step == 2 and all(np.isfinite(v) for v in hist[-1].values())
    with open(wd / "cfg.json") as f:
        model = json.load(f)["model"]
    assert (model["compute_dtype"], model["remat"]) == ("bfloat16", True)
    assert state.net.dtype == torch.bfloat16
    assert set(dtypes) == {torch.bfloat16}
    r = evaluate.main(["--cpu", "--config_file", SMOKE, "--data", "synthetic",
                       "--weight_file", str(wd / "final.ckpt"), "--ims_per_batch", "2",
                       "--working_dir", str(tmp_path / "eval")])
    out = capsys.readouterr().out
    n = len(torch.load(wd / "final.ckpt", weights_only=True))
    assert f"loaded {n} tensors from" in out and r["table"] in out
    assert set(dtypes) == {torch.bfloat16}
