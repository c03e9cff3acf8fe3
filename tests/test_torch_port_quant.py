"""PyTorch port, int8 post-training quantization (`kd6d_pose_adlp_tpu_torch/
utils/quant.py`, `models/blocks.QConv`, `conv2d_int8`) and the int8 KD
teacher of `train_kd --quant_teacher`, against the JAX package's
`utils/quant.py` and `models/blocks.QConv` on the same seeded numpy inputs
(darknet_tiny_h, 64², no P6/P7, as its tests/test_quant.py).

Tolerances, with the largest difference measured on this CPU beside them:
  conv2d_int8 / QConv int32 sums vs numpy and JAX   equal
  QConv quant output vs numpy (float64) and JAX     rtol 1e-5, atol 1e-6
                                                    (max |diff| 6.5e-6 of
                                                    values ~10 / equal)
  calibrated in_amax vs JAX's quant_stats           rtol 1e-5 (max 8.1e-7)
  int8 kernels, w_scale, bias, in_scale vs JAX      equal (fed equal amax)
  int8 PoseNet on JAX's quant variables             logits within 1e-4 of
                                                    their largest magnitude
                                                    (9.1e-8), regression 2e-2
                                                    (7.7e-3: one rounding
                                                    flip, see the test)
  int8 vs folded teacher KD step                    loss_cls rtol 1e-5,
                                                    loss_kd within 25%
                                                    (JAX's own bounds;
                                                    equal / 0.38%)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu.config import ModelConfig as JModelConfig
from kd6d_pose_adlp_tpu.models.blocks import QConv as JQConv
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu.utils.fold_bn import fold_batchnorm as j_fold
from kd6d_pose_adlp_tpu.utils.quant import build_quant_variables as j_build
from kd6d_pose_adlp_tpu.utils.quant import calibrate_amax as j_calibrate
from kd6d_pose_adlp_tpu.utils.quant import quantize_kernel as j_quantize_kernel
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.models.blocks import ConvBNAct, QConv, conv2d_int8
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
from kd6d_pose_adlp_tpu_torch.utils import quant
from kd6d_pose_adlp_tpu_torch.utils.convert import amax_from_jax, from_jax_variables
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)

RES, N_FG = 64, 3


def _oracle_int32(xq, kq, stride, pad):
    """numpy int64 sum of products over the symmetric zero-padded window;
    xq (B, H, W, C), kq HWIO."""
    B, H, W, C = xq.shape
    k = kq.shape[0]
    xp = np.pad(xq.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    Ho, Wo = (H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1
    acc = np.zeros((B, Ho, Wo, kq.shape[-1]), np.int64)
    for i in range(k):
        for j in range(k):
            win = xp[:, i:i + stride * (Ho - 1) + 1:stride, j:j + stride * (Wo - 1) + 1:stride]
            acc += np.einsum("bhwc,co->bhwo", win, kq[i, j].astype(np.int64))
    return acc


@pytest.mark.parametrize("B, C, O, H, W, k, stride", [
    (2, 3, 5, 8, 8, 3, 1),      # K = 27, O = 5: both padded to 8
    (2, 8, 16, 9, 7, 3, 2),     # odd map, stride 2
    (1, 5, 12, 4, 4, 3, 2),     # a 2x2 output: rows padded past 16
    (3, 16, 8, 6, 6, 1, 1),     # 1x1
    (1, 64, 32, 5, 5, 3, 1),    # sums far past the fp32 mantissa
])
def test_conv2d_int8_is_exact(B, C, O, H, W, k, stride):
    """Every int32 sum equals numpy's int64 one (largest |sum| here 4.1e5
    at C = 64; the fp32 mantissa ends at 1.7e7, int8 products at K = 9216
    reach 1.5e8)."""
    rng = np.random.default_rng(B * 100 + C)
    xq = rng.integers(-127, 128, (B, H, W, C)).astype(np.int8)
    kq = rng.integers(-127, 128, (k, k, C, O)).astype(np.int8)
    got = conv2d_int8(torch.from_numpy(xq).permute(0, 3, 1, 2),
                      torch.from_numpy(np.ascontiguousarray(kq.transpose(3, 2, 0, 1))),
                      stride, k // 2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  _oracle_int32(xq, kq, stride, k // 2))


@pytest.mark.parametrize("stride", [1, 2])
def test_qconv_matches_numpy_oracle_and_jax(stride):
    """QConv mode="quant" on JAX's own `quant` variables: int32 sums equal
    to JAX's conv (preferred_element_type int32) and to numpy's; outputs
    within rtol 1e-5 / atol 1e-6 of the float64 oracle (JAX's own bound;
    max |diff| 6.5e-6 on outputs up to ~10) and of JAX's QConv (measured
    equal)."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 8, 8, 3)) * 2.0).astype(np.float32)
    kq = rng.integers(-127, 128, (3, 3, 3, 5)).astype(np.int8)
    w_scale = rng.uniform(0.001, 0.1, 5).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)
    in_scale = np.float32(0.05)
    qvars = {"quant": {"kernel_q": kq, "w_scale": w_scale, "bias": bias,
                       "in_scale": in_scale}}
    pad = ((1, 1), (1, 1))
    want = np.asarray(JQConv(5, 3, strides=stride, padding=pad if stride > 1 else "SAME",
                             mode="quant").apply(qvars, jnp.asarray(x)))

    conv = QConv(3, 5, 3, stride=stride, mode="quant")
    conv.load_state_dict({"kernel_q": torch.from_numpy(np.ascontiguousarray(kq.transpose(3, 2, 0, 1))),
                          "w_scale": torch.from_numpy(w_scale),
                          "bias": torch.from_numpy(bias),
                          "in_scale": torch.tensor(in_scale)})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = conv(xt).permute(0, 2, 3, 1).numpy()

    xq = np.clip(np.round(x.astype(np.float64) / in_scale), -127, 127).astype(np.int8)
    acc = _oracle_int32(xq, kq, stride, 1)
    j_acc = jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(kq), (stride, stride), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    t_acc = conv2d_int8(torch.from_numpy(xq).permute(0, 3, 1, 2), conv.kernel_q, stride, 1)
    np.testing.assert_array_equal(t_acc.permute(0, 2, 3, 1).numpy(), acc)
    np.testing.assert_array_equal(np.asarray(j_acc), acc)

    oracle = acc.astype(np.float64) * (float(in_scale) * w_scale) + bias
    np.testing.assert_allclose(got.astype(np.float64), oracle, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_quantize_kernel_is_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    k = rng.normal(size=(3, 3, 8, 16)).astype(np.float32) * rng.uniform(
        0.01, 3.0, size=(16,)).astype(np.float32)
    for a, b in zip(quant.quantize_kernel(k), j_quantize_kernel(k)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_quant_requires_folded():
    with pytest.raises(ValueError, match="BN-folded"):
        ConvBNAct(3, 4, folded=False, quant_mode="quant")
    with pytest.raises(ValueError, match="BN-folded"):
        quant.quantize_posenet(tcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES,
                                                use_higher_levels=False), N_FG, {}, [])
    from kd6d_pose_adlp_tpu.models.blocks import ConvBNAct as JConvBNAct
    with pytest.raises(AssertionError):
        JConvBNAct(4, folded=False, quant_mode="quant").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))


@pytest.fixture(scope="module")
def folded_pair():
    """A BN-folded tiny_h PoseNet in both packages (JAX's fold of a random
    init with randomized BN statistics, converted), and its calibration
    images."""
    cfg = JModelConfig(backbone="darknet_tiny_h", input_res=RES, use_higher_levels=False)
    net = JPoseNet(cfg=cfg, n_fg=N_FG)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, RES, RES, 3)).astype(np.float32)
    variables = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    stats = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 2.0, a.shape) if np.asarray(a).min() > 0.5
                   else rng.normal(0.0, 0.3, a.shape)).astype(np.float32),
        variables["batch_stats"])
    folded = j_fold({"params": variables["params"], "batch_stats": stats})
    cfg_f = dataclasses.replace(cfg, bn_folded=True)
    tcfg_f = tcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES,
                              use_higher_levels=False, bn_folded=True)
    x2 = rng.normal(size=(2, RES, RES, 3)).astype(np.float32) * 3.0
    return cfg_f, tcfg_f, folded, from_jax_variables(folded), [x, x2]


@pytest.fixture(scope="module")
def jax_quant(folded_pair):
    cfg_f, _, folded, _, xs = folded_pair
    net_c = JPoseNet(cfg=dataclasses.replace(cfg_f, quant_mode="calibrate"), n_fg=N_FG)
    stats = j_calibrate(net_c, folded, [jnp.asarray(x) for x in xs])
    return stats, j_build(folded, stats)


def test_calibrate_amax_is_a_running_max_and_matches_jax(folded_pair, jax_quant):
    """The port's in_amax over the two batches equals JAX's quant_stats
    within rtol 1e-5 (max 8.1e-7) for every conv; one batch gives a
    smaller or equal absmax everywhere."""
    _, tcfg_f, _, sd, xs = folded_pair
    net_c = PoseNet(dataclasses.replace(tcfg_f, quant_mode="calibrate"), n_fg=N_FG)
    net_c.load_state_dict(sd, strict=True)
    one = quant.calibrate_amax(net_c, [torch.from_numpy(xs[0])])
    both = quant.calibrate_amax(net_c, [torch.from_numpy(x) for x in xs])
    assert all(both[k] >= one[k] for k in one)
    want = amax_from_jax(jax_quant[0])
    assert set(both) == set(want) and len(want) == 27
    for k in want:
        np.testing.assert_allclose(both[k], want[k], rtol=1e-5, err_msg=k)


def test_build_quant_state_structure_and_bits(folded_pair, jax_quant):
    """Backbone, FPN and tower convs int8; the head's output convs float.
    Fed JAX's calibration, every kernel_q, w_scale, bias and in_scale is
    JAX's, bit for bit."""
    _, tcfg_f, _, sd, _ = folded_pair
    stats, qvars = jax_quant
    state = quant.build_quant_state(sd, amax_from_jax(stats))
    q = [k[:-len(".kernel_q")] for k in state if k.endswith(".kernel_q")]
    assert any(k.startswith("backbone.") for k in q)
    assert any(k.startswith("fpn.") for k in q)
    assert any(k.startswith("head.cls_tower.") for k in q)
    assert any(k.startswith("head.pose_tower.") for k in q)
    for name in q:
        assert f"{name}.weight" not in state and state[f"{name}.kernel_q"].dtype == torch.int8
    for head_out in ("head.cls_logits", "head.pose_pred"):
        assert state[f"{head_out}.weight"].dtype == torch.float32
        assert f"{head_out}.kernel_q" not in state
    want = from_jax_variables(qvars)
    assert set(state) == set(want)
    for k in want:
        assert state[k].dtype == want[k].dtype, k
        assert torch.equal(state[k], want[k]), k
    net_q = PoseNet(dataclasses.replace(tcfg_f, quant_mode="quant"), n_fg=N_FG)
    net_q.load_state_dict(state, strict=True)


def test_int8_posenet_matches_jax_on_its_quant_variables(folded_pair, jax_quant):
    """JAX's int8 PoseNet variables through `from_jax_variables` into the
    port's: the logits within 1e-4 of their largest magnitude (measured
    9.1e-8), the regression within 2e-2 (measured 7.7e-3), and the logits
    within JAX's 0.05 of the folded float network (measured 0.014).

    The regression's bound is wider because of one rounding flip: one input
    element of the pose tower's second conv (level 0) lies within 1e-5 of a
    midpoint of round(x / in_scale); the GroupNorm before it rounds its
    float32 result an ulp apart in the two packages, so that element moves
    one int8 step (the first conv's outputs are equal, the second's differ
    by 1.1e-3 relative), and three more GroupNorms carry it to the
    output."""
    cfg_f, tcfg_f, folded, sd, xs = folded_pair
    _, qvars = jax_quant
    cfg_q = dataclasses.replace(cfg_f, quant_mode="quant")
    x = jnp.asarray(xs[1])
    jc, jr = jax.jit(lambda v, x: JPoseNet(cfg=cfg_q, n_fg=N_FG).apply(v, x, train=False))(
        qvars, x)
    net_q = PoseNet(dataclasses.replace(tcfg_f, quant_mode="quant"), n_fg=N_FG).eval()
    net_q.load_state_dict(from_jax_variables(qvars), strict=True)
    net_f = PoseNet(tcfg_f, n_fg=N_FG).eval()
    net_f.load_state_dict(sd, strict=True)
    with torch.no_grad():
        tc, tr = net_q(torch.from_numpy(xs[1]))
        fc, _ = net_f(torch.from_numpy(xs[1]))
    jc, jr = np.asarray(jc), np.asarray(jr)
    assert np.abs(tc.numpy() - jc).max() <= 1e-4 * np.abs(jc).max()
    assert np.abs(tr.numpy() - jr).max() <= 2e-2 * np.abs(jr).max()
    assert (tc - fc).abs().max() <= 0.05 * fc.abs().max()


def test_quantize_posenet_end_to_end(folded_pair):
    """The port's own pipeline (calibrate on its float network, quantize):
    logits within JAX's 0.05 of the folded float network's largest
    magnitude (measured 0.017); bf16 compute runs the same int8 sums."""
    _, tcfg_f, _, sd, xs = folded_pair
    calib = [torch.from_numpy(x) for x in xs]
    net_q, state = quant.quantize_posenet(tcfg_f, N_FG, sd, calib, device="cpu")
    assert not net_q.training and any(v.dtype == torch.int8 for v in state.values())
    net_f = PoseNet(tcfg_f, n_fg=N_FG).eval()
    net_f.load_state_dict(sd, strict=True)
    with torch.no_grad():
        qc, qr = net_q(calib[0])
        fc, _ = net_f(calib[0])
    assert (qc - fc).abs().max() <= 0.05 * fc.abs().max()
    assert torch.isfinite(qr).all()
    net_b, _ = quant.quantize_posenet(dataclasses.replace(tcfg_f, compute_dtype="bfloat16"),
                                      N_FG, sd, calib, device="cpu")
    with torch.no_grad():
        bc, _ = net_b(calib[0])
    assert bc.dtype == torch.float32 and torch.isfinite(bc).all()


def test_kd_train_step_with_int8_teacher():
    """The `--quant_teacher` composition in the port: an int8 darknet_tiny
    teacher (head prior 0.5, so its votes are live) drives one KD step of a
    darknet_tiny_h student with finite losses; against the BN-folded
    teacher on the same student, batch and SSC draw, loss_cls within rtol
    1e-5 (measured: equal) and loss_kd within 25% + 1e-3 (measured 0.38%),
    JAX's own bounds (tests/test_quant.py:138-143)."""
    from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
    from kd6d_pose_adlp_tpu_torch.engine import steps
    from kd6d_pose_adlp_tpu_torch.models.pose_net import init_pose_net
    from kd6d_pose_adlp_tpu_torch.utils.fold_bn import fold_batchnorm

    cfg = tcfg.Config(model=tcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES,
                                             use_higher_levels=False),
                      solver=tcfg.SolverConfig(ims_per_batch=4, max_iter=50, max_objs=2,
                                               max_pos=32),
                      test=tcfg.TestConfig(max_votes=16, ransac_iters=16),
                      kd=tcfg.KDConfig(weight=5.0, max_teacher_cells=16))
    cfg_t = cfg.replace(model=dataclasses.replace(cfg.model, backbone="darknet_tiny",
                                                  bn_folded=True))
    ds = SyntheticPoseDataset(n_fg=N_FG, input_res=RES, max_objs=2, single_class=1, seed=7)
    consts = ds.consts(device="cpu")
    batch = ds.batch(range(4), train=True)
    raw = init_pose_net(PoseNet(dataclasses.replace(cfg_t.model, bn_folded=False), n_fg=N_FG),
                        torch.Generator().manual_seed(5), prior=0.5)
    folded = fold_batchnorm(raw)
    t_folded = PoseNet(cfg_t.model, n_fg=N_FG).eval()
    t_folded.load_state_dict(folded, strict=True)
    t_int8, _ = quant.quantize_posenet(cfg_t.model, N_FG, folded, [batch.images],
                                       device="cpu")
    cfg_tq = cfg_t.replace(model=dataclasses.replace(cfg_t.model, quant_mode="quant"))

    u = torch.rand((4, cfg.model.num_cells, 2), generator=torch.Generator().manual_seed(3))
    metrics = {}
    for tag, (c_t, tnet) in {"folded": (cfg_t, t_folded), "int8": (cfg_tq, t_int8)}.items():
        net = init_pose_net(PoseNet(cfg.model, n_fg=N_FG), torch.Generator().manual_seed(0))
        opt = steps.make_optimizer(cfg)
        step = steps.build_train_step(cfg, c_t, consts, net, tnet, opt, distill=True)
        _, m = step(steps.create_train_state(cfg, net, opt), batch, uniform=u)
        metrics[tag] = {k: float(v) for k, v in m.items()}
        assert all(np.isfinite(v) for v in metrics[tag].values()), metrics[tag]
    assert metrics["folded"]["loss_kd"] > 0
    np.testing.assert_allclose(metrics["int8"]["loss_cls"], metrics["folded"]["loss_cls"],
                               rtol=1e-5)
    assert (abs(metrics["int8"]["loss_kd"] - metrics["folded"]["loss_kd"])
            <= 0.25 * abs(metrics["folded"]["loss_kd"]) + 1e-3), metrics


@pytest.mark.parametrize("pool", [[], ["--device_pool", "2", "--steps_per_dispatch", "2",
                                        "--cache_teacher"]], ids=["live", "cached"])
def test_train_kd_quant_teacher_end_to_end(tmp_path, capsys, monkeypatch, pool):
    """`train_kd.main --quant_teacher` on the CPU at 64² (configs/smoke.yaml,
    fp32), with the live teacher and with its votes cached over a device
    pool: the teacher file is loaded, folded, calibrated on 2 eval batches
    and int8-quantized, evaluated, and the student trains 2 KD steps with
    finite losses; without the fold the flag is refused, as in JAX."""
    import os

    from kd6d_pose_adlp_tpu_torch import train_kd
    from kd6d_pose_adlp_tpu_torch.data import loaders
    from kd6d_pose_adlp_tpu_torch.models.pose_net import init_pose_net

    build = loaders.build
    monkeypatch.setattr(loaders, "build",
                        lambda cfg, kind, device: build(cfg, kind, eval_limit=4, device=device))
    smoke = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "configs", "smoke.yaml")
    teacher_cfg = tcfg.load_yaml_config(smoke, backbone="darknet_tiny").model
    teacher = init_pose_net(PoseNet(teacher_cfg, n_fg=15), torch.Generator().manual_seed(1),
                            prior=0.5)
    torch.save(teacher.state_dict(), tmp_path / "teacher.pt")
    args = ["--cpu", "--config_file", smoke, "--data", "synthetic", "--max_iters", "2",
            "--working_dir", str(tmp_path / "run"), "--compute_dtype", "float32",
            "--backbone_t", "darknet_tiny", "--weight_file_t", str(tmp_path / "teacher.pt"),
            "--quant_teacher", "--quant_calib_batches", "2", "--eval_mode", "stream", *pool]
    state, hist = train_kd.main(args)
    out = capsys.readouterr().out
    assert "teacher: BN folded into conv weights" in out
    assert "teacher: int8-quantized (2 calib batches)" in out
    assert ("teacher knowledge cached for 2 pool batches" in out) == bool(pool)
    assert state.step == 2
    assert all(np.isfinite(h["loss_kd"]) and np.isfinite(h["loss_total"]) for h in hist)
    with pytest.raises(SystemExit, match="requires --fold_teacher_bn"):
        train_kd.main(args + ["--fold_teacher_bn", "false",
                              "--working_dir", str(tmp_path / "run2")])
