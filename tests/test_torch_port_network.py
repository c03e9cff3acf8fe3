"""PyTorch port, network (`kd6d_pose_adlp_tpu_torch/models/`) against the
Flax `PoseNet` of `kd6d_pose_adlp_tpu` at darknet_tiny_h's full widths and a
64² input, with weights carried across by `utils/convert.from_jax_variables`.

BN statistics and affines, GN affines and head biases are randomized before
converting: Flax's initial batch_stats (mean 0, var 1) would test the eval
BN fold of the stem segment trivially. Tolerances, with the largest
difference measured on this CPU beside them:
  flat cls/reg vs PoseNet.apply(train=False)   atol 1e-4  (max 2.4e-6)
  backbone pyramid maps vs Flax DarkNet         atol 1e-4  (max 1.3e-5;
                                                odd 37x42 input: max 9.5e-6)
  fused eval stem vs unfused ConvBNAct units    atol 1e-5  (max 2.9e-6)
  state_dict -> JAX converter -> Flax tree      exact
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.models.darknet import DarkNet as JDarkNet
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu.utils.torch_convert import (convert_pose_module,
                                                    merge_into_variables)
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.models.blocks import max_pool_2x2
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables

RES = 64
N_FG = 15


def _randomize(variables, rng):
    """Random BN stats/affines, GN affines and conv biases (numpy tree)."""
    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, variables))
    out = {}
    for path, a in flat.items():
        a = np.array(a, np.float32)
        if path[0] == "batch_stats" and path[-1] == "mean":
            a = rng.normal(0.0, 0.3, a.shape)
        elif path[0] == "batch_stats" and path[-1] == "var":
            a = rng.uniform(0.5, 2.0, a.shape)
        elif path[-1] == "scale" and path[-2] != "head":
            a = rng.uniform(0.5, 1.5, a.shape)
        elif path[-1] == "scales":
            a = rng.uniform(0.5, 1.5, a.shape)
        elif path[-1] == "bias":
            a = a + rng.normal(0.0, 0.1, a.shape)
        out[path] = np.asarray(a, np.float32)
    return traverse_util.unflatten_dict(out)


@pytest.fixture(scope="module")
def nets():
    cfg = jcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES)
    jnet = JPoseNet(cfg=cfg, n_fg=N_FG)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)))
    variables = _randomize(variables, np.random.default_rng(0))
    net = PoseNet(tcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES), n_fg=N_FG)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    net.eval()
    return jnet, variables, net


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_flat_outputs_match_flax(nets, kind):
    jnet, variables, net = nets
    rng = np.random.default_rng(1)
    if kind == "uint8":
        images = rng.integers(0, 256, (2, RES, RES, 3), dtype=np.uint8)
    else:
        images = rng.normal(size=(2, RES, RES, 3)).astype(np.float32)
    jc, jr = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        variables, jnp.asarray(images))
    with torch.no_grad():
        tc, tr = net(torch.from_numpy(images))
    assert tc.shape == (2, 85, N_FG) and tr.shape == (2, 85, N_FG * 16)
    assert tc.dtype == torch.float32 and tr.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4, rtol=0)


def test_backbone_pyramid_matches_flax(nets):
    """All four pyramid maps, including pyr[0] (the pooled stage-1 map the
    stem segment returns), which tiny_h's FPN skips."""
    _, variables, net = nets
    x = np.random.default_rng(2).normal(size=(2, RES, RES, 3)).astype(np.float32)
    jd = JDarkNet(version="tiny-h")
    want = jax.jit(lambda v, a: jd.apply(v, a, train=False))(
        {"params": variables["params"]["backbone"],
         "batch_stats": variables["batch_stats"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        got = net.backbone(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=1e-4, rtol=0)


def test_fused_eval_stem_equals_unfused_units(nets):
    """The eval stem runs through the fused segment with BN folded from the
    running statistics; the same units run unfused must agree."""
    _, _, net = nets
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, RES, RES, 3)).astype(np.float32))
    stages = list(net.backbone.features)
    with torch.no_grad():
        pyr = net.backbone(x)
        p1 = max_pool_2x2(stages[0](x.permute(0, 3, 1, 2)))
        p2 = max_pool_2x2(stages[1](p1))
    np.testing.assert_allclose(pyr[0].numpy(), p1.numpy(), atol=1e-5)
    np.testing.assert_allclose(pyr[1].numpy(), p2.numpy(), atol=1e-5)


def test_odd_sized_eval_input_goes_through_the_segment(nets, monkeypatch):
    """An eval input whose sides are not multiples of 4 still runs the fused
    stem segment (no silent unfused route), and the pyramid matches the Flax
    DarkNet, whose VALID pools floor the odd maps."""
    from kd6d_pose_adlp_tpu_torch.models import darknet
    _, variables, net = nets
    calls = []
    seg = darknet.stem_s2_segment_flat
    monkeypatch.setattr(darknet, "stem_s2_segment_flat",
                        lambda *a, **k: calls.append(1) or seg(*a, **k))
    x = np.random.default_rng(4).normal(size=(1, 37, 42, 3)).astype(np.float32)
    jd = JDarkNet(version="tiny-h")
    want = jax.jit(lambda v, a: jd.apply(v, a, train=False))(
        {"params": variables["params"]["backbone"],
         "batch_stats": variables["batch_stats"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        got = net.backbone(torch.from_numpy(x))
    assert calls == [1]
    for g, w in zip(got, want):
        assert g.permute(0, 2, 3, 1).shape == w.shape
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=1e-4, rtol=0)


def test_parameter_counts_equal(nets):
    _, variables, net = nets
    n_flax = sum(int(np.size(a)) for a in
                 jax.tree_util.tree_leaves(variables["params"]))
    assert sum(p.numel() for p in net.parameters()) == n_flax


def test_state_dict_round_trips_through_the_jax_converter(nets):
    """port state_dict -> convert_pose_module -> merge_into_variables(strict)
    reproduces the Flax tree exactly."""
    jnet, variables, net = nets
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    params, stats = convert_pose_module(sd)
    fresh = jax.jit(jnet.init)(jax.random.PRNGKey(5), jnp.zeros((1, RES, RES, 3)))
    merged = merge_into_variables(fresh, params, stats, strict=True)
    for coll in ("params", "batch_stats"):
        want = traverse_util.flatten_dict(variables[coll])
        got = traverse_util.flatten_dict(merged[coll])
        assert set(got) == set(want), coll
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=str(k))


def test_init_is_seeded_and_matches_flax_init_scheme():
    """init_pose_net draws from the given generator (same seed, same
    weights) with the JAX package's initializer families."""
    cfg = tcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES)
    a = init_pose_net(PoseNet(cfg), torch.Generator().manual_seed(0))
    b = init_pose_net(PoseNet(cfg), torch.Generator().manual_seed(0))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        assert torch.equal(va, vb), ka
    w = a.backbone.features.stage3.unit2.conv.weight       # 3x3, 8 -> 64
    assert w.abs().max() <= np.sqrt(6.0 / (8 * 9)) and w.std() > 0.1
    with torch.no_grad():
        assert abs(float(a.head.cls_logits.bias[0]) + np.log(99.0)) < 1e-5
        assert abs(float(a.head.pose_pred.weight.std()) - 0.01) < 1e-3


def test_config_copy_is_identical():
    assert dataclasses.asdict(tcfg.Config()) == dataclasses.asdict(jcfg.Config())
    m = tcfg.ModelConfig()
    assert (m.num_levels, m.level_strides, m.num_cells) == (4, (8, 16, 32, 64), 1360)
