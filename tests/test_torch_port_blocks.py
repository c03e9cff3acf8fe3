"""PyTorch port, train-mode blocks and the darknet53 backbone
(`kd6d_pose_adlp_tpu_torch/models/blocks.py`, `models/darknet53.py`,
`utils/convert.py`) against `kd6d_pose_adlp_tpu/models/blocks.py` and
`models/darknet53.py`.

Tolerances, with the largest difference measured on this CPU beside them:
  ConvBNAct train step: output atol 1e-5, running mean/var atol 1e-6
      (max 3.0e-8 / 2.4e-7; torch's own BatchNorm2d updates the running
      variance with the unbiased batch variance, 32/31 larger here, and
      misses by ~4e-3)
  max-pool gradients                    exact (one winner per window)
  darknet53 stage maps                  max |diff| <= 1e-5 (eval) / 1e-4 (train)
      times max |flax map| (the random residual stages grow to ~1e3;
      measured 2.3e-6 / 3.8e-5: at 64² the last stage's batch statistics
      come from 8 values per channel, and flax's E[x²] - E[x]² variance
      loses digits there)
  darknet53 batch stats after train     rtol 2e-5, atol 1e-5
  state_dict -> JAX converter           exact
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.models.blocks import ConvBNAct as JConvBNAct
from kd6d_pose_adlp_tpu.models.blocks import max_pool_2x2 as j_max_pool
from kd6d_pose_adlp_tpu.models.darknet53 import DarkNet53 as JDarkNet53
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu.utils.torch_convert import (convert_pose_module,
                                                    merge_into_variables)
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.models.blocks import ConvBNAct, max_pool_2x2
from kd6d_pose_adlp_tpu_torch.models.darknet53 import DarkNet53
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables

RES = 64


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("C,O,k,stride", [(8, 16, 3, 1), (5, 7, 1, 1), (4, 6, 3, 2)])
def test_conv_bn_act_train_step_matches_flax(C, O, k, stride):
    """One train-mode forward of (2, 4, 4, C): outputs and the updated
    running statistics agree with flax's `mutable=["batch_stats"]` result."""
    rng = np.random.default_rng(C)
    x = rng.normal(1.0, 2.0, (2, 4, 4, C)).astype(np.float32)
    jm = JConvBNAct(O, kernel_size=k, strides=stride)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    scale = rng.uniform(0.5, 1.5, O).astype(np.float32)
    bias = rng.normal(0, 0.2, O).astype(np.float32)
    mean0 = rng.normal(0, 0.3, O).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, O).astype(np.float32)
    v = {"params": {"conv": v["params"]["conv"], "bn": {"scale": scale, "bias": bias}},
         "batch_stats": {"bn": {"mean": mean0, "var": var0}}}
    jy, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])

    m = ConvBNAct(C, O, kernel_size=k, stride=stride)
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(
            np.asarray(v["params"]["conv"]["kernel"]).transpose(3, 2, 0, 1)))
        m.bn.weight.copy_(torch.from_numpy(scale))
        m.bn.bias.copy_(torch.from_numpy(bias))
        m.bn.running_mean.copy_(torch.from_numpy(mean0))
        m.bn.running_var.copy_(torch.from_numpy(var0))
    m.train()
    ty = m(_nchw(x))
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jy),
                               atol=1e-5, rtol=0)
    st = mut["batch_stats"]["bn"]
    np.testing.assert_allclose(m.bn.running_mean.numpy(), np.asarray(st["mean"]), atol=1e-6)
    np.testing.assert_allclose(m.bn.running_var.numpy(), np.asarray(st["var"]), atol=1e-6)
    assert int(m.bn.num_batches_tracked) == 1


@pytest.mark.parametrize("kind", ["all_tied", "quantized", "random"])
def test_max_pool_gradient_routes_to_one_winner_like_flax(kind):
    """The cotangent of a window reaches exactly one input element, the same
    one as flax's nn.max_pool (XLA SelectAndScatter)."""
    rng = np.random.default_rng(7)
    x = {"all_tied": np.ones((1, 4, 4, 2), np.float32),
         "quantized": (np.round(rng.normal(size=(2, 8, 8, 3)) * 2) / 2).astype(np.float32),
         "random": rng.normal(size=(2, 8, 8, 3)).astype(np.float32)}[kind]
    w = rng.normal(size=(x.shape[0], x.shape[1] // 2, x.shape[2] // 2, x.shape[3]))
    w = w.astype(np.float32)
    jg = jax.grad(lambda a: (j_max_pool(a) * w).sum())(jnp.asarray(x))
    tx = _nchw(x).requires_grad_(True)
    (max_pool_2x2(tx) * _nchw(w)).sum().backward()
    g = tx.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(g, np.asarray(jg))
    np.testing.assert_array_equal(max_pool_2x2(tx).detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(j_max_pool(jnp.asarray(x))))
    if kind == "all_tied":
        assert (np.count_nonzero(g.reshape(1, 2, 2, 2, 2, 2)
                                 .transpose(0, 1, 3, 5, 2, 4).reshape(-1, 4), axis=1) == 1).all()


def _randomize(tree, rng):
    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, tree))
    out = {}
    for path, a in flat.items():
        a = np.array(a, np.float32)
        if path[0] == "batch_stats" and path[-1] == "mean":
            a = rng.normal(0.0, 0.3, a.shape)
        elif path[0] == "batch_stats" and path[-1] == "var":
            a = rng.uniform(0.5, 2.0, a.shape)
        elif path[-1] == "scale":
            a = rng.uniform(0.5, 1.5, a.shape)
        elif path[-1] == "bias":
            a = a + rng.normal(0.0, 0.1, a.shape)
        out[path] = np.asarray(a, np.float32)
    return traverse_util.unflatten_dict(out)


@pytest.fixture(scope="module")
def darknet53():
    jnet = JDarkNet53()
    x0 = jnp.zeros((1, RES, RES, 3))
    variables = _randomize(jax.jit(jnet.init)(jax.random.PRNGKey(0), x0),
                           np.random.default_rng(0))
    sd = from_jax_variables({"params": {"backbone": variables["params"], "fpn": {},
                                        "head": {}},
                             "batch_stats": {"backbone": variables["batch_stats"]}})
    net = DarkNet53()
    net.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    return jnet, variables, net


@pytest.mark.parametrize("train", [False, True])
def test_darknet53_stages_match_flax(darknet53, train):
    jnet, variables, net = darknet53
    x = np.random.default_rng(1).normal(size=(2, RES, RES, 3)).astype(np.float32)
    if train:
        want, mut = jax.jit(lambda v, a: jnet.apply(v, a, train=True,
                                                    mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    else:
        want = jax.jit(lambda v, a: jnet.apply(v, a, train=False))(variables, jnp.asarray(x))
    net.train(train)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(2, c, RES // s, RES // s) for c, s in
                                             zip((64, 128, 256, 512, 1024), (2, 4, 8, 16, 32))]
    for g, w in zip(got, want):
        g, w = g.permute(0, 2, 3, 1).numpy(), np.asarray(w)
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= (1e-4 if train else 1e-5), err
    if train:
        sd = from_jax_variables({"params": {"backbone": variables["params"], "fpn": {},
                                            "head": {}},
                                 "batch_stats": {"backbone": mut["batch_stats"]}})
        for k, v in sd.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(net.state_dict()[k[len("backbone."):]].numpy(),
                                           v.numpy(), rtol=2e-5, atol=1e-5, err_msg=k)
        net.load_state_dict(before)


@pytest.fixture(scope="module")
def posenet53():
    """A full darknet53 PoseNet tree with random values, shapes from flax's
    init without compiling it."""
    cfg = jcfg.ModelConfig(backbone="darknet53", input_res=128)
    jnet = JPoseNet(cfg=cfg, n_fg=15)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    rng = np.random.default_rng(2)
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    return jnet, variables


def test_darknet53_posenet_parameter_count_equals_flax(posenet53):
    _, variables = posenet53
    n_flax = sum(int(np.size(a)) for a in jax.tree_util.tree_leaves(variables["params"]))
    net = PoseNet(tcfg.ModelConfig(backbone="darknet53", input_res=128))
    assert sum(p.numel() for p in net.parameters()) == n_flax
    # the backbone alone: the reference's 41,609,928 less its 1000-class head
    assert sum(p.numel() for p in net.backbone.parameters()) == 41_609_928 - 1_025_000


def test_darknet53_state_dict_round_trips_through_the_jax_converter(posenet53):
    """flax tree -> from_jax_variables -> PoseNet(darknet53) -> state_dict ->
    convert_pose_module -> merge_into_variables(strict) reproduces the tree."""
    _, variables = posenet53
    net = PoseNet(tcfg.ModelConfig(backbone="darknet53", input_res=128))
    net.load_state_dict(from_jax_variables(variables), strict=True)
    params, stats = convert_pose_module({k: v.numpy() for k, v in net.state_dict().items()})
    merged = merge_into_variables(variables, params, stats, strict=True)
    for coll in ("params", "batch_stats"):
        want = traverse_util.flatten_dict(variables[coll])
        got = traverse_util.flatten_dict(merged[coll])
        assert set(got) == set(want), coll
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=str(k))


def test_darknet53_posenet_forward_shapes_and_raises():
    cfg = tcfg.ModelConfig(backbone="darknet53", input_res=128)
    net = PoseNet(cfg, n_fg=15).eval()
    with torch.no_grad():
        c, r = net(torch.zeros((1, 128, 128, 3)))
    assert cfg.num_levels == 5 and c.shape == (1, cfg.num_cells, 15)
    assert r.shape == (1, cfg.num_cells, 15 * 16)
    import dataclasses
    # bfloat16, remat, the folded form and its int8 PTQ forms build; int8
    # PTQ needs the fold; the binary-code head adds a third output
    for kw in (dict(compute_dtype="bfloat16"), dict(remat=True), dict(bn_folded=True),
               dict(bn_folded=True, quant_mode="calibrate"),
               dict(bn_folded=True, quant_mode="quant")):
        PoseNet(dataclasses.replace(cfg, **kw))
    with pytest.raises(ValueError, match="BN-folded"):
        PoseNet(dataclasses.replace(cfg, quant_mode="quant"))
    net = PoseNet(dataclasses.replace(cfg, code_bits=4), n_fg=15).eval()
    with torch.no_grad():
        out = net(torch.zeros((1, 128, 128, 3)))
    assert [tuple(o.shape) for o in out] == [(1, cfg.num_cells, 15), (1, cfg.num_cells, 15 * 16),
                                             (1, cfg.num_cells, 15 * (4 + 2))]
