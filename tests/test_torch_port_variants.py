"""PyTorch port, the backbone variants and the BN fold
(`kd6d_pose_adlp_tpu_torch/models/darknet.py`, `models/darknet53.py`,
`models/pose_net.make_backbone`, `utils/fold_bn.py`, `utils/convert.py`)
against the Flax modules of `kd6d_pose_adlp_tpu` at 64², B=2, no P6/P7.

BN statistics and affines, GN affines and conv biases are randomized
before converting, as in test_torch_port_network.py. Tolerances, with the
largest difference measured on this CPU beside them:
  parameter counts with include_head       exact, and equal to the
                                           reference's constants
  pyramid maps' shapes, eval and train     exact
  eval-mode PoseNet outputs, fp32          atol 1e-4 (max 2.9e-6)
  fold_batchnorm vs JAX fold_batchnorm     rtol 1e-6 (bit-equal)
  folded vs unfolded eval forward          rtol 1e-4, atol 1e-4, as JAX's
                                           tests/test_fold_bn.py:36 (max 5.8e-6
                                           on outputs up to 5.5)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.models.darknet import DarkNet as JDarkNet
from kd6d_pose_adlp_tpu.models.darknet53 import DarkNet53 as JDarkNet53
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu.utils.fold_bn import fold_batchnorm as j_fold
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.models.darknet import DarkNet
from kd6d_pose_adlp_tpu_torch.models.darknet53 import DarkNet53
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables
from kd6d_pose_adlp_tpu_torch.utils.fold_bn import fold_batchnorm
from test_torch_port_network import _randomize
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)

RES = 64
N_FG = 15


def _n_flax(module, res):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, res, res, 3)))
    return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("plan, want", [("ref", 7_319_416), ("tiny", 1_042_104),
                                        ("19", 20_842_376), ("darknet53", 41_609_928)])
def test_parameter_counts_with_the_imagenet_head(plan, want):
    """The reference's self-test constants (backbone/darknet.py:285,
    darknet53.py:242): the port's module and flax's both hold them."""
    if plan == "darknet53":
        port, flax_mod = DarkNet53(include_head=True), JDarkNet53(include_head=True)
    else:
        port, flax_mod = DarkNet(plan, include_head=True), JDarkNet(version=plan,
                                                                    include_head=True)
    assert sum(p.numel() for p in port.parameters()) == want
    assert _n_flax(flax_mod, RES) == want


@pytest.mark.parametrize("plan, s2d", [("ref", False), ("tiny", False), ("tiny-h", False),
                                       ("19", False), ("tiny-h-wide", False),
                                       ("tiny-h", True)])
def test_pyramid_shapes_match_flax(plan, s2d):
    """The four pyramid maps of every plan, eval (the stem segment) and
    train mode, against flax's (NHWC) shapes; and the include_head logits."""
    x = np.random.default_rng(0).normal(size=(2, RES, RES, 3)).astype(np.float32)
    jd = JDarkNet(version=plan, s2d_stem=s2d)
    want = jax.eval_shape(lambda a: jd.init_with_output(jax.random.PRNGKey(0), a)[0],
                          jnp.asarray(x))
    net = DarkNet(plan, s2d_stem=s2d)
    for train in (False, True):
        net.train(train)
        with torch.no_grad():
            got = net(torch.from_numpy(x))
        assert [tuple(g.permute(0, 2, 3, 1).shape) for g in got] == [w.shape for w in want]
    head = DarkNet(plan, s2d_stem=s2d, include_head=True, n_classes=10).eval()
    with torch.no_grad():
        assert head(torch.from_numpy(x)).shape == (2, 10)


def _jax_pose_net(backbone, dtype="float32", **kw):
    cfg = jcfg.ModelConfig(backbone=backbone, input_res=RES, use_higher_levels=False,
                           compute_dtype=dtype, **kw)
    return cfg, JPoseNet(cfg=cfg, n_fg=N_FG)


@pytest.fixture(scope="module")
def variables():
    """Randomized flax variables of each PoseNet backbone, by name."""
    out = {}
    for i, bb in enumerate(("darknet_tiny", "darknet_tiny_h_wide", "darknet_tiny_h_s2d",
                            "darknet_tiny_h")):
        _, jnet = _jax_pose_net(bb)
        v = jax.jit(jnet.init)(jax.random.PRNGKey(i), jnp.zeros((1, RES, RES, 3)))
        out[bb] = _randomize(v, np.random.default_rng(i))
    return out


@pytest.mark.parametrize("backbone", ["darknet_tiny", "darknet_tiny_h_wide",
                                      "darknet_tiny_h_s2d"])
def test_variant_eval_outputs_match_flax(variables, backbone):
    """fp32 eval-mode flat outputs, weights carried across by
    from_jax_variables; the eval stem runs the K2 segment's plain version
    (the s2d one without its first pool)."""
    _, jnet = _jax_pose_net(backbone)
    v = variables[backbone]
    net = PoseNet(tcfg.ModelConfig(backbone=backbone, input_res=RES,
                                   use_higher_levels=False), n_fg=N_FG)
    net.load_state_dict(from_jax_variables(v), strict=True)
    images = np.random.default_rng(1).integers(0, 256, (2, RES, RES, 3), dtype=np.uint8)
    jc, jr = jax.jit(lambda vv, a: jnet.apply(vv, a, train=False))(v, jnp.asarray(images))
    with torch.no_grad():
        tc, tr = net.eval()(torch.from_numpy(images))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4, rtol=0)


def test_fold_batchnorm_matches_jax(variables):
    """The port's fold of a converted tree, of the JAX tree itself and of
    JAX's already folded {"params"} tree against JAX's fold, key by key."""
    v = variables["darknet_tiny_h"]
    want = from_jax_variables(j_fold(v))
    for got in (fold_batchnorm(from_jax_variables(v)), fold_batchnorm(v),
                fold_batchnorm(j_fold(v))):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6,
                                       atol=0, err_msg=k)
    assert not any(".bn." in k for k in want)


@pytest.mark.parametrize("backbone", ["darknet_tiny_h", "darknet53"])
def test_folded_eval_forward_equals_unfolded(backbone):
    """A PoseNet with random BN statistics, in eval mode, against the
    bn_folded PoseNet loaded with its fold (JAX tests/test_fold_bn.py:36);
    the folded form builds with conv biases and no BN."""
    cfg = tcfg.ModelConfig(backbone=backbone, input_res=RES, use_higher_levels=False)
    net = init_pose_net(PoseNet(cfg, n_fg=N_FG), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.3)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) * 1.5 + 0.5)
    folded = PoseNet(dataclasses.replace(cfg, bn_folded=True), n_fg=N_FG)
    folded.load_state_dict(fold_batchnorm(net), strict=True)
    x = torch.randn((2, RES, RES, 3), generator=g)
    with torch.no_grad():
        want, got = net.eval()(x), folded.eval()(x)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)
