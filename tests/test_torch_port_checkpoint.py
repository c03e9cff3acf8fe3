"""PyTorch port, checkpoints (`kd6d_pose_adlp_tpu_torch/utils/msgpack_read.py`,
`utils/convert.read_jax_checkpoint`, `utils/checkpoint.py`) against the JAX
package's `utils/checkpoint.py` and flax's msgpack, on the CPU.

The JAX files are a darknet_tiny_h PoseNet at 64² (no P6/P7) whose BN
statistics and affines are randomized (flax's initial mean 0 / var 1 would
hide a swapped statistic), converted to flax's tree by the JAX package's
`utils/torch_convert.convert_pose_module` and written by its `save_params`
(final.ckpt) and `save_checkpoint` (latest.ckpt, a whole optax train
state). Tolerances:
  msgpack reader vs flax.serialization.msgpack_restore   every leaf bit-equal
                                                          (type, dtype, shape, bytes)
  JAX final.ckpt loaded loosely, eval-mode outputs        atol 1e-4, as
      vs the JAX PoseNet                                  test_torch_port_network.py
                                                          (max 2.4e-6 there)
  load_backbone_init                                      backbone.* bit-equal to the
                                                          file, every other tensor
                                                          untouched; count = JAX's
  save_checkpoint -> restore_checkpoint                   bit-exact: step, params, BN
                                                          statistics, count, mu, nu
  config_hash                                             equal to JAX's
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.engine import steps as jsteps
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu.utils import checkpoint as jckpt
from kd6d_pose_adlp_tpu.utils.torch_convert import convert_pose_module
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.data import loaders
from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
from kd6d_pose_adlp_tpu_torch.engine import steps as tsteps
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
from kd6d_pose_adlp_tpu_torch.utils import checkpoint as tckpt
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables, read_jax_checkpoint
from kd6d_pose_adlp_tpu_torch.utils.msgpack_read import read_msgpack
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)

RES = 64
B = 2
YAML = ("MODEL:\n  BACKBONE: 'darknet_tiny_h'\n  INPUT_RES: 64\n"
        "  USE_HIGHER_LEVELS: False\n")


def _cfg(m):
    return m.Config(model=m.ModelConfig(input_res=RES, use_higher_levels=False),
                    solver=m.SolverConfig(ims_per_batch=B, max_iter=20, max_pos=32))


def _random_variables(seed):
    """JAX {"params", "batch_stats"} of a seeded port PoseNet whose BN
    statistics and affines and all biases are randomized, through the JAX
    package's own converter (numpy only: no JAX init to compile)."""
    net = init_pose_net(PoseNet(_cfg(tcfg).model), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in net.state_dict().items():
        a = v.numpy()
        if k.endswith("running_mean"):
            a = rng.normal(0.0, 0.3, a.shape)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, a.shape)
        elif k.endswith("bn.weight"):
            a = rng.uniform(0.5, 1.5, a.shape)
        elif k.endswith("bias"):
            a = a + rng.normal(0.0, 0.1, a.shape)
        sd[k] = a if k.endswith("num_batches_tracked") else np.asarray(a, np.float32)
    params, stats = convert_pose_module(sd)
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """A JAX final.ckpt and latest.ckpt (a whole optax train state), the
    JAX config, network and variables."""
    d = tmp_path_factory.mktemp("jax")
    cfg = _cfg(jcfg)
    net = JPoseNet(cfg=cfg.model)
    variables = _random_variables(0)
    state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=jsteps.make_optimizer(cfg).init(variables["params"]))
    jckpt.save_params(str(d / "final.ckpt"), variables)
    jckpt.save_checkpoint(str(d / "latest.ckpt"), state, 7, cfg_hash="abc")
    return d, cfg, net, variables


def _assert_same_tree(got, want, path=""):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want, path


@pytest.mark.parametrize("name", ["final.ckpt", "latest.ckpt"])
def test_msgpack_reader_matches_flax(jax_files, name):
    d = jax_files[0]
    with open(d / name, "rb") as f:
        data = f.read()
    want = serialization.msgpack_restore(data)
    _assert_same_tree(read_msgpack(data), want)
    if name == "latest.ckpt":
        assert int(read_msgpack(data)["step"]) == 7


@pytest.mark.parametrize("value", [
    {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 + 5, -1, -32, -33,
              -129, -32769, -2**31 - 1, -2**62]},
    {"floats": [0.5, -1e300, float("inf")], "flags": [True, False, None]},
    {"s": "x" * 40, "long": "y" * 70_000, "b": b"\x00\x01" * 200, "nested": {"a": {}}},
    {f"k{i}": i for i in range(20)},
    {"list": list(range(20)), "big": list(range(70_000))},
])
def test_msgpack_reader_decodes_the_scalar_forms(value):
    np.testing.assert_equal(read_msgpack(msgpack.packb(value, use_bin_type=True)), value)


@pytest.mark.parametrize("arr", [np.arange(12, dtype=np.int64).reshape(3, 4),
                                 np.float16([1.5, -2]), np.bool_([True, False]),
                                 np.zeros((0, 3), np.float32), np.uint8(7), np.float64(0.25)])
def test_msgpack_reader_reads_flax_arrays_and_scalars(arr):
    data = serialization.msgpack_serialize({"a": arr})
    _assert_same_tree(read_msgpack(data), serialization.msgpack_restore(data))


def test_msgpack_reader_refuses_chunks_and_bfloat16(monkeypatch):
    data = serialization.msgpack_serialize({"w": jnp.ones((3,), jnp.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16.*float32"):
        read_msgpack(data)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    data = serialization.msgpack_serialize({"w": np.arange(40, dtype=np.float32)})
    with pytest.raises(ValueError, match="chunked.*1 GiB"):
        read_msgpack(data)


def test_jax_final_ckpt_loads_into_the_port(jax_files):
    d, cfg, jnet, variables = jax_files
    for name in ("final.ckpt", "latest.ckpt"):
        sd = read_jax_checkpoint(str(d / name))
        assert set(sd) == set(PoseNet(_cfg(tcfg).model).state_dict()), name
    net = init_pose_net(PoseNet(_cfg(tcfg).model), torch.Generator().manual_seed(5))
    n = tckpt.load_params_loose(str(d / "final.ckpt"), net)
    assert n == len(net.state_dict())
    images = np.random.default_rng(1).normal(size=(B, RES, RES, 3)).astype(np.float32)
    jc, jr = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(variables,
                                                                 jnp.asarray(images))
    with torch.no_grad():
        tc, tr = net.eval()(torch.from_numpy(images))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4, rtol=0)


def test_backbone_only_tree_converts():
    v = _random_variables(2)
    part = from_jax_variables({"params": {"backbone": v["params"]["backbone"]},
                               "batch_stats": {"backbone": v["batch_stats"]["backbone"]}})
    full = from_jax_variables(v)
    assert part and all(k.startswith("backbone.") for k in part)
    assert {k for k in full if k.startswith("backbone.")} == set(part)
    for k in part:
        assert torch.equal(part[k], full[k]), k
    no_stats = from_jax_variables({"params": {"fpn": v["params"]["fpn"]}})
    assert no_stats and all(k.startswith("fpn.") for k in no_stats)


@pytest.mark.parametrize("fmt", ["torch", "jax"])
def test_load_backbone_init_touches_only_the_backbone(jax_files, tmp_path, fmt):
    d, cfg, jnet, variables = jax_files
    if fmt == "jax":
        path, src = str(d / "final.ckpt"), from_jax_variables(variables)
        fresh = _random_variables(3)
        _, _, n_jax = jckpt.load_backbone_init(path, fresh["params"], fresh["batch_stats"])
    else:
        src = init_pose_net(PoseNet(_cfg(tcfg).model),
                            torch.Generator().manual_seed(1)).state_dict()
        src = {k: v + 0.5 if v.is_floating_point() else v for k, v in src.items()}
        path = str(tmp_path / "w.pt")
        tckpt.save_params(path, src)
        n_jax = None
    net = init_pose_net(PoseNet(_cfg(tcfg).model), torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    n = tckpt.load_backbone_init(path, net)
    after = net.state_dict()
    loaded = [k for k in after if k.startswith("backbone.")
              and not k.endswith("num_batches_tracked")]
    assert n == len(loaded) > 0
    if n_jax is not None:
        assert n == n_jax
    for k, v in after.items():
        want = src[k] if k in loaded else before[k]
        assert torch.equal(v, want), k


def _trained_state(seed):
    """A port TrainState after two steps (non-zero mu / nu, moved BN stats)."""
    cfg = _cfg(tcfg)
    ds = SyntheticPoseDataset(input_res=RES, seed=seed)
    net = PoseNet(cfg.model)
    opt = tsteps.make_optimizer(cfg)
    state = tsteps.create_train_state(cfg, net, opt,
                                      generator=torch.Generator().manual_seed(seed))
    step = tsteps.build_train_step(cfg, None, ds.consts(device="cpu"), net, None, opt,
                                   distill=False)
    gen = torch.Generator().manual_seed(seed)
    for i in range(2):
        state, _ = step(state, ds.batch(range(B * i, B * (i + 1))), generator=gen)
    return cfg, state


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    cfg, state = _trained_state(0)
    h = tckpt.config_hash(cfg)
    path = str(tmp_path / "latest.ckpt")
    tckpt.save_checkpoint(path, state, state.step, cfg_hash=h)
    assert not os.path.exists(path + ".tmp")

    _, template = _trained_state(1)        # other weights, statistics and moments
    want_sd = {k: v.clone() for k, v in state.net.state_dict().items()}
    assert any(not torch.equal(template.net.state_dict()[k], v) for k, v in want_sd.items())
    got, step = tckpt.restore_checkpoint(path, template, cfg_hash=h)
    assert step == got.step == state.step == 2
    assert got.opt_state.count == state.opt_state.count == 2
    got_sd = got.net.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert stats and any(float(want_sd[k].abs().sum()) > 0 for k in stats)
    for name in ("mu", "nu"):
        a, b = getattr(got.opt_state, name), getattr(state.opt_state, name)
        assert len(a) == len(b) and any(float(t.abs().sum()) > 0 for t in b)
        for x, y in zip(a, b):
            assert torch.equal(x, y), name
    # the restored parameters are the live module's (the optimizer steps them)
    assert [p.data_ptr() for p in got.net.parameters()] == \
        [p.data_ptr() for p in template.net.parameters()]


def test_config_hash_matches_jax_and_guards_resume(tmp_path):
    for kw in ({}, {"kd": dict(weight=0.0)}, {"model": dict(backbone="darknet53")}):
        pair = []
        for m in (jcfg, tcfg):
            cfg = m.Config()
            for field, over in kw.items():
                cfg = cfg.replace(**{field: dataclasses.replace(getattr(cfg, field), **over)})
            pair.append(cfg)
        assert tckpt.config_hash(pair[1]) == jckpt.config_hash(pair[0]), kw
    cfg, state = _trained_state(0)
    longer = cfg.replace(solver=dataclasses.replace(cfg.solver, max_iter=99, val_freq=3),
                         working_dir="elsewhere")
    assert tckpt.config_hash(longer) == tckpt.config_hash(cfg)
    path = str(tmp_path / "latest.ckpt")
    tckpt.save_checkpoint(path, state, 2, cfg_hash=tckpt.config_hash(cfg))
    other = cfg.replace(kd=dataclasses.replace(cfg.kd, blur=0.01))
    with pytest.raises(ValueError, match="different config"):
        tckpt.restore_checkpoint(path, state, cfg_hash=tckpt.config_hash(other))


def test_evaluate_and_train_kd_read_a_jax_final_ckpt(jax_files, tmp_path, capsys,
                                                      monkeypatch):
    """evaluate.main takes the JAX final.ckpt as --weight_file, train_kd.main
    as --weight_file_t (the teacher), each loading every tensor."""
    from kd6d_pose_adlp_tpu_torch import evaluate, train_kd
    d = jax_files[0]
    (tmp_path / "cfg.yaml").write_text(YAML)
    build = loaders.build
    # the first 2 images of the eval split: the CLIs' TestConfig solves 128
    # hypotheses over 512 points per image, seconds per chunk on a CPU
    monkeypatch.setattr(loaders, "build",
                        lambda cfg, kind, device: build(cfg, kind, eval_limit=2, device=device))
    n_all = len(PoseNet(_cfg(tcfg).model).state_dict())
    r = evaluate.main(["--config_file", str(tmp_path / "cfg.yaml"), "--weight_file",
                       str(d / "final.ckpt"), "--data", "synthetic", "--cpu",
                       "--ims_per_batch", "2", "--working_dir", str(tmp_path / "eval")])
    out = capsys.readouterr().out
    assert f"loaded {n_all} tensors from {d / 'final.ckpt'}" in out and r["table"] in out
    state, _ = train_kd.main(["--config_file", str(tmp_path / "cfg.yaml"), "--cpu",
                              "--data", "synthetic", "--max_iters", "1",
                              "--backbone_t", "darknet_tiny_h", "--weight_file_t",
                              str(d / "final.ckpt"), "--working_dir", str(tmp_path / "kd")])
    out = capsys.readouterr().out
    assert f"teacher: loaded {n_all} tensors from {d / 'final.ckpt'}" in out
    assert "--- evaluate teacher ---" in out and state.step == 1
