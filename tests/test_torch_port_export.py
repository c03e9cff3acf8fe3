"""PyTorch port, the exported serving artifact (`kd6d_pose_adlp_tpu_torch/
engine/serving.export_inference`, `load_serving`) and the `export_model`
entry point, on the CPU, as the JAX package's tests/test_serving.py holds
its StableHLO artifact: the loaded program reproduces the in-process
endpoint, from the file alone.

darknet_tiny_h at 64², no P6/P7, ransac_iters = max_votes = 16, lowered
confidence_th so that random weights vote. The program takes the RANSAC
draws as an input (`gumbel`); `serve(..., seed=s)` draws them as
`build_infer_fn(seed=s)` does.

Tolerances, with the largest difference measured on this CPU beside them:
  loaded program vs the eager endpoint        floats within 1e-6 (0: equal),
    (single, multi, frame, symbolic at B=1      ints and bools equal
    and 3, int8)
  loaded program on JAX's weights and draws   score atol 1e-5 (5.2e-8),
    vs JAX's build_infer_fn                     kp2d atol 1e-2 px (1.2e-4),
                                                masks and cls equal
Each export, save and load takes ~3-5 s here (the pose solve is one op of
the port, `kd6d::solve_pose`; see engine/postprocess.py), so none is
marked slow.
"""
import json
import os

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
from kd6d_pose_adlp_tpu_torch import export_model
from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
from kd6d_pose_adlp_tpu_torch.engine.postprocess import MULTI_KEYS
from kd6d_pose_adlp_tpu_torch.engine.serving import (SINGLE_KEYS, build_frame_infer_fn,
                                                     build_infer_fn, centered_bbox_trans,
                                                     export_inference, load_serving)
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
from kd6d_pose_adlp_tpu_torch.ops import conv_fused
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_serving import TEST, _jax_gumbel, _randomize_bn

RES, B = 64, 3
META_KEYS = {"mode", "frame_hw", "batch_size", "input_res", "n_fg", "backbone", "bytes",
             "output_keys", "device", "gumbel_shape"}


def _cfg(**model):
    return tcfg.Config(model=tcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES,
                                              use_higher_levels=False, **model),
                       test=tcfg.TestConfig(**TEST))


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    consts = SyntheticPoseDataset(n_fg=15, input_res=RES, seed=0).consts(device="cpu")
    net = init_pose_net(PoseNet(cfg.model, n_fg=15), torch.Generator().manual_seed(0),
                        prior=0.5).eval()
    return cfg, consts, net


@pytest.fixture(scope="module")
def artifact(setup, tmp_path_factory):
    """(path, meta) of one B=3 single-mode CPU artifact, exported once."""
    cfg, consts, net = setup
    path = str(tmp_path_factory.mktemp("serving") / "model.pt2")
    return path, export_inference(cfg, consts, net, path, batch_size=B, device="cpu")


def _request(n=B, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, RES, RES, 3), dtype=np.uint8),
            centered_bbox_trans(n, RES), np.array([0, 3, 7, 1][:n], np.int32))


def _assert_equal_outputs(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if want[k].is_floating_point():
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_export_roundtrip_single(setup, artifact, seed):
    """serve(seed=s) from the file equals build_infer_fn(seed=s); the
    artifact records K2 as a node and the CPU run launched no kernel."""
    cfg, consts, net = setup
    path, _ = artifact
    images, bt, ids = _request()
    want = build_infer_fn(cfg, consts, net, device="cpu")(images, bt, ids, seed=seed)
    serve, meta = load_serving(path, device="cpu")
    conv_fused.reset_launch_counts()
    got = serve(images, bt, ids, seed=seed)
    assert not conv_fused.launches
    _assert_equal_outputs(got, want)
    assert meta["input_res"] == RES
    assert want["vote_valid"].any(), "lower confidence_th: no vote cast"
    graph = str(torch.export.load(path).graph)
    assert graph.count("kd6d.conv3x3_bn_act_flat") == 2 and "kd6d.solve_pose" in graph


def test_metadata_keys(artifact):
    path, meta = artifact
    with open(path + ".json") as f:
        assert json.load(f) == meta
    assert set(meta) == META_KEYS
    assert meta["output_keys"] == list(SINGLE_KEYS) and meta["batch_size"] == B
    assert (meta["mode"], meta["device"], meta["backbone"]) == ("single", "cpu",
                                                                "darknet_tiny_h")
    assert meta["bytes"] == os.path.getsize(path) > 0
    assert meta["gumbel_shape"] == [TEST["ransac_iters"], TEST["max_votes"] * 8]
    with pytest.raises(ValueError, match="exported for cpu"):
        load_serving(path, device="cuda")


def test_serving_respects_invalid_class(artifact):
    path, _ = artifact
    serve, _ = load_serving(path, device="cpu")
    images, bt, _ = _request()
    out = serve(images, bt, np.array([0, -1, -5], np.int32), seed=0)
    np.testing.assert_array_equal(out["valid"].numpy(), [True, False, False])
    np.testing.assert_array_equal(out["cls"].numpy(), [0, 0, 0])


@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    """JAX's endpoint and the port's artifact of the same random-BN weights."""
    jc = jcfg.Config(model=jcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES),
                     test=jcfg.TestConfig(**TEST))
    jnet = JPoseNet(cfg=jc.model, n_fg=15)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)))
    variables = _randomize_bn(variables, np.random.default_rng(0))
    j_infer = jax.jit(j_build_infer_fn(jc, JSynth(n_fg=15, input_res=RES, seed=0).consts(),
                                       variables))
    tc = tcfg.Config(model=tcfg.ModelConfig(backbone="darknet_tiny_h", input_res=RES),
                     test=tcfg.TestConfig(**TEST))
    consts = SyntheticPoseDataset(n_fg=15, input_res=RES, seed=0).consts(device="cpu")
    path = str(tmp_path_factory.mktemp("jax_pair") / "model.pt2")
    export_inference(tc, consts, from_jax_variables(variables), path, batch_size=B,
                     device="cpu")
    return j_infer, path


def test_loaded_program_matches_jax(jax_pair):
    """The program read back from the file, fed JAX's RANSAC draws, against
    JAX's `build_infer_fn` on the same weights and crops: the held values
    of tests/test_torch_port_serving.py."""
    j_infer, path = jax_pair
    ds = SyntheticPoseDataset(n_fg=15, input_res=RES, seed=0)
    req = ds.requests(range(B))
    want = jax.device_get(j_infer(jnp.asarray(req["images"]), jnp.asarray(req["bbox_trans"]),
                                  jnp.asarray(req["class_ids"], jnp.int32),
                                  jnp.asarray(7, jnp.uint32)))
    program = torch.export.load(path).module()
    with torch.inference_mode():
        out = program(torch.from_numpy(req["images"]),
                      torch.as_tensor(req["bbox_trans"], dtype=torch.float32),
                      torch.as_tensor(req["class_ids"], dtype=torch.int32), _jax_gumbel(7))
    got = dict(zip(SINGLE_KEYS, out))
    vv = want["vote_valid"]
    assert vv.any(axis=1).all()
    for k in ("vote_valid", "valid", "cls"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["score"].numpy(), want["score"], atol=1e-5)
    np.testing.assert_allclose(got["kp2d"].numpy()[vv], want["kp2d"][vv], atol=1e-2)
    R = got["R"].numpy()
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-4)


def test_export_multi_mode(setup, tmp_path):
    cfg, consts, net = setup
    path = str(tmp_path / "multi.pt2")
    meta = export_inference(cfg, consts, net, path, batch_size=1, mode="multi", device="cpu")
    assert meta["output_keys"] == list(MULTI_KEYS)
    serve, _ = load_serving(path, device="cpu")
    images, bt, ids = _request(1)
    got = serve(images, bt, ids, seed=2)
    assert got["R"].shape == (1, 15, 3, 3) and got["valid"].shape == (1, 15)
    _assert_equal_outputs(got, build_infer_fn(cfg, consts, net, mode="multi",
                                              device="cpu")(images, bt, ids, seed=2))


def test_symbolic_batch_export(setup, tmp_path):
    """batch_size=0: one artifact (traced at B=2) serves B=1 and B=3, each
    equal to the eager endpoint (JAX tests/test_serving.py:144)."""
    cfg, consts, net = setup
    path = str(tmp_path / "sym.pt2")
    meta = export_inference(cfg, consts, net, path, batch_size=0, device="cpu")
    assert meta["batch_size"] == "symbolic"
    serve, _ = load_serving(path, device="cpu")
    direct = build_infer_fn(cfg, consts, net, device="cpu")
    for n in (1, 3):
        images, bt, ids = _request(n)
        got = serve(images, bt, ids, seed=5)
        assert got["R"].shape == (n, 3, 3)
        _assert_equal_outputs(got, direct(images, bt, ids, seed=5))


def test_frame_mode_export_roundtrip(setup, tmp_path):
    """The frame-mode artifact reproduces the in-process raw-frame endpoint."""
    cfg, consts, net = setup
    fh, fw = 120, 160
    path = str(tmp_path / "frame.pt2")
    meta = export_inference(cfg, consts, net, path, batch_size=2, mode="frame",
                            frame_hw=(fh, fw), device="cpu")
    assert meta["mode"] == "frame" and meta["frame_hw"] == [fh, fw]
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, fh, fw, 3), dtype=np.uint8)
    centers = np.array([[320.0, 240.0], [280.0, 300.0]], np.float32)
    scales = np.array([220.0, 180.0], np.float32)
    ids = np.array([0, 2], np.int32)
    serve, _ = load_serving(path, device="cpu")
    want = build_frame_infer_fn(cfg, consts, net, (fh, fw), device="cpu")(
        frames, centers, scales, ids, seed=9)
    _assert_equal_outputs(serve(frames, centers, scales, ids, seed=9), want)
    with pytest.raises(ValueError, match="frame_hw"):
        export_inference(cfg, consts, net, path, mode="frame", device="cpu")


def test_quant_export_roundtrip(setup, tmp_path):
    """The int8 artifact (export_model --fold_bn --quant) reproduces the
    in-process int8 network's endpoint; it holds no K2 node (the int8 stem
    is QConv units) and its int8 weights shrink it (measured 0.51x the
    folded float artifact's bytes here)."""
    import dataclasses

    from kd6d_pose_adlp_tpu_torch.utils.fold_bn import fold_batchnorm
    from kd6d_pose_adlp_tpu_torch.utils.quant import quantize_posenet

    cfg, consts, net = setup
    images, bt, ids = _request()
    cfg_f = cfg.replace(model=dataclasses.replace(cfg.model, bn_folded=True))
    folded = fold_batchnorm(net)
    net_q, _ = quantize_posenet(cfg_f.model, 15, folded, [torch.from_numpy(images)],
                                device="cpu")
    cfg_q = cfg_f.replace(model=dataclasses.replace(cfg_f.model, quant_mode="quant"))
    meta_f = export_inference(cfg_f, consts, folded, str(tmp_path / "f.pt2"), batch_size=B,
                              device="cpu")
    meta_q = export_inference(cfg_q, consts, net_q, str(tmp_path / "q.pt2"), batch_size=B,
                              device="cpu")
    assert meta_q["bytes"] < 0.6 * meta_f["bytes"], (meta_q["bytes"], meta_f["bytes"])
    assert "kd6d.conv3x3_bn_act_flat" not in str(torch.export.load(str(tmp_path / "q.pt2")).graph)
    serve, _ = load_serving(str(tmp_path / "q.pt2"), device="cpu")
    _assert_equal_outputs(serve(images, bt, ids, seed=3),
                          build_infer_fn(cfg_q, consts, net_q, device="cpu")(images, bt, ids,
                                                                              seed=3))


@pytest.fixture(scope="module")
def bop_yaml(tmp_path_factory):
    """The smoke config of a BOP tree of the 15 synthetic classes, 2 test
    images."""
    from test_torch_port_bop_cli import write_smoke_tree
    return write_smoke_tree(str(tmp_path_factory.mktemp("bop")), n_train=1, n_test=2, n_fg=15)


@pytest.mark.parametrize("extra", [[], ["--fold_bn", "--quant", "--quant_calib_batches", "1"],
                                   ["--batch_size", "0"]],
                         ids=["float", "int8", "symbolic"])
def test_export_model_cli_with_check(setup, bop_yaml, tmp_path, capsys, extra):
    """`export_model.main --cpu --check` (configs/smoke.yaml: 64², no P6/P7)
    on a torch.save'd state_dict: the
    artifact and its metadata written, the round trip against the eager
    endpoint passes; again with --data bop on a small BOP tree."""
    cfg, _, net = setup
    weights = tmp_path / "w.pt"
    torch.save(net.state_dict(), weights)
    out = tmp_path / "m.pt2"
    smoke = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "configs", "smoke.yaml")
    args = ["--cpu", "--config_file", smoke, "--weight_file", str(weights), "--input_res", str(RES),
            "--batch_size", "2", "--out", str(out), "--check", *extra]
    meta = export_model.main(args)
    text = capsys.readouterr().out
    assert f"loaded {len(net.state_dict())} tensors from" in text
    assert "round-trip check OK" in text and os.path.exists(str(out) + ".json")
    assert meta["backbone"] == "darknet_tiny_h" and meta["input_res"] == RES
    if "--quant" in extra:
        assert "int8-quantized (1 calib batches)" in text and "fold_bn: max output" in text
    if "--batch_size" in extra[:1]:
        assert meta["batch_size"] == "symbolic"
    # --data bop: the task constants and calibration batches of a BOP tree
    bop_args = [bop_yaml if a == smoke else a for a in args]
    meta_bop = export_model.main(bop_args + ["--data", "bop", "--out", str(tmp_path / "b.pt2")])
    text = capsys.readouterr().out
    assert "round-trip check OK" in text and meta_bop["n_fg"] == 15
    if "--quant" in extra:
        assert "int8-quantized (1 calib batches)" in text
    with pytest.raises(SystemExit, match="requires --fold_bn"):
        export_model.main([a for a in args if a != "--fold_bn"] + ["--quant"])
