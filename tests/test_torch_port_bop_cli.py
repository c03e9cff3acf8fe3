"""PyTorch port, the BOP host pipeline under the training step and the
CLIs: one KD step on a BOP batch against the JAX package's
`engine/steps.build_train_step` (as JAX's tests/test_data_pipeline.py
drives its step from the on-disk pipeline), `train_kd.main --data bop` and
`evaluate.main --data bop` (with --test_file, and with --fast_pipeline) on
the CPU, on a tree the port's `make_bop_dataset` writes (three classes,
the procedural renderer's 640x480 PNG frames). It stands alone because it
compiles a JAX step; xdist runs it beside test_torch_port_bop.py.

The step: darknet_tiny_h student and teacher (head prior 0.5, so the
random teacher votes and the KD term is live), 64², B=2, no P6/P7, the
same BOP batch (uint8 crops, asserted equal), weights and SSC draw.
Tolerances as test_torch_port_train.py's first step: metrics rtol 5e-3,
num_pos equal; every parameter within 2 lr of JAX's, fewer than 0.5% of
elements off by more than 1e-6.
"""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.data import pipeline as jpipe
from kd6d_pose_adlp_tpu.engine import steps as jsteps
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch import evaluate, make_bop_dataset, train_kd
from kd6d_pose_adlp_tpu_torch.data import pipeline as tpipe
from kd6d_pose_adlp_tpu_torch.data.batch import TaskConsts
from kd6d_pose_adlp_tpu_torch.engine import steps as tsteps
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)

RES = 64
B = 2
ARTIFACTS = ("latest.ckpt", "final.ckpt", "cfg.json", "info.txt", "scalars.jsonl",
             "eval_scalars.jsonl", "preds.json")


def write_smoke_tree(root: str, n_train: int, n_test: int, n_fg: int) -> str:
    """Write a BOP tree with the port's make_bop_dataset under `root` and a
    config of its lists with smoke.yaml's model, solver and test sections
    (64², no P6/P7, B=2); returns that config's path."""
    tree_yaml = make_bop_dataset.write_dataset(root, n_train=n_train, n_test=n_test,
                                               n_fg=n_fg, single_class=None, seed=1)
    with open(tree_yaml) as f:
        head = f.read().split("SOLVER:")[0]
    yaml_path = os.path.join(root, "smoke_bop.yaml")
    with open(yaml_path, "w") as f:
        f.write(head + "MODEL:\n  BACKBONE: 'darknet_tiny_h'\n  INPUT_RES: 64\n"
                "  USE_HIGHER_LEVELS: False\nSOLVER:\n  IMS_PER_BATCH: 2\n  VAL_FREQ: 2\n"
                "TEST:\n  IMS_PER_BATCH: 2\n  CONFIDENCE_TH: 0.1\n")
    return yaml_path


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """(the tree's root, its smoke config)."""
    root = str(tmp_path_factory.mktemp("bop_cli"))
    return root, write_smoke_tree(root, n_train=4, n_test=2, n_fg=3)


def _cfgs(yaml_path):
    """(JAX student, JAX teacher, port student, port teacher) configs: the
    tree's data at test_torch_port_train.py's sizes."""
    out = []
    for m in (jcfg, tcfg):
        cfg = m.load_yaml_config(yaml_path)
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, ims_per_batch=B, max_iter=50,
                                                     max_pos=32),
                          kd=dataclasses.replace(cfg.kd, max_teacher_cells=16))
        out += [cfg, cfg.replace(model=dataclasses.replace(cfg.model, prior=0.5))]
    return out


def test_one_kd_step_on_a_bop_batch_matches_jax(tree):
    _, yaml_path = tree
    jcf, jcf_t, tcf, tcf_t = _cfgs(yaml_path)
    assert (tcf.model.input_res, tcf.data.n_fg, tcf.model.use_higher_levels) == (RES, 3, False)
    jds = jpipe.BOPPoseDataset(jcf, jcf.data.train_list, train=True)
    tds = tpipe.BOPPoseDataset(tcf, tcf.data.train_list, train=True)
    jb = jpipe.collate([jds.sample(i, seed=3) for i in range(B)])
    tb = tpipe.collate([tds.sample(i, seed=3) for i in range(B)])
    for f in jb._fields:
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                      err_msg=f)
    assert tb.images.dtype == torch.uint8
    jc = jds.consts()
    tc = TaskConsts.create(np.asarray(jc.K), np.asarray(jc.kp3d), np.asarray(jc.diameters),
                           device="cpu")
    np.testing.assert_array_equal(tds.consts(device="cpu").kp3d.numpy(), np.asarray(jc.kp3d))

    jnet, jteach = JPoseNet(cfg=jcf.model, n_fg=3), JPoseNet(cfg=jcf_t.model, n_fg=3)
    opt = jsteps.make_optimizer(jcf)
    jstate = jsteps.create_train_state(jax.random.PRNGKey(0), jcf, jnet, opt)
    tvars = jax.jit(jteach.init)(jax.random.PRNGKey(1), jnp.zeros((1, RES, RES, 3)))
    step = jax.jit(jsteps.build_train_step(jcf, jcf_t, jc, jnet, jteach, opt))
    net = PoseNet(tcf.model, n_fg=3)
    net.load_state_dict(from_jax_variables({"params": jstate.params,
                                            "batch_stats": jstate.batch_stats}))
    teacher = PoseNet(tcf_t.model, n_fg=3)
    teacher.load_state_dict(from_jax_variables(tvars))
    topt = tsteps.make_optimizer(tcf)
    tstate = tsteps.create_train_state(tcf, net, topt)
    tstep = tsteps.build_train_step(tcf, tcf_t, tc, net, teacher, topt)

    key = jax.random.PRNGKey(2)
    u = jax.random.uniform(key, (B, jcf.model.num_cells, jcf.solver.max_objs))
    jstate, jm = step(jstate, tvars, jb, key)
    tstate, tm = tstep(tstate, tb, uniform=torch.from_numpy(np.asarray(u)))
    assert float(tm["loss_kd"]) > 0
    assert int(tm["num_pos"]) == int(jm["num_pos"]) > 0
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=5e-3, err_msg=k)
    want = from_jax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got = net.state_dict()
    stat = ("num_batches_tracked", "running_mean", "running_var")
    d = torch.cat([(got[k] - w).abs().reshape(-1) for k, w in want.items()
                   if not k.endswith(stat)])
    lr = topt.lr_schedule(0)
    assert float(d.max()) <= 2 * lr * 1.001
    assert float((d > 1e-6).float().mean()) < 5e-3


def test_train_kd_and_evaluate_on_bop(tree, tmp_path, capsys):
    """train_kd.main --data bop at its defaults (bf16) but --cpu, 2 steps
    with a darknet_tiny_h teacher file (its BN folded), then evaluate.main
    --data bop on the run's final.ckpt, with --test_file and with
    --fast_pipeline."""
    root, yaml_path = tree
    _, _, tcf, tcf_t = _cfgs(yaml_path)
    from kd6d_pose_adlp_tpu_torch.models.pose_net import init_pose_net
    teacher = init_pose_net(PoseNet(tcf_t.model, n_fg=3), torch.Generator().manual_seed(1))
    torch.save(teacher.state_dict(), tmp_path / "teacher.pt")
    wd = tmp_path / "run"
    state, hist = train_kd.main(["--cpu", "--config_file", yaml_path, "--max_iters", "2",
                                 "--num_workers", "2", "--backbone_t", "darknet_tiny_h",
                                 "--weight_file_t", str(tmp_path / "teacher.pt"),
                                 "--working_dir", str(wd)])
    out = capsys.readouterr().out
    assert state.step == 2 and hist[-1]["step"] == 2
    assert np.isfinite(hist[-1]["loss_total"]) and hist[-1]["loss_kd"] > 0
    assert "teacher: BN folded into conv weights" in out
    assert out.count("[valid @ step") == 2          # the teacher at 0, the student at 2
    for name in ARTIFACTS:
        assert os.path.exists(wd / name), name
    with open(wd / "preds.json") as f:
        assert len(json.load(f)) == 2               # one entry per (image, object)
    # the loader's threads stopped when training ended
    assert not [t for t in threading.enumerate() if "(producer)" in t.name]

    n_tensors = len(PoseNet(tcf.model, n_fg=3).state_dict())
    for extra, n_items in ((["--test_file", os.path.join(root, "train_list.txt")], 4),
                           (["--fast_pipeline"], 2)):
        r = evaluate.main(["--cpu", "--config_file", yaml_path, "--weight_file",
                           str(wd / "final.ckpt"), "--ims_per_batch", "2",
                           "--working_dir", str(tmp_path / "eval"), *extra])
        out = capsys.readouterr().out
        assert f"loaded {n_tensors} tensors from" in out and r["table"] in out
        with open(tmp_path / "eval" / "preds.json") as f:
            preds = json.load(f)
        split = "train" if "--test_file" in extra else "test"
        assert sorted(preds) == [os.path.join(root, split, "000001", "rgb", f"{i:06d}.png#obj0")
                                 for i in range(n_items)]
