"""The plain reference against the program at a small size on the CPU:
the networks on the same weights, and whole runs of each cell, whose check
compares the program's timed path with the reference."""
import pytest
import torch

import harness
from conftest import run_small, small_cell
from reference.config import Cfg
from reference.net import PoseNet as RefNet
from reference.net import fold_bn
from weights import make_state


@pytest.mark.parametrize("which,folded,train", [
    ("student", False, True), ("student", False, False), ("teacher", True, False)])
def test_network_matches_the_program(which, folded, train):
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
    from kd6d_pose_adlp_tpu_torch.utils.fold_bn import fold_batchnorm
    raw = small_cell("kd_train.tiny_h_d53.b16")["config_raw"]
    rcfg = Cfg(raw, which)
    g = torch.Generator().manual_seed(5)
    with torch.device("meta"):
        meta = RefNet(rcfg.model, rcfg.n_fg)
    state = make_state(meta, 0.5, g, "cpu")
    cfg = harness.port_config(raw, which)
    prog = PoseNet(cfg.model, n_fg=rcfg.n_fg)
    prog.load_state_dict(fold_batchnorm(state) if folded else state)
    ref = RefNet(rcfg.model, rcfg.n_fg, folded=folded)
    ref.load_state_dict(fold_bn(state) if folded else state)
    prog.train(train)
    ref.train(train)
    x = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8, generator=g)
    with torch.no_grad():
        for a, b in zip(prog(x), ref(x)):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("name", ["kd_train.tiny_h_d53.b16", "train.darknet53.b16",
                                  "serve.tiny_h.multi_b32"])
def test_a_small_run_is_correct(name):
    rc, result, err = run_small(name)
    assert rc == 0, err
    assert result["correct"], err
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == set(small_cell(name)["limits"])
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"]
