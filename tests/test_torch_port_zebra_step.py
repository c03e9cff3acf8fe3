"""PyTorch port, the zebra train step, multi step and CLI (`kd6d_pose_adlp_
tpu_torch/engine/zebra.build_zebra_train_step`, `build_zebra_multi_step`,
`train_zebra.py`) against `kd6d_pose_adlp_tpu/engine/zebra.py` and
`scripts/train_zebra.py` on the CPU, at tests/test_zebra.py's `_cfg()`
(darknet_tiny_h, 128², code_bits 8, max_pos 16, B=2), from the same
weights (JAX's `create_train_state`, converted), batches and SSC draws
(JAX's key per step; its multi step splits its key once per step,
`zebra.py:231`). This file holds what compiles JAX's steps, so that xdist
runs it beside test_torch_port_zebra.py.

Tolerances (test_torch_port_train.py's KD-step bounds), with the largest
difference measured on this CPU beside them:
  3 steps, distill off / on (a tiny_h zebra teacher, tests/test_zebra.py:240):
    per-step metrics                        rtol 5e-3, num_pos exact
                                            (off 7.7e-5, on 7.7e-4)
    after step 1, every parameter           within 2 lr of JAX (7.85e-5 of
                                            8.0e-5: a sign flip), < 0.5% of
                                            elements off by more than 1e-6
                                            (0.097%, 0.097%)
    after step 3, every parameter           within 2 * sum(lr) (1.13e-3,
                                            1.08e-3 of 1.68e-3)
    after step 3, |port - JAX| / |JAX - start|  <= 0.15 (0.024, 0.024)
    after step 3, BN statistics             max |diff| <= 5e-3 max |stat|
                                            (2.3e-5, 1.0e-5)
  the port's multi step vs its single steps  bit-equal parameters, BN
                                            statistics and metrics
  the port's multi step vs JAX's, 3 steps over a 2-batch pool:
    metric means                            rtol 5e-3, num_pos exact (1.4e-4)
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.data.synthetic import SyntheticPoseDataset as JSynth
from kd6d_pose_adlp_tpu.engine import steps as jsteps
from kd6d_pose_adlp_tpu.engine import zebra as jz
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch import train_zebra
from kd6d_pose_adlp_tpu_torch.data.batch import Batch
from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
from kd6d_pose_adlp_tpu_torch.engine import steps as tsteps
from kd6d_pose_adlp_tpu_torch.engine import zebra as tz
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_train import _split
from test_torch_port_zebra import B, N_BITS, N_FG, RES, _cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 3
POOL = 2


@pytest.fixture(scope="module")
def setup():
    jcf, tcf = _cfg(jcfg), _cfg(tcfg)
    jds = JSynth(input_res=RES, single_class=0, seed=0)
    tds = SyntheticPoseDataset(input_res=RES, single_class=0, seed=0)
    rows = [range(B * i, B * (i + 1)) for i in range(N_STEPS)]
    jnet = JPoseNet(cfg=jcf.model, n_fg=N_FG)
    opt = jsteps.make_optimizer(jcf)
    # jsteps.create_train_state, with the init jitted (op by op it takes ~25 s)
    init = jax.jit(jnet.init)
    v = init(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)))
    jstate = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                               batch_stats=v["batch_stats"], opt_state=opt.init(v["params"]))
    t_vars = init(jax.random.PRNGKey(7), jnp.zeros((1, RES, RES, 3)))
    return dict(jcf=jcf, tcf=tcf, jnet=jnet, opt=opt, jstate=jstate, t_vars=t_vars,
                jb=[jds.batch(r, train=True) for r in rows],
                tb=[tds.batch(r, train=True) for r in rows],
                jc=jds.consts(code_bits=N_BITS),
                tc=tds.consts(device="cpu", code_bits=N_BITS))


def _sd(state):
    return from_jax_variables({"params": state.params, "batch_stats": state.batch_stats})


def _port(s, distill: bool):
    """(step_fn, state, net, optimizer) of the port from JAX's initial
    state, with the teacher when `distill`."""
    net = PoseNet(s["tcf"].model, n_fg=N_FG)
    net.load_state_dict(_sd(s["jstate"]), strict=True)
    teacher = None
    if distill:
        teacher = PoseNet(s["tcf"].model, n_fg=N_FG)
        teacher.load_state_dict(from_jax_variables(s["t_vars"]), strict=True)
    opt = tsteps.make_optimizer(s["tcf"])
    state = tsteps.create_train_state(s["tcf"], net, opt)
    step = tz.build_zebra_train_step(s["tcf"], s["tc"], net, teacher, opt, N_FG,
                                     distill=distill)
    return step, state, net, opt


def _uniform(s, key):
    return torch.from_numpy(np.array(jax.random.uniform(
        key, (B, s["jcf"].model.num_cells, s["jcf"].solver.max_objs))))


@pytest.mark.parametrize("distill", [False, True])
def test_zebra_steps_match_jax(setup, distill):
    s = setup
    jstep = jax.jit(jz.build_zebra_train_step(s["jcf"], s["jc"], s["jnet"],
                                              s["jnet"] if distill else None, s["opt"],
                                              N_FG, distill=distill))
    tstep, tstate, net, opt = _port(s, distill)
    init = _sd(s["jstate"])
    lrs = [opt.lr_schedule(i) for i in range(N_STEPS)]
    jstate, key = s["jstate"], jax.random.PRNGKey(1)
    for i in range(N_STEPS):
        key, sub = jax.random.split(key)
        jstate, jm = jstep(jstate, s["t_vars"] if distill else None, s["jb"][i], sub)
        tstate, tm = tstep(tstate, s["tb"][i], uniform=_uniform(s, sub))
        assert int(tm["num_pos"]) == int(jm["num_pos"]) > 0, i
        assert (float(tm["loss_kd"]) > 0) is distill, i
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=5e-3,
                                       err_msg=f"step {i} {k}")
        if i == 0:
            # gradients reach the code head
            g = net.head.code_pred.weight.grad
            assert g is not None and float(g.abs().max()) > 0
            d = torch.cat([(net.state_dict()[k] - w).abs().reshape(-1)
                           for k, w in _split(_sd(jstate))[0].items()])
            assert float(d.max()) <= 2 * lrs[0] * 1.001
            assert float((d > 1e-6).float().mean()) < 5e-3
    assert tstate.step == N_STEPS and tstate.opt_state.count == N_STEPS
    (want, want_st), (got, got_st) = _split(_sd(jstate)), _split(net.state_dict())
    start = _split(init)[0]
    assert not torch.equal(got["head.code_pred.weight"], start["head.code_pred.weight"])
    d = torch.cat([(got[k] - want[k]).reshape(-1) for k in want])
    upd = torch.cat([(want[k] - start[k]).reshape(-1) for k in want])
    assert float(d.abs().max()) <= 2 * sum(lrs)
    assert float(d.norm() / upd.norm()) <= 0.15
    for k, w in want_st.items():
        assert float((got_st[k] - w).abs().max()) <= 5e-3 * float(w.abs().max()), k


def test_multi_step_equals_single_steps_and_jax(setup):
    s = setup
    jpool = jax.tree_util.tree_map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                                   *s["jb"][:POOL])
    tpool = Batch.stack(s["tb"][:POOL])
    rng = jax.random.PRNGKey(5)
    jmulti = jax.jit(jz.build_zebra_multi_step(s["jcf"], s["jc"], s["jnet"], None, s["opt"],
                                               N_FG, pool_size=POOL), static_argnums=(5,))
    _, _, jm = jmulti(s["jstate"], None, jpool, rng, jnp.asarray(0, jnp.int32), N_STEPS)
    draws, key = [], rng
    for _ in range(N_STEPS):
        key, sub = jax.random.split(key)
        draws.append(_uniform(s, sub))
    uniforms = torch.stack(draws)

    _, state, net, opt = _port(s, False)
    multi = tz.build_zebra_multi_step(s["tcf"], s["tc"], net, None, opt, N_FG, pool_size=POOL)
    state, tm = multi(state, tpool, 0, N_STEPS, uniforms=uniforms)
    assert state.step == N_STEPS
    assert int(tm["num_pos"]) == int(jm["num_pos"]) > 0
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=5e-3, err_msg=k)

    step, state1, net1, _ = _port(s, False)
    per = []
    for i in range(N_STEPS):
        state1, m = step(state1, tpool.take(i % POOL), uniform=uniforms[i])
        per.append(m)
    for k, v in net1.state_dict().items():
        assert torch.equal(v, net.state_dict()[k]), k
    for k in tm:
        want = per[-1][k] if k == "num_pos" else torch.stack([m[k] for m in per]).mean()
        assert torch.equal(tm[k], want), k


def _run_cli(tmp_path, *extra):
    return train_zebra.main(["--cpu", "--steps", "4", "--batches", "2", "--batch_size", "2",
                             "--input_res", str(RES), "--eval_n", "4", "--code_bits",
                             str(N_BITS), "--working_dir", str(tmp_path), *extra])


def test_train_zebra_cli_on_cpu(tmp_path, capsys):
    """JAX's CPU smoke (scripts/train_zebra.py:16-17): final.ckpt holds the
    zebra student, and the eval's JSON line has JAX's keys."""
    out = _run_cli(tmp_path)
    lines = capsys.readouterr().out.splitlines()
    res = json.loads(next(ln for ln in lines if ln.startswith('{"ADD.10d"')))
    assert list(res) == ["ADD.10d", "ADD.20d", "REP05px", "REP10px", "mean_err3d_mm",
                         "n_valid", "n_eval"]
    assert res["n_eval"] == 4 and out["final"] == res and out["code_bits"] == N_BITS
    assert json.loads(lines[-1]) == out
    assert any(ln.startswith("step 4/4 ") for ln in lines)
    net = PoseNet(_cfg(tcfg).model, n_fg=N_FG)
    net.load_state_dict(torch.load(tmp_path / "final.ckpt", weights_only=True), strict=True)


def test_train_zebra_reads_jax_teacher_and_backbone_files(setup, tmp_path, capsys):
    """--weight_file_t and --backbone_init take a JAX msgpack checkpoint (a
    zebra tiny_h teacher here, every tensor loaded) and distill."""
    from kd6d_pose_adlp_tpu.utils.checkpoint import save_params
    path = str(tmp_path / "teacher.ckpt")
    save_params(path, setup["t_vars"])
    n_sd = len(from_jax_variables(setup["t_vars"]))
    _run_cli(tmp_path, "--weight_file_t", path, "--backbone_t", "darknet_tiny_h",
             "--kd_weight", "1", "--backbone_init", path)
    out = capsys.readouterr().out
    assert f"zebra teacher: loaded {n_sd} tensors" in out
    assert "student backbone warm-started:" in out
    step = next(ln for ln in out.splitlines() if ln.startswith("step 4/4 "))
    assert float(step.split(" kd ")[1].split()[0]) > 0


def test_train_zebra_parser_matches_jax():
    spec = importlib.util.spec_from_file_location(
        "jax_train_zebra", os.path.join(REPO, "scripts", "train_zebra.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    opts = lambda p: {a.dest: (tuple(a.option_strings), a.default, a.type)  # noqa: E731
                      for a in p._actions if a.dest != "help"}
    assert opts(train_zebra.build_parser()) == opts(mod.build_parser())


def test_train_zebra_needs_a_card_or_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        train_zebra.main(["--steps", "1", "--working_dir", str(tmp_path)])
    assert e.value.code not in (0, None)
    assert not os.listdir(tmp_path)


def test_parse_classes_as_jax():
    assert train_zebra.parse_classes("") is None
    assert train_zebra.parse_classes("2-5") == (2, 3, 4, 5)
    assert train_zebra.parse_classes("3,1,7") == (3, 1, 7)
