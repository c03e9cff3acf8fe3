"""PyTorch port, the KD training step (`kd6d_pose_adlp_tpu_torch/engine/
schedule.py`, `engine/steps.py`, `engine/loop.py`) against
`kd6d_pose_adlp_tpu/engine/steps.build_train_step` and optax.

The 5-step test runs a darknet_tiny_h student and a darknet_tiny_h teacher
(head prior 0.5 on both sides, so the random teacher's votes pass
confidence_th and the KD term is live) at 64², B=2, no P6/P7, from
identical weights, batches and SSC draws (JAX's key per step). Tolerances,
with the largest difference measured on this CPU beside them:
  OneCycle LR                          bit-equal at every step
  clip + AdamW vs optax, 10 updates    rtol 1e-5, atol 1e-7 (max 3.7e-9)
  5 KD steps, per-step metrics         rtol 5e-3, num_pos exact (max 1.7e-3)
  after step 1, every parameter        within 2 lr of JAX, < 0.5% of elements
                                       off by more than 1e-6 (0.05%)
  after step 5, every parameter        within 2 * sum(lr) (max 1.85e-3 of 3.6e-3)
  after step 5, |port - JAX| / |JAX - start| over all parameters
                                       <= 0.15 (0.071)
  after step 5, BN statistics          max |diff| <= 5e-3 * max |stat| (1.9e-3)
Why elementwise tolerances are loose after the first step: Adam normalizes
every gradient element, so a near-zero gradient whose sign float noise
flips moves its parameter 2 lr the other way; and at blur 1e-3 the
Sinkhorn plan is near one-hot, so the KD gradient w.r.t. the keypoints is
stable in direction, not elementwise (see test_torch_port_sinkhorn.py).
The two runs' gradient norms stay within 1.7e-3 of each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.data.synthetic import SyntheticPoseDataset as JSynth
from kd6d_pose_adlp_tpu.engine import schedule as jsched
from kd6d_pose_adlp_tpu.engine import steps as jsteps
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.data.batch import Batch, TaskConsts
from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
from kd6d_pose_adlp_tpu_torch.engine import schedule as tsched
from kd6d_pose_adlp_tpu_torch.engine import steps as tsteps
from kd6d_pose_adlp_tpu_torch.engine.loop import train
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
from kd6d_pose_adlp_tpu_torch.parallel.mesh import make_mesh
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables

RES = 64
B = 2
N_STEPS = 5


@pytest.mark.parametrize("total", [7, 150, 10_100])
def test_onecycle_lr_is_bit_equal_at_every_step(total):
    j = jsched.onecycle_linear_lr(1e-3, total)
    t = tsched.onecycle_linear_lr(1e-3, total)
    jb, tb = jsched.onecycle_linear_beta1(total), tsched.onecycle_linear_beta1(total)
    steps = np.arange(total + 3)
    np.testing.assert_array_equal(np.float32([t(s) for s in steps]),
                                  np.asarray(jax.vmap(j)(steps)))
    np.testing.assert_array_equal(np.float32([tb(s) for s in steps]),
                                  np.asarray(jax.vmap(jb)(steps)))


def test_clip_and_adamw_match_optax():
    """Ten updates on a toy parameter set; gradient norms on both sides of
    the clip threshold."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    sched = jsched.onecycle_linear_lr(1e-2, 30)
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(learning_rate=sched, b1=0.9, b2=0.999, eps=1e-8,
                                  weight_decay=1e-4))
    jp = [jnp.asarray(p) for p in params]
    js = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    topt = tsteps.AdamW(tsched.onecycle_linear_lr(1e-2, 30), weight_decay=1e-4,
                        max_norm=1.0)
    ts = topt.init(tp)
    for i in range(10):
        scale = 0.05 if i % 3 == 0 else 3.0
        grads = [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]
        upd, js = opt.update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, upd)
        ts, gn = topt.update(tp, [torch.from_numpy(g) for g in grads], ts)
        np.testing.assert_allclose(float(gn), float(optax.global_norm(grads)), rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    assert ts.count == 10


def _cfgs():
    kw = dict(model=dict(input_res=RES, use_higher_levels=False),
              solver=dict(ims_per_batch=B, max_iter=50, max_pos=32),
              kd=dict(max_teacher_cells=16))
    out = []
    for m in (jcfg, tcfg):
        cfg = m.Config(model=m.ModelConfig(**kw["model"]),
                       solver=m.SolverConfig(**kw["solver"]), kd=m.KDConfig(**kw["kd"]))
        out += [cfg, cfg.replace(model=dataclasses.replace(cfg.model, prior=0.5))]
    return out


def _split(sd):
    """(parameters, BN running statistics) of a state_dict."""
    par = {k: v for k, v in sd.items()
           if not k.endswith(("num_batches_tracked", "running_mean", "running_var"))}
    st = {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
    return par, st


def test_five_kd_steps_match_jax():
    jcf, jcf_t, tcf, tcf_t = _cfgs()
    ds, tds = JSynth(input_res=RES, seed=11), SyntheticPoseDataset(input_res=RES, seed=11)
    jc = ds.consts()
    tc = TaskConsts.create(np.asarray(jc.K), np.asarray(jc.kp3d), np.asarray(jc.diameters),
                           device="cpu")

    jnet, jteach = JPoseNet(cfg=jcf.model), JPoseNet(cfg=jcf_t.model)
    opt = jsteps.make_optimizer(jcf)
    jstate = jsteps.create_train_state(jax.random.PRNGKey(0), jcf, jnet, opt)
    tvars = jax.jit(jteach.init)(jax.random.PRNGKey(1), jnp.zeros((1, RES, RES, 3)))
    step = jax.jit(jsteps.build_train_step(jcf, jcf_t, jc, jnet, jteach, opt))
    jsd = lambda st: from_jax_variables({"params": st.params,
                                         "batch_stats": st.batch_stats})

    init = jsd(jstate)
    net = PoseNet(tcf.model)
    net.load_state_dict(init)
    teacher = PoseNet(tcf_t.model)
    teacher.load_state_dict(from_jax_variables(tvars))
    topt = tsteps.make_optimizer(tcf)
    tstate = tsteps.create_train_state(tcf, net, topt)
    tstep = tsteps.build_train_step(tcf, tcf_t, tc, net, teacher, topt)
    lrs = [topt.lr_schedule(i) for i in range(N_STEPS)]

    key = jax.random.PRNGKey(2)
    for i in range(N_STEPS):
        jb = ds.batch(range(B * i, B * (i + 1)))
        tb = tds.batch(range(B * i, B * (i + 1)))
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, (B, jcf.model.num_cells, jcf.solver.max_objs))
        jstate, jm = step(jstate, tvars, jb, sub)
        tstate, tm = tstep(tstate, tb, uniform=torch.from_numpy(np.asarray(u)))
        assert float(tm["loss_kd"]) > 0, i
        assert int(tm["num_pos"]) == int(jm["num_pos"]) > 0, i
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=5e-3,
                                       err_msg=f"step {i} {k}")
        if i == 0:
            # Adam's first update is lr * g / (|g| + 1e-8) elementwise: equal
            # updates wherever the gradient signs agree, 2 lr apart where
            # float noise flips the sign of a near-zero gradient
            d = torch.cat([(net.state_dict()[k] - w).abs().reshape(-1)
                           for k, w in _split(jsd(jstate))[0].items()])
            assert float(d.max()) <= 2 * lrs[0] * 1.001
            assert float((d > 1e-6).float().mean()) < 5e-3
    assert tstate.step == N_STEPS and tstate.opt_state.count == N_STEPS

    (want, want_st), (got, got_st) = _split(jsd(jstate)), _split(net.state_dict())
    (start, _) = _split(init)
    d = torch.cat([(got[k] - want[k]).reshape(-1) for k in want])
    upd = torch.cat([(want[k] - start[k]).reshape(-1) for k in want])
    assert float(d.abs().max()) <= 2 * sum(lrs)
    assert float(d.norm() / upd.norm()) <= 0.15
    for k, w in want_st.items():
        assert float((got_st[k] - w).abs().max()) <= 5e-3 * float(w.abs().max()), k


def test_teacher_votes_are_live_at_prior_half():
    """With the default prior 0.01 no random-teacher score passes
    confidence_th = 0.1; at 0.5 every image has votes and the KD clouds are
    valid."""
    from kd6d_pose_adlp_tpu_torch.models.pose_net import init_pose_net
    _, _, tcf, tcf_t = _cfgs()
    tb = SyntheticPoseDataset(input_res=RES, seed=3).batch(range(B))
    for cfg_t, live in ((tcf, False), (tcf_t, True)):
        teacher = init_pose_net(PoseNet(cfg_t.model), torch.Generator().manual_seed(0))
        votes = tsteps.teacher_votes(tcf, cfg_t, teacher, tb)
        assert bool(votes.valid.any(-1).all()) is live


def _stream(ds, bs):
    i = 0
    while True:
        yield ds.batch(range(i, i + bs))
        i += bs


def test_loop_trains_three_steps_on_cpu(tmp_path):
    _, _, tcf, tcf_t = _cfgs()
    tcf = tcf.replace(solver=dataclasses.replace(tcf.solver, max_iter=3))
    ds = SyntheticPoseDataset(input_res=RES, seed=4)
    from kd6d_pose_adlp_tpu_torch.models.pose_net import init_pose_net
    teacher = init_pose_net(PoseNet(tcf_t.model), torch.Generator().manual_seed(1))
    state, hist = train(tcf, ds.consts(device="cpu"), _stream(ds, B), cfg_t=tcf_t,
                        teacher_state_dict=teacher.state_dict(), device="cpu",
                        log_every=1, verbose=False, working_dir=str(tmp_path / "a"))
    assert state.step == 3 and [h["step"] for h in hist] == [1, 2, 3]
    for h in hist:
        assert all(np.isfinite(v) for v in h.values()), h
        assert h["loss_kd"] > 0 and h["num_pos"] > 0 and h["images_per_sec"] > 0
    # the same seed gives the same run
    state2, hist2 = train(tcf, ds.consts(device="cpu"), _stream(ds, B), cfg_t=tcf_t,
                          teacher_state_dict=teacher.state_dict(), device="cpu",
                          log_every=3, verbose=False, working_dir=str(tmp_path / "b"))
    assert hist2[0]["loss_total"] == hist[-1]["loss_total"]


@pytest.mark.parametrize("option", ["pool", "mesh", "cache_teacher", "vis_every",
                                    "eval_fn", "resume"])
def test_loop_raises_on_unported_options(option, tmp_path):
    """No option of the loop raises as unported any more: pool,
    cache_teacher, resume, eval_fn, mesh (a one-rank data mesh here) and
    vis_every are accepted (test_torch_port_pool.py, test_torch_port_cli.py,
    test_torch_port_dist.py and test_torch_port_vis_jax.py hold what they
    do)."""
    _, _, tcf, _ = _cfgs()
    ds = SyntheticPoseDataset(input_res=RES)
    value = {"pool": Batch.stack([ds.batch(range(B)), ds.batch(range(B, 2 * B))]),
             "cache_teacher": True, "eval_fn": lambda *a: None, "resume": True,
             "mesh": make_mesh(device="cpu"), "vis_every": 5}[option]
    tcf = tcf.replace(solver=dataclasses.replace(tcf.solver, max_iter=0))
    state, hist = train(tcf, ds.consts(device="cpu"), iter(()), device="cpu",
                        working_dir=str(tmp_path), **{option: value})
    assert state.step == 0 and hist == []


def test_distill_off_skips_the_teacher():
    _, _, tcf, _ = _cfgs()
    tds = SyntheticPoseDataset(input_res=RES, seed=5)
    net = PoseNet(tcf.model)
    opt = tsteps.make_optimizer(tcf)
    state = tsteps.create_train_state(tcf, net, opt, generator=torch.Generator().manual_seed(0))
    step = tsteps.build_train_step(tcf, None, tds.consts(device="cpu"), net, None, opt,
                                   distill=False)
    state, m = step(state, tds.batch(range(B)), generator=torch.Generator().manual_seed(0))
    assert float(m["loss_kd"]) == 0.0 and np.isfinite(float(m["loss_total"]))
    assert isinstance(tds.batch(range(1)), Batch)


def test_train_step_runs_in_full_fp32_under_tf32_defaults(monkeypatch):
    """With both TF32 flags on (cuDNN's is on by PyTorch's default), the
    teacher's and the student's forward and the student's backward see
    both off, and both are on again after the step."""
    from kd6d_pose_adlp_tpu_torch.models.pose_net import init_pose_net
    _, _, tcf, tcf_t = _cfgs()
    tds = SyntheticPoseDataset(input_res=RES, seed=6)
    net = init_pose_net(PoseNet(tcf.model), torch.Generator().manual_seed(0))
    teacher = init_pose_net(PoseNet(tcf_t.model), torch.Generator().manual_seed(1))
    seen = []
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,  # noqa: E731
                     torch.backends.cudnn.allow_tf32)
    for name, m in (("teacher", teacher), ("student", net)):
        m.register_forward_pre_hook(lambda mod, args, name=name: seen.append((name, flags())))
    next(net.parameters()).register_hook(lambda g: seen.append(("backward", flags())))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    opt = tsteps.make_optimizer(tcf)
    state = tsteps.create_train_state(tcf, net, opt)
    step = tsteps.build_train_step(tcf, tcf_t, tds.consts(device="cpu"), net, teacher, opt)
    _, m = step(state, tds.batch(range(B)), generator=torch.Generator().manual_seed(0))
    assert float(m["loss_kd"]) > 0
    assert seen == [("teacher", (False, False)), ("student", (False, False)),
                    ("backward", (False, False))]
    assert flags() == (True, True)
