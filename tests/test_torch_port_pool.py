"""PyTorch port, the device pool and the cached teacher (`kd6d_pose_adlp_tpu_
torch/engine/steps.precompute_pool_votes`, `build_multi_step`, `engine/loop.
train(pool=...)`) against `kd6d_pose_adlp_tpu/engine/steps.py`, on the CPU.

A darknet_tiny_h student and a darknet_tiny_h teacher (head prior 0.5, so
the random teacher's votes pass confidence_th and the KD term is live) at
64², B=2, no P6/P7, a 3-batch pool, from identical weights (the port's
seeded nets, carried to flax by the JAX package's `convert_pose_module`).
JAX's SSC draws (its multi-step splits its key once per step, `steps.py:215`)
are handed to the port as `uniforms` (test_torch_port_pool_jax.py, which
compiles JAX's multi-step, ~55 s on one core, in a file of its own).
Tolerances, with the largest difference measured on this CPU beside them:
  precompute_pool_votes vs JAX's: score, valid,  rtol 1e-5, atol 1e-5 (0)
      box_size
    kp2d (internal-frame px, up to ~600)        max|diff| <= 1e-5 max|kp2d|
                                                (1.2e-4 px of 6.6e-3; one entry
                                                of 1,536, at 10.6 px, misses an
                                                elementwise rtol 1e-5 + atol 1e-5
                                                by 2%)
  the pool's votes vs each batch's live votes   equal
  port live vs port cached multi_fn             metrics rtol 1e-4, parameters
                                                max|diff| < 5e-3, BN statistics
                                                rtol 1e-3 / atol 1e-4 (JAX's
                                                tests/test_cache_teacher.py)
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.data.synthetic import SyntheticPoseDataset as JSynth
from kd6d_pose_adlp_tpu.engine import steps as jsteps
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu.utils.torch_convert import convert_pose_module
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.data.batch import Batch
from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
from kd6d_pose_adlp_tpu_torch.engine import steps as tsteps
from kd6d_pose_adlp_tpu_torch.engine.loop import train
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
from kd6d_pose_adlp_tpu_torch.ops.voting import Votes

RES = 64
B = 2
POOL = 3
K = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs: xdist's workers share the CPU,
    and a thread per core in each of them oversubscribes it (a test that
    takes 1.5 s alone took 186 s beside five busy workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(m):
    cfg = m.Config(model=m.ModelConfig(input_res=RES, use_higher_levels=False),
                   solver=m.SolverConfig(ims_per_batch=B, max_iter=50, max_pos=32),
                   kd=m.KDConfig(max_teacher_cells=16))
    return cfg, cfg.replace(model=dataclasses.replace(cfg.model, prior=0.5))


def _jax_vars(net):
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    params, stats = convert_pose_module(sd)
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def setup():
    jcf, jcf_t = _cfgs(jcfg)
    tcf, tcf_t = _cfgs(tcfg)
    jds, tds = JSynth(input_res=RES, seed=21), SyntheticPoseDataset(input_res=RES, seed=21)
    jpool = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                                   *[jds.batch(range(B * i, B * (i + 1))) for i in range(POOL)])
    tpool = Batch.stack([tds.batch(range(B * i, B * (i + 1))) for i in range(POOL)])
    jc = jds.consts()
    student = init_pose_net(PoseNet(tcf.model), torch.Generator().manual_seed(0))
    teacher = init_pose_net(PoseNet(tcf_t.model), torch.Generator().manual_seed(1)).eval()
    return dict(jcf=jcf, jcf_t=jcf_t, tcf=tcf, tcf_t=tcf_t, jpool=jpool, tpool=tpool, jc=jc,
                tc=tds.consts(device="cpu"), student=student, teacher=teacher,
                jstudent=_jax_vars(student), jteacher=_jax_vars(teacher))


def test_batch_and_votes_stack_and_index(setup):
    pool = setup["tpool"]
    assert pool.images.shape == (POOL, B, RES, RES, 3)
    for i in range(POOL):
        one = pool.take(i)
        assert isinstance(one, Batch)
        for name in Batch._fields:
            assert torch.equal(getattr(one, name), getattr(pool, name)[i]), name
    v = Votes(*(torch.randn(B, 3) for _ in Votes._fields))
    vs = Votes.stack([v, v])
    assert vs.kp2d.shape == (2, B, 3) and torch.equal(vs.take(1).score, v.score)


def test_pool_votes_match_jax(setup):
    s = setup
    jteach = JPoseNet(cfg=s["jcf_t"].model)
    want = jsteps.precompute_pool_votes(s["jcf"], s["jcf_t"], jteach, s["jteacher"],
                                        jax.device_put(s["jpool"]))
    got = tsteps.precompute_pool_votes(s["tcf"], s["tcf_t"], s["teacher"], s["tpool"])
    assert bool(got.valid.any(-1).all())          # every image votes: KD is live
    for name in Votes._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "kp2d":
            # keypoints in internal-frame pixels (up to ~600): the networks'
            # fp32 difference (~2e-6 on the regression) times the decode
            # scale; rtol 1e-5 of the field's magnitude
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), np.abs(a - b).max()
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)
    # the pool's votes are each batch's live votes
    for i in range(POOL):
        live = tsteps.teacher_votes(s["tcf"], s["tcf_t"], s["teacher"], s["tpool"].take(i))
        for name in Votes._fields:
            assert torch.equal(getattr(live, name), getattr(got.take(i), name)), (i, name)


def _port_multi(s, cached: bool, uniforms):
    net = PoseNet(s["tcf"].model)
    net.load_state_dict(s["student"].state_dict())
    opt = tsteps.make_optimizer(s["tcf"])
    state = tsteps.create_train_state(s["tcf"], net, opt)
    fn = tsteps.build_multi_step(s["tcf"], s["tcf_t"], s["tc"], net,
                                 None if cached else s["teacher"], opt, distill=True,
                                 pool_size=POOL, cached_votes=cached)
    arg = (tsteps.precompute_pool_votes(s["tcf"], s["tcf_t"], s["teacher"], s["tpool"])
           if cached else None)
    state, m = fn(state, arg, s["tpool"], 0, K, uniforms=uniforms)
    return state, {k: float(v) for k, v in m.items()}


def test_live_and_cached_multi_steps_agree(setup):
    s = setup
    u = torch.rand((K, B, s["tcf"].model.num_cells, s["tcf"].solver.max_objs),
                   generator=torch.Generator().manual_seed(4))
    (st_live, m_live), (st_cache, m_cache) = _port_multi(s, False, u), _port_multi(s, True, u)
    assert m_live["loss_kd"] > 0
    for k in ("loss_total", "loss_cls", "loss_reg", "loss_kd"):
        np.testing.assert_allclose(m_cache[k], m_live[k], rtol=1e-4, err_msg=k)
    assert m_cache["num_pos"] == m_live["num_pos"]
    a, b = st_live.net.state_dict(), st_cache.net.state_dict()
    for k, v in a.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-4,
                                       err_msg=k)
        elif v.is_floating_point():
            assert float((b[k] - v).abs().max()) < 5e-3, k


def test_pool_loop_clips_calls_at_val_freq(setup, tmp_path):
    """val_freq 2 over 6 steps with 4 steps per call: calls of 2, 2, 2 and
    eval_fn at 2, 4, 6 (JAX tests/test_pool_scan.py:115, which also runs
    without a teacher); then 7 steps with val_freq 5 and 3 per call: 3, 2,
    2."""
    s = setup
    for max_iter, val_freq, spd, want in ((6, 2, 4, [2, 4, 6]), (7, 5, 3, [3, 5, 7])):
        cfg = s["tcf"].replace(solver=dataclasses.replace(
            s["tcf"].solver, max_iter=max_iter, val_freq=val_freq))
        calls = []
        state, hist = train(cfg, s["tc"], None, device="cpu", pool=s["tpool"],
                            steps_per_dispatch=spd,
                            eval_fn=lambda st, step: calls.append(step),
                            working_dir=str(tmp_path / f"vf{val_freq}"), verbose=False)
        assert state.step == max_iter
        assert [h["step"] for h in hist] == want
        assert calls == [st for st in want if st % val_freq == 0 or st == max_iter]


def test_pool_loop_matches_the_host_loop(setup, tmp_path):
    """The pool cycles like itertools.cycle over the same batches: with the
    same seed and draws, 5 pooled steps (3 per call, so a call wraps the
    pool) end where 5 host-loop steps do."""
    s = setup
    cfg = s["tcf"].replace(solver=dataclasses.replace(s["tcf"].solver, max_iter=5))
    kw = dict(cfg_t=s["tcf_t"], teacher_state_dict=s["teacher"].state_dict(), device="cpu",
              log_every=1, verbose=False, cache_teacher=True)
    host, _ = train(cfg, s["tc"], itertools.cycle([s["tpool"].take(i) for i in range(POOL)]),
                    working_dir=str(tmp_path / "host"), **kw)
    pooled, _ = train(cfg, s["tc"], None, pool=s["tpool"], steps_per_dispatch=3,
                      working_dir=str(tmp_path / "pool"), **kw)
    a, b = host.net.state_dict(), pooled.net.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_pool_loop_checks_steps_per_dispatch(setup, tmp_path):
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        train(setup["tcf"], setup["tc"], None, device="cpu", pool=setup["tpool"],
              steps_per_dispatch=0, working_dir=str(tmp_path))
