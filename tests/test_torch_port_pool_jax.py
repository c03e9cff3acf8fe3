"""PyTorch port, the cached-teacher multi-step (`kd6d_pose_adlp_tpu_torch/
engine/steps.build_multi_step(cached_votes=True)`) against the JAX
package's `build_multi_step(cached_votes=True)` on the CPU, from identical
weights, pool and cached votes, with JAX's SSC draws handed to the port
(JAX splits its key once per step inside the call, `steps.py:215`). The
set-up is test_torch_port_pool.py's; this file holds what compiles JAX's
scanned step (~55 s on one core), so that xdist runs it beside that file.

Tolerances, with the largest difference measured on this CPU beside them:
  4 steps over the 3-batch pool (wraps), metric    rtol 5e-3, num_pos exact, as
      means                                        test_torch_port_train.py's five
                                                   steps (max 3.4e-4, grad_norm)
  200 steps, 4-batch pool, 20 steps per call (slow, both tests below share the runs):
    the port's 20-step windows of loss_total and   within 5% relative of JAX's
      loss_kd                                      (loss_total 4.6%, loss_kd 9.0%:
                                                   a miss, ROADMAP Queue 3)
    the port's run level (mean of window / JAX's)  |Welch t| <= 3 against JAX's
      from 12 starts 1e-4 apart, against JAX's     (loss_total -1.6, loss_kd
      from 12 such starts                          -0.6). JAX's own runs from
                                                   those starts miss the 5% above
                                                   in 12 of 12 on loss_kd (6.0%
                                                   to 36.1%)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.data.synthetic import SyntheticPoseDataset as JSynth
from kd6d_pose_adlp_tpu.engine import steps as jsteps
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.data.batch import Batch
from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
from kd6d_pose_adlp_tpu_torch.engine import steps as tsteps
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
from test_torch_port_pool import (B, K, POOL, RES, _cfgs, _jax_vars,  # noqa: F401
                                  one_torch_thread, setup)             # (fixtures)


def _draws(jcf, rng, k):
    """JAX's per-step SSC draws of a k-step call from `rng`, and the key
    the call hands back."""
    out, key = [], rng
    for _ in range(k):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(
            sub, (B, jcf.model.num_cells, jcf.solver.max_objs))))
    return torch.from_numpy(np.stack(out)), key


def _jax_multi(jcf, jcf_t, jc, jstudent, jteacher, jpool, pool_size):
    """(multi_fn jitted with k static, initial state, the pool's cached votes)."""
    jnet = JPoseNet(cfg=jcf.model)
    opt = jsteps.make_optimizer(jcf)
    state0 = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=jstudent["params"],
                               batch_stats=jstudent["batch_stats"],
                               opt_state=opt.init(jstudent["params"]))
    cached = jsteps.precompute_pool_votes(jcf, jcf_t, JPoseNet(cfg=jcf_t.model), jteacher,
                                          jpool)
    fn = jax.jit(jsteps.build_multi_step(jcf, jcf_t, jc, jnet, None, opt, distill=True,
                                         pool_size=pool_size, cached_votes=True),
                 static_argnums=(5,))
    return fn, state0, cached


def _port_multi(tcf, tcf_t, tc, student, teacher, tpool, pool_size):
    net = PoseNet(tcf.model)
    net.load_state_dict(student.state_dict())
    opt = tsteps.make_optimizer(tcf)
    fn = tsteps.build_multi_step(tcf, tcf_t, tc, net, None, opt, distill=True,
                                 pool_size=pool_size, cached_votes=True)
    votes = tsteps.precompute_pool_votes(tcf, tcf_t, teacher, tpool)
    return fn, tsteps.create_train_state(tcf, net, opt), votes


def test_cached_multi_step_matches_jax(setup):
    s = setup
    jpool = jax.device_put(s["jpool"])
    jfn, jstate, jvotes = _jax_multi(s["jcf"], s["jcf_t"], s["jc"], s["jstudent"],
                                     s["jteacher"], jpool, POOL)
    tfn, tstate, tvotes = _port_multi(s["tcf"], s["tcf_t"], s["tc"], s["student"],
                                      s["teacher"], s["tpool"], POOL)
    rng = jax.random.PRNGKey(3)
    _, _, jm = jfn(jstate, jvotes, jpool, rng, jnp.zeros((), jnp.int32), K)
    uniforms, _ = _draws(s["jcf"], rng, K)
    tstate, tm = tfn(tstate, tvotes, s["tpool"], 0, K, uniforms=uniforms)
    assert tstate.step == K and tstate.opt_state.count == K
    assert float(tm["loss_kd"]) > 0
    assert int(tm["num_pos"]) == int(jm["num_pos"]) > 0
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=5e-3, err_msg=k)


N_DRAWS = 12          # perturbed starts per package in the float-spread yardstick
PERTURB = 1e-4        # their parameters scaled by 1 + PERTURB N(0, 1)
T_MAX = 3.0           # |Welch t| of the port's run level against JAX's


@pytest.fixture(scope="module")
def overlay(setup):
    """200 KD steps over a 4-batch pool with the cached teacher, 20 steps a
    call on both sides (JAX's multi-step returns only its call's means, so
    each call is one 20-step window), with JAX's draws. Returns
    - "windows": per key (loss_total, loss_kd), the 10 window means of JAX
      and of the port from the same weights, and of N_DRAWS runs of each
      package from starts whose parameters are scaled by 1 + PERTURB
      N(0, 1), one draw per run;
    - "param_gap": |params - JAX's| / |JAX's| after the first window, of
      the port and of JAX's perturbed runs."""
    s = setup
    n_pool, k, n_steps = 4, 20, 200
    jcf, jcf_t = _cfgs(jcfg)
    tcf, tcf_t = _cfgs(tcfg)
    jcf = jcf.replace(solver=dataclasses.replace(jcf.solver, max_iter=n_steps))
    tcf = tcf.replace(solver=dataclasses.replace(tcf.solver, max_iter=n_steps))
    jds, tds = JSynth(input_res=RES, seed=31), SyntheticPoseDataset(input_res=RES, seed=31)
    jpool = jax.device_put(jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[jds.batch(range(B * i, B * (i + 1))) for i in range(n_pool)]))
    tpool = Batch.stack([tds.batch(range(B * i, B * (i + 1))) for i in range(n_pool)])
    jfn, jstate0, jvotes = _jax_multi(jcf, jcf_t, jds.consts(), s["jstudent"], s["jteacher"],
                                      jpool, n_pool)
    keys = ("loss_total", "loss_kd")

    def flat(params):
        return np.concatenate([np.asarray(v, np.float64).ravel()
                               for v in jax.tree_util.tree_leaves(params)])

    def run_jax(state):
        rng, out = jax.random.PRNGKey(5), {key: [] for key in keys}
        for start in range(0, n_steps, k):
            state, rng, m = jfn(state, jvotes, jpool, rng,
                                jnp.asarray(start % n_pool, jnp.int32), k)
            for key in keys:
                out[key].append(float(m[key]))
            if start == 0:
                first = flat(state.params)
        return out, first

    def run_port(student):
        tfn, state, votes = _port_multi(tcf, tcf_t, tds.consts(device="cpu"), student,
                                        s["teacher"], tpool, n_pool)
        rng, out = jax.random.PRNGKey(5), {key: [] for key in keys}
        for start in range(0, n_steps, k):
            uniforms, rng = _draws(jcf, rng, k)
            state, m = tfn(state, votes, tpool, start % n_pool, k, uniforms=uniforms)
            for key in keys:
                out[key].append(float(m[key]))
            if start == 0:
                first = flat(_jax_vars(state.net)["params"])
        assert state.step == n_steps
        return out, first

    def scale(noise, a):
        return np.asarray(a) * (1 + PERTURB * noise.standard_normal(np.shape(a))
                                ).astype(np.float32)

    def port_start(seed):
        net = PoseNet(tcf.model)
        net.load_state_dict(s["student"].state_dict())
        noise = np.random.default_rng(seed)
        with torch.no_grad():
            for prm in net.parameters():
                prm.copy_(torch.from_numpy(scale(noise, prm.numpy())))
        return net

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)     # module scope runs before one_torch_thread
    try:
        runs = {"jax": run_jax(jstate0), "port": run_port(s["student"]),
                "jax_draws": [], "port_draws": []}
        for d in range(N_DRAWS):
            noise = np.random.default_rng(100 + d)
            runs["jax_draws"].append(run_jax(jstate0._replace(
                params=jax.tree_util.tree_map(lambda a: scale(noise, a), jstate0.params))))
            runs["port_draws"].append(run_port(port_start(200 + d)))
    finally:
        torch.set_num_threads(n_threads)
    ref = runs["jax"][1]
    gap = lambda first: float(np.linalg.norm(first - ref) / np.linalg.norm(ref))  # noqa: E731
    return {"windows": {key: {name: (np.asarray([r[0][key] for r in v])
                                     if name.endswith("draws") else np.asarray(v[0][key]))
                              for name, v in runs.items()} for key in keys},
            "param_gap": {"port": gap(runs["port"][1]),
                          "jax_draws": np.asarray([gap(r[1]) for r in runs["jax_draws"]])}}


@pytest.mark.slow
def test_two_hundred_cached_steps_overlay_jax(overlay):
    """The port's 20-step windows of loss_total and loss_kd within 5% of
    JAX's, run from the same weights and draws."""
    worst = {}
    for key, r in overlay["windows"].items():
        gaps = r["port"] / r["jax"] - 1
        print(f"port - JAX, {key}, relative, per 20-step window: "
              + " ".join(f"{g:+.4f}" for g in gaps))
        worst[key] = float(np.abs(gaps).max())
    assert all(r["jax"].min() > 0 for r in overlay["windows"].values())
    for key, w in worst.items():
        assert w <= 0.05, (key, w)


@pytest.mark.slow
def test_two_hundred_cached_steps_within_jax_float_spread(overlay):
    """Whether the port drifts from JAX beyond what float noise does to JAX
    itself. From a start 1e-7 apart, two runs of one package are already
    different trajectories after ~40 steps, so one port run against one JAX
    run cannot tell noise from drift. Instead each package runs from
    N_DRAWS starts scaled by 1 + PERTURB N(0, 1). The yardstick must
    outweigh the port's own difference from JAX: after the first window the
    median perturbed JAX run sits at least as far from JAX's parameters as
    the port does. Each run's level is the mean over the 10 windows of its
    window mean / JAX's. The two packages' levels must agree within |Welch
    t| <= T_MAX (two-sided p < 1% per key for 12 + 12 runs when they do not
    differ)."""
    pg = overlay["param_gap"]
    print(f"parameters after 20 steps, |. - JAX's| / |JAX's|: port {pg['port']:.3e}, "
          f"JAX from starts {PERTURB:g} apart {np.round(pg['jax_draws'], 5)}")
    assert np.median(pg["jax_draws"]) >= pg["port"], pg
    for key, r in overlay["windows"].items():
        lj = (r["jax_draws"] / r["jax"]).mean(1)
        lp = (r["port_draws"] / r["jax"]).mean(1)
        se = np.sqrt(lj.var(ddof=1) / len(lj) + lp.var(ddof=1) / len(lp))
        t = (lp.mean() - lj.mean()) / se
        worst_j = np.abs(r["jax_draws"] / r["jax"] - 1).max(1)
        print(f"{key}: run levels JAX {np.round(lj, 4)} port {np.round(lp, 4)}, "
              f"difference {lp.mean() - lj.mean():+.4f} (s.e. {se:.4f}, t {t:+.2f}); "
              f"JAX's own worst window against JAX, per draw: {np.round(worst_j, 4)}")
        assert abs(t) <= T_MAX, (key, t)
