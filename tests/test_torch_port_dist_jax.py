"""PyTorch port, data parallelism against JAX's `Mesh('data')` step, on the
CPU: two gloo ranks of the port (`parallel/mesh.spawn`, one torch thread
each, test_torch_port_dist.py's workers) against
`kd6d_pose_adlp_tpu/engine/steps.build_train_step` jitted over
`make_mesh(2)` of the 8-device CPU mesh that tests/conftest.py sets up, on
the concatenation of the ranks' batches, both with `make_optimizer(cfg,
n_devices=2)`; and the loaders' shard streams against JAX's.

The step: a darknet_tiny_h student and a darknet_tiny_h teacher (head prior
0.5, so the KD term is live) at 64², no P6/P7, B=2 per rank, 4 in all,
from JAX's initial weights, JAX's SSC draws (the global `uniform` of each
step's key; each rank takes its rows). Three steps. Tolerances, those of
test_torch_port_train.py::test_five_kd_steps_match_jax, with the largest
difference measured on this CPU beside them:
  per-step metrics, grad_norm       rtol 5e-3, num_pos exact (max 1.9e-3)
  included
  after step 1, every parameter     within 2 lr, < 0.5% of elements off by
                                    more than 1e-6 (0.013%)
  after step 3, every parameter     within 2 * sum(lr) (max 3.0e-4 of 6.0e-4)
  after step 3, |port - JAX| / |JAX - start|
                                    <= 0.15 (0.035)
  after step 3, BN statistics       max |diff| <= 5e-3 * max |stat| (3.4e-5)
The first step is also traced layer by layer against the one-process
port's (test_two_rank_step_layer_by_layer_against_jax): the ranks' BatchNorm
statistics and first update sit as close to JAX's as one process does.
grad_norm is the norm of the gradient of the global loss, the sum of the
ranks' gradients (within 1.9e-3 of JAX's at every step): a gradient
averaged over the ranks (DDP's) would give half of JAX's, which the first
update, nearly scale-free under Adam, would hide.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu import config as jcfg
from kd6d_pose_adlp_tpu.data import loaders as jloaders
from kd6d_pose_adlp_tpu.data import pipeline as jpipe
from kd6d_pose_adlp_tpu.data.synthetic import SyntheticPoseDataset as JSynth
from kd6d_pose_adlp_tpu.engine import steps as jsteps
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.data import loaders as tloaders
from kd6d_pose_adlp_tpu_torch.data import pipeline as tpipe
from kd6d_pose_adlp_tpu_torch.engine import steps as tsteps
from kd6d_pose_adlp_tpu_torch.parallel import mesh as pmesh
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables
from test_torch_port_bop_cli import write_smoke_tree
from test_torch_port_dist import (B, N_STEPS, RES, W, assert_steps_close,  # noqa: F401
                                  one_torch_thread, port_cfgs, run_steps, step_inputs,
                                  step_worker)


def jax_cfgs():
    """port_cfgs' configs in the JAX package."""
    cfg = jcfg.Config(model=jcfg.ModelConfig(input_res=RES, use_higher_levels=False),
                      solver=jcfg.SolverConfig(ims_per_batch=B * W, max_iter=50, max_pos=32),
                      kd=jcfg.KDConfig(max_teacher_cells=16))
    return cfg, cfg.replace(model=dataclasses.replace(cfg.model, prior=0.5))


@pytest.fixture(scope="module")
def runs():
    """JAX's three mesh steps and the two port ranks' three steps from the
    same weights, batches and draws."""
    jcf, jcf_t = jax_cfgs()
    ds = JSynth(input_res=RES, seed=11)
    jc = ds.consts()
    jnet, jteach = JPoseNet(cfg=jcf.model), JPoseNet(cfg=jcf_t.model)
    opt = jsteps.make_optimizer(jcf, n_devices=W)
    jstate = jsteps.create_train_state(jax.random.PRNGKey(0), jcf, jnet, opt)
    tvars = jax.jit(jteach.init)(jax.random.PRNGKey(1), jnp.zeros((1, RES, RES, 3)))
    jsd = lambda st: from_jax_variables({"params": st.params,  # noqa: E731
                                         "batch_stats": st.batch_stats})
    init = jsd(jstate)
    inp = step_inputs(init, from_jax_variables(tvars),
                      (np.asarray(jc.K), np.asarray(jc.kp3d), np.asarray(jc.diameters)))

    mesh = make_mesh(W)
    step = jax.jit(jsteps.build_train_step(jcf, jcf_t, jc, jnet, jteach, opt))
    jstate, tvars = replicate(jstate, mesh), replicate(tvars, mesh)
    cfg, _ = port_cfgs()
    key, want, uniforms = jax.random.PRNGKey(2), [], []
    for i in range(N_STEPS):
        key, sub = jax.random.split(key)
        uniforms.append(torch.from_numpy(np.array(jax.random.uniform(
            sub, (B * W, cfg.model.num_cells, cfg.solver.max_objs)))))
        jb = ds.batch(range(B * W * i, B * W * (i + 1)))
        jstate, jm = step(jstate, tvars, shard_batch(jb, mesh), sub)
        want.append(({k: float(v) for k, v in jm.items()}, jsd(jstate)))
    inp["uniforms"] = uniforms
    ranks = pmesh.spawn(step_worker, W, args=(inp,), num_threads=1)
    return dict(want=want, ranks=ranks, init=init, one=run_steps(inp))


def test_two_rank_port_steps_match_the_jax_mesh_step(runs):
    """Every metric, grad_norm and num_pos included, the parameters and
    the BN statistics; both ranks hold the same state."""
    r0, r1 = runs["ranks"]
    for (m0, sd0), (m1, sd1) in zip(r0, r1):
        assert m0 == m1 and all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    opt = tsteps.make_optimizer(port_cfgs()[0], n_devices=W)
    assert_steps_close(r0, runs["want"], runs["init"],
                       [opt.lr_schedule(i) for i in range(N_STEPS)])


def test_grad_norm_is_the_global_sum_not_the_mean(runs):
    """The ranks' gradients are summed: grad_norm is JAX's, where
    averaging them would halve it."""
    for i, ((m, _), (jm, _)) in enumerate(zip(runs["ranks"][0], runs["want"])):
        ratio = m["grad_norm"] / jm["grad_norm"]
        assert abs(ratio - 1.0) < 5e-3, (i, ratio)
        assert jm["grad_norm"] > 1.0, i             # the clip is live at every step


@pytest.mark.parametrize("rank", [0, 1])
def test_synthetic_shard_streams_equal_jax(rank):
    """`train_iter(shard)` reads stream position step * count + rank and
    `eval_batches(shard)` the strided eval shard, image for image as
    JAX's."""
    jc = jcfg.Config(model=jcfg.ModelConfig(input_res=RES, use_higher_levels=False),
                     solver=jcfg.SolverConfig(ims_per_batch=B, max_objs=2),
                     test=jcfg.TestConfig(ims_per_batch=2))
    tc = tcfg.Config(model=tcfg.ModelConfig(input_res=RES, use_higher_levels=False),
                     solver=tcfg.SolverConfig(ims_per_batch=B, max_objs=2),
                     test=tcfg.TestConfig(ims_per_batch=2))
    jd = jloaders.build(jc, "synthetic", eval_limit=6)
    td = tloaders.build(tc, "synthetic", eval_limit=6, device="cpu")
    shard = (rank, W)
    for (tb, jb) in zip(list(zip(range(2), td.train_iter(shard=shard))),
                        list(zip(range(2), jd.train_iter(shard=shard)))):
        for a, b in zip(tb[1], jb[1]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got, want = list(td.eval_batches(shard=shard)), list(jd.eval_batches(shard=shard))
    assert len(got) == len(want) == 2                   # 3 images, the last chunk padded
    for (tb, tm), (jb, jm) in zip(got, want):
        assert [m["filename"] for m in tm] == [m["filename"] for m in jm]
        np.testing.assert_array_equal(tb.images.numpy(), np.asarray(jb.images))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_bop"))
    return write_smoke_tree(root, n_train=4, n_test=3, n_fg=3)


@pytest.mark.parametrize("rank", [0, 1])
def test_bop_shard_streams_equal_jax(tree, rank):
    """The BOP eval shard and the sharded PrefetchLoader epochs (the
    strided slices of one shared permutation) take JAX's items in JAX's
    order."""
    jc, tc = jcfg.load_yaml_config(tree), tcfg.load_yaml_config(tree)
    shard = (rank, W)
    jd = jloaders.build(jc, kind="bop")
    td = tloaders.build(tc, kind="bop", device="cpu")
    got, want = list(td.eval_batches(shard=shard)), list(jd.eval_batches(shard=shard))
    assert len(got) == len(want) > 0
    for (tb, tm), (jb, jm) in zip(got, want):
        assert [m["filename"] for m in tm] == [m["filename"] for m in jm]
        np.testing.assert_array_equal(tb.class_ids.numpy(), np.asarray(jb.class_ids))
    jds = jpipe.BOPPoseDataset(jc, jc.data.train_list, train=True)
    tds = tpipe.BOPPoseDataset(tc, tc.data.train_list, train=True)
    jit = iter(jpipe.PrefetchLoader(jds, 1, train=True, num_threads=1, seed=4, shard=shard))
    tit = iter(tpipe.PrefetchLoader(tds, 1, train=True, num_threads=1, seed=4, shard=shard))
    names = []
    for _ in range(3):                          # past the shard's first epoch of 2
        (tb, tm), (jb, jm) = next(tit), next(jit)
        assert [m["filename"] for m in tm] == [m["filename"] for m in jm]
        np.testing.assert_array_equal(tb.class_ids.numpy(), np.asarray(jb.class_ids))
        names += [m["filename"] for m in tm]
    tit.close()
    jit.close()
    assert len(set(names[:2])) == 2



def first_step_batch_stats(sd: dict, init: dict) -> dict:
    """Each BatchNorm's batch mean and biased variance of the first step's
    forward, from its running statistics after the step: running =
    0.9 * init + 0.1 * batch (flax's momentum, the port's 0.1)."""
    return {k: (sd[k] - 0.9 * init[k]) / 0.1 for k in sd
            if k.endswith(("running_mean", "running_var"))}


def test_two_rank_step_layer_by_layer_against_jax(runs):
    """The first step traced layer by layer, the 2 ranks and the one-process
    port each against JAX's mesh step. The forward: every BatchNorm's batch
    mean and variance (the ranks take flax's E[x^2] - E[x]^2 from summed
    float32 sums, one process ATen's statistics) within 2e-5 of the layer's
    largest entry (at most 6.3e-6 on this CPU, the ranks and one process
    alike), and the ranks' worst layer no further from JAX than twice the
    one process's worst. The backward: Adam's first update is lr * g / |g|,
    so the elements whose gradient sign rounding decides are those off by
    more than 1e-6; the ranks have no more of them than the one process
    has, plus a half (0.0128% against 0.0132% here)."""
    init = runs["init"]
    want = first_step_batch_stats(runs["want"][0][1], init)
    gap = {}
    for name, got in (("ranks", runs["ranks"][0]), ("one", runs["one"])):
        stats = first_step_batch_stats(got[0][1], init)
        gap[name] = {k: float((stats[k] - w).abs().max() / w.abs().max())
                     for k, w in want.items()}
        assert max(gap[name].values()) <= 2e-5, (name, gap[name])
    assert max(gap["ranks"].values()) <= 2 * max(gap["one"].values()), gap

    def flipped(sd):
        w = runs["want"][0][1]
        return torch.cat([((sd[k] - v).abs() > 1e-6).reshape(-1) for k, v in w.items()
                          if not k.endswith(("running_mean", "running_var",
                                             "num_batches_tracked"))]).float().mean()
    assert flipped(runs["ranks"][0][0][1]) <= 1.5 * flipped(runs["one"][0][1])
