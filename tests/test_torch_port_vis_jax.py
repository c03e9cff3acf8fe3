"""PyTorch port, the cloud plots of training (`kd6d_pose_adlp_tpu_torch/
engine/steps.build_kd_debug`, `engine/loop.train(vis_every=...)`) against
the JAX package's `engine/steps.build_kd_debug` and `engine/loop.train`, on
the CPU.

test_torch_port_pool.py's set-up: a darknet_tiny_h student and a
darknet_tiny_h teacher (head prior 0.5, so the random teacher votes) at
64², B=2, no P6/P7, from identical weights (the port's seeded nets carried
to flax by `convert_pose_module`), with JAX's SSC draw
(`jax.random.uniform(rng, (B, A, G))`, as its `ssc_assign` draws it)
handed to the port. This file compiles JAX's debug function (~20 s on one
core), so it stands alone beside that file.

Tolerances:
  the clouds x, y (normalized internal frame)   max|diff| <= 1e-5 max|value|
                                                (precompute_pool_votes' bound)
  the weights a, b                              atol 1e-6
  img_valid                                     equal
The loop writes `vis/{step}_img_2d.png` after the steps JAX's loop plots
at: per step, step 1 and every multiple of vis_every (JAX `loop.py:232`):
1, 2, 4 of 5 at vis_every 2; pooled, 3 steps a call to 7 (calls ending at
3, 6, 7), after a call ending at `step` when step == k or step % vis_every
< k (`loop.py:187-188`): 3 (3 == k) and 6 (0 < 3), not 7 (1 < 1 fails).
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu.engine import steps as jsteps
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu_torch.data import png
from kd6d_pose_adlp_tpu_torch.engine import steps as tsteps
from kd6d_pose_adlp_tpu_torch.engine.loop import train
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
from kd6d_pose_adlp_tpu_torch.tools import visualizer
from test_torch_port_pool import B, one_torch_thread, setup  # noqa: F401 (fixtures)

FIELDS = ("x", "y", "a", "b", "img_valid")


def test_kd_debug_matches_jax(setup):
    s = setup
    jfn = jsteps.build_kd_debug(s["jcf"], s["jcf_t"], s["jc"], JPoseNet(cfg=s["jcf"].model),
                                JPoseNet(cfg=s["jcf_t"].model))
    jbatch = jax.tree_util.tree_map(lambda x: x[0], s["jpool"])
    rng = jax.random.PRNGKey(11)
    want = [np.asarray(v) for v in jfn(s["jstudent"], s["jteacher"], jbatch, rng)]
    uniform = torch.from_numpy(np.array(jax.random.uniform(
        rng, (B, s["jcf"].model.num_cells, s["jcf"].solver.max_objs))))

    net = PoseNet(s["tcf"].model)
    net.load_state_dict(s["student"].state_dict())
    net.train()
    fn = tsteps.build_kd_debug(s["tcf"], s["tcf_t"], s["tc"], net, s["teacher"])
    got = [v.numpy() for v in fn(s["tpool"].take(0), uniform=uniform)]
    assert net.training                      # the student is left as it was
    assert bool(want[4].all())               # both images have both clouds
    for name, g, w in zip(FIELDS, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name in ("x", "y"):
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), (name, np.abs(g - w).max())
        elif name == "img_valid":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("branch, kw, max_iter, want", [
    ("per_step", {}, 5, [1, 2, 4]),
    ("pooled", {"steps_per_dispatch": 3}, 7, [3, 6]),
])
def test_loop_plots_at_the_jax_steps(setup, tmp_path, branch, kw, max_iter, want):
    s = setup
    cfg = s["tcf"].replace(solver=dataclasses.replace(s["tcf"].solver, max_iter=max_iter))
    pool = s["tpool"]
    batches = [pool.take(i % pool.images.shape[0]) for i in range(max_iter)]

    def run(vis_every, wd):
        it, src = (None, dict(pool=pool, **kw)) if branch == "pooled" else (iter(batches), {})
        state, _ = train(cfg, s["tc"], it, cfg_t=s["tcf_t"], device="cpu",
                         teacher_state_dict=s["teacher"].state_dict(), working_dir=str(wd),
                         vis_every=vis_every, verbose=False, **src)
        return state

    state = run(2, tmp_path / "vis_on")
    names = sorted(os.listdir(tmp_path / "vis_on" / "vis"))
    assert names == sorted(f"{i}_img_2d.png" for i in want)
    for n in names:
        img = png.read(str(tmp_path / "vis_on" / "vis" / n))
        assert img.shape == visualizer.CLOUD_SIZE + (3,) and img.dtype == np.uint8
        # both clouds drawn: the blended student green and teacher red
        assert (img == (128, 192, 128)).all(-1).any() and (img == (128, 128, 255)).all(-1).any()
    if branch == "per_step":
        # the plots draw from a generator of their own: the run trains as
        # one without them
        off = run(0, tmp_path / "vis_off")
        assert not os.path.exists(tmp_path / "vis_off" / "vis")
        for k, v in off.net.state_dict().items():
            assert torch.equal(state.net.state_dict()[k], v), k

