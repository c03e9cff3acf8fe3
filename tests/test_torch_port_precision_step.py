"""PyTorch port, one bfloat16 KD step (`kd6d_pose_adlp_tpu_torch/engine/
steps.py` with bf16 student and teacher) against
`kd6d_pose_adlp_tpu/engine/steps.build_train_step` in bf16, on the setup of
test_torch_port_train.py (darknet_tiny_h student and teacher, head prior
0.5, 64², B=2, no P6/P7, identical weights, batch and SSC draw).

Each metric is held to JAX's own bf16 error plus one bf16 rounding of the
metric: |port_bf16 - jax_bf16| <= 2 |jax_bf16 - jax_fp32| + 2^-7 |jax_fp32|;
num_pos equal. The network tests' yardstick (2x JAX's gap + 1e-3) takes
the max over a whole output map, a stable statistic; a scalar metric's
bf16 error is one draw, and JAX's own gap can be far below its noise: on
this setup cut to one tower conv a head, JAX's jitted and eager bf16 steps differ
by 0.028 on loss_total while the jitted step misses the fp32 step by
0.0012. Measured on this CPU: |port_bf16 - jax_bf16| is 2.2-4.2x JAX's
gap, 0.12-0.62% of the metric (grad_norm 169.38 vs 168.33, fp32 167.93).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kd6d_pose_adlp_tpu.data.synthetic import SyntheticPoseDataset as JSynth
from kd6d_pose_adlp_tpu.engine import steps as jsteps
from kd6d_pose_adlp_tpu.models.pose_net import PoseNet as JPoseNet
from kd6d_pose_adlp_tpu_torch.data.batch import TaskConsts
from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
from kd6d_pose_adlp_tpu_torch.engine import steps as tsteps
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_train import B, RES, _cfgs


def _bf16(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))


def test_one_bf16_kd_step_within_the_jax_yardstick():
    jcf, jcf_t, tcf, tcf_t = _cfgs()
    ds, tds = JSynth(input_res=RES, seed=11), SyntheticPoseDataset(input_res=RES, seed=11)
    jc = ds.consts()
    tc = TaskConsts.create(np.asarray(jc.K), np.asarray(jc.kp3d), np.asarray(jc.diameters),
                           device="cpu")
    jb, tb = ds.batch(range(B)), tds.batch(range(B))
    key = jax.random.PRNGKey(2)
    u = jax.random.uniform(key, (B, jcf.model.num_cells, jcf.solver.max_objs))

    jm, init, tvars = {}, None, None
    for dt, (c, c_t) in (("float32", (jcf, jcf_t)), ("bfloat16", (_bf16(jcf), _bf16(jcf_t)))):
        jnet, jteach = JPoseNet(cfg=c.model), JPoseNet(cfg=c_t.model)
        opt = jsteps.make_optimizer(c)
        jstate = jsteps.create_train_state(jax.random.PRNGKey(0), c, jnet, opt)
        if tvars is None:
            tvars = jax.jit(jteach.init)(jax.random.PRNGKey(1), jnp.zeros((1, RES, RES, 3)))
            init = from_jax_variables({"params": jstate.params,
                                       "batch_stats": jstate.batch_stats})
        step = jax.jit(jsteps.build_train_step(c, c_t, jc, jnet, jteach, opt))
        _, m = step(jstate, tvars, jb, key)
        jm[dt] = {k: float(v) for k, v in m.items()}

    tcf, tcf_t = _bf16(tcf), _bf16(tcf_t)
    net = PoseNet(tcf.model)
    net.load_state_dict(init, strict=True)
    teacher = PoseNet(tcf_t.model)
    teacher.load_state_dict(from_jax_variables(tvars), strict=True)
    topt = tsteps.make_optimizer(tcf)
    tstate = tsteps.create_train_state(tcf, net, topt)
    tstep = tsteps.build_train_step(tcf, tcf_t, tc, net, teacher, topt)
    _, tm = tstep(tstate, tb, uniform=torch.from_numpy(np.asarray(u)))
    tm = {k: float(v) for k, v in tm.items()}

    assert tm["loss_kd"] > 0 and tm["num_pos"] == jm["bfloat16"]["num_pos"] > 0
    for k, want in jm["bfloat16"].items():
        ref = jm["float32"][k]
        assert abs(tm[k] - want) <= 2 * abs(want - ref) + 2.0 ** -7 * abs(ref), (k, tm, jm)
