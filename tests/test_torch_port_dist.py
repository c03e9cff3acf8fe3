"""PyTorch port, data parallelism (`kd6d_pose_adlp_tpu_torch/parallel/mesh.py`
and what runs under it: `models/blocks.BatchNorm2d`, `engine/losses.
kd_ot_loss`, `engine/steps`, `engine/loop.train(mesh=...)`, `data/loaders`,
`engine/evaluator.valid`, `engine/eval_scan.ScanEvaluator.run`, `train_kd
--n_devices` / `--distributed` in test_torch_port_dist_cli.py), on the
CPU: two gloo ranks spawned by the port's launcher (`parallel/mesh.spawn`),
one torch thread each. JAX's mesh step is held against the same ranks in
test_torch_port_dist_jax.py.

The step: a darknet_tiny_h student and a darknet_tiny_h teacher (head prior
0.5, so the KD term is live) at 64², no P6/P7, B=2 per rank and 4 in all,
the config of test_torch_port_train.py, SSC draws injected per rank as its
rows of the global `uniform`. Three steps of the 2-rank port against three
steps of the 1-process port on the concatenated batches, both with
`make_optimizer(cfg, n_devices=2)`. Tolerances, with the largest difference
measured on this CPU beside them:
  per-step metrics                rtol 5e-3, num_pos exact (max 6.8e-4)
  after step 1, every parameter   within 2 lr, < 0.5% of elements off by
                                  more than 1e-6 (2 lr where a near-zero
                                  gradient's sign flips; 0.07%)
  after step 3, every parameter   within 2 * sum(lr) (max 4.2e-4 of 6.0e-4)
  after step 3, |2-rank - 1-process| / |1-process - start|
                                  <= 0.15 (0.045)
  after step 3, BN statistics     max |diff| <= 5e-3 * max |stat| (8.8e-5)
  the two ranks' state dicts      bit-equal after every step
These are test_torch_port_dist_jax.py's bounds against JAX. The one
difference in arithmetic: the group's BatchNorm takes flax's fast variance
E[x^2] - E[x]^2 from all-reduced float32 sums, where one process takes
ATen's batch statistics; the 2-rank port is closer to JAX's mesh step than
to the 1-process port (the parameters 0.035 against 0.045 of the update,
the BN statistics 3.4e-5 against 8.8e-5).

The spawned workers live in this module (the spawn start method imports
them by module path) and import neither `jax` nor the JAX package.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.data import loaders
from kd6d_pose_adlp_tpu_torch.data.batch import Batch, TaskConsts
from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
from kd6d_pose_adlp_tpu_torch.engine import eval_scan, evaluator
from kd6d_pose_adlp_tpu_torch.engine import steps as tsteps
from kd6d_pose_adlp_tpu_torch.engine.loop import train
from kd6d_pose_adlp_tpu_torch.engine.postprocess import build_postprocess
from kd6d_pose_adlp_tpu_torch.engine.serving import network_fn
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
from kd6d_pose_adlp_tpu_torch.parallel import mesh as pmesh

RES, B, W, N_STEPS = 64, 2, 2, 3
EVAL_N, EVAL_B = 8, 2
TEST = dict(ims_per_batch=EVAL_B, max_votes=16, ransac_iters=16, lhm_iters=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs (the spawned ranks take one
    each): xdist's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfgs(max_iter: int = 50):
    """test_torch_port_train.py's student config and its teacher (head
    prior 0.5); SOLVER.IMS_PER_BATCH is the global batch."""
    cfg = tcfg.Config(model=tcfg.ModelConfig(input_res=RES, use_higher_levels=False),
                      solver=tcfg.SolverConfig(ims_per_batch=B * W, max_iter=max_iter,
                                               max_pos=32),
                      kd=tcfg.KDConfig(max_teacher_cells=16), test=tcfg.TestConfig(**TEST))
    return cfg, cfg.replace(model=dataclasses.replace(cfg.model, prior=0.5))


def step_inputs(student: dict, teacher: dict, consts, seed: int = 11) -> dict:
    """The steps' inputs, host tensors only: the weights, the task
    constants as numpy, N_STEPS global batches of B * W synthetic images
    and their SSC draws."""
    cfg, _ = port_cfgs()
    ds = SyntheticPoseDataset(input_res=RES, seed=seed)
    g = torch.Generator().manual_seed(seed)
    G = B * W
    return dict(student=student, teacher=teacher,
                consts=[np.asarray(c) for c in consts],
                batches=[ds.batch(range(G * i, G * (i + 1))) for i in range(N_STEPS)],
                uniforms=[torch.rand((G, cfg.model.num_cells, cfg.solver.max_objs),
                                     generator=g) for _ in range(N_STEPS)])


def run_steps(inp: dict, mesh=None, remat: bool = False, n_steps: int = N_STEPS) -> list:
    """`n_steps` KD steps from `inp` with make_optimizer(n_devices=W): on
    this rank's rows of each global batch under `mesh`, on the whole batch
    without one. [(metrics, state_dict)] a step."""
    cfg, cfg_t = port_cfgs()
    if remat:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, remat=True))
    consts = TaskConsts.create(*inp["consts"], device="cpu")
    net, teacher = PoseNet(cfg.model), PoseNet(cfg_t.model)
    net.load_state_dict(inp["student"])
    teacher.load_state_dict(inp["teacher"])
    opt = tsteps.make_optimizer(cfg, n_devices=W)
    state = tsteps.create_train_state(cfg, net, opt)
    step = tsteps.build_train_step(cfg, cfg_t, consts, net, teacher, opt, mesh=mesh)
    out = []
    for b, u in list(zip(inp["batches"], inp["uniforms"]))[:n_steps]:
        if mesh is not None:
            b, u = pmesh.shard_batch(b, mesh), pmesh.shard_batch(u, mesh)
        state, m = step(state, b, uniform=u)
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.clone() for k, v in net.state_dict().items()}))
    return out


def step_worker(inp: dict) -> list:
    """A rank's three global steps (spawned by `pmesh.spawn`)."""
    mesh = pmesh.init_from_env(cpu=True)
    try:
        return run_steps(inp, mesh)
    finally:
        torch.distributed.destroy_process_group()


def _loop_runs(mesh, inp: dict, wd: str) -> dict:
    """loop.train under `mesh` for N_STEPS from its own seeded init: the host
    loop, the pool and the pool with the cached teacher; each rank feeds its
    rows of the global batches. The final state_dict of each, and what
    was written."""
    cfg, cfg_t = port_cfgs(max_iter=N_STEPS)
    consts = TaskConsts.create(*inp["consts"], device="cpu")
    mine = [pmesh.shard_batch(b, mesh) for b in inp["batches"]]
    out = {}
    for name, kw in (("host", dict(train_iter=iter(mine))),
                     ("pool", dict(train_iter=None, pool=Batch.stack(mine),
                                   steps_per_dispatch=2)),
                     ("cached", dict(train_iter=None, pool=Batch.stack(mine),
                                     steps_per_dispatch=2, cache_teacher=True))):
        d = os.path.join(wd, name)
        state, hist = train(cfg, consts, cfg_t=cfg_t, teacher_state_dict=inp["teacher"],
                            device="cpu", log_every=1, working_dir=d, verbose=False,
                            mesh=mesh, **kw)
        out[name] = dict(sd=state.net.state_dict(), hist=hist, step=state.step,
                         files=sorted(os.listdir(d)))
    return out


def eval_inputs(seed: int = 5) -> dict:
    """A random tiny_h (head prior 0.5, so cells vote) and per-image RANSAC
    draws for the EVAL_N synthetic eval images."""
    cfg, cfg_t = port_cfgs()
    net = init_pose_net(PoseNet(cfg_t.model), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((EVAL_N, TEST["ransac_iters"], TEST["max_votes"] * 8), generator=g)
    return dict(net=net.state_dict(), gumbel=-torch.log(-torch.log(u.clamp(1e-7, 1 - 1e-7))))


def run_eval(inp: dict, wd: str, rank: int = 0, size: int = 1) -> dict:
    """valid and ScanEvaluator.run over this process's shard of the
    synthetic eval split (the group's shard under a group), each image with
    its own draws."""
    cfg, cfg_t = port_cfgs()
    data = loaders.build(cfg, "synthetic", eval_limit=EVAL_N, device="cpu")
    cfg = data.cfg
    net = PoseNet(cfg_t.model)
    net.load_state_dict(inp["net"])
    net.eval()
    mine = list(range(EVAL_N))[rank::size]

    def gumbel_fn(i):
        return inp["gumbel"][mine[i * EVAL_B:(i + 1) * EVAL_B]]

    v = evaluator.valid(cfg, data.consts, network_fn(net), build_postprocess(cfg, data.consts),
                        data.eval_batches(), data.meshes, working_dir=os.path.join(wd, "valid"),
                        gumbel_fn=gumbel_fn, verbose=False)
    s = eval_scan.ScanEvaluator(cfg, data.consts, net, data.meshes).prepare(
        data.eval_batches()).run(working_dir=os.path.join(wd, "scan"), gumbel_fn=gumbel_fn,
                                 verbose=False)
    return {k: dict(table=r["table"], preds=r["predictions"],
                    files=sorted(os.listdir(os.path.join(wd, k)))
                    if os.path.isdir(os.path.join(wd, k)) else [])
            for k, r in (("valid", v), ("scan", s))}


def without_tensorboard() -> None:
    """In a spawned rank: `utils/logging_utils.ScalarLogger` skips its
    optional TensorBoard writer, whose import takes ~14 s in a fresh
    process on a CPU; the scalars still go to scalars.jsonl."""
    sys.modules["torch.utils.tensorboard"] = None


def group_worker(inp: dict, ev: dict, root: str) -> dict:
    """Everything else one 2-rank group runs: the steps, one remat step, the
    loop three ways, the gathers, the shard read from the group, and both
    evaluators (each rank writes to its own directory under `root`)."""
    without_tensorboard()
    mesh = pmesh.init_from_env(cpu=True)
    try:
        rank = mesh.rank
        wd = os.path.join(root, f"rank{rank}")
        return dict(
            steps=run_steps(inp, mesh),
            remat=run_steps(inp, mesh, remat=True, n_steps=1),
            loop=_loop_runs(mesh, inp, os.path.join(root, "loop")),
            objects=pmesh.gather_host_objects({"rank": rank, "data": list(range(37 * rank))}),
            tree=pmesh.gather_eval_pytree({"a": torch.full((3, 2), float(rank)),
                                           "b": (np.arange(4) + 10 * rank,),
                                           "ok": torch.tensor([rank == 1, True])}),
            shard=loaders._process_shard(None),
            eval=run_eval(ev, wd, rank, mesh.size))
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """One spawned 2-rank group for the module's tests, with its inputs and
    the 1-process runs it is held against."""
    cfg, cfg_t = port_cfgs()
    ds = SyntheticPoseDataset(input_res=RES, seed=11)
    student = init_pose_net(PoseNet(cfg.model), torch.Generator().manual_seed(0)).state_dict()
    teacher = init_pose_net(PoseNet(cfg_t.model), torch.Generator().manual_seed(1)).state_dict()
    c = ds.consts(device="cpu")
    inp = step_inputs(student, teacher, (c.K, c.kp3d, c.diameters))
    ev = eval_inputs()
    root = str(tmp_path_factory.mktemp("dist"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = pmesh.spawn(group_worker, W, args=(inp, ev, root), num_threads=1)
        one = run_steps(inp)
        one_eval = run_eval(ev, os.path.join(root, "one"))
    finally:
        torch.set_num_threads(n)
    return dict(inp=inp, ranks=ranks, one=one, one_eval=one_eval, root=root)


def assert_steps_close(got: list, want: list, start: dict, lrs: list):
    """test_five_kd_steps_match_jax's bounds: metrics rtol 5e-3 and num_pos
    exact at every step; parameters after the first and the last step; BN
    statistics after the last."""
    def split(sd):
        par = {k: v for k, v in sd.items()
               if not k.endswith(("num_batches_tracked", "running_mean", "running_var"))}
        return par, {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}

    for i, ((gm, gsd), (wm, wsd)) in enumerate(zip(got, want)):
        assert gm["loss_kd"] > 0 and int(gm["num_pos"]) == int(wm["num_pos"]) > 0, i
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], rtol=5e-3, err_msg=f"step {i} {k}")
        if i == 0:
            d = torch.cat([(gsd[k] - w).abs().reshape(-1) for k, w in split(wsd)[0].items()])
            assert float(d.max()) <= 2 * lrs[0] * 1.001
            assert float((d > 1e-6).float().mean()) < 5e-3
    (g, g_st), (w, w_st) = split(got[-1][1]), split(want[-1][1])
    s = split(start)[0]
    d = torch.cat([(g[k] - w[k]).reshape(-1) for k in w])
    upd = torch.cat([(w[k] - s[k]).reshape(-1) for k in w])
    assert float(d.abs().max()) <= 2 * sum(lrs)
    assert float(d.norm() / upd.norm()) <= 0.15
    for k, v in w_st.items():
        assert float((g_st[k] - v).abs().max()) <= 5e-3 * float(v.abs().max()), k


def test_two_ranks_take_the_one_process_step(group):
    """3 steps of 2 ranks = 3 steps of one process on the concatenated
    batches, both with the LR divided by 2; the ranks bit-equal each step."""
    r0, r1 = group["ranks"][0]["steps"], group["ranks"][1]["steps"]
    for i, ((m0, sd0), (m1, sd1)) in enumerate(zip(r0, r1)):
        assert m0 == m1, i
        assert all(torch.equal(sd0[k], sd1[k]) for k in sd0), i
    opt = tsteps.make_optimizer(port_cfgs()[0], n_devices=W)
    lrs = [opt.lr_schedule(i) for i in range(N_STEPS)]
    assert_steps_close(r0, group["one"], group["inp"]["student"], lrs)


def test_remat_step_is_bit_equal_under_the_group(group):
    """The rematerialized step issues the same collectives and gives the
    plain step's state bit for bit."""
    for r in group["ranks"]:
        (m, sd), (pm, psd) = r["remat"][0], r["steps"][0]
        assert m == pm
        assert all(torch.equal(sd[k], psd[k]) for k in psd)


def test_pooled_and_cached_runs_equal_the_host_loop(group):
    """Loop.train under the group: the pool (2 steps a call) and the
    pool with the cached teacher give the host loop's state bit for bit;
    rank 0 alone wrote, once a step."""
    for r in group["ranks"]:
        runs = r["loop"]
        for name in ("pool", "cached"):
            assert runs[name]["step"] == N_STEPS
            assert all(torch.equal(runs[name]["sd"][k], v) for k, v in runs["host"]["sd"].items())
        assert [h["step"] for h in runs["host"]["hist"]] == [1, 2, 3]
    r0, r1 = (r["loop"] for r in group["ranks"])
    assert all(torch.equal(r0["host"]["sd"][k], v) for k, v in r1["host"]["sd"].items())
    assert r0["host"]["hist"][-1]["loss_total"] == r1["host"]["hist"][-1]["loss_total"]
    for name, steps in (("host", [1, 2, 3]), ("pool", [2, 3]), ("cached", [2, 3])):
        assert {"cfg.json", "final.ckpt", "info.txt", "latest.ckpt",
                "scalars.jsonl"} <= set(r0[name]["files"]), name
        with open(os.path.join(group["root"], "loop", name, "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        assert [r["step"] for r in rows] == steps, name   # one writer


def test_gathers_round_trip_and_the_shard_comes_from_the_group(group):
    """Gather_host_objects returns every rank's ragged object by rank;
    gather_eval_pytree stacks each leaf over the ranks; both are the
    identity on one process. The loaders read (rank, 2) from the group."""
    for rank, r in enumerate(group["ranks"]):
        assert r["objects"] == [{"rank": q, "data": list(range(37 * q))} for q in range(W)]
        t = r["tree"]
        assert torch.equal(t["a"], torch.stack([torch.full((3, 2), float(q)) for q in range(W)]))
        np.testing.assert_array_equal(t["b"][0], np.stack([np.arange(4) + 10 * q
                                                           for q in range(W)]))
        assert t["ok"].dtype == torch.bool and t["ok"].tolist() == [[False, True], [True, True]]
        assert r["shard"] == (rank, W)
    tree = {"a": torch.ones(3)}
    assert pmesh.gather_eval_pytree(tree) is tree
    assert pmesh.gather_host_objects([1, "x"]) == [[1, "x"]]
    assert loaders._process_shard(None) is None


@pytest.mark.parametrize("kind", ["valid", "scan"])
def test_sharded_evaluation_merges_to_the_one_process_result(group, kind):
    """Each rank evaluates its half of the eval split; the merged
    predictions equal one process's, entry for entry, and so does the
    table; rank 0 alone writes preds.json and the per-depth PNG."""
    want = group["one_eval"][kind]
    assert len(want["preds"]) == EVAL_N
    assert any(e["pred"] for e in want["preds"].values())
    for r in group["ranks"]:
        got = r["eval"][kind]
        assert got["preds"] == want["preds"]
        assert got["table"] == want["table"]
    assert group["ranks"][0]["eval"][kind]["files"] == ["accuracy_per_depth_000000.png",
                                                        "preds.json"]
    assert group["ranks"][1]["eval"][kind]["files"] == []


def test_distribution_ops_are_the_identity_on_one_process():
    """On a single process: make_mesh is rank 0 of 1, shard_batch keeps every
    row, replicate and all_reduce_ change nothing, all_reduce_sum is x."""
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.distributed) == (0, 1, False)
    b = SyntheticPoseDataset(input_res=RES, seed=1).batch(range(2))
    assert all(torch.equal(x, y) for x, y in zip(pmesh.shard_batch(b, mesh), b))
    x = torch.arange(3.0)
    assert pmesh.all_reduce_sum(x, mesh) is x
    pmesh.all_reduce_([x], mesh)
    assert x.tolist() == [0.0, 1.0, 2.0]
    with pytest.raises(ValueError, match="needs a process group of 2 ranks"):
        pmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="does not split over"):
        pmesh.shard_batch(b, pmesh.DataMesh(rank=0, size=3, device=torch.device("cpu")))
