"""PyTorch port, the training CLI (`kd6d_pose_adlp_tpu_torch/train_kd.py`)
and what it drives of `engine/loop.train`: the run's files, resume, the
device pool with the cached teacher, the evaluation CLI on the run's
final.ckpt, the flags of modules not ported yet and the BOP flags reaching
the BOP reader, at the CLIs' default
flags (bfloat16), on the CPU with
`configs/smoke.yaml` (darknet_tiny_h student at 64², B=2), and the errors
of the distribution flags. As the JAX
package's tests/test_train_loop.py, without distillation (--kd_weight 0):
a run to 3 steps writes latest.ckpt,
final.ckpt, cfg.json, info.txt and scalars.jsonl; a run to 5 in the same
directory resumes at step 3 and moves the parameters; a run from
--backbone_init takes the backbone of that final.ckpt. The pool runs with
a random darknet_tiny_h teacher, cached. The evaluations see
the eval split's first 2 images (the CLIs' TestConfig takes seconds a chunk
on a CPU).
"""
import json
import os

import pytest
import torch

from kd6d_pose_adlp_tpu_torch import evaluate, train_kd
from kd6d_pose_adlp_tpu_torch.data import loaders
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "smoke.yaml")
ARTIFACTS = ("latest.ckpt", "final.ckpt", "cfg.json", "info.txt", "scalars.jsonl")


@pytest.fixture
def two_eval_images(monkeypatch):
    build = loaders.build
    monkeypatch.setattr(loaders, "build",
                        lambda cfg, kind, device: build(cfg, kind, eval_limit=2, device=device))


def _args(wd, max_iters, *extra):
    return ["--cpu", "--config_file", SMOKE, "--data", "synthetic", "--max_iters",
            str(max_iters), "--working_dir", str(wd), *extra]


def test_run_writes_its_files_and_resumes(tmp_path, capsys, two_eval_images):
    wd = tmp_path / "run"
    state, hist = train_kd.main(_args(wd, 3, "--kd_weight", "0"))
    out = capsys.readouterr().out
    assert state.step == 3 and hist[-1]["step"] == 3
    for name in ARTIFACTS + ("eval_scalars.jsonl", "preds.json"):
        assert os.path.exists(wd / name), name
    assert "Model size: 2018028 params" in out and "[valid @ step 3]" in out
    with open(wd / "cfg.json") as f:
        assert json.load(f)["solver"]["max_iter"] == 3
    with open(wd / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert rows[-1]["step"] == 3 and "training/loss_total" in rows[-1]
    with open(wd / "eval_scalars.jsonl") as f:
        assert json.loads(f.readline())["step"] == 3
    first = torch.load(wd / "final.ckpt", weights_only=True)

    state2, _ = train_kd.main(_args(wd, 5, "--kd_weight", "0"))
    out = capsys.readouterr().out
    assert f"resumed from {wd / 'latest.ckpt'} @ step 3" in out
    assert state2.step == 5 and state2.opt_state.count == 5
    second = torch.load(wd / "final.ckpt", weights_only=True)
    assert set(first) == set(second)
    assert any(not torch.equal(first[k], second[k]) for k in first)   # 2 more steps

    # the evaluation CLI reads the run's final.ckpt, every tensor
    r = evaluate.main(["--cpu", "--config_file", SMOKE, "--data", "synthetic",
                       "--weight_file", str(wd / "final.ckpt"), "--ims_per_batch", "2",
                       "--working_dir", str(tmp_path / "eval")])
    out = capsys.readouterr().out
    assert f"loaded {len(second)} tensors from" in out and r["table"] in out

    # a new run whose backbone starts from it (0 steps: its final.ckpt is
    # the initial state)
    init = tmp_path / "init"
    train_kd.main(_args(init, 0, "--kd_weight", "0", "--backbone_init",
                        str(wd / "final.ckpt")))
    out = capsys.readouterr().out
    third = torch.load(init / "final.ckpt", weights_only=True)
    backbone = [k for k in third if k.startswith("backbone.")
                and not k.endswith("num_batches_tracked")]
    assert f"backbone init: {len(backbone)} tensors from {wd / 'final.ckpt'}" in out
    for k in third:
        assert torch.equal(third[k], second[k]) == (k in backbone), k


def test_device_pool_with_the_cached_teacher(tmp_path, capsys, two_eval_images):
    state, hist = train_kd.main(_args(tmp_path, 3, "--device_pool", "2",
                                      "--steps_per_dispatch", "2", "--cache_teacher",
                                      "--backbone_t", "darknet_tiny_h"))
    out = capsys.readouterr().out
    assert "Model size: Student VS Teacher: 2018028 vs 2018028" in out
    assert "device pool: 2 batches x 2 images" in out
    assert "teacher knowledge cached for 2 pool batches" in out
    assert state.step == 3 and [h["step"] for h in hist] == [2, 3]
    for name in ARTIFACTS:
        assert os.path.exists(tmp_path / name), name


def test_defaults_that_differ_from_the_jax_cli():
    # the JAX CLI's bfloat16, fold_teacher_bn and remat defaults hold; only
    # vis_every (KD cloud plots, not ported) differs
    args = train_kd.get_argparser().parse_args([])
    assert (args.compute_dtype, args.vis_every, args.fold_teacher_bn) == ("bfloat16", 0, True)
    assert not args.remat
    assert not args.cpu and args.data == "bop"
    assert (args.steps_per_dispatch, args.cache_teacher, args.kd_weight) == (50, False, 5.0)


@pytest.mark.parametrize("flags, item", [
    (["--vis_every", "1000"], 6),
])
def test_unported_flags_raise(tmp_path, flags, item):
    args = _args(tmp_path, 1, *flags)          # a later --data overrides synthetic
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        train_kd.main(args)
    assert not os.path.exists(tmp_path / "cfg.json")


@pytest.mark.parametrize("flag", ["--n_devices", "--distributed"])
def test_distribution_flags_raise_their_errors(tmp_path, monkeypatch, flag):
    """The data mesh is ported (test_torch_port_dist_cli.py): on the card
    (no --cpu) more ranks than visible cards raises naming both counts, and
    --distributed outside torchrun names the variables it lacks."""
    from kd6d_pose_adlp_tpu_torch.parallel.mesh import TORCHRUN_ENV
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    if flag == "--n_devices":
        cards = torch.cuda.device_count()
        n = max(cards + 1, 2)
        flags, error = [flag, str(n)], ValueError
        words = (f"--n_devices {n}", f"{cards} cards are visible")
    else:
        flags, error = [flag], RuntimeError
        words = ("RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT not set",)
    args = [a for a in _args(tmp_path, 1, *flags) if a != "--cpu"]
    with pytest.raises(error) as e:
        train_kd.main(args)
    assert all(w in str(e.value) for w in words), str(e.value)
    assert not os.path.exists(tmp_path / "cfg.json")


@pytest.mark.parametrize("flags", [["--data", "bop"], ["--data", "bop", "--fast_pipeline"]],
                         ids=["bop", "fast_pipeline"])
def test_bop_flags_reach_the_bop_reader(tmp_path, flags):
    """--data bop and --fast_pipeline are ported: smoke.yaml names no image
    list, so the BOP reader raises FileNotFoundError on it, not
    NotImplementedError."""
    with pytest.raises(FileNotFoundError):
        train_kd.main(_args(tmp_path, 1, *flags))
    assert not os.path.exists(tmp_path / "cfg.json")
