"""PyTorch port, the training CLI under data parallelism
(`kd6d_pose_adlp_tpu_torch/train_kd.py --n_devices`, `--distributed`), on
the CPU with `configs/smoke.yaml` (darknet_tiny_h at 64², a global batch of
2) without distillation, fp32: `--n_devices 2` starts two gloo ranks through
the port's launcher; `--distributed` runs as rank 0 of a 1-rank group from
torchrun's variables, which the test sets. Each run writes its files once
and resumes. The ranks see the eval split's first 2 images.

The spawned wrapper lives in this module (the spawn start method imports it
by module path) and imports neither `jax` nor the JAX package.
"""
import json
import os

import torch

from kd6d_pose_adlp_tpu_torch import train_kd
from kd6d_pose_adlp_tpu_torch.data import loaders
from kd6d_pose_adlp_tpu_torch.parallel import mesh as pmesh
from test_torch_port_dist import one_torch_thread, without_tensorboard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "smoke.yaml")


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _two_eval_images(build):
    return lambda cfg, kind, device: build(cfg, kind, eval_limit=2, device=device)


def with_two_eval_images(fn, *args):
    """`fn(*args)` in a spawned rank whose loaders see the eval split's
    first 2 images."""
    without_tensorboard()
    loaders.build = _two_eval_images(loaders.build)
    return fn(*args)


def test_train_kd_n_devices_two_writes_once_and_resumes(tmp_path, monkeypatch):
    """`train_kd --cpu --n_devices 2` starts two gloo ranks
    (`train_kd._rank`) of B=1 each: 2 steps, the files written once (one
    scalars line a step, one eval line), then resumed to 3 by a second
    command. The ranks see the eval split's first 2 images."""
    spawn = pmesh.spawn
    started = []

    def spawn_two_eval_images(fn, nprocs, args=(), num_threads=None):
        started.append((fn, nprocs, num_threads))
        return spawn(with_two_eval_images, nprocs, args=(fn,) + args,
                     num_threads=num_threads)

    monkeypatch.setattr(pmesh, "spawn", spawn_two_eval_images)
    args = ["--cpu", "--config_file", SMOKE, "--data", "synthetic", "--kd_weight", "0",
            "--working_dir", str(tmp_path), "--n_devices", "2", "--compute_dtype",
            "float32"]
    ranks = train_kd.main(args + ["--max_iters", "2"])
    assert started == [(train_kd._rank, 2, 1)]
    assert [step for step, _ in ranks] == [2, 2]
    clock = ("images_per_sec", "step_ms")
    assert [{k: v for k, v in h.items() if k not in clock} for h in ranks[0][1]] \
        == [{k: v for k, v in h.items() if k not in clock} for h in ranks[1][1]]
    for name in ("latest.ckpt", "final.ckpt", "cfg.json", "info.txt", "preds.json"):
        assert os.path.exists(tmp_path / name), name
    assert [r["step"] for r in _rows(tmp_path / "scalars.jsonl")] == [2]
    assert [r["step"] for r in _rows(tmp_path / "eval_scalars.jsonl")] == [2]
    with open(tmp_path / "cfg.json") as f:
        assert json.load(f)["solver"]["ims_per_batch"] == 2   # the global batch
    ranks = train_kd.main(args + ["--max_iters", "3"])
    assert [step for step, _ in ranks] == [3, 3]
    assert [r["step"] for r in _rows(tmp_path / "scalars.jsonl")] == [2, 3]


def test_train_kd_distributed_under_torchrun_env(tmp_path, monkeypatch, capsys):
    """`train_kd --distributed` as rank 0 of a 1-rank gloo group from
    torchrun's variables, set here: 2 steps, its files, a resume; the
    group is destroyed when it returns."""
    monkeypatch.setattr(loaders, "build", _two_eval_images(loaders.build))
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(pmesh.free_port())).items():
        monkeypatch.setenv(k, v)
    args = ["--cpu", "--config_file", SMOKE, "--data", "synthetic", "--kd_weight", "0",
            "--working_dir", str(tmp_path), "--distributed"]
    state, hist = train_kd.main(args + ["--max_iters", "2"])
    assert state.step == 2 and not torch.distributed.is_initialized()
    for name in ("latest.ckpt", "final.ckpt", "cfg.json", "info.txt", "scalars.jsonl",
                 "eval_scalars.jsonl", "preds.json"):
        assert os.path.exists(tmp_path / name), name
    monkeypatch.setenv("MASTER_PORT", str(pmesh.free_port()))
    state, _ = train_kd.main(args + ["--max_iters", "3"])
    assert state.step == 3
    assert f"resumed from {tmp_path / 'latest.ckpt'} @ step 2" in capsys.readouterr().out
