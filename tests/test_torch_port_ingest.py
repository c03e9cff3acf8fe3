"""PyTorch port, reference-format weight files (`kd6d_pose_adlp_tpu_torch/
utils/checkpoint.read_state_dict`, `utils/torch_convert.py`,
`ingest_reference.py`) against the JAX package's `utils/torch_convert.py`
and `scripts/ingest_reference.py`'s conversion, on the CPU.

- The reference's checkpoint layout `{"model": state_dict, "steps",
  "optim", "sched"}`, with and without DDP's `module.`, built from a port
  PoseNet (darknet_tiny_h, 64², no P6/P7): every tensor loads, equal to
  JAX's `convert_pose_module` + `merge_into_variables` carried back by the
  port's `utils/convert.from_jax_variables`, exactly.
- A pytorchcv backbone dict (`features.…`, `output.final_conv.*`,
  darknet53's `output.{weight,bias}`), bare and in an imgclsmob release
  zip (as tests/test_torch_convert.py fabricates one): `--backbone_init`
  takes every backbone tensor; `imgclsmob_to_backbone_ckpt` counts as
  JAX's `convert_backbone` does, and, at darknet_tiny_h, as JAX's
  `imgclsmob_to_backbone_ckpt`, whose file the port reads to the same
  backbone as its own.
- A file that matches nothing raises ValueError, naming it, in every
  entry point that reads weights; so does one that `weights_only` refuses.
- `ingest_reference --convert_only --cpu` writes a file that loads back
  to the source weights.
"""
import io
import os
import zipfile

import pytest
import torch
from flax import traverse_util

from kd6d_pose_adlp_tpu.utils import torch_convert as jtc
from kd6d_pose_adlp_tpu_torch import evaluate, export_model, ingest_reference, train_kd
from kd6d_pose_adlp_tpu_torch import config as tcfg
from kd6d_pose_adlp_tpu_torch.data import loaders
from kd6d_pose_adlp_tpu_torch.models.darknet import DarkNet
from kd6d_pose_adlp_tpu_torch.models.darknet53 import DarkNet53
from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
from kd6d_pose_adlp_tpu_torch.utils import torch_convert as ttc
from kd6d_pose_adlp_tpu_torch.utils.checkpoint import load_backbone_init, load_params_loose
from kd6d_pose_adlp_tpu_torch.utils.convert import from_jax_variables
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "smoke.yaml")
RES = 64


def _net(seed: int, cfg=None) -> PoseNet:
    cfg = cfg or tcfg.ModelConfig(input_res=RES, use_higher_levels=False)
    net = init_pose_net(PoseNet(cfg), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    for k, v in net.state_dict().items():           # BN statistics off their init
        if k.endswith(("running_mean", "running_var")):
            v.copy_(torch.rand(v.shape, generator=g) + 0.5)
    return net


def _reference_file(path, sd, ddp: bool) -> None:
    """The reference train loop's checkpoint (train_kd.py's save): the
    model's state_dict beside the step, the optimizer and the scheduler."""
    torch.save({"model": {("module." if ddp else "") + k: v for k, v in sd.items()},
                "steps": 120, "optim": {"state": {}, "param_groups": [{"lr": 1e-3}]},
                "sched": {"last_epoch": 120, "_step_count": 121}}, path)


@pytest.mark.parametrize("ddp", [False, True], ids=["plain", "module_prefix"])
def test_reference_layout_loads_every_tensor_as_jax(tmp_path, ddp):
    src = _net(0).state_dict()
    path = str(tmp_path / "latest.pth")
    _reference_file(path, src, ddp)
    net = _net(1)
    assert load_params_loose(path, net) == len(src)

    # JAX: its reader, ingest_reference's prefix strip, convert_pose_module,
    # merge_into_variables over the variables of another PoseNet (the
    # flax tree of net 2, as test_torch_port_pool.py builds it), carried back
    sd = {k.removeprefix("module."): v for k, v in jtc.load_torch_state_dict(path).items()}
    params, stats = jtc.convert_pose_module(sd)
    p2, s2 = jtc.convert_pose_module({k: v.numpy() for k, v in _net(2).state_dict().items()})
    variables = {"params": p2, "batch_stats": s2}
    want = from_jax_variables(jtc.merge_into_variables(variables, params, stats))
    got = net.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k
        assert torch.equal(got[k], src[k]), k


def _pytorchcv(backbone: str):
    """A seeded port backbone with its ImageNet head, as pytorchcv names
    it: (pytorchcv state_dict, the port backbone)."""
    torch.manual_seed(3)
    bb = DarkNet("tiny-h", include_head=True) if backbone == "darknet_tiny_h" else \
        DarkNet53(include_head=True)
    for k, v in bb.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            v.copy_(torch.rand(v.shape) + 0.5)
    sd = {("output." + k if k.startswith("final_conv.") else k): v
          for k, v in bb.state_dict().items()}
    assert any(k.startswith("output.") for k in sd)
    return sd, bb


def _backbone_of(net: PoseNet):
    return {k: v for k, v in net.state_dict().items()
            if k.startswith("backbone.") and not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("backbone", ["darknet_tiny_h", "darknet53"])
def test_pytorchcv_backbone_and_zip(tmp_path, backbone):
    sd, bb = _pytorchcv(backbone)
    cfg = tcfg.ModelConfig(backbone=backbone, input_res=128)
    want = {"backbone." + k: v for k, v in bb.state_dict().items()}

    bare = str(tmp_path / "bare.pth")
    torch.save(sd, bare)
    net = _net(1, cfg)
    n_bb = len(_backbone_of(net))
    assert load_backbone_init(bare, net) == n_bb
    for k, v in _backbone_of(net).items():
        assert torch.equal(v, want[k]), k

    pth = f"{backbone}-2340-cdd2c0c9.pth"
    buf = io.BytesIO()
    torch.save(sd, buf)
    zpath = str(tmp_path / (pth + ".zip"))
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.writestr(pth, buf.getvalue())
    ours = str(tmp_path / "port.ckpt")
    n = ttc.imgclsmob_to_backbone_ckpt(zpath, backbone, ours, input_res=128)
    params, stats = jtc.convert_backbone({k: v.numpy() for k, v in sd.items()})
    assert n == len(traverse_util.flatten_dict(params)) + len(traverse_util.flatten_dict(stats))
    assert n == n_bb + 2                        # and the classifier head's two
    files = [ours]
    if backbone == "darknet_tiny_h":            # (flax's darknet53 init takes ~25 s)
        theirs = str(tmp_path / "jax.ckpt")
        assert n == jtc.imgclsmob_to_backbone_ckpt(zpath, backbone, theirs, input_res=128)
        files.append(theirs)
    for f in files:
        net = _net(2, cfg)
        assert load_backbone_init(f, net) == n_bb
        for k, v in _backbone_of(net).items():
            assert torch.equal(v, want[k]), (f, k)


def test_zip_of_other_than_one_pth_raises(tmp_path):
    zpath = str(tmp_path / "two.zip")
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.writestr("a.pth", b"")
        zf.writestr("b.pth", b"")
    with pytest.raises(ValueError, match="exactly one .pth"):
        ttc.load_imgclsmob_zip(zpath)


class _Scheduler:                      # not a tensor, container or plain value
    pass


@pytest.mark.parametrize("entry", ["evaluate", "export_model", "weight_file_t",
                                   "backbone_init", "refused"])
def test_a_file_that_loads_nothing_raises(tmp_path, monkeypatch, entry):
    build = loaders.build
    monkeypatch.setattr(loaders, "build", lambda cfg, kind, device, eval_limit=None:
                        build(cfg, kind, eval_limit=2, device=device))
    path = str(tmp_path / "nothing.pth")
    if entry == "refused":
        torch.save({"model": _net(0).state_dict(), "sched": _Scheduler}, path)
        with pytest.raises(ValueError, match="weights_only=True") as e:
            load_params_loose(path, _net(1))
        assert path in str(e.value)
        return
    torch.save({"model": {"rpn.weight": torch.zeros(3)}}, path)
    wd = str(tmp_path / "run")
    train = ["--cpu", "--config_file", SMOKE, "--data", "synthetic", "--max_iters", "1",
             "--working_dir", wd]
    run = {
        "evaluate": lambda: evaluate.main(["--cpu", "--config_file", SMOKE, "--data",
                                           "synthetic", "--weight_file", path,
                                           "--working_dir", wd]),
        "export_model": lambda: export_model.main(["--cpu", "--config_file", SMOKE,
                                                   "--input_res", str(RES), "--weight_file",
                                                   path, "--out", wd + "/m.pt2"]),
        "weight_file_t": lambda: train_kd.main(train + ["--weight_file_t", path]),
        "backbone_init": lambda: train_kd.main(train + ["--kd_weight", "0",
                                                        "--backbone_init", path]),
    }[entry]
    with pytest.raises(ValueError, match="no tensor of the file matches") as e:
        run()
    assert path in str(e.value)
    assert not os.path.exists(os.path.join(wd, "final.ckpt"))


def test_ingest_reference_convert_only(tmp_path, capsys):
    cfg = tcfg.load_yaml_config(SMOKE)
    src = _net(0, cfg.model)
    src_sd = {k: v.clone() for k, v in src.state_dict().items()}
    path = str(tmp_path / "final.pth")
    _reference_file(path, src_sd, ddp=True)
    out = str(tmp_path / "ingest")
    assert ingest_reference.main(["--weight_file", path, "--config_file", SMOKE,
                                  "--out", out, "--convert_only", "--cpu"]) is None
    printed = capsys.readouterr().out
    assert f"converted {len(src_sd)} reference tensors" in printed
    net = _net(5, cfg.model)
    assert load_params_loose(os.path.join(out, "converted.ckpt"), net) == len(src_sd)
    for k, v in net.state_dict().items():
        assert torch.equal(v, src_sd[k]), k
