"""The evaluation CLI, the port's counterpart of the JAX package's
`test.py`:

    python -m kd6d_pose_adlp_tpu_torch.evaluate --data synthetic --weight_file W.pt
    python -m kd6d_pose_adlp_tpu_torch.evaluate --data synthetic --weight_file W.pt --cpu
    python -m kd6d_pose_adlp_tpu_torch.evaluate --config_file TREE/config.yaml \\
        --weight_file W.pt --test_file TREE/test_list.txt [--fast_pipeline]

Loads a PoseNet weight file loosely (`utils/checkpoint.load_params_loose`):
a `torch.save`d state_dict, such as the port's `final.ckpt`, or a JAX
package checkpoint (flax msgpack, such as its `final.ckpt`). It evaluates
the weights on the configured split, prints
`loaded N tensors from ...` and the per-class ADD/ADI/AUC/REP table, and
writes preds.json into --working_dir. The network computes in
--compute_dtype, bfloat16 by default as in `test.py:23`, or float32. Runs
on the card unless --cpu is given. --data bop (the default) evaluates one
crop per (image, object) of the config's test list, or of --test_file,
which replaces the config's TEST and VALID lists as in `test.py:59-61`;
--fast_pipeline takes the host pipeline's one-warp path. --data synthetic
evaluates the 64-image synthetic split.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config_file", type=str, default="./configs/ape.yaml",
                   help="reference-format YAML; '' = the built-in defaults")
    p.add_argument("--backbone", type=str, default="darknet_tiny_h")
    p.add_argument("--weight_file", type=str, required=True)
    p.add_argument("--test_file", type=str, default="",
                   help="image list that replaces the config's TEST and VALID lists")
    p.add_argument("--working_dir", type=str, default="./outputs/eval/")
    p.add_argument("--data", type=str, default="bop", choices=["bop", "synthetic"])
    p.add_argument("--ims_per_batch", type=int, default=24)  # reference test.py:114
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--eval_mode", type=str, default="scan", choices=["scan", "stream"],
                   help="scan = the device-resident one-pass evaluator "
                        "(engine/eval_scan); stream = the per-batch "
                        "evaluator.valid (the oracle path)")
    p.add_argument("--eval_all_classes", action="store_true",
                   help="also run detection-style eval over every class "
                        "(recovery rate / false positives / ADI rate)")
    p.add_argument("--fast_pipeline", action="store_true",
                   help="the host pipeline's one-warp path (--data bop)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the evaluation; returns the results of the chosen evaluator
    (with "detection" when --eval_all_classes)."""
    args = parse_args(argv)
    import torch

    from .config import Config, load_yaml_config
    from .data import loaders
    from .engine import evaluator
    from .engine.eval_scan import ScanEvaluator
    from .engine.postprocess import build_postprocess
    from .engine.serving import network_fn
    from .models.pose_net import PoseNet, init_pose_net
    from .utils.checkpoint import load_params_loose

    if not os.path.exists(args.weight_file):
        raise SystemExit(f"error: --weight_file not found: {args.weight_file}")
    device = torch.device("cpu" if args.cpu else args.device)

    cfg = (load_yaml_config(args.config_file, backbone=args.backbone)
           if args.config_file else
           Config().replace(model=dataclasses.replace(Config().model,
                                                      backbone=args.backbone)))
    if args.test_file:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, test_list=args.test_file,
                                                   valid_list=args.test_file))
    cfg = cfg.replace(test=dataclasses.replace(cfg.test, ims_per_batch=args.ims_per_batch),
                      model=dataclasses.replace(cfg.model, compute_dtype=args.compute_dtype),
                      data=dataclasses.replace(cfg.data, fast_pipeline=args.fast_pipeline))

    data = loaders.build(cfg, kind=args.data, device=device)
    if data.cfg is not None:
        cfg = data.cfg
    net = PoseNet(cfg.model, n_fg=cfg.data.n_fg)
    init_pose_net(net, torch.Generator().manual_seed(0))
    n = load_params_loose(args.weight_file, net)
    print(f"loaded {n} tensors from {args.weight_file}", flush=True)
    net = net.to(device).eval()

    if args.eval_mode == "scan":
        sev = ScanEvaluator(cfg, data.consts, net, data.meshes)
        sev.prepare(data.eval_batches())
        results = sev.run(step=0, working_dir=args.working_dir)
    else:
        results = evaluator.valid(cfg, data.consts, network_fn(net),
                                  build_postprocess(cfg, data.consts),
                                  data.eval_batches(), data.meshes, step=0,
                                  working_dir=args.working_dir)
    if args.eval_all_classes:
        results["detection"] = evaluator.detection_stats(
            cfg, data.consts, network_fn(net), data.eval_batches(),
            n_fg=cfg.data.n_fg)
    return results


if __name__ == "__main__":
    main()
