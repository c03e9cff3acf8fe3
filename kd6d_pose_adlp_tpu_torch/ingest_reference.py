"""Reference-checkpoint ingestion in one command, the port's counterpart of
the JAX package's `scripts/ingest_reference.py`:

    python -m kd6d_pose_adlp_tpu_torch.ingest_reference \\
        --weight_file final.pth --config_file TREE/config.yaml \\
        [--backbone darknet_tiny_h] [--out outputs/ingest/] [--convert_only] [--cpu]

1. reads the reference-format weight file (`{"model": state_dict, ...}`
   as the reference's train loop saves it, reference test.py:94-137, with
   or without DDP's `module.`; or a bare state_dict) through
   `utils/checkpoint.load_params_loose` into a PoseNet of the YAML's model
   (seed 0 for whatever the file lacks); it raises when nothing loads;
2. saves the port's state_dict as `<out>/converted.ckpt`;
3. unless --convert_only, evaluates it through `evaluate.main` on the
   YAML's BOP test split (`--data bop`) and prints the per-class
   ADD/ADI/AUC/REP table, on the card unless --cpu is given (which also
   takes float32, as the JAX script does).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def convert(weight_file: str, config_file: str, backbone: str, out_path: str) -> str:
    """Reference weight file -> the port's state_dict at `out_path`;
    returns `out_path`."""
    import torch

    from .config import load_yaml_config
    from .models.pose_net import PoseNet, init_pose_net
    from .utils.checkpoint import load_params_loose, save_params

    cfg = load_yaml_config(config_file, backbone=backbone)
    net = init_pose_net(PoseNet(cfg.model, n_fg=cfg.data.n_fg),
                        torch.Generator().manual_seed(0))
    n = load_params_loose(weight_file, net)
    print(f"converted {n} reference tensors into a {len(net.state_dict())}-tensor "
          f"{backbone} PoseNet", flush=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    save_params(out_path, net.state_dict())
    print(f"wrote {out_path}", flush=True)
    return out_path


def main(argv: Optional[Sequence[str]] = None):
    """Converts, then evaluates unless --convert_only; returns
    `evaluate.main`'s results, or None."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weight_file", type=str, required=True,
                    help="reference-format final.pth / latest.pth")
    ap.add_argument("--config_file", type=str, default="./configs/ape.yaml",
                    help="reference-schema YAML whose DATASETS paths point at the "
                         "LINEMOD/BOP-layout tree")
    ap.add_argument("--backbone", type=str, default="darknet_tiny_h")
    ap.add_argument("--out", type=str, default="outputs/ingest/")
    ap.add_argument("--eval_mode", type=str, default="scan", choices=["scan", "stream"])
    ap.add_argument("--ims_per_batch", type=int, default=24)
    ap.add_argument("--compute_dtype", type=str, default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--convert_only", action="store_true",
                    help="stop after writing converted.ckpt")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (in float32)")
    args = ap.parse_args(argv)

    ckpt = convert(args.weight_file, args.config_file, args.backbone,
                   os.path.join(args.out, "converted.ckpt"))
    if args.convert_only:
        return None
    from . import evaluate
    return evaluate.main(
        ["--weight_file", ckpt, "--config_file", args.config_file,
         "--backbone", args.backbone, "--data", "bop", "--working_dir", args.out,
         "--eval_mode", args.eval_mode, "--ims_per_batch", str(args.ims_per_batch),
         "--compute_dtype", "float32" if args.cpu else args.compute_dtype]
        + (["--cpu"] if args.cpu else []))


if __name__ == "__main__":
    main()
