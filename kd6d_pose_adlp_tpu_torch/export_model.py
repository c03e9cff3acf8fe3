"""Export a trained weight file as a serving artifact, the port's
counterpart of the JAX package's `scripts/export_model.py`:

    python -m kd6d_pose_adlp_tpu_torch.export_model --weight_file W \\
        --batch_size 8 --out outputs/serving/model.pt2 --check
    python -m kd6d_pose_adlp_tpu_torch.export_model --weight_file W --cpu \\
        --input_res 64 --batch_size 2 --fold_bn --quant --check

Builds the config and the task constants, loads the weights
loosely (a `torch.save`d PoseNet state_dict, such as the port's final.ckpt,
or a JAX package checkpoint, as `evaluate` reads them), optionally folds BN
(`--fold_bn`, checked against the unfolded network's logits) and
int8-quantizes (`--quant`, after `--fold_bn`, calibrated on
`--quant_calib_batches` eval batches), and writes the endpoint with
`engine/serving.export_inference` (`--out`, plus `--out`.json metadata).
`--check` loads the artifact back with `load_serving` and compares it with
the eager endpoint on random inputs, seed 7 (rtol 1e-5, atol 1e-5; JAX's
check). The network computes in float32 with `--cpu` and in bfloat16 on
the card, as the JAX script does. Runs on the card unless --cpu is given;
the artifact serves on the device it was exported on. `--data` names the
source of the task constants (camera K, 3D keypoints) and of the
calibration batches: the synthetic scenes (the default), or with `--data
bop` the BOP tree that `--config_file` names.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weight_file", type=str, required=True)
    ap.add_argument("--backbone", type=str, default="darknet_tiny_h")
    ap.add_argument("--input_res", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=1,
                    help="0 = symbolic batch (one artifact, any batch size)")
    ap.add_argument("--mode", choices=["single", "multi", "frame"], default="single",
                    help="'frame' puts the raw-frame -> crop warp into the artifact; "
                         "requires --frame_hw")
    ap.add_argument("--frame_hw", type=int, nargs=2, default=None, metavar=("H", "W"),
                    help="raw camera frame size for --mode frame")
    ap.add_argument("--data", choices=["synthetic", "bop"], default="synthetic",
                    help="task-constant source (camera K, 3D keypoints)")
    ap.add_argument("--config_file", type=str, default="",
                    help="reference-format YAML; '' = the built-in defaults")
    ap.add_argument("--out", type=str, default="outputs/serving/model.pt2")
    ap.add_argument("--check", action="store_true",
                    help="round-trip the artifact and compare it with the eager endpoint")
    ap.add_argument("--fold_bn", action="store_true",
                    help="fold BatchNorm into the conv weights before export")
    ap.add_argument("--quant", action="store_true",
                    help="int8 post-training quantization (requires --fold_bn)")
    ap.add_argument("--quant_calib_batches", type=int, default=4,
                    help="eval batches for the --quant activation calibration")
    ap.add_argument("--cpu", action="store_true", help="export for and on the CPU")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Exports; returns the artifact's metadata."""
    args = parse_args(argv)
    if args.quant and not args.fold_bn:
        raise SystemExit("--quant requires --fold_bn")
    import numpy as np
    import torch

    from .config import Config, ModelConfig, load_yaml_config
    from .data import loaders
    from .engine.serving import (build_frame_infer_fn, build_infer_fn, centered_bbox_trans,
                                 export_inference, load_serving, network_fn)
    from .models.pose_net import PoseNet, init_pose_net
    from .utils.checkpoint import load_params_loose

    device = torch.device("cpu" if args.cpu else "cuda")
    dtype = "float32" if args.cpu else "bfloat16"
    if args.config_file:
        cfg = load_yaml_config(args.config_file)
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, backbone=args.backbone, input_res=args.input_res, compute_dtype=dtype))
    else:
        cfg = Config(model=ModelConfig(backbone=args.backbone, input_res=args.input_res,
                                       compute_dtype=dtype))
    bundle = loaders.build(cfg, args.data, device=device,
                           eval_limit=(args.quant_calib_batches * cfg.test.ims_per_batch
                                       if args.quant else 1))
    cfg = bundle.cfg or cfg
    consts = bundle.consts

    net = init_pose_net(PoseNet(cfg.model, n_fg=cfg.data.n_fg),
                        torch.Generator().manual_seed(0)).eval()
    n = load_params_loose(args.weight_file, net)
    print(f"loaded {n} tensors from {args.weight_file}", flush=True)

    if args.fold_bn:
        from .utils.fold_bn import fold_batchnorm
        folded = fold_batchnorm(net)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, bn_folded=True))
        net_f = PoseNet(cfg.model, n_fg=cfg.data.n_fg).eval()
        net_f.load_state_dict(folded, strict=True)
        # the folded network must reproduce the frozen-BN outputs
        x = torch.from_numpy(np.random.default_rng(1).integers(
            0, 256, (1, args.input_res, args.input_res, 3), dtype=np.uint8)).to(device)
        ref = network_fn(net.to(device))(x)
        got = network_fn(net_f.to(device))(x)
        err = max(float((a - b).abs().max()) for a, b in zip(ref, got))
        tol = 1e-3 if cfg.model.compute_dtype == "float32" else 1e-1
        print(f"fold_bn: max output delta {err:.2e} (tol {tol})", flush=True)
        if not err < tol:
            raise SystemExit("BN folding changed the network beyond tolerance")
        net = net_f

    if args.quant:
        from .utils.quant import quantize_posenet
        calib = []
        for b, _ in bundle.eval_batches():
            calib.append(b.images.to(device))
            if len(calib) >= args.quant_calib_batches:
                break
        net, _ = quantize_posenet(cfg.model, cfg.data.n_fg, net.cpu().state_dict(), calib,
                                  device=device)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, quant_mode="quant"))
        print(f"int8-quantized ({len(calib)} calib batches)", flush=True)

    frame_hw = tuple(args.frame_hw) if args.frame_hw else None
    meta = export_inference(cfg, consts, net, args.out, batch_size=args.batch_size,
                            mode=args.mode, frame_hw=frame_hw, device=device)
    print(json.dumps(meta), flush=True)

    if args.check:
        bs = args.batch_size or 2      # a symbolic artifact is checked at 2
        rng = np.random.default_rng(0)
        ids = np.zeros((bs,), np.int32)
        serve, _ = load_serving(args.out, device=device)
        if args.mode == "frame":
            fh, fw = frame_hw
            frames = rng.integers(0, 256, (bs, fh, fw, 3), dtype=np.uint8)
            centers = np.tile(np.asarray([[cfg.data.internal_width / 2,
                                           cfg.data.internal_height / 2]], np.float32), (bs, 1))
            scales = np.full((bs,), args.input_res, np.float32)
            direct = build_frame_infer_fn(cfg, consts, net, frame_hw, device=device)
            ref = direct(frames, centers, scales, ids, seed=7)
            got = serve(frames, centers, scales, ids, seed=7)
        else:
            images = rng.integers(0, 256, (bs, args.input_res, args.input_res, 3),
                                  dtype=np.uint8)
            bt = centered_bbox_trans(bs, args.input_res)
            direct = build_infer_fn(cfg, consts, net, mode=args.mode, device=device)
            ref = direct(images, bt, ids, seed=7)
            got = serve(images, bt, ids, seed=7)
        if list(got) != list(ref):
            raise SystemExit(f"round trip: keys {list(got)} != {list(ref)}")
        for k in ref:
            np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].cpu().numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        print("round-trip check OK: artifact reproduces the in-process model", flush=True)
    return meta


if __name__ == "__main__":
    main()
