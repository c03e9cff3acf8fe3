"""Write a BOP-layout dataset from the procedural renderer, the port's
counterpart of the JAX package's `scripts/make_bop_dataset.py`:

    python -m kd6d_pose_adlp_tpu_torch.make_bop_dataset --out outputs/bop_synth \\
        --n_train 1024 --n_test 256

It writes the same tree: `{train,test}/000001/rgb/*.png` (640x480 frames of
`SyntheticPoseDataset.sample_internal`), `mask_visib/*_000000.png`,
`scene_gt.json`, `scene_camera.json`, `models/obj_*.ply` (the classes' box
corners), `bbox.json`, `train_list.txt`, `test_list.txt` and a
reference-format `config.yaml` that `train_kd --data bop` and `evaluate
--data bop` read (reference `libs/dataset.py:27-183`). PNGs go through
`data/png.py`, so it needs no image library.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np

from .data import png
from .data.synthetic import SyntheticPoseDataset
from .utils.mesh import mesh_bbox_corners


def write_ply(path: str, verts: np.ndarray):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")


def write_split(ds: SyntheticPoseDataset, root: str, split: str, indices,
                index_base: int):
    """One BOP scene dir per split; returns the image list entries."""
    scene = os.path.join(root, split, "000001")
    os.makedirs(os.path.join(scene, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(scene, "mask_visib"), exist_ok=True)
    cam, gt, names = {}, {}, []
    for j, idx in enumerate(indices):
        s = ds.sample_internal(index_base + idx)
        name = f"{j:06d}"
        # the frame's RGB is stored as such: BGR in, as cv2.imwrite takes it
        png.write(os.path.join(scene, "rgb", f"{name}.png"), s["img"][:, :, ::-1])
        png.write(os.path.join(scene, "mask_visib", f"{name}_000000.png"), s["mask"])
        cam[str(j)] = {"cam_K": ds.K.reshape(-1).tolist(), "depth_scale": 1.0}
        gt[str(j)] = [{"cam_R_m2c": np.asarray(s["R"]).reshape(-1).tolist(),
                       "cam_t_m2c": np.asarray(s["T"]).reshape(-1).tolist(),
                       "obj_id": int(s["cls"]) + 1}]
        names.append(f"{split}/000001/rgb/{name}.png")
    with open(os.path.join(scene, "scene_camera.json"), "w") as f:
        json.dump(cam, f)
    with open(os.path.join(scene, "scene_gt.json"), "w") as f:
        json.dump(gt, f)
    return names


def write_dataset(root: str, n_train: int, n_test: int, n_fg: int = 15,
                  single_class: Optional[int] = 0, seed: int = 0) -> str:
    """Write the tree under `root`; returns its config.yaml's path. Train
    frames are the renderer's indices 1000 + i, test frames i."""
    ds = SyntheticPoseDataset(n_fg=n_fg, single_class=single_class, seed=seed)
    os.makedirs(os.path.join(root, "models"), exist_ok=True)
    # meshes: the procedural cuboid corner sets (the BOP pipeline derives
    # kp3d via mesh_bbox_corners, which is identity for these)
    bboxes = []
    for c in range(n_fg):
        write_ply(os.path.join(root, "models", f"obj_{c + 1:06d}.ply"), ds.kp3d[c])
        bboxes.append(mesh_bbox_corners(ds.kp3d[c]).tolist())
    with open(os.path.join(root, "bbox.json"), "w") as f:
        json.dump(bboxes, f)

    train_names = write_split(ds, root, "train", range(n_train), index_base=1000)
    test_names = write_split(ds, root, "test", range(n_test), index_base=0)
    with open(os.path.join(root, "train_list.txt"), "w") as f:
        f.write("\n".join(train_names))
    with open(os.path.join(root, "test_list.txt"), "w") as f:
        f.write("\n".join(test_names))

    yaml_path = os.path.join(root, "config.yaml")
    diam = [round(float(d), 2) for d in np.asarray(ds.diameters)]
    with open(yaml_path, "w") as f:
        f.write(
            "DATASETS:\n"
            f"  TRAIN: '{root}/train_list.txt'\n"
            f"  VALID: '{root}/test_list.txt'\n"
            f"  TEST: '{root}/test_list.txt'\n"
            f"  MESH_DIR: '{root}/models/'\n"
            f"  BBOX_FILE: '{root}/bbox.json'\n"
            f"  N_CLASS: {n_fg + 1}\n"
            f"  MESH_DIAMETERS: {diam}\n"
            "INPUT:\n  INTERNAL_WIDTH: 640\n  INTERNAL_HEIGHT: 480\n"
            f"  INTERNAL_K: {np.asarray(ds.K).reshape(-1).tolist()}\n"
            "SOLVER:\n  IMS_PER_BATCH: 16\n"
            "TEST:\n  IMS_PER_BATCH: 8\n")
    return yaml_path


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=str, default="outputs/bop_synth")
    ap.add_argument("--n_train", type=int, default=1024)
    ap.add_argument("--n_test", type=int, default=256)
    ap.add_argument("--n_fg", type=int, default=15)
    ap.add_argument("--single_class", type=int, default=0, help="-1 = multi-class scenes")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t0 = time.time()
    yaml_path = write_dataset(args.out, args.n_train, args.n_test, args.n_fg,
                              None if args.single_class < 0 else args.single_class,
                              args.seed)
    n = args.n_train + args.n_test
    dt = time.time() - t0
    print(f"wrote {n} images under {args.out} in {dt:.0f}s ({n / max(dt, 1e-9):.1f} img/s); "
          f"config: {yaml_path}", flush=True)
    return yaml_path


if __name__ == "__main__":
    main()
