"""Minimal PLY mesh loading (a copy of `kd6d_pose_adlp_tpu/utils/mesh.py`;
replaces the reference's trimesh dependency, `libs/utils.py:43-56`). Supports ascii and binary_little_endian vertex data;
only vertex positions are needed (ADD/ADI metrics + 3D bbox extraction)."""
from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply_vertices(path: str) -> np.ndarray:
    """(N, 3) float32 vertex positions."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply", path
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        cur = None
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = (name, int(cnt), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append(("list", parts[2] + ":" + parts[3]))
                else:
                    cur[2].append((parts[1], parts[2]))
            elif line.startswith("end_header"):
                break

        verts = None
        for name, cnt, props in elements:
            if name == "vertex":
                names = [p[1] for p in props]
                xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(cnt)]
                    arr = np.asarray(rows, dtype=np.float64)
                    verts = arr[:, [xi, yi, zi]].astype(np.float32)
                else:
                    assert fmt == "binary_little_endian", fmt
                    codes = [_PLY_TYPES[t][0] for t, _ in props]
                    rec = np.dtype([(n, "<" + c) for (t, n), c in zip(props, codes)])
                    arr = np.frombuffer(f.read(cnt * rec.itemsize), dtype=rec, count=cnt)
                    verts = np.stack([arr["x"], arr["y"], arr["z"]], 1).astype(np.float32)
                break
        if verts is None:
            raise ValueError(f"no vertex element in {path}")
        return verts


def load_bop_meshes(model_dir: str):
    """-> (list of (N,3) vertex arrays sorted by obj id, {objId_str: clsId})
    (reference libs/utils.py:43-56)."""
    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".ply"))
    meshes, obj2cls = [], {}
    for i, fn in enumerate(files):
        obj_id = int(os.path.splitext(fn)[0][4:])  # obj_000001.ply
        obj2cls[str(obj_id)] = i
        meshes.append(load_ply_vertices(os.path.join(model_dir, fn)))
    return meshes, obj2cls


def load_bbox_3d(json_file: str) -> np.ndarray:
    """(n_cls, 8, 3) corner table (reference libs/utils.py:58-61)."""
    with open(json_file) as f:
        return np.asarray(json.load(f), np.float32)


def mesh_bbox_corners(vertices: np.ndarray) -> np.ndarray:
    """(8,3) axis-aligned bounding-box corners of a vertex set, in the same
    corner ordering as trimesh.bounding_box (binary counting over z,y,x)."""
    mn, mx = vertices.min(0), vertices.max(0)
    return np.array([[x, y, z] for x in (mn[0], mx[0]) for y in (mn[1], mx[1])
                     for z in (mn[2], mx[2])], np.float32)
