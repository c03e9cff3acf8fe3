"""Time versions of the port's JPEG decoder (`csrc/jpeg.cpp`) side by side.

Each source is built with the data plane's g++ flags into its own library,
and every file (by default the committed fixture frames and the damaged
ones) is decoded under IMREAD_UNCHANGED `--reps` times a round, in rounds
ordered a, b, b, a (more sources: a, b, c, c, b, a), all in this process, so
that a drift of the host shows as a difference between a's two rounds.
Prints one JSON line: the median ms of each file for each source (null
where that source refuses the file), and the host's CPU.

    python scripts/bench_decode.py --sources old/jpeg.cpp \\
        kd6d_pose_adlp_tpu_torch/csrc/jpeg.cpp --reps 10

With --rasters it times instead the port's whole read (`imread.read`,
IMREAD_UNCHANGED) of each committed 640x480 TIFF frame of
tests/torch_port_fixtures_rasters/ (8-bit grey LZW, 16-bit RGB Deflate with
predictor 2, 8-bit palette PackBits in tiles): one row a frame, the median
of three rounds.

    python scripts/bench_decode.py --rasters --reps 10

Needs g++ and numpy; no image library.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import platform
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build(src: str, out_dir: str, i: int) -> ctypes.CDLL:
    from kd6d_pose_adlp_tpu_torch.data.native import GXX_FLAGS

    lib = os.path.join(out_dir, f"libjpeg{i}.so")
    subprocess.run(["g++", *GXX_FLAGS, src, "-o", lib], check=True)
    h = ctypes.CDLL(lib)
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    h.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p, ctypes.c_char_p, ctypes.c_int]
    h.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_char_p, ctypes.c_int]
    h.jpeg_info.restype = h.jpeg_decode.restype = ctypes.c_int
    return h


def decode_ms(lib, data: bytes, reps: int):
    """ms of one decode (mean of `reps`), or None where the source refuses
    the file."""
    info, err = np.zeros(4, np.int32), ctypes.create_string_buffer(256)
    if lib.jpeg_info(data, len(data), info, err, 256):
        return None
    out = np.empty(int(info[0]) * int(info[1]) * (1 if info[2] == 1 else 3), np.uint8)
    t0 = time.perf_counter()
    for _ in range(reps):
        if lib.jpeg_decode(data, len(data), out, out.size, 0, err, 256):
            return None
    return 1e3 * (time.perf_counter() - t0) / reps


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def raster_rows(reps: int) -> dict:
    """{frame: median ms of imread.read} over three rounds of `reps`."""
    from kd6d_pose_adlp_tpu_torch.data import imread

    frames = os.path.join(REPO, "tests", "torch_port_fixtures_rasters", "frames")
    files = {f: os.path.join(frames, f) for f in sorted(os.listdir(frames))}
    times = {name: [] for name in files}
    for _ in range(3):
        for name, path in files.items():
            img = imread.read(path)
            if img is None or img.shape[:2] != (480, 640):
                raise SystemExit(f"{name}: read as {None if img is None else img.shape}")
            t0 = time.perf_counter()
            for _ in range(reps):
                imread.read(path)
            times[name].append(1e3 * (time.perf_counter() - t0) / reps)
    return {name: statistics.median(v) for name, v in times.items()}


def main(argv=None) -> int:
    fixtures = os.path.join(REPO, "tests", "torch_port_fixtures")
    default_files = [os.path.join(fixtures, d, f) for d in ("frames", "damaged")
                     for f in sorted(os.listdir(os.path.join(fixtures, d))) if f.endswith(".jpg")]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sources", nargs="+",
                    default=[os.path.join(REPO, "kd6d_pose_adlp_tpu_torch", "csrc", "jpeg.cpp")])
    ap.add_argument("--files", nargs="+", default=default_files)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rasters", action="store_true",
                    help="time imread.read on each committed 640x480 TIFF frame")
    args = ap.parse_args(argv)
    if args.rasters:
        print(json.dumps(dict(cpu=cpu_name(), reps=args.reps, frame="640x480",
                              median_ms=raster_rows(args.reps))))
        return 0
    datas = {os.path.relpath(p, fixtures) if p.startswith(fixtures) else p: open(p, "rb").read()
             for p in args.files}
    with tempfile.TemporaryDirectory() as tmp:
        libs = [build(src, tmp, i) for i, src in enumerate(args.sources)]
        order = list(range(len(libs))) + list(range(len(libs)))[::-1]
        times = {src: {name: [] for name in datas} for src in args.sources}
        for i in order:
            for name, data in datas.items():
                times[args.sources[i]][name].append(decode_ms(libs[i], data, args.reps))
    result = {src: {name: (None if None in v else statistics.median(v)) for name, v in t.items()}
              for src, t in times.items()}
    print(json.dumps(dict(cpu=cpu_name(), reps=args.reps, order=order, median_ms=result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
