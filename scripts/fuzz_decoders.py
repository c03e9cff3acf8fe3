"""Fuzz the port's image decoders on mutated copies of the committed fixtures.

JPEG: `kd6d_pose_adlp_tpu_torch/csrc/jpeg.cpp` is compiled with a small
driver under AddressSanitizer and UndefinedBehaviorSanitizer (any report
aborts the run), which cuts, flips, inserts and deletes bytes of each seed
file with its own seeded generator and calls `jpeg_info` and `jpeg_decode`
(both colour flags) on every mutation. PNG: `data/png.py` decodes mutated
PNG fixtures in this process; anything raised other than CorruptImage fails
the run. TIFF: `csrc/rasters.cpp` is compiled the same way with a driver
that mutates the inputs of each of its loops (the LZW strips of the TIFF
fixtures, PackBits runs of seeded bytes, the predictors on seeded rows) and
calls them; then `data/tiff.py`, through `imread.decode`, reads mutated
TIFF fixtures in this process, where only CorruptImage, UnsupportedImage
and ImageSizeError may be raised. Prints the outcomes of each.

    python scripts/fuzz_decoders.py --jpeg_iters 20000 --png_iters 5000 \
        --raster_iters 20000 --raster_py_iters 3000 --seed 0

Needs g++ with the sanitizer runtimes; no image library.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_port_fixtures")
RASTER_FIXTURES = os.path.join(REPO, "tests", "torch_port_fixtures_rasters")

DRIVER = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
extern "C" int jpeg_info(const uint8_t*, int64_t, int*, char*, int);
extern "C" int jpeg_decode(const uint8_t*, int64_t, uint8_t*, int64_t, int, char*, int);

static uint64_t s;
static uint64_t next() {                       // splitmix64
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

int main(int argc, char** argv) {
  long iters = atol(argv[1]);
  s = strtoull(argv[2], nullptr, 10);
  long counts[3] = {0, 0, 0};
  char err[256];
  for (int f = 3; f < argc; ++f) {
    FILE* fp = fopen(argv[f], "rb");
    std::vector<uint8_t> seed;
    int c;
    while ((c = fgetc(fp)) != EOF) seed.push_back((uint8_t)c);
    fclose(fp);
    for (long i = 0; i < iters; ++i) {
      std::vector<uint8_t> d = seed;
      int edits = 1 + (int)(next() % 3);
      for (int e = 0; e < edits && d.size() > 2; ++e) {
        size_t p = 2 + next() % (d.size() - 2);
        switch (next() % 5) {
          case 0: d.resize(p); break;                                  // cut
          case 1: d[p] = (uint8_t)next(); break;                       // byte
          case 2: d[p] ^= (uint8_t)(1u << (next() % 8)); break;        // bit
          case 3: {                                                    // insert
            size_t k = 1 + next() % 16;
            bool zeros = next() & 1;
            for (size_t j = 0; j < k; ++j) d.insert(d.begin() + p, zeros ? 0 : (uint8_t)next());
            break;
          }
          default: {                                                   // delete
            size_t k = 1 + next() % 16;
            d.erase(d.begin() + p, d.begin() + std::min(d.size(), p + k));
          }
        }
      }
      int info[4];
      int rc = jpeg_info(d.data(), (int64_t)d.size(), info, err, sizeof(err));
      if (rc == 0) {
        for (int color = 0; color < 2; ++color) {
          int64_t size = (int64_t)info[0] * info[1] * (info[2] == 1 && !color ? 1 : 3);
          std::vector<uint8_t> out((size_t)size);
          rc = jpeg_decode(d.data(), (int64_t)d.size(), out.data(), size, color, err, sizeof(err));
        }
      }
      counts[rc]++;
    }
  }
  printf("%ld %ld %ld\n", counts[0], counts[1], counts[2]);
  return 0;
}
"""


RASTER_DRIVER = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
extern "C" {
int tiff_lzw(const uint8_t*, int64_t, uint8_t*, int64_t);
int tiff_packbits(const uint8_t*, int64_t, uint8_t*, int64_t);
void tiff_hor_acc(uint8_t*, int64_t, int64_t, int, int);
void tiff_fp_acc(uint8_t*, int64_t, int64_t, int, int);
}

static uint64_t s;
static uint64_t next() {                       // splitmix64
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// argv: iters seed, then lines of the corpus file: kind a b c path
int main(int argc, char** argv) {
  long iters = atol(argv[1]);
  s = strtoull(argv[2], nullptr, 10);
  FILE* corpus = fopen(argv[3], "r");
  char kind[16], path[4096];
  long a, b, c, counts[3] = {0, 0, 0};
  while (fscanf(corpus, "%15s %ld %ld %ld %4095s", kind, &a, &b, &c, path) == 5) {
    FILE* fp = fopen(path, "rb");
    std::vector<uint8_t> seed;
    int ch;
    while ((ch = fgetc(fp)) != EOF) seed.push_back((uint8_t)ch);
    fclose(fp);
    std::string k(kind);
    for (long i = 0; i < iters; ++i) {
      std::vector<uint8_t> d = seed;
      int edits = 1 + (int)(next() % 3);
      for (int e = 0; e < edits && d.size() > 1; ++e) {
        size_t p = next() % d.size();
        switch (next() % 4) {
          case 0: d.resize(p); break;
          case 1: d[p] = (uint8_t)next(); break;
          case 2: d[p] ^= (uint8_t)(1u << (next() % 8)); break;
          default: d.erase(d.begin() + p, d.begin() + std::min(d.size(), p + 1 + next() % 16));
        }
      }
      int rc = 0;
      if (k == "lzw" || k == "packbits") {
        std::vector<uint8_t> out((size_t)a);
        rc = k == "lzw" ? tiff_lzw(d.data(), (int64_t)d.size(), out.data(), a)
                        : tiff_packbits(d.data(), (int64_t)d.size(), out.data(), a);
      } else if (k == "hacc" || k == "facc") {            // rows of c-byte samples, stride 3
        int64_t row = (int64_t)(d.size() / (size_t)a) / c * c;
        if (row > 0) {
          if (k == "hacc") tiff_hor_acc(d.data(), a, row, (int)c, 3);
          else tiff_fp_acc(d.data(), a, row, (int)c, 3);
        }
      }
      counts[rc]++;
    }
  }
  printf("%ld %ld %ld\n", counts[0], counts[1], counts[2]);
  return 0;
}
"""


def fixtures(ext: str, root: str = FIXTURES) -> list:
    out = []
    for sub in ("frames", "backgrounds", "damaged"):
        d = os.path.join(root, sub)
        if os.path.isdir(d):
            out += [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(ext)]
    return out


def fuzz_jpeg(iters: int, seed: int) -> dict:
    seeds = fixtures(".jpg")
    with tempfile.TemporaryDirectory() as tmp:
        drv, exe = os.path.join(tmp, "driver.cpp"), os.path.join(tmp, "fuzz")
        with open(drv, "w") as f:
            f.write(DRIVER)
        subprocess.run(["g++", "-O1", "-g", "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=undefined", "-fno-omit-frame-pointer",
                        os.path.join(REPO, "kd6d_pose_adlp_tpu_torch", "csrc", "jpeg.cpp"), drv,
                        "-o", exe], check=True)
        per_file = max(1, iters // len(seeds))
        t0 = time.perf_counter()
        proc = subprocess.run([exe, str(per_file), str(seed)] + seeds, capture_output=True,
                              text=True, env=dict(os.environ, ASAN_OPTIONS="detect_leaks=1"))
        if proc.returncode != 0:
            raise SystemExit(f"the JPEG decoder faulted under the sanitizers:\n{proc.stderr[-4000:]}")
        ok, corrupt, unsupported = map(int, proc.stdout.split())
    return dict(files=len(seeds), mutations=per_file * len(seeds), decoded=ok, corrupt=corrupt,
                unsupported=unsupported, seconds=round(time.perf_counter() - t0, 1))


def fuzz_png(iters: int, seed: int) -> dict:
    import numpy as np

    sys.path.insert(0, REPO)
    from kd6d_pose_adlp_tpu_torch.data import native, png

    rng = np.random.default_rng(seed)
    seeds = [open(p, "rb").read() for p in fixtures(".png")]
    counts = dict(decoded=0, corrupt=0)
    for _ in range(iters):
        d = bytearray(seeds[int(rng.integers(len(seeds)))])
        for _ in range(int(rng.integers(1, 4))):
            p = int(rng.integers(0, len(d)))
            kind = int(rng.integers(5))
            if kind == 0:
                del d[p:]
            elif kind == 1:
                d[p:p + 1] = bytes([int(rng.integers(256))])
            elif kind == 2:
                d[p:p + 1] = bytes([d[p] ^ (1 << int(rng.integers(8)))]) if p < len(d) else b""
            elif kind == 3:
                d[p:p] = bytes(rng.integers(0, 256, int(rng.integers(1, 17))).astype(np.uint8))
            else:
                del d[p:p + int(rng.integers(1, 17))]
        try:
            png.decode(bytes(d))
            counts["decoded"] += 1
        except native.CorruptImage:
            counts["corrupt"] += 1
    return dict(files=len(seeds), mutations=iters, **counts)


def _raster_corpus(tmp: str) -> list:
    """(kind, a, b, c, path) seeds of the TIFF loops, written under tmp."""
    import numpy as np

    sys.path.insert(0, REPO)
    from kd6d_pose_adlp_tpu_torch.data import tiff

    def save(name, data):
        path = os.path.join(tmp, name)
        with open(path, "wb") as f:
            f.write(data)
        return path

    rng = np.random.default_rng(0)
    corpus = []
    for p in fixtures(".tif", RASTER_FIXTURES):
        data = open(p, "rb").read()
        lay = tiff._Layout(data, p)
        if lay.compression == 5:
            for k in range(0, len(lay.offsets), max(1, len(lay.offsets) // 3)):
                rows, cols = lay.chunk_shape(k % lay.per_plane)
                size = rows * cols * lay.spp * lay.bps // 8
                corpus.append(("lzw", size, 0, 0, save(f"lzw{len(corpus)}", data[
                    lay.offsets[k]:lay.offsets[k] + lay.counts[k]])))
    corpus.append(("packbits", 4096, 0, 0, save("packbits", bytes(rng.integers(
        0, 256, 1500).astype(np.uint8)))))
    corpus.append(("hacc", 7, 0, 2, save("hacc", bytes(rng.integers(0, 256, 2100).astype(
        np.uint8)))))
    corpus.append(("facc", 5, 0, 4, save("facc", bytes(rng.integers(0, 256, 2400).astype(
        np.uint8)))))
    return corpus


def fuzz_raster_loops(iters: int, seed: int) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        corpus = _raster_corpus(tmp)
        listing = os.path.join(tmp, "corpus.txt")
        with open(listing, "w") as f:
            f.write("".join(f"{k} {a} {b} {c} {p}\n" for k, a, b, c, p in corpus))
        drv, exe = os.path.join(tmp, "driver.cpp"), os.path.join(tmp, "fuzz_rasters")
        with open(drv, "w") as f:
            f.write(RASTER_DRIVER)
        subprocess.run(["g++", "-O1", "-g", "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=undefined", "-fno-omit-frame-pointer",
                        os.path.join(REPO, "kd6d_pose_adlp_tpu_torch", "csrc", "rasters.cpp"),
                        drv, "-o", exe], check=True)
        per_seed = max(1, iters // len(corpus))
        t0 = time.perf_counter()
        proc = subprocess.run([exe, str(per_seed), str(seed), listing], capture_output=True,
                              text=True, env=dict(os.environ, ASAN_OPTIONS="detect_leaks=1"))
        if proc.returncode != 0:
            raise SystemExit("the TIFF loops faulted under the sanitizers:\n"
                             + proc.stderr[-4000:])
        done, damaged, unsupported = map(int, proc.stdout.split())
    return dict(seeds=sorted({k for k, *_ in corpus}), inputs=len(corpus),
                mutations=per_seed * len(corpus), done=done, damaged=damaged,
                unsupported=unsupported,
                seconds=round(time.perf_counter() - t0, 1))


def fuzz_raster_decoders(iters: int, seed: int) -> dict:
    import numpy as np

    sys.path.insert(0, REPO)
    from kd6d_pose_adlp_tpu_torch.data import imread, native

    rng = np.random.default_rng(seed)
    seeds = [open(p, "rb").read() for p in fixtures("", RASTER_FIXTURES)
             if os.path.getsize(p) < 200_000]
    counts = dict(decoded=0, corrupt=0, unsupported=0, size_error=0)
    for _ in range(iters):
        d = bytearray(seeds[int(rng.integers(len(seeds)))])
        for _ in range(int(rng.integers(1, 4))):
            if not d:
                break
            p = int(rng.integers(0, len(d)))
            kind = int(rng.integers(4))
            if kind == 0:
                del d[p:]
            elif kind == 1:
                d[p:p + 1] = bytes([int(rng.integers(256))])
            elif kind == 2:
                d[p:p + 1] = bytes([d[p] ^ (1 << int(rng.integers(8)))]) if p < len(d) else b""
            else:
                del d[p:p + int(rng.integers(1, 17))]
        for color in (False, True):
            try:
                imread.decode(bytes(d), color=color)
                counts["decoded"] += 1
            except native.ImageSizeError:
                counts["size_error"] += 1
            except native.UnsupportedImage:
                counts["unsupported"] += 1
            except native.CorruptImage:
                counts["corrupt"] += 1
    return dict(files=len(seeds), mutations=iters, reads=2 * iters, **counts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jpeg_iters", type=int, default=20000)
    ap.add_argument("--png_iters", type=int, default=5000)
    ap.add_argument("--raster_iters", type=int, default=20000)
    ap.add_argument("--raster_py_iters", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.jpeg_iters:
        print("jpeg (ASan + UBSan):", fuzz_jpeg(args.jpeg_iters, args.seed), flush=True)
    if args.png_iters:
        print("png:", fuzz_png(args.png_iters, args.seed), flush=True)
    if args.raster_iters:
        print("TIFF loops (ASan + UBSan):", fuzz_raster_loops(args.raster_iters, args.seed),
              flush=True)
    if args.raster_py_iters:
        print("TIFF decoder:", fuzz_raster_decoders(args.raster_py_iters, args.seed),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
