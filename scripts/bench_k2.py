#!/usr/bin/env python3
"""Time K2, the port's flat fused 3x3 conv + BN affine + LeakyReLU, on one
NVIDIA card, and compare versions of its source.

    python3 scripts/bench_k2.py                       # the committed source
    python3 scripts/bench_k2.py --sources a.cu b.cu   # versions side by side

Each source (default: kd6d_pose_adlp_tpu_torch/csrc/conv3x3_bn_act.cu) is
built with the port's nvcc flags and called through the same C interface as
`ops/conv_fused.conv3x3_bn_act_flat`. Each is first held against the plain
version (chip_smoke's ATOL_KERNEL, all columns) at the serving shapes
(B = 8: stem 3->8 @256², s2 8->16 @128²) and at chip_smoke's K2 edge
shapes, then timed by CUDA-graph replay, inputs cycled past the L2 as in
chip_smoke.time_cuda, the sources in turn and back (a, b, b, a): K2 at the
stem and s2 shapes, and the serving-stem segment (`stem_s2_segment_flat`:
conv, pool, conv, pool) built on that source's K2, whose device kernels
are then listed (torch.profiler). `--sweep` also times K2 at B = 1, 2, 4, 8
and one tiny graph node (a block's latency against throughput); `--sass`
prints the opcode counts of the serving-instance kernels (cuobjdump).
Prints one JSON line, then the card's name and power limit; runs only on
the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from _bench import build  # noqa: E402

ITERS = 100


def sass_histogram(lib_path, needle="conv3x3_flat_"):
    """Opcode counts of each kernel in the library whose name holds
    `needle`, from cuobjdump -sass: {kernel: {opcode: count}}."""
    from kd6d_pose_adlp_tpu_torch.utils import cuda_build as cb

    cuobjdump = os.path.join(os.path.dirname(cb.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    hist, cur = {}, None
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("Function :"):
            name = s.split(":", 1)[1].strip()
            cur = hist.setdefault(name, {}) if needle in name else None
        elif cur is not None and s.startswith("/*") and "*/" in s:
            body = s.split("*/", 1)[1].strip()
            if not body or body.startswith("/*"):
                continue
            tok = body.split()
            op = tok[1] if tok[0].startswith("@") and len(tok) > 1 else tok[0]
            op = op.rstrip(";").split(".")[0]
            cur[op] = cur.get(op, 0) + 1
    return hist


def sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sources", nargs="+", default=[os.path.join(
        ROOT, "kd6d_pose_adlp_tpu_torch", "csrc", "conv3x3_bn_act.cu")])
    ap.add_argument("--sass", action="store_true",
                    help="print each source's opcode counts of its serving-instance kernels")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K2 at B = 1, 2, 4, 8 (per-block latency "
                         "against throughput)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("bench_k2: no CUDA device", file=sys.stderr)
        return 2
    from kd6d_pose_adlp_tpu_torch.ops import conv_fused as cf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = build(args.sources, "conv3x3_bn_act_flat", [p, p, p, p, p, i, i, i, i, i, f, p])

    def flat_fn(lib):
        def run(xf, w, sc, bi, *, H, W, alpha=0.1):
            B, C, _ = xf.shape
            O = w.shape[1]
            out = torch.empty((B, O, H * (W + 2)), device=dev)
            err = lib.conv3x3_bn_act_flat(
                xf.data_ptr(), w.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(),
                B, C, O, H, W, alpha, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return out
        return run

    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def conv_inputs(B, C, O, H, W):
        k = torch.randn((3, 3, C, O), generator=g, device=dev) * (1.0 / math.sqrt(9 * C))
        sc = torch.rand((O, 1), generator=g, device=dev) + 0.5
        bi = torch.randn((O, 1), generator=g, device=dev) * 0.1
        x = torch.randn((B, H, W, C), generator=g, device=dev)
        return cf.nhwc_to_flat(x), cf.pack_weights(k), sc, bi

    B, R = cs.BATCH, cs.RES
    shapes = {"stem": (B, 3, 8, R, R), "s2": (B, 8, 16, R // 2, R // 2)}
    inputs = {k: conv_inputs(*v) for k, v in shapes.items()}
    edges = {f"B={s[0]} {s[1]}->{s[2]} @{s[3]}x{s[4]}": (s, conv_inputs(*s)) for s in cs.K2_EDGES}
    seg_x = torch.randn((B, R, R, 3), generator=g, device=dev)
    seg_p = inputs["stem"][1:] + inputs["s2"][1:]

    bounds = {tag: dict(zip(("bound_ms", "bound_by"), cs.k2_bound(*s)))
              for tag, s in shapes.items()}
    result = {"card": cs.gpu_name_and_power(), "shapes": shapes, "bounds": bounds,
              "sources": {}}

    for name, lib in libs.items():
        fn = flat_fn(lib)
        gate = {}
        for tag, (s, (xf, w, sc, bi)) in [(k, (shapes[k], v)) for k, v in inputs.items()] + list(
                edges.items()):
            H, W = s[3], s[4]
            got = fn(xf, w, sc, bi, H=H, W=W)
            torch.cuda.synchronize()
            gate[tag] = (got - cf.conv3x3_bn_act_flat_plain(xf, w, sc, bi, H=H, W=W)
                         ).abs().max().item()
        agrees = all(e <= cs.ATOL_KERNEL for e in gate.values())
        result["sources"][name] = dict(agrees=agrees, max_abs_err=gate,
                                       ms={k: [] for k in (*shapes, "segment")})
        print(f"[gate] {name}: agrees {agrees}; {gate}", flush=True)

    if args.sass:
        for name, lib in libs.items():
            hist = sass_histogram(lib._name)
            result["sources"][name]["sass"] = hist
            for fn_name, h in hist.items():
                top = sorted(h.items(), key=lambda kv: -kv[1])[:10]
                print(f"[sass] {name} {fn_name[-60:]}: {sum(h.values())} instructions; {top}",
                      flush=True)

    def copies(t):
        return [(t.clone(),) for _ in range(cs.n_copies(4 * t.numel()))]

    print(f"[clock] before timing: {sm_clock()}", flush=True)

    order = list(libs) + list(libs)[::-1]
    for name in order:
        fn = flat_fn(libs[name])
        for tag, (xf, w, sc, bi) in inputs.items():
            H, W = shapes[tag][3], shapes[tag][4]
            ms = cs.time_cuda(torch, lambda a: fn(a, w, sc, bi, H=H, W=W), copies(xf),
                              iters=ITERS)
            result["sources"][name]["ms"][tag].append(ms)
            print(f"[time] {name} {tag}: {ms * 1e3:.2f} us (bound "
                  f"{bounds[tag]['bound_ms'] * 1e3:.2f} us by {bounds[tag]['bound_by']})",
                  flush=True)
        seg = lambda a: cf._segment(a, *seg_p, 0.1, False, fn, None)
        ms = cs.time_cuda(torch, seg, copies(seg_x), iters=20)
        result["sources"][name]["ms"]["segment"].append(ms)
        print(f"[time] {name} segment: {ms * 1e3:.2f} us", flush=True)
    print(f"[clock] after timing: {sm_clock()}", flush=True)
    if args.sweep:
        # the floor: one tiny PyTorch kernel per graph node
        tiny = torch.zeros(4, device=dev)
        floor = cs.time_cuda(torch, torch.neg, [(tiny,)], iters=ITERS)
        result["graph_node_floor_ms"] = floor
        print(f"[sweep] a 4-element torch.neg per graph node: {floor * 1e3:.2f} us", flush=True)
        for name, lib in libs.items():
            fn = flat_fn(lib)
            sweep = result["sources"][name]["sweep"] = {}
            for tag, (xf, w, sc, bi) in inputs.items():
                H, W = shapes[tag][3], shapes[tag][4]
                for b_ in (1, 2, 4, 8):
                    ms = cs.time_cuda(torch, lambda a: fn(a, w, sc, bi, H=H, W=W),
                                      copies(xf[:b_].contiguous()), iters=ITERS)
                    sweep[f"{tag} B={b_}"] = ms
            print(f"[sweep] {name}: " + ", ".join(f"{k} {v * 1e3:.2f} us"
                                                  for k, v in sweep.items()), flush=True)
    for name, lib in libs.items():
        # the segment's device kernels, eager, under torch.profiler
        fn = flat_fn(lib)
        prof = cs.profile_request(torch, lambda: cf._segment(seg_x, *seg_p, 0.1, False, fn, None))
        result["sources"][name]["segment_profile"] = prof
        print(f"[profile] {name} segment: {prof['device_kernels']} kernels, busy "
              f"{prof['device_busy_ms'] * 1e3:.1f} us; "
              + "; ".join(f"{t['name'][:60]} x{t['count']} {t['ms'] * 1e3:.1f} us"
                          for t in prof["top"]), flush=True)
    print(json.dumps(result), flush=True)
    print(result["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
