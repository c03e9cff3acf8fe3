#!/usr/bin/env python3
"""Time K2 and K3, the port's fused 3x3 conv + BN affine + LeakyReLU in its
flat and its stacked-tap form, on one NVIDIA card, and compare versions of
their source.

    python3 scripts/bench_k2.py                       # the committed source
    python3 scripts/bench_k2.py --sources a.cu b.cu   # versions side by side

Each source (default: kd6d_pose_adlp_tpu_torch/csrc/conv3x3_bn_act.cu) is
built with the port's nvcc flags and called through the same C interfaces
as `ops/conv_fused.conv3x3_bn_act_flat` (K2) and `conv3x3_bn_act_stacked`
(K3), fp32 and bf16. Each is first held against the plain versions
(chip_smoke.kernel_gate: fp32 within ATOL_KERNEL, bf16 within one bf16
rounding, all columns) in both types at the serving shapes (B = 8: stem
3->8 @256², s2 8->16 @128²), at chip_smoke's VARIANT_SHAPES (B = 8: the
DarkNet variants' stems and DarkNet-19's 32->64, every shape
conv3x3_igemm serves on the main path) and at chip_smoke's K2 and
K3 edge shapes, then timed by CUDA-graph replay, inputs cycled past the L2
as in chip_smoke.time_cuda, the sources in turn and back (a, b, b, a): K2
and K3 in both types at all of those shapes, K2 also at the serving shapes
at the eval batch (B = 24), and the serving-stem segment
(`stem_s2_segment_flat`: conv, pool, conv, pool) in both forms and both
types built on that source's kernels; the flat fp32 segment's device
kernels are then listed (torch.profiler). The serving, eval-batch and
variant rows carry their bounds (chip_smoke.k2_bound / k3_bound). `--only`
keeps the cases and segments whose key holds one of its words (e.g.
`--only "K2 bfloat16 stem" "K2 bfloat16 s2"` gates and times the bf16
serving instances and their eval batch). The segments are held to the
plain versions stage by stage (chip_smoke.segment_gate). `--sweep` also times K2 and K3 at the
serving shapes at B = 1, 2, 4, 8 and one tiny graph node (a block's
latency against throughput); `--sass` prints the opcode counts of the
serving-instance kernels and conv3x3_igemm's instances (cuobjdump).
`--wide` takes in place of all of those chip_smoke's K2_WIDE shapes, the
widths where K2 runs conv3x3_rows (its last, 32->32 @960² fp32, is the
main path's): each source is held there against the plain version
(kernel_gate; fp32 also against the library conv on the valid columns),
then the sources and the library call (F.conv2d, the affine and
leaky_relu in the same dtype, TF32 off) are timed in turn and back (a, b,
cuDNN, cuDNN, b, a), with each shape's bound and plan (`--only` keeps the
shapes whose key holds a word). Prints one JSON line, then
the card's name and power limit; runs only on the card.

    python3 scripts/bench_k2.py --wide --sources parent.cu new.cu
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from _bench import build  # noqa: E402

ITERS = 100


def sass_histogram(lib_path):
    """Opcode counts of K2's and K3's kernels in the library
    (conv3x3_flat_*, conv3x3_stacked_*, conv3x3_igemm's instances, and a
    parent source's general kernel conv3x3_bn_act_kernel), from cuobjdump
    -sass: {kernel: {opcode: count}}."""
    from kd6d_pose_adlp_tpu_torch.utils import cuda_build as cb

    cuobjdump = os.path.join(os.path.dirname(cb.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    hist, cur = {}, None
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("Function :"):
            name = s.split(":", 1)[1].strip()
            keep = ("conv3x3_flat_" in name or "conv3x3_stacked" in name
                    or "conv3x3_igemm" in name or "conv3x3_rows" in name
                    or "conv3x3_bn_act_kernel" in name)
            cur = hist.setdefault(name, {}) if keep else None
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
                    help="print each source's opcode counts of its serving-instance kernels "
                         "and conv3x3_igemm's instances")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K2 and K3 at B = 1, 2, 4, 8 (per-block latency "
                         "against throughput)")
    ap.add_argument("--only", nargs="+", default=None,
                    help="keep only the cases and segments whose key holds one of these")
    ap.add_argument("--wide", action="store_true",
                    help="time K2 at chip_smoke's K2_WIDE shapes beside the cuDNN call")
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
    # the flat entry points' last two arguments: the flag conv3x3_rows sets
    # (passed as NULL) and that form's launch plan (a source that predates
    # either ignores the extra arguments)
    flat_args = [p, p, p, p, p, i, i, i, i, i, f, p, p, p]
    stacked_args = [p, p, p, p, p, i, i, i, i, f, p]
    libs = build(args.sources, {"conv3x3_bn_act_flat": flat_args,
                                "conv3x3_bn_act_stacked": stacked_args,
                                "conv3x3_bn_act_flat_bf16": flat_args,
                                "conv3x3_bn_act_stacked_bf16": stacked_args})
    suffix = {torch.float32: "", torch.bfloat16: "_bf16"}

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def flat_fn(lib):
        def run(xf, w, sc, bi, *, H, W, alpha=0.1):
            B, C, _ = xf.shape
            O = w.shape[1]
            out = torch.empty((B, O, H * (W + 2)), device=dev, dtype=xf.dtype)
            plan = cf.rows_plan(B, C, O, H, W, str(xf.dtype).removeprefix("torch."), sms)
            err = getattr(lib, "conv3x3_bn_act_flat" + suffix[xf.dtype])(
                xf.data_ptr(), w.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(),
                B, C, O, H, W, alpha, torch.cuda.current_stream().cuda_stream, None,
                (ctypes.c_int * len(plan))(*plan))
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return out
        return run

    def stacked_fn(lib):
        def run(xs, w, sc, bi, *, alpha=0.1):
            B, _, C, M = xs.shape
            O = w.shape[1]
            out = torch.empty((B, O, M), device=dev, dtype=xs.dtype)
            err = getattr(lib, "conv3x3_bn_act_stacked" + suffix[xs.dtype])(
                xs.data_ptr(), w.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(),
                B, C, O, M, alpha, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return out
        return run

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    if args.wide:
        return wide(torch, cf, libs, flat_fn, g, dev,
                    lambda key: args.only is None or any(w in key for w in args.only))

    def conv_inputs(B, C, O, H, W, dtype=torch.float32):
        _, w, sc, bi, _, xf = cs.conv_case(torch, cf, g, dev, B, C, O, H, W, dtype)
        return xf, w, sc, bi

    B, R, BE = cs.BATCH, cs.RES, cs.EVAL_BATCH
    shapes = {"stem": (B, 3, 8, R, R), "s2": (B, 8, 16, R // 2, R // 2)}
    shapes.update({tag: (B, C, O, H, H) for tag, C, O, H in cs.VARIANT_SHAPES})
    # K2 at the eval batch, where the evaluators run the eval-mode stem
    eval_shapes = {f"stem B={BE}": (BE, 3, 8, R, R), f"s2 B={BE}": (BE, 8, 16, R // 2, R // 2)}

    def kept(key):
        return args.only is None or any(word in key for word in args.only)
    # (key, shape, flat input, weights, scale, bias, kernel input) of K2 and
    # K3 in both types at the serving and variant shapes, then at their edge
    # shapes
    cases, bounds = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        elem = 2 if dtype == torch.bfloat16 else 4
        for form, edges, bound in (("K2", cs.K2_EDGES, cs.k2_bound),
                                   ("K3", cs.K3_EDGES, cs.k3_bound)):
            named = dict(shapes, **eval_shapes) if form == "K2" else dict(shapes)
            named.update({f"B={e[0]} {e[1]}->{e[2]} @{e[3]}x{e[4]}": e for e in edges})
            for tag, s in named.items():
                key = f"{form} {dname} {tag}"
                if not kept(key):
                    continue
                xf, w, sc, bi = conv_inputs(*s, dtype)
                inp = xf if form == "K2" else cf.stack_taps(xf, s[3], s[4])
                cases.append((key, s, xf, w, sc, bi, inp))
                if tag in shapes or tag in eval_shapes:
                    bounds[key] = dict(zip(("bound_ms", "bound_by"), bound(*s, elem=elem)))
    # the segment in each form and type: key -> (stacked, input, parameters)
    segments = {}
    for dtype, suffix_ in ((torch.float32, ""), (torch.bfloat16, " bfloat16")):
        forms = [(key + suffix_, stacked) for key, stacked in
                 (("segment", False), ("segment stacked", True)) if kept(key + suffix_)]
        if not forms:
            continue
        seg_x = torch.randn((B, R, R, 3), generator=g, device=dev).to(dtype)
        seg_p = (conv_inputs(*shapes["stem"], dtype)[1:]
                 + conv_inputs(*shapes["s2"], dtype)[1:])
        for key, stacked in forms:
            segments[key] = (stacked, seg_x, seg_p)

    result = {"card": cs.gpu_name_and_power(), "shapes": shapes, "bounds": bounds,
              "sources": {}}

    def kernel_call(lib, key, s, w, sc, bi):
        """The call of K2 or K3 (by key) from `lib` at shape s, on its input."""
        if key.startswith("K2"):
            fn, H, W = flat_fn(lib), s[3], s[4]
            return lambda a: fn(a, w, sc, bi, H=H, W=W)
        st = stacked_fn(lib)
        return lambda a: st(a, w, sc, bi)

    for name, lib in libs.items():
        gate, agrees = {}, True
        for key, s, xf, w, sc, bi, inp in cases:
            got = kernel_call(lib, key, s, w, sc, bi)(inp)
            torch.cuda.synchronize()
            want = cf.conv3x3_bn_act_flat_plain(xf, w, sc, bi, H=s[3], W=s[4])
            gate[key], ok = cs.kernel_gate(torch, got, want)
            agrees = agrees and ok
        for key, (stacked, seg_x, seg_p) in segments.items():
            fn, st = flat_fn(lib), stacked_fn(lib)
            got = cf._segment(seg_x, *seg_p, 0.1, stacked, True, fn, st)
            torch.cuda.synchronize()
            gate[key], ok = cs.segment_gate(torch, cf, got, seg_x, *seg_p)
            agrees = agrees and ok
        result["sources"][name] = dict(
            agrees=agrees, max_abs_err=gate,
            ms={k: [] for k in [c[0] for c in cases] + list(segments)})
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
        return [(t.clone(),) for _ in range(cs.n_copies(t.element_size() * t.numel()))]

    print(f"[clock] before timing: {sm_clock()}", flush=True)

    order = list(libs) + list(libs)[::-1]
    for name in order:
        lib = libs[name]
        for key, s, _, w, sc, bi, inp in cases:
            ms = cs.time_cuda(torch, kernel_call(lib, key, s, w, sc, bi), copies(inp),
                              iters=ITERS)
            result["sources"][name]["ms"][key].append(ms)
            bd = bounds.get(key)
            print(f"[time] {name} {key}: {ms * 1e3:.2f} us" + (
                f" (bound {bd['bound_ms'] * 1e3:.2f} us by {bd['bound_by']})" if bd else ""),
                flush=True)
        fn, st = flat_fn(lib), stacked_fn(lib)
        for key, (stacked, seg_x, seg_p) in segments.items():
            seg = lambda a: cf._segment(a, *seg_p, 0.1, stacked, True, fn, st)
            ms = cs.time_cuda(torch, seg, copies(seg_x), iters=20)
            result["sources"][name]["ms"][key].append(ms)
            print(f"[time] {name} {key}: {ms * 1e3:.2f} us", flush=True)
    print(f"[clock] after timing: {sm_clock()}", flush=True)
    if args.sweep:
        # the floor: one tiny PyTorch kernel per graph node
        tiny = torch.zeros(4, device=dev)
        floor = cs.time_cuda(torch, torch.neg, [(tiny,)], iters=ITERS)
        result["graph_node_floor_ms"] = floor
        print(f"[sweep] a 4-element torch.neg per graph node: {floor * 1e3:.2f} us", flush=True)
        for name, lib in libs.items():
            sweep = result["sources"][name]["sweep"] = {}
            for key, s, _, w, sc, bi, inp in cases:
                if key in bounds and key.split()[-1] in ("stem", "s2"):
                    for b_ in (1, 2, 4, 8):
                        sweep[f"{key} B={b_}"] = cs.time_cuda(
                            torch, kernel_call(lib, key, s, w, sc, bi),
                            copies(inp[:b_].contiguous()), iters=ITERS)
            print(f"[sweep] {name}: " + ", ".join(f"{k} {v * 1e3:.2f} us"
                                                  for k, v in sweep.items()), flush=True)
    for name, lib in libs.items():
        # the flat segment's device kernels, eager, under torch.profiler
        if "segment" not in segments:
            break
        fn = flat_fn(lib)
        _, seg_x, seg_p = segments["segment"]
        prof = cs.profile_request(torch, lambda: cf._segment(seg_x, *seg_p, 0.1, False, True, fn, None))
        result["sources"][name]["segment_profile"] = prof
        print(f"[profile] {name} segment: {prof['device_kernels']} kernels, busy "
              f"{prof['device_busy_ms'] * 1e3:.1f} us; "
              + "; ".join(f"{t['name'][:60]} x{t['count']} {t['ms'] * 1e3:.1f} us"
                          for t in prof["top"]), flush=True)
    print(json.dumps(result), flush=True)
    print(result["card"], flush=True)
    return 0


def wide(torch, cf, libs, flat_fn, g, dev, kept) -> int:
    """--wide: K2 at chip_smoke.K2_WIDE from each source beside the
    library call, gated first, then timed a, b, cuDNN, cuDNN, b, a."""
    import torch.nn.functional as F

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = []
    for B, C, O, H, W, dname in cs.K2_WIDE:
        if not kept(f"{C}->{O} @{H}x{W} B={B} {dname}"):
            continue
        dtype = getattr(torch, dname)
        k, w, sc, bi, x_nhwc, xf = cs.conv_case(torch, cf, g, dev, B, C, O, H, W, dtype)
        x_nchw = x_nhwc.permute(0, 3, 1, 2).contiguous()
        k_oihw, sc_l, bi_l = k.permute(3, 2, 0, 1).to(dtype).contiguous(), sc.to(dtype), bi.to(dtype)

        def library(xn, k_oihw=k_oihw, sc_l=sc_l, bi_l=bi_l, O=O):
            y = F.conv2d(xn, k_oihw, padding=1)
            return F.leaky_relu(y * sc_l.reshape(1, O, 1, 1) + bi_l.reshape(1, O, 1, 1), 0.1)

        key = f"{C}->{O} @{H}x{W} B={B} {dname}"
        bound_ms, bound_by, _, _ = cs.k2_bound(B, C, O, H, W, elem=x_nhwc.element_size())
        cases.append(dict(key=key, shape=(B, C, O, H, W), xf=xf, w=w, sc=sc, bi=bi,
                          x_nchw=x_nchw, library=library, bound_ms=bound_ms,
                          bound_by=bound_by,
                          plan=cf.rows_plan(B, C, O, H, W, dname, sms)._asdict()))

    def call(lib, c):
        fn, (_, _, _, H, W) = flat_fn(lib), c["shape"]
        return lambda a: fn(a, c["w"], c["sc"], c["bi"], H=H, W=W)

    result = {"card": cs.gpu_name_and_power(), "cases": {}, "sources": {}, "cudnn": {}}
    for c in cases:
        result["cases"][c["key"]] = dict(bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                                         plan=c["plan"])
        result["cudnn"][c["key"]] = []
    agrees = True
    for name, lib in libs.items():
        gate = {}
        for c in cases:
            _, _, _, H, W = c["shape"]
            got = call(lib, c)(c["xf"])
            torch.cuda.synchronize()
            want = cf.conv3x3_bn_act_flat_plain(c["xf"], c["w"], c["sc"], c["bi"], H=H, W=W)
            err, ok = cs.kernel_gate(torch, got, want)
            lib_err = (cf.flat_to_nhwc(got, H, W).float()
                       - c["library"](c["x_nchw"]).permute(0, 2, 3, 1).float()).abs().max().item()
            ok = ok and (got.dtype != torch.float32 or lib_err <= cs.ATOL_KERNEL)
            gate[c["key"]] = dict(max_abs_err=err, library_max_abs_err=lib_err, ok=ok)
            agrees = agrees and ok
        result["sources"][name] = dict(gate=gate, ms={c["key"]: [] for c in cases})
        print(f"[gate] {name}: " + "; ".join(
            f"{k} {v['max_abs_err']:.2e} / {v['library_max_abs_err']:.2e}"
            + ("" if v["ok"] else " FAILS") for k, v in gate.items()), flush=True)

    def copies(t):
        return [(t.clone(),) for _ in range(cs.n_copies(t.element_size() * t.numel()))]

    print(f"[clock] before timing: {sm_clock()}", flush=True)
    order = list(libs) + ["cudnn", "cudnn"] + list(libs)[::-1]
    for name in order:
        for c in cases:
            if name == "cudnn":
                ms = cs.time_cuda(torch, c["library"], copies(c["x_nchw"]), iters=ITERS)
                result["cudnn"][c["key"]].append(ms)
            else:
                ms = cs.time_cuda(torch, call(libs[name], c), copies(c["xf"]), iters=ITERS)
                result["sources"][name]["ms"][c["key"]].append(ms)
            print(f"[time] {name} {c['key']}: {ms * 1e3:.2f} us (bound "
                  f"{c['bound_ms'] * 1e3:.2f} us by {c['bound_by']})", flush=True)
    print(f"[clock] after timing: {sm_clock()}", flush=True)
    result["agrees"] = agrees
    print(json.dumps(result), flush=True)
    print(result["card"], flush=True)
    return 0 if agrees else 1


if __name__ == "__main__":
    sys.exit(main())
