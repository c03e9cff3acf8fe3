#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`kd6d_pose_adlp_tpu_torch`) on one NVIDIA
card: the quickest proof that the port builds, starts and answers on the GPU.

    python3 chip_smoke.py                  # all phases, one card
    python3 chip_smoke.py --phases kernel  # kernel checks and timings only
    python3 chip_smoke.py --phases train   # the KD steps only
    python3 chip_smoke.py --phases cli     # the training entry point's path only

Phases:
  set-up   builds the CUDA kernels from kd6d_pose_adlp_tpu_torch/csrc/ with
           nvcc (one process per source, all started together) and prints
           ptxas's register and spill lines.
  kernel   at the serving shapes (B=8: stem 3->8 @256², s2 8->16 @128²)
           holds K2 (conv3x3_bn_act_flat) and K3 (conv3x3_bn_act_stacked),
           and the stem segment in both forms, against their plain PyTorch
           versions on the card (atol 1e-4) and times each with CUDA events
           beside its bound, the plain version and one library call
           (F.conv2d / matmul + affine + leaky_relu, a yardstick only). The
           bound's operation term counts an instance that runs on the
           tensor cores (K2_MMA) as three TF32 products per product.
           K2 also at the edges of its mappings (K2_EDGES: the stem at
           255², 41x61 and 33x30, s2 at 67x61 and 30², and outside the two
           serving instances 16->64 @20², 5->12 @9x7), and K3 at its
           (K3_EDGES: each serving-instance kernel at B=1, odd M at both,
           a ragged tile at 30², the general kernel at 3->16 and 16->32),
           held the same way, times logged.
           Then K1 (sinkhorn_potentials) at the KD loss's shape (N = 128
           problems of P = T = 64 points in [0, 1]², a quarter of the
           weights zero) against its plain version: each of the four
           potentials over its real (weight > 0) and its padded points
           apart, max|kernel - plain| <= 1e-5 * max|plain| there (the self
           potentials a_x, b_y are ~1e-6 at real points and ~1e-2 at
           padded ones), and the divergence built from them (rtol 1e-4,
           atol 1e-6); the same at the edges of its thread mapping (N, P, T
           = 3, 1, 1; 5, 1, 128; 3, 128, 128; 7, 64, 37 balanced; 8, 37,
           128 balanced and biased; 4, 128, 5) and at the 128-point cap
           with the main path's N, every cloud keeping at least one real
           point; P = 129 must raise. Timed by CUDA-graph replay beside its
           bound and the plain version, at the main shape and (logged) at
           the cap. No single PyTorch call computes it.
  serving  builds the full-width darknet_tiny_h PoseNet from a seeded
           generator and answers requests of 8 synthetic 256² uint8 crops
           through build_infer_fn(device="cuda"): 4 requests on the default
           flat stem (K2 twice per request), then 2 on the stacked stem (K3
           twice per request). Launch counts are zeroed just before each
           run and read just after. Outputs must be finite and the network
           outputs (`infer.network`) must match the same weights run on the
           CPU (atol 1e-3), also under PyTorch's default precision flags
           (cuDNN TF32 on), which the endpoint overrides.
  pose     runs a planted ground-truth scene through the port's postprocess
           on the card: rotation error < 3 deg, translation error < 15 mm.
  train    builds the full-width darknet_tiny_h student and darknet53 teacher
           (head prior 0.5, so the random teacher's votes pass
           confidence_th) from seeded generators and runs
           engine/loop.train(device="cuda") for 10 steps on synthetic 256²
           batches of 16 (rendered on the host beforehand, then moved to the
           card): finite metrics, loss_kd > 0 and K1 launched once per step
           (counts zeroed just before, read just after). Median step ms,
           images/s and peak device memory after 2 warm-up steps; one
           profiled step (device activity only) for the idle share and the
           top kernels; the teacher's forward and voting timed alone. Then
           one step from the same weights, batch (B=2) and SSC draw on the
           card and on the CPU: metrics within rtol 1e-3, every parameter's
           gradient within ||g_card - g_cpu|| <= 1e-2 ||g_cpu|| (the worst
           parameter tensor), BN statistics within 1e-4 of their largest
           entry; the card's step again under PyTorch's default precision
           flags (cuDNN TF32 on), which the step overrides: metrics and
           gradients within the same limits.
  eval     240 synthetic images (10 chunks of 24 at 256², mixed classes)
           through the evaluators on the card. A planted scene (fabricated
           network outputs that decode to the ground truth, every fourth
           image with its own K, so the batched EPnP re-fit runs; injected
           draws) through ScanEvaluator on the card and on the CPU and
           through valid on the card: ADI.10d >= 99 for every class, the
           card's poses within 1e-3 (R) and 1e-3 relative (T) of the CPU's
           and their tables equal (AUC within AUC_ATOL), scan equal to
           streaming. Then the full-width darknet_tiny_h (seeded random
           weights, head prior 0.5) through ScanEvaluator.run, valid and
           detection_stats, each launching K2 once per chunk at each of its
           two shapes (counts zeroed just before each, read just after);
           scan equal to streaming; images/s (median of 3), a split of a
           scan run and one profiled chunk; then evaluate.main on 64 images
           from a state_dict file (table printed, preds.json written).
  cli      the training entry point's path at full width: the same student
           and teacher, a device pool of 4 synthetic batches of 16 at 256²
           on the card. (a) precompute_pool_votes (under PyTorch's default
           flags; it pins fp32 itself) against the live step's votes batch
           by batch, rtol 1e-5 / atol 1e-5, timed. (b) engine/loop.train
           with the pool and the cached teacher, 10 steps in 2 calls: K1
           once per step (counts zeroed just before, read just after); then
           4 timed calls of 5 cached steps (median step ms, images/s), peak
           memory, one profiled step (kernels, busy ms, idle share). (c) the
           live and the cached multi-step from the same weights and draws, 4
           steps over a 3-batch pool: metrics rtol 1e-4, parameters
           max|diff| < 5e-3, BN statistics rtol 1e-3 / atol 1e-4 (JAX's
           tests/test_cache_teacher.py). (d) train_kd.main (--config_file '',
           --device_pool 4 --steps_per_dispatch 5 --cache_teacher, the
           teacher from a temporary teacher.pt) to 6 steps: K1 once per
           step, the five files, the teacher's sanity evaluation and one
           student evaluation at step 6 with K2 once per chunk at each
           shape; then again to 8: "resumed from ... @ step 6", K1 twice.
           (e) evaluate.main on the run's final.ckpt, every tensor loaded.

TF32 is off for matmuls and convolutions throughout, so the comparisons are
fp32 against fp32 (the serving network, one KD step and the pool's cached
votes are also run under PyTorch's defaults). Prints the
per-kernel JSON line, the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Any failure raises before that line.
Details go to the --json_out file (default outputs/chip_smoke.json).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32, CUDA cores
TF32_FLOPS = 495e12            # H100 SXM TF32, tensor cores, dense (data sheet)
# special-function unit (expf/logf) results: 16 per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs at the 1.98 GHz boost clock
SFU_OPS_PER_S = 16 * 132 * 1.98e9
ATOL_KERNEL = 1e-4
ATOL_NETWORK = 1e-3
# the eval tables of one set of predictions from two devices: ADI and REP
# equal, AUC per class within this many points. AUC averages 1000 error
# thresholds 0.1 mm apart, finer than the fp32 spread of a pose between the
# card and the CPU (~1e-4 of the depth, ~0.1 mm); one image crossing one
# threshold moves its class's AUC by 0.1 / (images of the class) points
AUC_ATOL = 0.05
# K1 vs its plain version: max|kernel - plain| over max|plain|, per
# potential and per point group (real, padded); read at up to 2.5e-7 on an
# H100 at N=128, P=T=64
RTOL_POTENTIALS = 1e-5
# one KD step, card vs CPU: the worst parameter tensor's
# ||g_card - g_cpu|| / ||g_cpu||; read at 1.3e-3 (median 5.8e-4) on an H100,
# the KD term's near one-hot plan at eps = 1e-6 turning float noise in the
# potentials into ~1e-3 changes of its weights
RTOL_GRADIENTS = 1e-2
BATCH = 8
RES = 256
# the evaluators' chunk (reference test.py:114) and the eval set: 10 chunks
EVAL_BATCH = 24
EVAL_CHUNKS = 10
EVAL_RUNS = 3
TRAIN_STEPS = 10
TRAIN_WARMUP = 2
# the cli phase: its pool, the timed calls of the cached step, and the
# config file train_kd.main and evaluate.main read ('' = the defaults)
CLI_POOL = 4
CLI_TIMED_CALLS = 4
CLI_CONFIG_FILE = ""
CLI_EVAL_IMAGES = 64        # the synthetic eval split
# K2's edge shapes (B, C, O, H, W): the stem kernel at each row-shift
# remainder (W + 2) % 4 = 1, 3, 0 (M odd in the first two), the s2 kernel
# with M odd and with a ragged last tile, then two shapes of the general
# kernel
K2_EDGES = ((1, 3, 8, 255, 255), (1, 3, 8, 41, 61), (1, 3, 8, 33, 30),
            (3, 8, 16, 67, 61), (2, 8, 16, 30, 30), (2, 16, 64, 20, 20),
            (2, 5, 12, 9, 7))
# K3's edge shapes (B, C, O, H, W): each serving-instance kernel at B = 1
# (both with a ragged last tile), M = H * (W + 2) odd (the 4-byte path) at
# each instance, a ragged last tile at B = 2, then the general kernel at the
# eval stems of darknet ref and tiny (3 -> 16, 16 -> 32)
K3_EDGES = ((1, 3, 8, 256, 256), (1, 8, 16, 128, 128), (1, 3, 8, 41, 61),
            (3, 8, 16, 67, 61), (2, 8, 16, 30, 30), (2, 3, 16, 64, 64),
            (2, 16, 32, 32, 32))
# the (C, O) instances of K2 whose products run on the tensor cores in
# 3xTF32 (csrc/conv3x3_bn_act.cu, dispatch_flat)
K2_MMA = ((8, 16),)
CONV_SRC = "kd6d_pose_adlp_tpu_torch/csrc/conv3x3_bn_act.cu"
SINKHORN_SRC = "kd6d_pose_adlp_tpu_torch/csrc/sinkhorn_potentials.cu"
REPLACES = {
    "conv3x3_bn_act_flat": "kd6d_pose_adlp_tpu/ops/conv_pallas.py:105",
    "conv3x3_bn_act_stacked": "kd6d_pose_adlp_tpu/ops/conv_pallas.py:178",
    "sinkhorn_potentials": "kd6d_pose_adlp_tpu/ops/sinkhorn_pallas.py:128",
}


def log(*a):
    print(*a, flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_cuda(torch, fn, args_list, iters: int = 50, warmup: int = 5,
              graph: bool = True) -> float:
    """Mean ms per call over `iters` calls, cycling through `args_list` so the
    inputs come from HBM rather than L2, timed with CUDA events.

    graph=True captures the `iters` calls in one CUDA graph and times its
    replay: device time of back-to-back launches, without the host cost of
    each eager call (which for a ~10 us kernel is larger than the kernel).
    graph=False times the eager calls as issued."""
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    g = None
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fn(*args_list[i % len(args_list)])
        g.replay()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if graph:
        g.replay()
    else:
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del g
    return ms


def n_copies(nbytes: int) -> int:
    """Enough input copies to cycle through > 2x the 50 MB L2."""
    return max(2, math.ceil(100e6 / nbytes))


def conv_bound(in_bytes: int, B: int, C: int, O: int, M: int, mma: bool = False):
    """(bound_ms, bound_by, bytes, flops) of a fused 3x3 conv + affine +
    LeakyReLU (K2, K3) writing (B, O, M): bytes = the input once, the
    parameters, the output once, over HBM; operations = the products over
    fp32 on the CUDA cores, or with mma three TF32 products each (3xTF32)
    over the tensor cores' TF32 rate, plus the affine over fp32."""
    nbytes = in_bytes + 4 * (9 * O * C + 2 * O) + 4 * B * O * M
    conv = B * M * O * 2 * 9 * C
    flops = conv + 2 * B * M * O
    op_s = (3 * conv / TF32_FLOPS + (flops - conv) / FP32_FLOPS if mma
            else flops / FP32_FLOPS)
    byte_s = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(byte_s, op_s), "bytes" if byte_s >= op_s else "operations",
            nbytes, flops)


def k2_bound(B: int, C: int, O: int, H: int, W: int):
    """conv_bound of K2 (the flat form) on its (B, C, (H+2)(W+2)+2) slab."""
    return conv_bound(4 * B * C * ((H + 2) * (W + 2) + 2), B, C, O, H * (W + 2),
                      mma=(C, O) in K2_MMA)


def k3_bound(B: int, C: int, O: int, H: int, W: int):
    """conv_bound of K3 (the stacked form) on its (B, 9, C, H(W+2)) stack."""
    M = H * (W + 2)
    return conv_bound(4 * B * 9 * C * M, B, C, O, M)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(torch, F, cf, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    shapes = {"stem": (3, 8, RES, RES), "s2": (8, 16, RES // 2, RES // 2)}
    rows, params = [], {}
    # K2 and K3 at the serving batch; K2 also at the eval batch, where the
    # evaluators run the eval-mode stem once per chunk (K3 is off that path)
    for B, tag, (C, O, H, W) in [(BATCH, t, s) for t, s in shapes.items()] + \
            [(EVAL_BATCH, t, s) for t, s in shapes.items()]:
        M = H * (W + 2)
        k = torch.randn((3, 3, C, O), generator=g, device=dev) * (1.0 / math.sqrt(9 * C))
        w = cf.pack_weights(k)
        sc = torch.rand((O, 1), generator=g, device=dev) + 0.5
        bi = torch.randn((O, 1), generator=g, device=dev) * 0.1
        if B == BATCH:
            params[tag] = (k, w, sc, bi)
        x_nhwc = torch.randn((B, H, W, C), generator=g, device=dev)
        x_nchw = x_nhwc.permute(0, 3, 1, 2).contiguous()
        xf = cf.nhwc_to_flat(x_nhwc)
        xs = cf.stack_taps(xf, H, W)
        k_oihw = k.permute(3, 2, 0, 1).contiguous()
        w_mat = w.permute(1, 0, 2).reshape(O, 9 * C).contiguous()

        def library_flat(xn):
            y = F.conv2d(xn, k_oihw, padding=1)
            return F.leaky_relu(y * sc.reshape(1, O, 1, 1) + bi.reshape(1, O, 1, 1), 0.1)

        def library_stacked(xsn):
            y = torch.matmul(w_mat, xsn.reshape(B, 9 * C, M))
            return F.leaky_relu(y * sc + bi, 0.1)

        for name, inp, kern, plain, lib_fn, lib_inp in (
                ("conv3x3_bn_act_flat", xf,
                 lambda a: cf.conv3x3_bn_act_flat(a, w, sc, bi, H=H, W=W),
                 lambda a: cf.conv3x3_bn_act_flat_plain(a, w, sc, bi, H=H, W=W),
                 library_flat, x_nchw),
                ("conv3x3_bn_act_stacked", xs,
                 lambda a: cf.conv3x3_bn_act_stacked(a, w, sc, bi),
                 lambda a: cf.conv3x3_bn_act_stacked_plain(a, w, sc, bi),
                 library_stacked, xs))[:2 if B == BATCH else 1]:
            got = kern(inp)
            torch.cuda.synchronize()
            want = plain(inp)
            err = (got - want).abs().max().item()
            # the valid columns also against the library conv
            lib_err = (cf.flat_to_nhwc(got, H, W)
                       - library_flat(x_nchw).permute(0, 2, 3, 1)).abs().max().item()
            log(f"[kernel] {name} {tag} B={B}: max|kernel-plain| {err:.3e}, "
                f"max|kernel-library| (valid cols) {lib_err:.3e}")
            if not err <= ATOL_KERNEL or not lib_err <= ATOL_KERNEL:
                raise AssertionError(f"{name} {tag} disagrees with its plain version")
            in_bytes = 4 * inp.numel()
            copies = [(inp.clone(),) for _ in range(n_copies(in_bytes))]
            lib_copies = [(lib_inp.clone(),) for _ in range(n_copies(4 * lib_inp.numel()))]
            ms = time_cuda(torch, kern, copies)
            eager_ms = time_cuda(torch, kern, copies, graph=False)
            plain_ms = time_cuda(torch, plain, copies, iters=20)
            library_ms = time_cuda(torch, lib_fn, lib_copies)
            del copies, lib_copies
            if name == "conv3x3_bn_act_flat":
                bound_ms, bound_by, nbytes, flops = k2_bound(B, C, O, H, W)
            else:
                bound_ms, bound_by, nbytes, flops = k3_bound(B, C, O, H, W)
            rows.append(dict(
                name=name, shape=tag, C=C, O=O, H=H, W=W, B=B,
                route="cuda", source=CONV_SRC, replaces=REPLACES[name],
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, eager_ms=eager_ms,
                bytes=nbytes, flops=flops))
            log(f"[kernel] {name} {tag} B={B}: {ms * 1e3:.1f} us  (bound "
                f"{rows[-1]['bound_ms'] * 1e3:.1f} us by {rows[-1]['bound_by']}, "
                f"plain {plain_ms * 1e3:.1f} us, library {library_ms * 1e3:.1f} us; "
                f"eager call incl. host {eager_ms * 1e3:.1f} us)")

    conv_edges(torch, cf, dev, g, stacked=False)
    conv_edges(torch, cf, dev, g, stacked=True)

    # the whole stem segment, both forms, against the plain segment and the
    # NHWC library chain
    x = torch.randn((BATCH, RES, RES, 3), generator=g, device=dev)
    (k1, w1, s1, b1), (k2, w2, s2, b2) = params["stem"], params["s2"]

    def library_segment(xn):
        y = F.max_pool2d(cf.conv3x3_bn_act_ref(xn, k1, s1, b1).permute(0, 3, 1, 2), 2)
        p1 = y.permute(0, 2, 3, 1)
        y = F.max_pool2d(cf.conv3x3_bn_act_ref(p1, k2, s2, b2).permute(0, 3, 1, 2), 2)
        return p1, y.permute(0, 2, 3, 1)

    ref = library_segment(x)
    segment = []
    for stacked in (False, True):
        kern = lambda a: cf.stem_s2_segment_flat(a, w1, s1, b1, w2, s2, b2, stacked=stacked)
        plain = lambda a: cf.stem_s2_segment_flat_plain(a, w1, s1, b1, w2, s2, b2,
                                                        stacked=stacked)
        got, want = kern(x), plain(x)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        lib_err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        log(f"[kernel] stem_s2_segment_flat stacked={stacked}: max|seg-plain| "
            f"{err:.3e}, max|seg-library| {lib_err:.3e}")
        if not err <= ATOL_KERNEL or not lib_err <= ATOL_KERNEL:
            raise AssertionError(f"segment stacked={stacked} disagrees")
        copies = [(x.clone(),) for _ in range(n_copies(4 * x.numel()))]
        segment.append(dict(stacked=stacked, max_abs_err=err,
                            ms=time_cuda(torch, kern, copies, iters=20),
                            plain_ms=time_cuda(torch, plain, copies, iters=20),
                            library_ms=time_cuda(torch, library_segment, copies,
                                                 iters=20)))
        log(f"[kernel] segment stacked={stacked}: {json.dumps(segment[-1])}")
    return rows, segment


def conv_edges(torch, cf, dev, g, stacked: bool):
    """K2 at K2_EDGES, or K3 at K3_EDGES (stacked): the edges of their thread
    mappings and shapes of the general kernel. All columns against the plain
    version, the valid ones against the library conv; each time is logged,
    not a row of the kernels line."""
    name = "conv3x3_bn_act_stacked" if stacked else "conv3x3_bn_act_flat"
    for B, C, O, H, W in K3_EDGES if stacked else K2_EDGES:
        k = torch.randn((3, 3, C, O), generator=g, device=dev) * (1.0 / math.sqrt(9 * C))
        w = cf.pack_weights(k)
        sc = torch.rand((O, 1), generator=g, device=dev) + 0.5
        bi = torch.randn((O, 1), generator=g, device=dev) * 0.1
        x_nhwc = torch.randn((B, H, W, C), generator=g, device=dev)
        xf = cf.nhwc_to_flat(x_nhwc)
        if stacked:
            inp = cf.stack_taps(xf, H, W)
            kern = lambda a: cf.conv3x3_bn_act_stacked(a, w, sc, bi)
        else:
            inp = xf
            kern = lambda a: cf.conv3x3_bn_act_flat(a, w, sc, bi, H=H, W=W)
        got = kern(inp)
        torch.cuda.synchronize()
        err = (got - cf.conv3x3_bn_act_flat_plain(xf, w, sc, bi, H=H, W=W)).abs().max().item()
        lib_err = (cf.flat_to_nhwc(got, H, W)
                   - cf.conv3x3_bn_act_ref(x_nhwc, k, sc, bi)).abs().max().item()
        ms = time_cuda(torch, kern, [(inp.clone(),) for _ in range(n_copies(4 * inp.numel()))])
        log(f"[kernel] {name} edge B={B} {C}->{O} @{H}x{W}: max|kernel-plain| "
            f"{err:.3e}, max|kernel-library| (valid cols) {lib_err:.3e}; {ms * 1e3:.2f} us")
        if not err <= ATOL_KERNEL or not lib_err <= ATOL_KERNEL:
            raise AssertionError(f"{name} disagrees at B={B} {C}->{O} @{H}x{W}")


def potential_errors(got, want, a, b) -> dict:
    """K1 against its plain version: for each potential (a_x, b_y, a_y, b_x),
    max|got - want| and, over its real (weight > 0) and its padded points
    apart, that error over max|want| there. At the last eps (1e-6) the self
    potentials a_x, b_y are ~1e-6 at real points and ~1e-2 at padded ones,
    so one absolute tolerance over all points cannot see a wrong real-point
    self potential."""
    pots = {}
    for name, u, v, m in zip(("a_x", "b_y", "a_y", "b_x"), got, want, (a, b, b, a)):
        d, groups = (u - v).abs(), {}
        for grp, sel in (("real", m > 0), ("pad", m == 0)):
            if bool(sel.any()):
                groups[grp] = (d[sel].max() / v[sel].abs().max().clamp_min(1e-30)).item()
        pots[name] = dict(max_abs_err=d.max().item(), **groups)
    return pots


def potentials_agree(pots: dict) -> bool:
    return all(r <= RTOL_POTENTIALS for e in pots.values() for k, r in e.items()
               if k != "max_abs_err")


def sinkhorn_kernel(torch, sf, dev):
    """K1 at the KD loss's shape against its plain version, and its time."""
    from kd6d_pose_adlp_tpu_torch.config import Config
    from kd6d_pose_adlp_tpu_torch.ops import sinkhorn as sk

    cfg = Config()
    kd = cfg.kd
    # one problem per (image, keypoint): B * 8 clouds of max_pos student and
    # max_teacher_cells teacher points
    N, P, T = cfg.solver.ims_per_batch * 8, cfg.solver.max_pos, kd.max_teacher_cells
    kw = dict(p=kd.p, blur=kd.blur, scaling=kd.scaling, reach=kd.reach, diameter=2.0,
              debias=True)
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def problems(n, p_, t_):
        x = torch.rand((n, p_, 2), generator=g, device=dev)
        y = torch.rand((n, t_, 2), generator=g, device=dev)

        def w(*s):
            # a quarter of the points padded, the first point of every cloud
            # kept real (a cloud of padding alone has no divergence, and its
            # ~1e29 potentials would swamp the padded points' gate)
            keep = torch.rand(s, generator=g, device=dev) >= 0.25
            keep[:, 0] = True
            return (0.1 + 0.9 * torch.rand(s, generator=g, device=dev)) * keep
        return x, y, w(n, p_), w(n, t_)

    def compare(x, y, a, b, **kw_):
        args = (x, y, sk._safe_log_weights(a), sk._safe_log_weights(b))
        got = sf.solve_potentials(*args, **kw_)
        torch.cuda.synchronize()
        with torch.no_grad():
            want = sf.solve_potentials_plain(*args, **kw_)
            pots = potential_errors(got, want, a, b)
            dg = sk.sinkhorn_value(x, y, a, b, got, **kw_)
            dw = sk.sinkhorn_value(x, y, a, b, want, **kw_)
        ok = potentials_agree(pots) and bool(torch.allclose(dg, dw, rtol=1e-4, atol=1e-6))
        div_err = (dg - dw).abs().max().item()
        return args, pots, ok, div_err, dw

    def show(pots):
        return "; ".join(f"{n} {e['max_abs_err']:.2e} ("
                         + ", ".join(f"{g} {e[g]:.2e}" for g in ("real", "pad") if g in e)
                         + ")" for n, e in pots.items())

    x, y, a, b = problems(N, P, T)
    args, pots, ok, div_err, div = compare(x, y, a, b, **kw)
    err = max(e["max_abs_err"] for e in pots.values())
    log(f"[kernel] sinkhorn_potentials N={N} P={P} T={T}: max|kernel-plain| "
        f"(over max|plain| at real, padded points): {show(pots)}; divergence "
        f"{div_err:.3e} (|divergence| up to {div.abs().max().item():.3e})")
    if not ok:
        raise AssertionError("sinkhorn_potentials disagrees with its plain version")
    # other sizes the kernel takes (P != T, the 128-point cap, the balanced
    # and biased forms) and the edges of its thread mapping (one point; 4, 2
    # and 1 lanes per row; a row of exactly 128 columns; passes that split
    # a warp); above 128 it raises
    for (n, p_, t_), kw_ in (((8, 37, 128), dict(kw, reach=None, debias=False)),
                             ((4, 128, 5), dict(kw, debias=True)),
                             ((3, 1, 1), kw),
                             ((5, 1, 128), kw),
                             ((3, 128, 128), dict(kw, debias=True)),
                             ((7, 64, 37), dict(kw, reach=None))):
        _, pe, ok, de, _ = compare(*problems(n, p_, t_), **kw_)
        log(f"[kernel] sinkhorn_potentials N={n} P={p_} T={t_} reach={kw_['reach']} "
            f"debias={kw_['debias']}: {show(pe)}; divergence {de:.3e}")
        if not ok:
            raise AssertionError(f"sinkhorn_potentials disagrees at P={p_}, T={t_}")
    try:
        sf.solve_potentials(*problems(1, 129, 4)[:2], torch.zeros((1, 129), device=dev),
                            torch.zeros((1, 4), device=dev), **kw)
    except ValueError:
        pass
    else:
        raise AssertionError("sinkhorn_potentials took P = 129")

    kern = lambda *t: sf.solve_potentials(*t, **kw)
    plain = lambda *t: sf.solve_potentials_plain(*t, **kw)
    n_eps = len(sk.schedule(kd.p, kd.blur, kd.scaling, kd.reach, 2.0)[0])

    def bound(args_, p_, t_):
        """(bound s, bytes, expf count, SFU ops, bound_by) of one solve: per
        eps 4 softmin passes (x over y, y over x, x over x, y over y), one
        expf per (row, column) and one logf per row; ~10 fp32 operations per
        (row, column) for the cost, the scale, the max and the sum."""
        n = args_[0].shape[0]
        nbytes = 4 * sum(t.numel() for t in args_) + 4 * n * 2 * (p_ + t_)
        pairs_ = n * n_eps * (2 * p_ * t_ + p_ * p_ + t_ * t_)
        sfu_ = pairs_ + n * n_eps * 2 * (p_ + t_)
        byte_s_ = nbytes / HBM_BYTES_PER_S
        op_s_ = max(sfu_ / SFU_OPS_PER_S, 10 * pairs_ / FP32_FLOPS)
        return (max(byte_s_, op_s_), nbytes, pairs_, sfu_,
                "bytes" if byte_s_ >= op_s_ else "operations")

    def timed(args_):
        copies = [tuple(t.clone() for t in args_) for _ in range(n_copies(4 * sum(
            t.numel() for t in args_)))]
        ms_, eager_ = time_cuda(torch, kern, copies), time_cuda(torch, kern, copies,
                                                                graph=False)
        with torch.no_grad():
            plain_ = time_cuda(torch, plain, copies, iters=20)
        return ms_, eager_, plain_

    # the 128-point cap at the main path's N, held by the same gate and timed
    # (logged, not a row of the kernels line)
    cap_args, cap_pots, ok, cap_div, _ = compare(*problems(N, 128, 128), **kw)
    if not ok:
        raise AssertionError("sinkhorn_potentials disagrees at P = T = 128")
    cap_ms, _, cap_plain = timed(cap_args)
    cap_bound_s, *_, cap_by = bound(cap_args, 128, 128)
    log(f"[kernel] sinkhorn_potentials at the cap, N={N} P=T=128: {show(cap_pots)}; "
        f"divergence {cap_div:.3e}; {cap_ms * 1e3:.1f} us (bound {cap_bound_s * 1e6:.1f} us "
        f"by {cap_by}, plain {cap_plain * 1e3:.1f} us)")

    ms, eager_ms, plain_ms = timed(args)
    bound_s, nbytes, pairs, sfu_ops, bound_by = bound(args, P, T)
    row = dict(name="sinkhorn_potentials", shape=f"N={N} P={P} T={T} eps={n_eps}",
               route="cuda", source=SINKHORN_SRC, replaces=REPLACES["sinkhorn_potentials"],
               max_abs_err=err, potentials=pots, divergence_max_abs_err=div_err, ms=ms,
               plain_ms=plain_ms, bound_ms=1e3 * bound_s, bound_by=bound_by,
               library_ms=None, eager_ms=eager_ms, bytes=nbytes,
               expf=pairs, sfu_ops=sfu_ops, P=P, T=T,
               cap=dict(N=N, P=128, T=128, ms=cap_ms, plain_ms=cap_plain,
                        bound_ms=1e3 * cap_bound_s))
    log(f"[kernel] sinkhorn_potentials: {ms * 1e3:.1f} us  (bound "
        f"{row['bound_ms'] * 1e3:.1f} us by {row['bound_by']}: {pairs / 1e6:.1f} M expf; "
        f"plain {plain_ms * 1e3:.1f} us; no single PyTorch call computes it; eager call "
        f"incl. host {eager_ms * 1e3:.1f} us)")
    return row


# ---------------------------------------------------------------------------
# serving phase
# ---------------------------------------------------------------------------

def profile_request(torch, fn) -> dict:
    """Device kernels, their summed device time and the top kernels by
    device time for one call of fn, from torch.profiler (CUPTI), and the
    wall time of that same call (profiler overhead included). Only device
    activity is traced: host op recording more than doubles the wall time
    of this launch-bound request."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    by_name = {}
    for e in kern:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return dict(device_kernels=len(kern), device_busy_ms=busy_us / 1e3,
                wall_ms=wall_ms, top=[dict(name=n[:80], count=c, ms=t / 1e3) for n, (c, t) in top])


def serving_phase(torch, cf, dev, tf32_defaults, n_flat: int = 4, n_stacked: int = 2):
    """tf32_defaults: PyTorch's (matmul, cuDNN) allow_tf32 flags as they were
    before main turned TF32 off."""
    from kd6d_pose_adlp_tpu_torch.config import Config
    from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
    from kd6d_pose_adlp_tpu_torch.engine.serving import SINGLE_KEYS, build_infer_fn
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net

    cfg = Config()
    assert cfg.model.backbone == "darknet_tiny_h" and cfg.model.input_res == RES
    ds = SyntheticPoseDataset(n_fg=cfg.data.n_fg, input_res=RES, seed=0)
    gen = torch.Generator()
    gen.manual_seed(0)
    net = init_pose_net(PoseNet(cfg.model, n_fg=cfg.data.n_fg), gen)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    infer = build_infer_fn(cfg, ds.consts(device=dev), net, device=dev)
    log(f"[serving] PoseNet darknet_tiny_h, {sum(p.numel() for p in net.parameters())} "
        f"params, {cfg.model.num_cells} cells, TestConfig {cfg.test}")

    reqs = [ds.requests(range(BATCH * r, BATCH * (r + 1)))
            for r in range(1 + n_flat + n_stacked)]

    def serve(fn, req, seed):
        tm = {}
        t0 = time.perf_counter()
        out = fn(req["images"], req["bbox_trans"], req["class_ids"], seed=seed,
                 timings=tm)
        torch.cuda.synchronize()
        tm["total_s"] = time.perf_counter() - t0
        for k in SINGLE_KEYS:
            if out[k].is_floating_point() and not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"non-finite serving output {k}")
        tm["valid_images"] = int(out["valid"].sum())
        tm["valid_votes"] = int(out["vote_valid"].sum())
        return out, tm

    # each stem form launches its kernel once per request at each of the two
    # (C, O) shapes of the segment
    seg_shapes = ((3, 8), (8, 16))

    def check_launches(name, n_requests):
        by_shape = dict(cf.launches)
        for c, o in seg_shapes:
            if by_shape.get((name, c, o), 0) != n_requests:
                raise AssertionError(f"{name} {c}->{o} was not launched once per "
                                     f"request: {by_shape}")
        return by_shape

    def per_kernel(by_shape):
        totals = {}
        for (n, _, _), v in by_shape.items():
            totals[n] = totals.get(n, 0) + v
        return totals

    serve(infer, reqs[0], 0)                                # warm-up, not counted
    cf.reset_launch_counts()
    lat = [serve(infer, reqs[1 + r], r)[1] for r in range(n_flat)]
    by_shape_flat = check_launches("conv3x3_bn_act_flat", n_flat)
    counts_flat = per_kernel(by_shape_flat)
    shapes_flat = {f"{n}:{c}->{o}": v for (n, c, o), v in by_shape_flat.items()}
    log(f"[serving] flat stem, {n_flat} requests: launches {counts_flat} {shapes_flat}")
    for i, t in enumerate(lat):
        log(f"[serving] request {i}: {t['total_s'] * 1e3:.1f} ms "
            f"(network {t['network_s'] * 1e3:.1f} ms, postprocess "
            f"{t['postprocess_s'] * 1e3:.1f} ms; {t['valid_images']} valid images, "
            f"{t['valid_votes']} votes)")

    # one more request under torch.profiler: device busy time and launches
    req = reqs[1]
    prof = profile_request(torch, lambda: infer(req["images"], req["bbox_trans"],
                                                req["class_ids"], seed=0))
    log(f"[serving] profiled request: {prof['device_kernels']} device kernels, "
        f"device busy {prof['device_busy_ms']:.1f} ms of its "
        f"{prof['wall_ms']:.1f} ms wall time; top: {prof['top']}")

    # the same weights on the CPU: the endpoint's network calls must agree
    cpu = build_infer_fn(cfg, ds.consts(device="cpu"), state, device="cpu")
    gc, gr = infer.network(req["images"])
    cc, cr = cpu.network(req["images"])
    net_err = max((gc.cpu() - cc).abs().max().item(), (gr.cpu() - cr).abs().max().item())
    log(f"[serving] network cls/reg, card vs CPU: max abs diff {net_err:.3e}")
    if not net_err <= ATOL_NETWORK:
        raise AssertionError("card and CPU network outputs disagree")
    # the same comparison under PyTorch's default precision flags, as a
    # caller of build_infer_fn runs it: the endpoint pins fp32 itself
    fp32_flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    try:
        dc, dr = infer.network(req["images"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = fp32_flags
    net_err_default = max((dc.cpu() - cc).abs().max().item(), (dr.cpu() - cr).abs().max().item())
    log(f"[serving] network cls/reg, card under PyTorch's default flags (matmul TF32 "
        f"{tf32_defaults[0]}, cuDNN TF32 {tf32_defaults[1]}) vs CPU: max abs diff "
        f"{net_err_default:.3e} (gate ATOL_NETWORK {ATOL_NETWORK:g})")
    if not net_err_default <= ATOL_NETWORK:
        raise AssertionError("under PyTorch's default flags the card's network misses the CPU")

    # the stacked stem (K3) on the same weights
    net_st = PoseNet(cfg.model, n_fg=cfg.data.n_fg, stem_stacked=True)
    net_st.load_state_dict(state, strict=True)
    infer_st = build_infer_fn(cfg, ds.consts(device=dev), net_st, device=dev)
    serve(infer_st, reqs[0], 0)
    cf.reset_launch_counts()
    lat_st = [serve(infer_st, reqs[1 + n_flat + r], r)[1] for r in range(n_stacked)]
    by_shape_st = check_launches("conv3x3_bn_act_stacked", n_stacked)
    counts_st = per_kernel(by_shape_st)
    log(f"[serving] stacked stem, {n_stacked} requests: launches {counts_st}")
    sc_, sr_ = infer_st.network(req["images"])
    st_err = max((sc_ - gc).abs().max().item(), (sr_ - gr).abs().max().item())
    log(f"[serving] stacked vs flat stem network outputs: max abs diff {st_err:.3e}")
    if not st_err <= ATOL_NETWORK:
        raise AssertionError("stacked and flat stems disagree")

    mean = lambda xs, k: sum(x[k] for x in xs) / len(xs)
    summary = dict(
        batch=BATCH, requests_flat=n_flat, requests_stacked=n_stacked,
        request_ms=[1e3 * t["total_s"] for t in lat],
        network_ms=[1e3 * t["network_s"] for t in lat],
        postprocess_ms=[1e3 * t["postprocess_s"] for t in lat],
        mean_request_ms=1e3 * mean(lat, "total_s"),
        mean_network_ms=1e3 * mean(lat, "network_s"),
        mean_postprocess_ms=1e3 * mean(lat, "postprocess_s"),
        stacked_request_ms=[1e3 * t["total_s"] for t in lat_st],
        launches_flat_run=counts_flat, launches_flat_run_by_shape=shapes_flat,
        launches_stacked_run=counts_st, network_card_vs_cpu=net_err,
        network_card_vs_cpu_default_flags=net_err_default, default_tf32_flags=tf32_defaults,
        stacked_vs_flat=st_err, profile=prof)
    # busy and wall time of the same (profiled) request
    summary["device_idle_share"] = (
        1.0 - prof["device_busy_ms"] / prof["wall_ms"]
        if prof["device_busy_ms"] > 0 else None)
    # (name, C, O) -> launches; each stem form's run launches only its kernel
    return summary, {**by_shape_flat, **by_shape_st}


# ---------------------------------------------------------------------------
# pose phase
# ---------------------------------------------------------------------------

def pose_phase(torch, dev):
    import numpy as np

    from kd6d_pose_adlp_tpu_torch.config import Config
    from kd6d_pose_adlp_tpu_torch.data.batch import TaskConsts
    from kd6d_pose_adlp_tpu_torch.engine.postprocess import build_postprocess
    from kd6d_pose_adlp_tpu_torch.models import anchors as anchor_lib
    from kd6d_pose_adlp_tpu_torch.utils import geometry as geo

    cfg = Config()
    m = cfg.model
    n_fg = cfg.data.n_fg
    K = cfg.data.internal_K_np()
    rng = np.random.default_rng(0)
    kp3d = np.stack([np.array([[sx * (30 + c), sy * 25, sz * 40]
                               for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                              np.float32) for c in range(n_fg)])
    cls_gt = 3
    R_gt = geo.quaternion2rotation(rng.normal(size=4)).astype(np.float32)
    T_gt = np.array([20.0, -15.0, 820.0], np.float32)
    proj = geo.project_points(K, R_gt, T_gt, kp3d[cls_gt])
    Mc = geo.dzi_affine(proj.mean(0), 260.0, RES)
    kp_crop = geo.apply_affine(Mc, proj)
    anchors = anchor_lib.make_anchors(RES, m.level_strides, m.level_sizes)
    A = anchors.shape[0]
    logits = np.full((A, n_fg), -8.0, np.float32)
    hot = rng.choice(A, 30, replace=False)
    logits[hot, cls_gt] = rng.uniform(-1.5, 3.0, size=30)
    noisy = kp_crop[None] + rng.normal(scale=1.0, size=(A, 8, 2)).astype(np.float32)
    enc = np.concatenate([(noisy[..., 0] - anchors[:, None, 0]) / anchors[:, None, 2],
                          (noisy[..., 1] - anchors[:, None, 1]) / anchors[:, None, 3]], -1)
    reg = np.tile(enc[:, None, :], (1, n_fg, 1)).reshape(A, n_fg * 16).astype(np.float32)

    pp = build_postprocess(cfg, TaskConsts.create(K, kp3d, np.full(n_fg, 150.0), device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = pp(torch.as_tensor(logits, device=dev)[None],
                 torch.as_tensor(reg, device=dev)[None],
                 torch.tensor([cls_gt], device=dev),
                 torch.as_tensor(Mc, device=dev)[None], generator=gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    def rot_deg(Ra, Rb):
        # from the chord |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2): stable near 0,
        # where arccos of the fp32 trace floors at a few hundredths of a degree
        d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
        return float(np.degrees(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0))))

    R = out["R"][0].cpu().numpy()
    T = out["T"][0].cpu().numpy()
    rot = rot_deg(R_gt, R)
    trans = float(np.linalg.norm(T - T_gt))
    log(f"[pose] planted scene: valid {bool(out['valid'][0])}, inliers "
        f"{int(out['n_inliers'][0])}, rotation error {rot:.3f} deg, translation "
        f"error {trans:.3f} mm, postprocess {dt * 1e3:.1f} ms (B=1)")
    if not (bool(out["valid"][0]) and rot < 3.0 and trans < 15.0):
        raise AssertionError("planted-scene pose is off")

    # the same scene and RANSAC draws through the postprocess on the CPU:
    # the card's pose math must agree with it
    from kd6d_pose_adlp_tpu_torch.ops.epnp import sample_gumbel
    t = cfg.test
    gumbel = sample_gumbel((1, t.ransac_iters, t.max_votes * 8),
                           torch.Generator().manual_seed(1), "cpu")
    args = (torch.as_tensor(logits)[None], torch.as_tensor(reg)[None],
            torch.tensor([cls_gt]), torch.as_tensor(Mc)[None])
    pp_cpu = build_postprocess(cfg, TaskConsts.create(K, kp3d, np.full(n_fg, 150.0),
                                                      device="cpu"))
    with torch.inference_mode():
        card = pp(*(a.to(dev) for a in args), gumbel=gumbel.to(dev))
        host = pp_cpu(*args, gumbel=gumbel)
    Rc, Rh = card["R"][0].cpu().numpy(), host["R"][0].numpy()
    rot_ch = rot_deg(Rh, Rc)
    trans_ch = float(np.linalg.norm(card["T"][0].cpu().numpy() - host["T"][0].numpy()))
    same_votes = bool(torch.equal(card["vote_valid"].cpu(), host["vote_valid"]))
    same_inliers = int(card["n_inliers"][0]) == int(host["n_inliers"][0])
    log(f"[pose] same draws, card vs CPU: votes equal {same_votes}, inliers equal "
        f"{same_inliers}, rotation {rot_ch:.4f} deg, translation {trans_ch:.4f} mm")
    if not (same_votes and same_inliers and rot_ch < 0.1 and trans_ch < 0.5):
        raise AssertionError("card and CPU postprocess disagree")
    return dict(rotation_err_deg=rot, translation_err_mm=trans,
                n_inliers=int(out["n_inliers"][0]), postprocess_ms=1e3 * dt,
                card_vs_cpu_rotation_deg=rot_ch, card_vs_cpu_translation_mm=trans_ch)


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def train_configs():
    """The KD configuration: darknet_tiny_h student and darknet53 teacher at
    the repo defaults, the teacher's head prior raised to 0.5."""
    import dataclasses

    from kd6d_pose_adlp_tpu_torch.config import Config

    cfg = Config()
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, max_iter=TRAIN_STEPS))
    cfg_t = cfg.replace(model=dataclasses.replace(cfg.model, backbone="darknet53",
                                                  prior=0.5))
    assert cfg.model.backbone == "darknet_tiny_h" and cfg.model.input_res == RES
    return cfg, cfg_t


def one_step(torch, cfg, cfg_t, consts, student_sd, teacher_sd, batch, uniform, dev):
    """One KD step from the given weights on `dev`: metrics, the student's
    state_dict after it and the step's gradient of each parameter, on the
    CPU."""
    from kd6d_pose_adlp_tpu_torch.engine import steps
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet

    n_fg = cfg.data.n_fg
    net = PoseNet(cfg.model, n_fg=n_fg)
    net.load_state_dict(student_sd, strict=True)
    teacher = PoseNet(cfg_t.model, n_fg=n_fg)
    teacher.load_state_dict(teacher_sd, strict=True)
    opt = steps.make_optimizer(cfg)
    state = steps.create_train_state(cfg, net.to(dev), opt)
    step = steps.build_train_step(cfg, cfg_t, consts.to(dev), net, teacher.to(dev), opt)
    _, m = step(state, batch.to(dev), uniform=uniform.to(dev))
    return ({k: float(v) for k, v in m.items()},
            {k: v.detach().cpu() for k, v in net.state_dict().items()},
            {k: p.grad.detach().cpu() for k, p in net.named_parameters()
             if p.grad is not None})


def train_phase(torch, sf, dev, tf32_defaults):
    import statistics

    from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
    from kd6d_pose_adlp_tpu_torch.engine import steps
    from kd6d_pose_adlp_tpu_torch.engine.loop import train
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net

    cfg, cfg_t = train_configs()
    n_fg, B = cfg.data.n_fg, cfg.solver.ims_per_batch
    ds = SyntheticPoseDataset(n_fg=n_fg, input_res=RES, seed=0)
    t0 = time.perf_counter()
    batches = [ds.batch(range(B * i, B * (i + 1))).to(dev) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    teacher = init_pose_net(PoseNet(cfg_t.model, n_fg=n_fg),
                            torch.Generator().manual_seed(1))
    teacher_sd = {k: v.clone() for k, v in teacher.state_dict().items()}
    consts = ds.consts(device=dev)
    log(f"[train] student {cfg.model.backbone} ({cfg.model.out_channel}-wide FPN, "
        f"{cfg.model.num_levels} levels), teacher {cfg_t.model.backbone} "
        f"({sum(p.numel() for p in teacher.parameters())} params, "
        f"{cfg_t.model.num_levels} levels), {TRAIN_STEPS} steps of B={B} at {RES}²; "
        f"batches rendered in {render_s:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    sf.reset_launch_counts()
    # a fresh working_dir: train resumes from its latest.ckpt by default
    with tempfile.TemporaryDirectory() as wd:
        state, hist = train(cfg, consts, iter(batches), cfg_t=cfg_t,
                            teacher_state_dict=teacher_sd, device=dev, log_every=1,
                            working_dir=wd, verbose=False)
    launches = dict(sf.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    k1 = launches.get(("sinkhorn_potentials", cfg.solver.max_pos,
                       cfg.kd.max_teacher_cells), 0)
    for h in hist:
        log(f"[train] step {h['step']}: {h['step_ms']:.1f} ms, loss_total "
            f"{h['loss_total']:.4f} (cls {h['loss_cls']:.4f}, reg {h['loss_reg']:.4f}, "
            f"kd {h['loss_kd']:.5f}), num_pos {h['num_pos']:.0f}, grad_norm "
            f"{h['grad_norm']:.3f}")
    log(f"[train] K1 launches over the {TRAIN_STEPS} steps: {launches}")
    if state.step != TRAIN_STEPS or len(hist) != TRAIN_STEPS:
        raise AssertionError(f"train ran {state.step} steps, logged {len(hist)}")
    for h in hist:
        if not all(math.isfinite(v) for v in h.values()):
            raise AssertionError(f"non-finite train metrics {h}")
        if not (h["loss_kd"] > 0 and h["num_pos"] > 0):
            raise AssertionError(f"KD term or positives missing at step {h['step']}: {h}")
    if k1 != TRAIN_STEPS:
        raise AssertionError(f"sinkhorn_potentials launched {k1} times in "
                             f"{TRAIN_STEPS} steps, not once per step")
    step_ms = [h["step_ms"] for h in hist[TRAIN_WARMUP:]]
    med = statistics.median(step_ms)
    log(f"[train] median step {med:.2f} ms over steps {TRAIN_WARMUP + 1}-{TRAIN_STEPS} "
        f"(min {min(step_ms):.2f}, max {max(step_ms):.2f}): {1e3 * B / med:.1f} images/s; "
        f"peak device memory {peak_gb:.2f} GiB")

    # one more step of the same run under torch.profiler
    teacher_dev = PoseNet(cfg_t.model, n_fg=n_fg)
    teacher_dev.load_state_dict(teacher_sd, strict=True)
    step = steps.build_train_step(cfg, cfg_t, consts, state.net,
                                  teacher_dev.to(dev).eval(), steps.make_optimizer(cfg))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    holder = {}

    def one():
        holder["state"], m = step(state, batches[0], generator=gen)
        holder["m"] = {k: float(v) for k, v in m.items()}

    prof = profile_request(torch, one)
    idle = 1.0 - prof["device_busy_ms"] / prof["wall_ms"]
    log(f"[train] profiled step: {prof['device_kernels']} device kernels, device busy "
        f"{prof['device_busy_ms']:.1f} ms of its {prof['wall_ms']:.1f} ms wall time "
        f"(idle share {idle:.3f}); top: {prof['top']}")
    # the teacher's share of a step: its forward and voting alone (eager
    # calls between CUDA events)
    teacher_ms = time_cuda(torch, lambda b: steps.teacher_votes(cfg, cfg_t, teacher_dev, b),
                           [(b,) for b in batches], iters=5, warmup=1, graph=False)
    log(f"[train] teacher forward + voting alone: {teacher_ms:.2f} ms per B={B} batch")

    # one step from the same weights, batch and SSC draw on the card and the CPU
    student = init_pose_net(PoseNet(cfg.model, n_fg=n_fg), torch.Generator().manual_seed(2))
    student_sd = {k: v.clone() for k, v in student.state_dict().items()}
    small = ds.batch(range(2))
    uniform = torch.rand((2, cfg.model.num_cells, ds.max_objs),
                         generator=torch.Generator().manual_seed(3))
    mc, sc, gc = one_step(torch, cfg, cfg_t, consts, student_sd, teacher_sd, small,
                          uniform, dev)
    mh, sh, gh = one_step(torch, cfg, cfg_t, ds.consts(device="cpu"), student_sd,
                          teacher_sd, small, uniform, "cpu")
    stat = lambda k: k.endswith(("running_mean", "running_var"))
    st_rel = max(float((sc[k] - sh[k]).abs().max() / sh[k].abs().max().clamp_min(1e-12))
                 for k in sc if stat(k))
    met_rel = {k: abs(mc[k] - mh[k]) / max(abs(mh[k]), 1e-12) for k in mh}
    if set(gc) != set(gh):
        raise AssertionError(f"gradients on the card for {sorted(set(gc) ^ set(gh))} "
                             "but not on the CPU, or the other way round")
    # the gradients, not the updated parameters: Adam's first update is
    # about lr * sign(g) whatever |g| is
    g_rel = {k: float(torch.linalg.vector_norm(gc[k] - gh[k])
                      / torch.linalg.vector_norm(gh[k]).clamp_min(1e-30)) for k in gh}
    worst = max(g_rel, key=g_rel.get)
    g_all = float(torch.linalg.vector_norm(torch.cat([(gc[k] - gh[k]).reshape(-1) for k in gh]))
                  / torch.linalg.vector_norm(torch.cat([gh[k].reshape(-1) for k in gh])))
    log(f"[train] one step B=2, card vs CPU: metrics {mc} vs {mh} (largest relative "
        f"difference {max(met_rel.values()):.2e}); gradients of {len(gh)} parameter "
        f"tensors: worst ||g_card - g_cpu|| / ||g_cpu|| {g_rel[worst]:.2e} ({worst}), "
        f"median {sorted(g_rel.values())[len(g_rel) // 2]:.2e}, all together "
        f"{g_all:.2e}; BN statistics {st_rel:.2e} of their largest entry")
    if not (mc["loss_kd"] > 0 and mc["num_pos"] == mh["num_pos"]
            and max(met_rel.values()) <= 1e-3 and g_rel[worst] <= RTOL_GRADIENTS
            and st_rel <= 1e-4):
        raise AssertionError("the KD step on the card and on the CPU disagree")
    # the same step on the card under PyTorch's default precision flags, as
    # a caller of engine/loop.train runs it
    fp32_flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    try:
        md, _, gd = one_step(torch, cfg, cfg_t, consts, student_sd, teacher_sd, small,
                             uniform, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = fp32_flags
    gd_rel = {k: float(torch.linalg.vector_norm(gd[k] - gh[k])
                       / torch.linalg.vector_norm(gh[k]).clamp_min(1e-30)) for k in gh}
    worst_d = max(gd_rel, key=gd_rel.get)
    md_rel = max(abs(md[k] - mh[k]) / max(abs(mh[k]), 1e-12) for k in mh)
    log(f"[train] one step B=2 under PyTorch's default flags (matmul TF32 "
        f"{tf32_defaults[0]}, cuDNN TF32 {tf32_defaults[1]}) vs CPU: worst ||g_card - "
        f"g_cpu|| / ||g_cpu|| {gd_rel[worst_d]:.2e} ({worst_d}), median "
        f"{sorted(gd_rel.values())[len(gd_rel) // 2]:.2e}; metrics {md_rel:.2e} "
        f"(gates RTOL_GRADIENTS {RTOL_GRADIENTS:g}, 1e-3)")
    if not (gd_rel[worst_d] <= RTOL_GRADIENTS and md_rel <= 1e-3):
        raise AssertionError("under PyTorch's default flags the KD step on the card "
                             "misses the CPU")

    return dict(
        batch=B, steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, render_s=render_s,
        history=hist, step_ms=[h["step_ms"] for h in hist], median_step_ms=med,
        images_per_sec=1e3 * B / med, peak_memory_gib=peak_gb, teacher_ms=teacher_ms,
        k1_launches=k1, launches=
        {f"{n}:{p}x{t}": v for (n, p, t), v in launches.items()},
        profile=prof, device_idle_share=idle,
        card_vs_cpu=dict(card=mc, cpu=mh, metric_rel=met_rel, grad_rel=g_rel,
                         grad_rel_worst=g_rel[worst], grad_rel_all=g_all,
                         bn_stat_rel=st_rel),
        default_flags_vs_cpu=dict(card=md, metric_rel_max=md_rel,
                                  grad_rel_worst=gd_rel[worst_d], grad_rel_worst_tensor=worst_d,
                                  grad_rel=gd_rel)), k1


# ---------------------------------------------------------------------------
# cli phase
# ---------------------------------------------------------------------------

def votes_agree(torch, got, want) -> float:
    """Largest |got - want| over the Votes fields; raises unless every field
    is within rtol 1e-5 / atol 1e-5 (JAX's tests/test_cache_teacher.py:52)."""
    worst = 0.0
    for name, a, b in zip(want._fields, got, want):
        if a.shape != b.shape or not torch.allclose(a.float(), b.float(), rtol=1e-5,
                                                    atol=1e-5):
            raise AssertionError(f"votes field {name}: the cache misses the live votes")
        worst = max(worst, float((a.float() - b.float()).abs().max()))
    return worst


def cli_phase(torch, sf, cf, dev, tf32_defaults):
    """The training entry point's path on the card: the device pool, the
    cached teacher, K steps per call, K1 in every step, checkpoints and
    resume, and the student's evaluation (K2) at the end. (a) the pool's
    cached votes against live votes; (b) engine/loop.train with the pool
    and the cache, 10 steps in 2 calls, then timed and profiled cached
    steps; (c) live against cached multi-steps from the same weights and
    draws; (d) train_kd.main to 6 steps, then resumed to 8; (e)
    evaluate.main on the run's final.ckpt."""
    import contextlib
    import dataclasses
    import io
    import statistics

    from kd6d_pose_adlp_tpu_torch import evaluate, train_kd
    from kd6d_pose_adlp_tpu_torch.data import loaders
    from kd6d_pose_adlp_tpu_torch.data.batch import Batch
    from kd6d_pose_adlp_tpu_torch.engine import steps
    from kd6d_pose_adlp_tpu_torch.engine.loop import train
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
    from kd6d_pose_adlp_tpu_torch.utils.precision import full_fp32

    cfg, cfg_t = train_configs()
    n_fg, B = cfg.data.n_fg, cfg.solver.ims_per_batch
    k1_key = ("sinkhorn_potentials", cfg.solver.max_pos, cfg.kd.max_teacher_cells)
    data = loaders.build(cfg, kind="synthetic", device=dev)
    it = data.train_iter()
    t0 = time.perf_counter()
    pool = Batch.stack([next(it) for _ in range(CLI_POOL)]).to(dev)
    consts = data.consts
    teacher = init_pose_net(PoseNet(cfg_t.model, n_fg=n_fg),
                            torch.Generator().manual_seed(1)).to(dev).eval()
    torch.cuda.synchronize()
    log(f"[cli] pool of {CLI_POOL} batches of {B} at {cfg.model.input_res}² on the card "
        f"({time.perf_counter() - t0:.1f} s); teacher {cfg_t.model.backbone}, head prior "
        f"{cfg_t.model.prior}")

    # (a) the cache under PyTorch's default flags (precompute_pool_votes
    # pins fp32 itself) against the live step's votes, in full fp32
    fp32_flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    pre_s = []
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    try:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            votes = steps.precompute_pool_votes(cfg, cfg_t, teacher, pool)
            torch.cuda.synchronize()
            pre_s.append(time.perf_counter() - t0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = fp32_flags
    with full_fp32():
        diffs = [votes_agree(torch, votes.take(i),
                             steps.teacher_votes(cfg, cfg_t, teacher, pool.take(i)))
                 for i in range(CLI_POOL)]
    n_valid = int(votes.valid.sum())
    log(f"[cli] (a) precompute_pool_votes, {CLI_POOL} batches: {pre_s[0]:.3f} s, again "
        f"{pre_s[1]:.3f} s; against live votes batch by batch: max |diff| "
        f"{max(diffs):.2e} (gate rtol 1e-5, atol 1e-5); {n_valid} valid votes")
    if n_valid == 0:
        raise AssertionError("the random teacher cast no vote: the KD term is off")

    # (b) engine/loop.train with the pool and the cached teacher
    cfg_b = cfg.replace(solver=dataclasses.replace(cfg.solver, max_iter=TRAIN_STEPS,
                                                   val_freq=TRAIN_STEPS))
    teacher_sd = teacher.state_dict()
    torch.cuda.reset_peak_memory_stats()
    sf.reset_launch_counts()
    with tempfile.TemporaryDirectory() as wd:
        state, hist = train(cfg_b, consts, None, cfg_t=cfg_t, teacher_state_dict=teacher_sd,
                            device=dev, pool=pool, steps_per_dispatch=TRAIN_STEPS // 2,
                            cache_teacher=True, working_dir=wd, verbose=False)
    k1_b = sf.launches.get(k1_key, 0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for h in hist:
        log(f"[cli] (b) call to step {h['step']}: {h['step_ms']:.2f} ms a step, loss_total "
            f"{h['loss_total']:.4f} (kd {h['loss_kd']:.5f}), num_pos {h['num_pos']:.0f}")
    if state.step != TRAIN_STEPS or [h["step"] for h in hist] != [TRAIN_STEPS // 2,
                                                                  TRAIN_STEPS]:
        raise AssertionError(f"pooled train ran {state.step} steps in {len(hist)} calls")
    for h in hist:
        if not (all(math.isfinite(v) for v in h.values()) and h["loss_kd"] > 0):
            raise AssertionError(f"pooled train metrics {h}")
    if k1_b != TRAIN_STEPS or sum(sf.launches.values()) != TRAIN_STEPS:
        raise AssertionError(f"K1 launched {dict(sf.launches)} in {TRAIN_STEPS} pooled "
                             "steps, not once per step")
    # the same cached step, timed call by call (host clock, synchronized)
    # and one step profiled
    multi = steps.build_multi_step(cfg_b, cfg_t, consts, state.net, None,
                                   steps.make_optimizer(cfg_b), distill=True,
                                   pool_size=CLI_POOL, cached_votes=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k = TRAIN_STEPS // 2
    step_ms = []
    for c in range(CLI_TIMED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = multi(state, votes, pool, (c * k) % CLI_POOL, k, generator=gen)
        float(m["loss_total"])
        step_ms.append(1e3 * (time.perf_counter() - t0) / k)
    med = statistics.median(step_ms)
    holder = {}

    def one():
        holder["state"], holder["m"] = multi(state, votes, pool, 0, 1, generator=gen)

    prof = profile_request(torch, one)
    idle = 1.0 - prof["device_busy_ms"] / prof["wall_ms"]
    log(f"[cli] (b) cached pooled step, B={B}, {CLI_TIMED_CALLS} calls of {k} on "
        f"{gpu_name_and_power()}: median {med:.2f} ms ({', '.join(f'{x:.2f}' for x in step_ms)}"
        f") -> {1e3 * B / med:.1f} images/s; peak device memory {peak_gb:.2f} GiB; K1 "
        f"{k1_b} launches in {TRAIN_STEPS} steps")
    log(f"[cli] (b) profiled cached step: {prof['device_kernels']} device kernels, device "
        f"busy {prof['device_busy_ms']:.1f} ms of its {prof['wall_ms']:.1f} ms wall time "
        f"(idle share {idle:.3f}); top: {prof['top']}")

    # (c) live against cached multi-steps, same weights and draws
    sub = pool.take(slice(0, 3))
    student = init_pose_net(PoseNet(cfg.model, n_fg=n_fg), torch.Generator().manual_seed(2))
    uniforms = torch.rand((4, B, cfg.model.num_cells, cfg.solver.max_objs),
                          generator=torch.Generator().manual_seed(3)).to(dev)

    def run(cached):
        net = PoseNet(cfg.model, n_fg=n_fg)
        net.load_state_dict(student.state_dict())
        opt = steps.make_optimizer(cfg)
        st = steps.create_train_state(cfg, net.to(dev), opt)
        fn = steps.build_multi_step(cfg, cfg_t, consts, net, None if cached else teacher, opt,
                                    distill=True, pool_size=3, cached_votes=cached)
        arg = steps.precompute_pool_votes(cfg, cfg_t, teacher, sub) if cached else None
        st, mm = fn(st, arg, sub, 0, 4, uniforms=uniforms)
        return ({kk: float(v) for kk, v in mm.items()},
                {kk: v.detach().cpu() for kk, v in net.state_dict().items()})

    (m_live, sd_live), (m_cache, sd_cache) = run(False), run(True)
    met_rel = max(abs(m_cache[kk] - m_live[kk]) / max(abs(m_live[kk]), 1e-12)
                  for kk in ("loss_total", "loss_cls", "loss_reg", "loss_kd"))
    stat = lambda kk: kk.endswith(("running_mean", "running_var"))  # noqa: E731
    p_err = max(float((sd_cache[kk] - v).abs().max()) for kk, v in sd_live.items()
                if v.is_floating_point() and not stat(kk))
    st_ok = all(torch.allclose(sd_cache[kk], v, rtol=1e-3, atol=1e-4)
                for kk, v in sd_live.items() if stat(kk))
    log(f"[cli] (c) 4 steps over a 3-batch pool, live vs cached teacher: metrics "
        f"{m_live} vs {m_cache} (largest relative difference {met_rel:.2e}, gate 1e-4); "
        f"parameters max |diff| {p_err:.2e} (gate 5e-3); BN statistics within rtol 1e-3 / "
        f"atol 1e-4: {st_ok}")
    if not (m_live["loss_kd"] > 0 and met_rel <= 1e-4 and p_err < 5e-3 and st_ok
            and m_live["num_pos"] == m_cache["num_pos"]):
        raise AssertionError("the cached-teacher multi-step misses the live one")

    # (d) the entry point, then its resume; (e) the evaluation CLI
    tmp = tempfile.TemporaryDirectory()
    wd = tmp.name
    wf = os.path.join(wd, "teacher.pt")
    torch.save(teacher_sd, wf)
    n_chunks = -(-CLI_EVAL_IMAGES // cfg.test.ims_per_batch)
    shapes = ((3, 8), (8, 16))
    args = ["--config_file", CLI_CONFIG_FILE, "--data", "synthetic", "--device_pool",
            str(CLI_POOL), "--steps_per_dispatch", "5", "--cache_teacher",
            "--weight_file_t", wf, "--fold_teacher_bn", "false", "--working_dir", wd]
    runs = {}
    for max_iters in (6, 8):
        sf.reset_launch_counts()
        cf.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            st, h = train_kd.main(args + ["--max_iters", str(max_iters)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        printed = buf.getvalue()
        k1 = sf.launches.get(k1_key, 0)
        k2 = {f"{c}->{o}": cf.launches.get(("conv3x3_bn_act_flat", c, o), 0)
              for c, o in shapes}
        first = max_iters == 6
        log(f"[cli] (d) train_kd.main --max_iters {max_iters} ({secs:.1f} s): step "
            f"{st.step}, K1 {k1} launches, K2 {k2}; printed:\n"
            + "\n".join(line for line in printed.splitlines()
                        if not line.startswith(("ADI", "REP", "AUC", "metric"))))
        n_steps = 6 if first else 2
        want_resume = f"resumed from {os.path.join(wd, 'latest.ckpt')} @ step 6"
        if not (st.step == max_iters and k1 == n_steps and sum(sf.launches.values()) == n_steps
                and set(k2.values()) == {n_chunks}
                and sum(cf.launches.values()) == 2 * n_chunks
                and printed.count("[valid @ step") == 2      # teacher at 0, student at the end
                and f"[valid @ step {max_iters}]" in printed
                and "teacher knowledge cached for" in printed
                and (first or want_resume in printed)):
            raise AssertionError(f"train_kd.main --max_iters {max_iters}: steps, launches, "
                                 "evaluations or resume not as expected")
        missing = [f for f in ("latest.ckpt", "final.ckpt", "cfg.json", "info.txt",
                               "scalars.jsonl") if not os.path.exists(os.path.join(wd, f))]
        if missing:
            raise AssertionError(f"train_kd.main did not write {missing}")
        runs[max_iters] = dict(seconds=secs, k1=k1, k2=k2, history=h)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev = evaluate.main(["--config_file", CLI_CONFIG_FILE, "--weight_file",
                            os.path.join(wd, "final.ckpt"), "--data", "synthetic",
                            "--working_dir", os.path.join(wd, "eval")])
    printed = buf.getvalue()
    tmp.cleanup()
    n_tensors = len(PoseNet(cfg.model, n_fg=n_fg).state_dict())
    log(f"[cli] (e) evaluate.main on the run's final.ckpt: {printed.splitlines()[0]}")
    if not (printed.startswith(f"loaded {n_tensors} tensors from") and ev["table"] in printed):
        raise AssertionError("evaluate.main did not load every tensor of the run's "
                             "final.ckpt and print its table")

    return dict(
        pool=CLI_POOL, batch=B, precompute_s=pre_s, votes_max_abs_diff=max(diffs),
        loop_history=hist, k1_launches_loop=k1_b, peak_memory_gib=peak_gb,
        cached_step_ms=step_ms, median_step_ms=med, images_per_sec=1e3 * B / med,
        profile=prof, device_idle_share=idle,
        live_vs_cached=dict(live=m_live, cached=m_cache, metric_rel=met_rel,
                            param_max_abs=p_err, bn_stats_ok=st_ok),
        train_kd=runs), k1_b + runs[6]["k1"] + runs[8]["k1"]


# ---------------------------------------------------------------------------
# eval phase
# ---------------------------------------------------------------------------

def fabricated_outputs(torch, cfg, consts, batch):
    """(cls_logits, pred_reg) of a batch that decode exactly to its
    ground-truth corners: the GT class's logit 4 at cells inside the object's
    mask (-12 elsewhere), its regression the exact corner encoding at every
    cell (the JAX eval tests' fabricated outputs)."""
    from kd6d_pose_adlp_tpu_torch.models import anchors as anchor_lib
    from kd6d_pose_adlp_tpu_torch.models import coder

    m, n_fg = cfg.model, cfg.data.n_fg
    dev = consts.K.device
    batch = batch.to(dev)
    anchors = torch.as_tensor(anchor_lib.make_anchors(m.input_res, m.level_strides,
                                                      m.level_sizes), device=dev)
    A, B = anchors.shape[0], batch.images.shape[0]
    cls0 = batch.class_ids[:, 0].long().clamp_min(0)
    kp2d = coder.project_corners(consts.K, batch.rotations[:, 0], batch.translations[:, 0],
                                 consts.kp3d[cls0], batch.bbox_trans)
    enc = coder.encode(kp2d[:, None].expand(B, A, 8, 2), anchors[None])
    bi, ai = torch.arange(B, device=dev)[:, None], torch.arange(A, device=dev)[None, :]
    reg = torch.zeros((B, A, n_fg, 16), device=dev)
    reg[bi, ai, cls0[:, None]] = enc
    cx = anchors[:, 0].clamp(0, m.input_res - 1).long()
    cy = anchors[:, 1].clamp(0, m.input_res - 1).long()
    logits = torch.full((B, A, n_fg), -12.0, device=dev)
    logits[bi, ai, cls0[:, None]] = torch.where(batch.mask[:, cy, cx] > 0,
                                                torch.tensor(4.0, device=dev),
                                                torch.tensor(-12.0, device=dev))
    return logits, reg.reshape(B, A, n_fg * 16)


def compare_predictions(a: dict, b: dict, r_atol: float, t_rtol: float, t_atol: float = 0.0,
                        only=None):
    """Two preds.json dicts: the same images, metas and classes; returns
    (max |R_a - R_b|, max |T_a - T_b| / |T_b|, predictions compared) and
    raises if a pose is outside (r_atol, t_rtol |T_b| + t_atol)."""
    import numpy as np
    if set(a) != set(b):
        raise AssertionError("the two evaluations scored different images")
    r_err = t_err = 0.0
    n = 0
    for fn, wa in a.items():
        wb = b[fn]
        if wa["meta"] != wb["meta"] or len(wa["pred"]) != len(wb["pred"]):
            raise AssertionError(f"{fn}: metas or prediction counts differ")
        if only is not None and fn not in only:
            continue
        for pa, pb in zip(wa["pred"], wb["pred"]):
            if pa[1] != pb[1]:
                raise AssertionError(f"{fn}: classes differ")
            Ra, Rb = np.asarray(pa[2]), np.asarray(pb[2])
            Ta, Tb = np.asarray(pa[3]).reshape(3), np.asarray(pb[3]).reshape(3)
            dr, dt = float(np.abs(Ra - Rb).max()), float(np.abs(Ta - Tb).max())
            r_err = max(r_err, dr)
            t_err = max(t_err, dt / float(np.abs(Tb).max()))
            if not (dr <= r_atol and dt <= t_rtol * float(np.abs(Tb).max()) + t_atol):
                raise AssertionError(f"{fn}: poses differ (R {dr:.3e}, T {dt:.3e})")
            n += 1
    return r_err, t_err, n


def tables_agree(a: dict, b: dict, what: str) -> float:
    """Two evaluations' results: the ADI and REP numbers (per class and per
    depth bin) equal, each class's AUC within AUC_ATOL; returns the largest
    AUC difference."""
    for g in ("adi_per_class", "rep_per_class", "adi_per_depth", "rep_per_depth"):
        if a[g] != b[g]:
            raise AssertionError(f"{what}: {g} differ:\n{a['table']}\n{b['table']}")
    auc = max((abs(x[k] - y[k]) for x, y in zip(a["auc_per_class"], b["auc_per_class"])
               for k in x), default=0.0)
    if not auc <= AUC_ATOL:
        raise AssertionError(f"{what}: AUC differs by {auc:.3f} points:\n{a['table']}\n"
                             f"{b['table']}")
    return auc


def eval_phase(torch, cf, dev):
    """The evaluators on the card: a planted scene (fabricated outputs that
    decode to the ground truth, every fourth image with its own K) through
    ScanEvaluator and valid, held against the CPU; then the full-width
    random-weight network through ScanEvaluator.run, valid and
    detection_stats (K2 once per chunk at each shape), images/s, the split
    and one profiled chunk; then the evaluation CLI."""
    import contextlib
    import dataclasses
    import io
    import statistics

    import numpy as np

    from kd6d_pose_adlp_tpu_torch import evaluate
    from kd6d_pose_adlp_tpu_torch.config import Config
    from kd6d_pose_adlp_tpu_torch.data import loaders
    from kd6d_pose_adlp_tpu_torch.engine import evaluator
    from kd6d_pose_adlp_tpu_torch.engine.eval_scan import ScanEvaluator
    from kd6d_pose_adlp_tpu_torch.engine.postprocess import build_postprocess
    from kd6d_pose_adlp_tpu_torch.engine.serving import network_fn
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
    from kd6d_pose_adlp_tpu_torch.ops.epnp import sample_gumbel

    cfg = Config()
    cfg = cfg.replace(test=dataclasses.replace(cfg.test, ims_per_batch=EVAL_BATCH))
    assert cfg.model.backbone == "darknet_tiny_h" and cfg.model.input_res == RES
    n_img, t = EVAL_BATCH * EVAL_CHUNKS, cfg.test
    t0 = time.perf_counter()
    data = loaders.build(cfg, kind="synthetic", eval_limit=n_img, device=dev)
    cfg = data.cfg
    batches = list(data.eval_batches())
    render_s = time.perf_counter() - t0
    data_cpu = loaders.build(cfg, kind="synthetic", eval_limit=n_img, device="cpu")
    consts, consts_cpu, meshes = data.consts, data_cpu.consts, data.meshes
    K_int = consts_cpu.K.numpy().astype(np.float64)
    K_own = K_int.copy()
    K_own[0, 0] *= 1.07
    K_own[1, 1] *= 0.93
    K_own[0, 2] += 11.0
    planted = [(b, [dict(m, K=K_own) if (bi * EVAL_BATCH + i) % 4 == 0 else m
                    for i, m in enumerate(ms)]) for bi, (b, ms) in enumerate(batches)]
    remapped = {m["filename"] for _, ms in planted for m in ms if m["K"] is K_own}
    classes = sorted({int(m["class_ids"][0]) for _, ms in batches for m in ms})
    log(f"[eval] {n_img} synthetic images in {EVAL_CHUNKS} chunks of {EVAL_BATCH} at "
        f"{RES}² ({len(classes)} classes; rendered in {render_s:.1f} s); "
        f"{len(remapped)} with their own K")

    # the draws of both runs of the planted scene, chunk by chunk
    gen_cpu = torch.Generator().manual_seed(11)
    draws = [sample_gumbel((EVAL_BATCH, t.ransac_iters, t.max_votes * 8), gen_cpu, "cpu")
             for _ in range(EVAL_CHUNKS)]
    gumbel_fn = lambda i: draws[i]  # noqa: E731

    def planted_scan(consts_, device):
        outs = [fabricated_outputs(torch, cfg, consts_, b) for b, _ in batches]
        sev = ScanEvaluator(cfg, consts_, None, meshes, forward=lambda im, i: outs[i])
        sev.prepare(planted)
        t1 = time.perf_counter()
        r = sev.run(gumbel_fn=gumbel_fn, verbose=False)
        return r, time.perf_counter() - t1, outs

    card, card_s, outs = planted_scan(consts, dev)
    host, host_s, _ = planted_scan(consts_cpu, "cpu")
    log(f"[eval] planted scene, ScanEvaluator on the card ({card_s:.2f} s) and on the "
        f"CPU ({host_s:.2f} s), the same injected draws:\n{card['table']}")
    for c in classes:
        adi = card["adi_per_class"][c].get("ADI.10d", 0.0)
        if not adi >= 99.0:
            raise AssertionError(f"planted scene: ADI.10d {adi} < 99 for class {c}")
    r_err, t_err, n_cmp = compare_predictions(card["predictions"], host["predictions"],
                                              1e-3, 1e-3)
    auc_cpu = tables_agree(card, host, "planted scene, card vs CPU")
    log(f"[eval] planted scene, card vs CPU: {n_cmp} poses, max |R| diff {r_err:.2e}, max "
        f"relative T diff {t_err:.2e} (gates 1e-3, 1e-3); ADI and REP equal, AUC within "
        f"{auc_cpu:.4f} points (tables identical {card['table'] == host['table']})")
    it = iter(outs)
    t1 = time.perf_counter()
    stream = evaluator.valid(cfg, consts, lambda im: next(it), build_postprocess(cfg, consts),
                             iter(planted), meshes, gumbel_fn=gumbel_fn, verbose=False)
    stream_s = time.perf_counter() - t1
    kept = set(card["predictions"]) - remapped
    r1, t1_, n1 = compare_predictions(card["predictions"], stream["predictions"], 1e-4, 1e-4,
                                      only=kept)
    r2, t2, n2 = compare_predictions(card["predictions"], stream["predictions"], 5e-3, 2e-3,
                                     0.5, only=remapped)
    auc_stream = tables_agree(card, stream, "planted scene, scan vs streaming")
    log(f"[eval] planted scene, scan vs streaming on the card ({stream_s:.2f} s): {n1} "
        f"poses at the internal K, max |R| diff {r1:.2e}, relative T {t1_:.2e} (gates "
        f"1e-4, 1e-4); {n2} re-fit to their own K (device EPnP vs host), R {r2:.2e}, T "
        f"{t2:.2e} (gates 5e-3, 2e-3 + 0.5 mm); ADI and REP equal, AUC within "
        f"{auc_stream:.4f} points (tables identical {card['table'] == stream['table']})")

    # the full-width network, random weights, head prior 0.5 so that every
    # image votes; the images at the internal K
    net = init_pose_net(PoseNet(cfg.model, n_fg=cfg.data.n_fg),
                        torch.Generator().manual_seed(0), prior=0.5).to(dev).eval()
    sev = ScanEvaluator(cfg, consts, net, meshes)
    sev.prepare(batches)
    torch.cuda.synchronize()
    shapes = ((3, 8), (8, 16))

    def k2_launches(what):
        got = {f"{c}->{o}": cf.launches.get(("conv3x3_bn_act_flat", c, o), 0)
               for c, o in shapes}
        if set(got.values()) != {EVAL_CHUNKS} or sum(cf.launches.values()) != 2 * EVAL_CHUNKS:
            raise AssertionError(f"{what}: K2 not launched once per chunk at each shape: "
                                 f"{dict(cf.launches)}")
        return got

    cf.reset_launch_counts()
    scan = sev.run(seed=0, verbose=False)
    launches = dict(cf.launches)
    scan_launches = k2_launches("ScanEvaluator.run")
    cf.reset_launch_counts()
    network, post = network_fn(net), build_postprocess(cfg, consts)
    stream = evaluator.valid(cfg, consts, network, post, iter(batches), meshes, seed=0,
                             verbose=False)
    stream_launches = k2_launches("valid")
    cf.reset_launch_counts()
    det = evaluator.detection_stats(cfg, consts, network, iter(batches), cfg.data.n_fg,
                                    seed=0, verbose=False)
    det_launches = k2_launches("detection_stats")
    r_err, t_err, n_cmp = compare_predictions(scan["predictions"], stream["predictions"],
                                              1e-4, 1e-4)
    log(f"[eval] full-width network (random weights: its table means nothing): K2 launches "
        f"scan {scan_launches}, valid {stream_launches}, detection_stats {det_launches} in "
        f"{EVAL_CHUNKS} chunks; scan vs streaming: tables equal "
        f"{scan['table'] == stream['table']}, {n_cmp} poses, max |R| diff {r_err:.2e}, "
        f"relative T {t_err:.2e}; detection_stats {det}")
    if scan["table"] != stream["table"]:
        raise AssertionError("full-width network: scan and streaming tables differ")

    # images/s: host clock, each run ends in a synchronizing copy, median of 3
    def per_s(fn):
        times = []
        for _ in range(EVAL_RUNS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        return n_img / statistics.median(times), times

    scan_ips, scan_times = per_s(lambda: sev.run(seed=0, verbose=False))
    stream_ips, stream_times = per_s(lambda: evaluator.valid(
        cfg, consts, network, post, iter(batches), meshes, seed=0, verbose=False))
    split = {}
    sev.run(seed=0, verbose=False, timings=split)
    log(f"[eval] images/s at B={EVAL_BATCH}, {RES}², {n_img} images on {gpu_name_and_power()}: "
        f"scan {scan_ips:.1f} "
        f"({', '.join(f'{x:.3f}' for x in scan_times)} s), streaming {stream_ips:.1f} "
        f"({', '.join(f'{x:.3f}' for x in stream_times)} s); a scan run split (synchronized "
        f"per stage): {', '.join(f'{k} {v:.3f}' for k, v in split.items())}")
    one = ScanEvaluator(cfg, consts, net, meshes).prepare(batches[:1])
    one.run(seed=0, verbose=False)
    prof = profile_request(torch, lambda: one.run(seed=0, verbose=False))
    idle = 1.0 - prof["device_busy_ms"] / prof["wall_ms"]
    log(f"[eval] one profiled chunk (ScanEvaluator.run on {EVAL_BATCH} images): "
        f"{prof['device_kernels']} device kernels, device busy {prof['device_busy_ms']:.1f} "
        f"ms of its {prof['wall_ms']:.1f} ms wall time (idle share {idle:.3f}); "
        f"top: {prof['top']}")

    # the evaluation CLI on a state_dict file, 64 images
    with tempfile.TemporaryDirectory() as tmp:
        wf = os.path.join(tmp, "w.pt")
        torch.save(net.state_dict(), wf)
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli = evaluate.main(["--config_file", "", "--weight_file", wf, "--data",
                                 "synthetic", "--working_dir",
                                 os.path.join(tmp, "eval")])
        cli_s = time.perf_counter() - t1
        printed = buf.getvalue()
        with open(os.path.join(tmp, "eval", "preds.json")) as f:
            n_preds = len(json.load(f))
    log(f"[eval] evaluate.main on 64 images ({cli_s:.1f} s) printed:\n{printed.rstrip()}")
    if not (printed.startswith(f"loaded {len(net.state_dict())} tensors from")
            and cli["table"] in printed and n_preds == 64):
        raise AssertionError("the evaluation CLI did not load, print its table and write "
                             "preds.json")

    return dict(
        images=n_img, chunk=EVAL_BATCH, chunks=EVAL_CHUNKS, render_s=render_s,
        planted=dict(card_s=card_s, cpu_s=host_s, stream_s=stream_s, table=card["table"],
                     cpu_table=host["table"],
                     card_vs_cpu=dict(R=r_err, T_rel=t_err, auc=auc_cpu),
                     scan_vs_stream=dict(R=r1, T_rel=t1_, R_refit=r2, T_rel_refit=t2,
                                         auc=auc_stream)),
        network=dict(scan_images_per_s=scan_ips, scan_s=scan_times,
                     stream_images_per_s=stream_ips, stream_s=stream_times, split_s=split,
                     launches_scan=scan_launches, launches_stream=stream_launches,
                     launches_detection=det_launches, detection=det, profile=prof,
                     device_idle_share=idle),
        cli_s=cli_s), launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernel,serving,pose,train,eval,cli")
    ap.add_argument("--json_out", default="outputs/chip_smoke.json")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from kd6d_pose_adlp_tpu_torch.ops import conv_fused as cf
    from kd6d_pose_adlp_tpu_torch.ops import sinkhorn_fused as sf
    from kd6d_pose_adlp_tpu_torch.utils import cuda_build

    # fp32 comparisons: no TF32 in matmuls or cuDNN convolutions (the
    # serving phase also runs one comparison under the defaults kept here)
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    log(f"[set-up] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = cuda_build.build_all(["conv3x3_bn_act", "sinkhorn_potentials"])
    log(f"[set-up] built {[p.name for p in libs.values()]} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, p in libs.items():
        logf = p.with_suffix(".log")
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line or "entry function" in line:
                    log(f"[set-up] ptxas {name}: {line.strip()}")

    result = {"card": card}
    # launches of each main path's run, by batch: serving at B=8, eval at 24
    rows, launches, k1_row, k1_launches = [], {BATCH: {}, EVAL_BATCH: {}}, None, None
    if "kernel" in phases:
        rows, result["segment"] = kernel_phase(torch, F, cf, dev)
        k1_row = sinkhorn_kernel(torch, sf, dev)
    if "serving" in phases:
        result["serving"], launches[BATCH] = serving_phase(torch, cf, dev, tf32_defaults)
    if "pose" in phases:
        result["pose"] = pose_phase(torch, dev)
    if "train" in phases:
        result["train"], k1_launches = train_phase(torch, sf, dev, tf32_defaults)
    if "eval" in phases:
        result["eval"], launches[EVAL_BATCH] = eval_phase(torch, cf, dev)
    if "cli" in phases:
        result["cli"], k1_cli = cli_phase(torch, sf, cf, dev, tf32_defaults)
        k1_launches = (k1_launches or 0) + k1_cli

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for r in rows:
        r["launches"] = launches[r["B"]].get((r["name"], r["C"], r["O"]))
        r = dict(r, name=f"{r['name']}[{r['shape']} {r['C']}->{r['O']} @{r['H']}^2 B={r['B']}]")
        kernels.append({k: r[k] for k in keys})
    if k1_row is not None:
        # K1's launches are those of the train phase's run and the cli
        # phase's pooled runs (loop.train, train_kd.main and its resume)
        k1_row["launches"] = k1_launches
        kernels.append({k: k1_row[k] for k in keys}
                       | {"name": f"sinkhorn_potentials[{k1_row['shape']}]"})
        rows.append(k1_row)
    result["kernels"] = rows
    os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
