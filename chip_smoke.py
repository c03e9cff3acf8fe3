#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`kd6d_pose_adlp_tpu_torch`) on one NVIDIA
card: the quickest proof that the port builds, starts and answers on the GPU.

    python3 chip_smoke.py                  # all phases, one card
    python3 chip_smoke.py --phases kernel  # kernel checks and timings only
    python3 chip_smoke.py --phases train   # the KD steps only
    python3 chip_smoke.py --phases cli     # the training entry point's path only
    python3 chip_smoke.py --phases export  # frame endpoint, artifacts, int8 PTQ
    python3 chip_smoke.py --phases zebra   # the dense binary-code head
    python3 chip_smoke.py --phases bop     # the BOP host pipeline under the CLIs
    python3 chip_smoke.py --phases dist    # data parallelism over a process group
    python3 chip_smoke.py --phases tools   # reference checkpoints, the plots, a trace

Phases:
  set-up   builds the CUDA kernels from kd6d_pose_adlp_tpu_torch/csrc/ with
           nvcc (one process per source, all started together) and prints
           ptxas's register and spill lines.
  kernel   in fp32 and in bf16, at the serving shapes (B=8: stem 3->8
           @256², s2 8->16 @128²) holds K2 (conv3x3_bn_act_flat) and K3
           (conv3x3_bn_act_stacked), K2 also at the eval batch (B=24), and
           both at the other DarkNet plans' stem shapes (VARIANT_SHAPES, B=8:
           3->16 @256², 16->32 @128², 3->32 @256², 32->32 @128², 12->8
           @128², 32->64 @128²; every shape and type conv3x3_igemm serves),
           against their plain PyTorch versions on the card: fp32 atol 1e-4,
           bf16 within one bf16 rounding of the plain output (|k - p| <=
           2^-7 |p| + 1e-3). Each is timed with CUDA events beside its
           bound, the plain version and one library call in the same dtype
           (F.conv2d / matmul + affine + leaky_relu, a yardstick only). The
           bound's operation term counts an fp32 shape whose products run on
           the tensor cores (fp32_on_tensor_cores: all but K2's stem
           instance and K3's two streaming instances) as three TF32
           products per product, and bf16 products at the bf16 tensor-core
           rate. K2 also at the edges of its mappings (K2_EDGES: the stem
           at 255², 41x61, 33x30 and 19x28 (each (W + 2) % 4), s2 at 67x61,
           30², 128² at B = 1, 6x5 and 12², the bf16 tiling edges of
           tests/test_torch_port_precision.py, the serving instances also
           on a slab at an odd element offset, then conv3x3_igemm's:
           16->64 @20², 5->12 @9x7, a partial channel octet at C = 5 and
           20, eight octets through the staging ring at C = 64, O = 12, 24
           and 72 (the 128-output tiling past 64), two passes of 128
           outputs at O = 136, odd M, a ragged last tile at 32->64 and B =
           1), and K3 at its (K3_EDGES: each
           serving-instance kernel at B=1, odd M at both, a ragged tile at
           30², conv3x3_igemm at 3->16, 16->32 and the same new edges), in
           both dtypes, held the same way, times logged. The stem segment
           in both forms and both types against its plain version (fp32
           atol 1e-4, bf16 within one bf16 rounding), timed beside the
           library chain in the same type.
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
           (cuDNN TF32 on), which the endpoint overrides. Then the same
           weights in bf16: 4 requests on the flat stem (bf16 K2 twice per
           request) and 2 on the stacked one (bf16 K3 twice per request);
           then the other students, each in fp32 and in bf16 with the same
           weights, 2 requests each: darknet_tiny (K2 at 3->16, 16->32),
           darknet_tiny_h_wide (3->32, 32->32) and darknet_tiny_h_s2d (12->8,
           8->16 at 128²). Each bf16 network's logits within 0.25 of its
           fp32 network's (JAX's own bf16 bound, tests/test_models.py:79).
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
           gradients within the same limits. Then train_kd's defaults: the
           bf16 student against the bf16 BN-folded teacher, 10 steps plain
           and 10 with remat (K1 once per step, finite metrics, median step
           ms, images/s and peak memory beside the fp32 run's); one remat
           step against the plain step from the same weights and draws
           (metrics 1e-3, gradients 1e-2, BN statistics 1e-4); the folded
           teacher's outputs and votes against the unfolded one's in fp32
           (each field within 1e-4 of its largest magnitude, masks equal).
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
  export   the rest of serving at full width (darknet_tiny_h, FPN 128, P6/P7,
           15 classes, seeded random weights). (a) build_frame_infer_fn on 8
           raw 480x640 frames -> 256² crops: the card's crops within 1 LSB of
           the CPU's, bbox_trans within 1e-4, the poses equal (ints and masks;
           floats within 1e-4) to build_infer_fn on its own crops with the
           same seed, K2 once per request at each stem shape, the warp's and
           the request's median ms. (b) export_inference + load_serving on
           the card: single B=8, frame B=8 and a symbolic batch served at B=1
           and B=8, each loaded program against the eager endpoint with the
           same seed (ints and masks equal, floats rtol/atol 1e-5, JAX's
           check) and K2 counted from inside each loaded program; exported vs
           eager request ms (median of 5); then a mode="multi" artifact at
           B=8 (every class solved) against the eager multi endpoint, K2
           counted from inside it. (c) int8 PTQ of the darknet53
           teacher (FPN 256, the config's head prior) at B=16, 256², BN
           folded, calibrated on 4 synthetic batches: its logits within 0.05
           of the folded fp32 teacher's largest |logit| (JAX's bound), the
           int32 sums of one full-width QConv (cls_tower.0, 256 -> 256 at
           P5) equal on card and CPU; the int8, fp32-folded and bf16-folded
           teacher forwards timed (CUDA events) with their peak memory; an
           int8 darknet_tiny_h artifact exported and reloaded (no K2: its
           stem is int8).
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
           steps over a 3-batch pool, under deterministic algorithms: the
           metrics and the state dicts bit-equal (stricter than JAX's
           tests/test_cache_teacher.py bounds, metrics rtol 1e-4,
           parameters max|diff| < 5e-3, BN statistics rtol 1e-3 / atol
           1e-4, whose readings are logged). (a)-(c) run in fp32. (d)
           train_kd.main at its defaults (bf16, the teacher from a temporary
           teacher.pt with its BN folded; --config_file '', --device_pool 4
           --steps_per_dispatch 5 --cache_teacher) to 6 steps: K1 once per
           step, the five files, the teacher's sanity evaluation and one
           student evaluation at step 6 with the bf16 K2 once per chunk at
           each shape; then again to 8: "resumed from ... @ step 6", K1
           twice. (e) evaluate.main at its default bf16 on the run's
           final.ckpt, every tensor loaded, the bf16 K2 once per chunk.
           (f) train_kd.main --quant_teacher with the cached votes, 4 steps:
           the teacher folded, calibrated on 4 eval batches and int8, K1
           once per step, finite losses; then export_model --check (bf16,
           B=8) on that run's final.ckpt: the round trip passes, bf16 K2
           once per shape in each of the eager and the loaded request.
  zebra    the dense binary-code head at full width (darknet_tiny_h, FPN 128,
           P6/P7, 15 classes, 256², 16-bit codes over the 152 box-surface
           vertices a class). (a) one distilling zebra step, B=2, fp32, with a
           tiny_h zebra teacher (head prior 0.5), from the same weights, batch
           and SSC draw on the card and on the CPU: metrics rtol 1e-3, every
           gradient within RTOL_GRADIENTS, K2 once at each stem shape in the
           teacher's forward. (b) train_zebra.main at its defaults (bf16) but
           a pool of 4 batches of 16, 20 steps, 5 a call, 16 eval images and
           --kd_weight 1 with a darknet53 zebra teacher file (seeded, head
           prior 0.5): finite losses, loss_kd > 0, final.ckpt and the result
           line, the bf16 K2 once per eval batch of 8 at each shape; then the
           same bf16 step timed live (a host batch a step) and pooled (5 a
           call), with the peak memory. (c) perfect per-cell outputs through
           the dense postprocess on the card, B=8 eval crops: R within 0.02,
           T within 5 mm of the ground truth. (d) jittered outputs with some
           wrong codes through the dense postprocess on the card and on the
           CPU with the same draws: n_inliers, valid and pt_valid equal, R
           within 0.1 deg, T within 0.5 mm (the pose phase's gates); the
           dense and the corner postprocess timed per B=8 batch (median of
           5), one dense postprocess profiled.
  bop      the BOP host pipeline under the CLIs at full width (darknet_tiny_h,
           FPN 128, P6/P7, 15 classes, 256² crops). (a) make_bop_dataset
           writes a tree of 64 train and 48 test 640x480 frames, single class
           0 (as configs/ape.yaml), timed; every PNG read back through
           data/png.py bit-equal to the array written; png_unfilter (the data
           plane, built with g++) against its numpy version on random rows at
           1-8 bytes a pixel. (b) BOPPoseDataset on the tree, slow and fast,
           train and eval: the sample contract (shapes, dtypes, -1 padding),
           every eval crop's remapped GT pose against scene_gt.json (R within
           1e-5, T within 1e-3 mm: the internal frame is the raw frame),
           train crops finite with the object in the mask; PrefetchLoader
           images/s at B=16 with 1, 2 and 4 threads, slow and fast, frames
           decoded and cached (logged only). Then the live bf16 step
           (train_kd's defaults, the darknet53 teacher BN-folded) through
           engine/loop.train on BOP batches from 4 loader threads beside the
           same step on synthetic host batches, 10 steps each (K1 once per
           step, median ms), and one profiled BOP step (idle share). (c)
           train_kd.main --data bop at its defaults (bf16, the teacher from
           a temporary teacher.pt with its BN folded, the tree's config.yaml,
           --num_workers 4, B=16) to 6 steps: K1 once per step, finite
           losses with loss_kd > 0, the five files, the teacher's sanity
           evaluation and one student evaluation at step 6 on the 48 test
           crops with the bf16 K2 once per chunk at each stem shape, no
           loader thread left; then again to 8: "resumed from ... @ step 6".
           (d) evaluate.main --data bop on the run's final.ckpt, once with
           --test_file and once with --fast_pipeline: every tensor loaded,
           the table printed, 48 predictions, the bf16 K2 once per chunk of
           24. (e) export_model --data bop --check at B=8: the round trip
           passes, the bf16 K2 once per shape in each request.
  tools    reference checkpoints and the tools on the training entry
           point's path at full width (darknet_tiny_h, FPN 128, P6/P7, a
           darknet53 teacher, 256², B=16). (a) a reference-layout file
           ({"model": {"module." + k: v}, "steps", "optim", "sched"}) of a
           seeded darknet53 teacher: every tensor loads, and the loaded
           net's B=16 outputs equal the source net's bit for bit; a
           pytorchcv / imgclsmob zip of a seeded darknet_tiny_h backbone
           through imgclsmob_to_backbone_ckpt; a file that matches nothing
           raises in load_params_loose and load_backbone_init. (b)
           train_kd --vis_every 2 at its defaults (bf16, the teacher
           folded): pooled (2 batches, 3 steps a call, to 7) from that
           teacher file and --backbone_init on the zip's checkpoint, every
           tensor of each printed as loaded; then per step to 5 with a
           random teacher. Each writes vis/{step}_img_2d.png after JAX's
           steps (3 and 6; 1, 2 and 4) and nothing else there, K1 once a
           step, the bf16 K2 once a chunk at each stem shape plus once a
           plot (the plots' student forward at B=16). (c) the evaluations
           write accuracy_per_depth_{step:06d}.png (the teacher's at step
           0, the student's at the last step). (d) profiling.trace over 2
           bf16 steps of engine/loop.train with a plot each: the Chrome
           trace names K1 (k1_kept) once a step and K2 (conv3x3_) once a
           plot at each stem shape, as the wrappers count. Each part's
           seconds are logged. The kernels line's B=16 bf16 K2 rows count
           (d)'s launches only: in (b) one counter takes both the plots'
           B=16 forwards and the evaluations' chunks, so (b)'s totals are
           gated and logged, not given to a batch's row.
  dist     data parallelism (parallel/mesh) at full width. (a) two ranks on
           the one card, spawned by parallel/mesh.spawn, with gloo on CUDA
           tensors (NCCL refuses two ranks on one device), through the
           engine API: the darknet_tiny_h student and the BN-folded darknet53
           teacher (head prior 0.5) at 256², B=8 a rank and 16 in all, 2
           fp32 KD steps under deterministic algorithms (cuBLAS's workspace
           pinned, CUBLAS_WORKSPACE_CONFIG; an op with no deterministic
           kernel raises) against the one-process fp32 steps on the
           concatenated batches on the same card, both with the LR divided
           by 2, gated at the bounds of tests/test_torch_port_dist.py
           (metrics rtol 5e-3, num_pos equal; after the first step every
           parameter within 2 lr and < 0.5% of its elements off by more
           than 1e-6; after the last within 2 * sum(lr), the difference's
           norm <= 0.15 of the update's, BN statistics within 5e-3 of their
           largest entry), the first step's 2 lr plus the parameter's
           float32 spacing (dist_steps_agree says why). The CPU tests hold
           3 steps; a third step here parts the ranks from one process by
           more than the metrics' 5e-3, as reordering the images does
           (dist_spread). Then 2 bf16 steps (train_kd's default pair):
           finite losses; the ranks' state dicts bit-equal; K1 once a step
           on each rank. Then a 2-rank ScanEvaluator over 96 synthetic
           images, each rank its 48 (2 chunks of 24, K2 once a chunk at
           each stem shape), each image with its own draws: the merged
           table equals the one-process table of the 96. Step times are
           logged, labelled: two processes share one card, so they say
           nothing of scaling. (b) train_kd --distributed under a 1-rank
           NCCL group from torchrun's variables, set by the phase: 3
           synthetic steps at its defaults (bf16) and a scan evaluation (K1
           once a step, the bf16 K2 once a chunk at each shape), its files
           written, the group destroyed on return.
  dist_spread
           not in the default --phases: dist's (a) fp32 steps over 3 steps,
           ungated, read against the yardstick of the step's own rounding:
           the one process on the images in order against the 2 ranks, the
           one process again (gated bit-equal), on the images in 3 other
           orders (the same sums, rounded otherwise), and with the group's
           BatchNorm arithmetic (flax's E[x²] - E[x]²) in place of cuDNN's;
           each run's gaps, grad_norm by step and the first step's forward
           traced by layer (each BatchNorm's batch statistics against one
           process's, the worst layer) are logged.
  cli_spread
           not in the default --phases: the cli phase's (c) 10 times under
           deterministic algorithms (each bit-equal, gated) and 10 times
           without them (ungated): the run-to-run spread of the live and
           the cached multi-step under nondeterministic sums, the readings
           behind (c)'s bit-equal gate.

TF32 is off for matmuls and convolutions throughout, so the fp32
comparisons are fp32 against fp32 (the serving network, one KD step and
the pool's cached votes are also run under PyTorch's defaults); the fp32
networks and configs say so explicitly, as the CLIs default to bf16. Prints the
per-kernel JSON line, the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Any failure raises before that line.
Details go to the --json_out file (default outputs/chip_smoke.json).
"""
from __future__ import annotations

import argparse
import contextlib
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
BF16_FLOPS = 989e12            # H100 SXM bf16, tensor cores, dense (data sheet)
# special-function unit (expf/logf) results: 16 per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs at the 1.98 GHz boost clock
SFU_OPS_PER_S = 16 * 132 * 1.98e9
ATOL_KERNEL = 1e-4
# K2 / K3 in bf16 against their plain versions: within one bf16 rounding of
# the plain output, |kernel - plain| <= BF16_RTOL |plain| + BF16_ATOL
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 1e-3
ATOL_NETWORK = 1e-3
# a bf16 network against the fp32 network of the same weights: max |logit
# difference|, the JAX package's own bound (tests/test_models.py:79-103)
BF16_VS_FP32_LOGITS = 0.25
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
CLI_QUANT_STEPS = 4         # train_kd.main --quant_teacher
# the export phase: raw frame size, requests per timed run, calibration
# batches and timed forwards of the int8 teacher; the int8 teacher's logits
# against the folded fp32 teacher's, over its largest |logit| (JAX's bound,
# tests/test_quant.py:122-124)
EXPORT_FRAME_HW = (480, 640)
EXPORT_REQUESTS = 5
EXPORT_CALIB = 4
EXPORT_FWD_ITERS = 10
INT8_LOGITS_RTOL = 0.05
# the zebra phase: train_zebra's code bits and vertex grid, and its cuts (a
# pool of 4 batches of 16, 20 steps, 5 a call, 16 eval images); the bf16
# steps timed live and pooled, and the timed postprocess runs
ZEBRA_BITS = 16
ZEBRA_VERTS = 6
ZEBRA_POOL = 4
ZEBRA_BATCH = 16
ZEBRA_STEPS = 20
ZEBRA_PER_CALL = 5
ZEBRA_EVAL = 16
ZEBRA_TIMED = 10
ZEBRA_POST_RUNS = 5
# the bop phase: make_bop_dataset's tree (train and test frames, single class
# 0 of 15, as configs/ape.yaml), the loader's batch, threads and timed
# batches, the live steps timed, train_kd's loader threads and its runs (to
# 6 steps, then resumed to 8)
BOP_TRAIN_FRAMES = 64
BOP_TEST_FRAMES = 48
BOP_BATCH = 16
BOP_THREADS = (1, 2, 4)
BOP_LOADER_BATCHES = 4
BOP_TIMED_STEPS = 10
BOP_WORKERS = 4
BOP_STEPS = (6, 8)
# the dist phase: ranks on the one card, the batch a rank, the fp32 and bf16
# steps, the eval images (a multiple of 2 chunks of EVAL_BATCH) and
# train_kd --distributed's steps
DIST_RANKS = 2
DIST_BATCH = 8
DIST_STEPS = 2
DIST_BF16_STEPS = 2
DIST_EVAL_IMAGES = 96
DIST_CLI_STEPS = 3
# the dist_spread phase (not run by default): its fp32 steps, and the other
# orders of the images it reads
DIST_SPREAD_STEPS = 3
DIST_PERMS = 3
# the cli_spread phase (not run by default): repetitions of the cli phase's
# (c) in each mode
CLI_SPREAD_REPS = 10
# the tools phase: train_kd --vis_every 2, pooled (steps a call, steps) and
# per step, with the steps JAX's loop plots after (JAX engine/loop.py:187-188:
# a call ending at `step` when step == k or step % 2 < k, k its steps: the
# calls end at 3, 6, 7; :232: step 1 and the even steps); loop.train's
# steps under profiling.trace; the train batch, where the plots run the
# student's eval stem (K2)
TOOLS_POOLED = (3, 7)
TOOLS_POOLED_PLOTS = (3, 6)
TOOLS_PER_STEP = 5
TOOLS_PER_STEP_PLOTS = (1, 2, 4)
TOOLS_TRACE_STEPS = 2
VIS_BATCH = 16
# the edges of conv3x3_igemm's mapping (B, C, O, H, W), each in both forms:
# a partial channel octet (C = 5, O = 12, M = 23 * 31 odd, B = 1); C = 20
# (a partial third octet) with O = 72 (past 64: the 128-output tiling); C =
# 64 (eight octets through the staging ring) with O = 24, M odd, B = 1;
# 32 -> 64 with a ragged last tile of 256 columns; O = 136, two passes of
# 128 outputs over the block's columns
IGEMM_EDGES = ((1, 5, 12, 23, 29), (2, 20, 72, 10, 13), (1, 64, 24, 17, 19),
               (3, 32, 64, 37, 45), (1, 3, 136, 7, 6))
# K2's edge shapes (B, C, O, H, W): the stem kernels at each row-shift
# remainder (W + 2) % 4 = 1, 3, 0, 2 (M odd in the first two; a ragged last
# tile of the bf16 kernel's 1,024 columns in the first three, a map
# narrower than one in the last), the s2 kernels with M odd and a ragged
# last tile (of 256 columns in bf16), at B = 1 and full size, on a map
# narrower than one 64-column span (M = 42) and on one narrower than a
# tile (M = 168); the bf16 tiling edges that
# tests/test_torch_port_precision.py holds on the CPU (a ragged second
# stem tile with M odd, B = 1; (W + 2) % 4 = 0, 1, 2 on tiny maps; s2 at
# M = 15 and a ragged third tile), then shapes of conv3x3_igemm
K2_EDGES = ((1, 3, 8, 255, 255), (1, 3, 8, 41, 61), (1, 3, 8, 33, 30),
            (2, 3, 8, 19, 28), (3, 8, 16, 67, 61), (2, 8, 16, 30, 30),
            (1, 8, 16, 128, 128), (1, 8, 16, 6, 5), (2, 8, 16, 12, 12),
            (1, 3, 8, 37, 29), (2, 3, 8, 5, 2), (1, 3, 8, 6, 3), (2, 3, 8, 3, 4),
            (1, 8, 16, 3, 3), (2, 8, 16, 17, 30),
            (2, 16, 64, 20, 20), (2, 5, 12, 9, 7)) + IGEMM_EDGES
# K3's edge shapes (B, C, O, H, W): each serving-instance kernel at B = 1
# (both with a ragged last tile), M = H * (W + 2) odd (the 4-byte path) at
# each instance, a ragged last tile at B = 2, then conv3x3_igemm at the
# eval stems of darknet ref and tiny (3 -> 16, 16 -> 32) and its edges
K3_EDGES = ((1, 3, 8, 256, 256), (1, 8, 16, 128, 128), (1, 3, 8, 41, 61),
            (3, 8, 16, 67, 61), (2, 8, 16, 30, 30), (2, 3, 16, 64, 64),
            (2, 16, 32, 32, 32)) + IGEMM_EDGES
# the eval stems of the other DarkNet plans (tag, C, O, H = W), B = 8: tiny
# and ref (3 -> 16 @256², 16 -> 32 @128²), tiny-h-wide (3 -> 32, 32 -> 32),
# the space-to-depth stem's first conv (12 -> 8 @128²; its second is s2's
# 8 -> 16) and 19's second (32 -> 64)
VARIANT_SHAPES = (("tiny_stem", 3, 16, RES), ("tiny_s2", 16, 32, RES // 2),
                  ("wide_stem", 3, 32, RES), ("wide_s2", 32, 32, RES // 2),
                  ("s2d_stem", 12, 8, RES // 2), ("19_s2", 32, 64, RES // 2))


def fp32_on_tensor_cores(stacked: bool, C: int, O: int) -> bool:
    """Whether K2 (or K3, stacked) in fp32 at (C, O) runs its products on the
    tensor cores, as csrc/conv3x3_bn_act.cu dispatches it: every shape in
    3xTF32 (conv3x3_flat_mma at K2's 8 -> 16, conv3x3_igemm elsewhere) but
    the FFMA instances, K2's stem (conv3x3_flat_tiled, 3 -> 8) and K3's
    two streaming ones (conv3x3_stacked_stream, 3 -> 8 and 8 -> 16)."""
    return (C, O) not in (((3, 8), (8, 16)) if stacked else ((3, 8),))


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


def conv_bound(in_bytes: int, B: int, C: int, O: int, M: int, mma: bool = False,
               elem: int = 4):
    """(bound_ms, bound_by, bytes, flops) of a fused 3x3 conv + affine +
    LeakyReLU (K2, K3) writing (B, O, M) of `elem`-byte elements (4 fp32, 2
    bf16): bytes = the input once, the weights, the fp32 scale and bias,
    the output once, over HBM; operations = in fp32 the products over fp32
    on the CUDA cores, or with mma three TF32 products each (3xTF32) over
    the tensor cores' TF32 rate; in bf16 the products over the tensor
    cores' bf16 rate; plus the affine over fp32."""
    nbytes = in_bytes + elem * 9 * O * C + 4 * 2 * O + elem * B * O * M
    conv = B * M * O * 2 * 9 * C
    flops = conv + 2 * B * M * O
    if elem == 2:
        op_s = conv / BF16_FLOPS + (flops - conv) / FP32_FLOPS
    elif mma:
        op_s = 3 * conv / TF32_FLOPS + (flops - conv) / FP32_FLOPS
    else:
        op_s = flops / FP32_FLOPS
    byte_s = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(byte_s, op_s), "bytes" if byte_s >= op_s else "operations",
            nbytes, flops)


def k2_bound(B: int, C: int, O: int, H: int, W: int, elem: int = 4):
    """conv_bound of K2 (the flat form) on its (B, C, (H+2)(W+2)+2) slab."""
    return conv_bound(elem * B * C * ((H + 2) * (W + 2) + 2), B, C, O, H * (W + 2),
                      mma=fp32_on_tensor_cores(False, C, O), elem=elem)


def k3_bound(B: int, C: int, O: int, H: int, W: int, elem: int = 4):
    """conv_bound of K3 (the stacked form) on its (B, 9, C, H(W+2)) stack."""
    M = H * (W + 2)
    return conv_bound(elem * B * 9 * C * M, B, C, O, M,
                      mma=fp32_on_tensor_cores(True, C, O), elem=elem)


def kernel_gate(torch, got, want) -> tuple:
    """(max |got - want|, passed): fp32 within ATOL_KERNEL; bf16 within one
    bf16 rounding of the plain output, |k - p| <= 2^-7 |p| + 1e-3."""
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        ok = bool((d <= BF16_RTOL * want.float().abs() + BF16_ATOL).all())
    else:
        ok = bool(d.max() <= ATOL_KERNEL)
    return d.max().item(), ok


def segment_gate(torch, cf, got, x, w1, s1, b1, w2, s2, b2) -> tuple:
    """(max error, passed) of a stem segment's (pool1, pool2) against the
    plain versions stage by stage, each with kernel_gate: pool1 against the
    plain segment's, pool2 against the plain s2 conv and pool applied to the
    segment's own pool1. In bf16 the two sides may round the stem conv's
    fp32 sum to different neighbours (their sums run in other orders), and
    the s2 conv carries that difference on; stage by stage, each conv is
    held to one rounding of its own input."""
    p1, p2 = got
    want1 = cf.stem_s2_segment_flat_plain(x, w1, s1, b1, w2, s2, b2)[0]
    H2, W2 = p1.shape[1], p1.shape[2]
    y2 = cf.conv3x3_bn_act_flat_plain(cf.nhwc_to_flat(p1), w2, s2, b2, H=H2, W=W2)
    gates = [kernel_gate(torch, a, b) for a, b in (
        (p1, want1), (p2, cf.pool2x2_slab_to_nhwc(y2, H2, W2)))]
    return max(e for e, _ in gates), all(ok for _, ok in gates)


def conv_case(torch, cf, g, dev, B, C, O, H, W, dtype):
    """Seeded inputs of K2 / K3 at one shape: HWIO kernel k (fp32), packed
    weights w in `dtype`, fp32 scale and bias, NHWC x and its slab in
    `dtype`."""
    k = torch.randn((3, 3, C, O), generator=g, device=dev) * (1.0 / math.sqrt(9 * C))
    w = cf.pack_weights(k).to(dtype)
    sc = torch.rand((O, 1), generator=g, device=dev) + 0.5
    bi = torch.randn((O, 1), generator=g, device=dev) * 0.1
    x_nhwc = torch.randn((B, H, W, C), generator=g, device=dev).to(dtype)
    return k, w, sc, bi, x_nhwc, cf.nhwc_to_flat(x_nhwc)


def conv_rows(torch, F, cf, dev, g, B, tag, C, O, H, W, dtype, stacked_too: bool):
    """Rows of the kernels line for K2 (and K3 when stacked_too) at one
    shape and dtype: each against its plain version (kernel_gate), the
    fp32 ones also against the library conv on the valid columns, then
    timed (CUDA-graph replay) beside its bound, the plain version and one
    library call: F.conv2d (K2) or one matmul (K3) in the same dtype, then
    the affine and leaky_relu. Returns (rows, (k, w, sc, bi))."""
    M = H * (W + 2)
    elem = 2 if dtype == torch.bfloat16 else 4
    dname = str(dtype).removeprefix("torch.")
    k, w, sc, bi, x_nhwc, xf = conv_case(torch, cf, g, dev, B, C, O, H, W, dtype)
    x_nchw = x_nhwc.permute(0, 3, 1, 2).contiguous()
    xs = cf.stack_taps(xf, H, W)
    k_oihw = k.permute(3, 2, 0, 1).to(dtype).contiguous()
    w_mat = w.permute(1, 0, 2).reshape(O, 9 * C).contiguous()
    sc_l, bi_l = sc.to(dtype), bi.to(dtype)

    def library_flat(xn):
        y = F.conv2d(xn, k_oihw, padding=1)
        return F.leaky_relu(y * sc_l.reshape(1, O, 1, 1) + bi_l.reshape(1, O, 1, 1), 0.1)

    def library_stacked(xsn):
        y = torch.matmul(w_mat, xsn.reshape(B, 9 * C, M))
        return F.leaky_relu(y * sc_l + bi_l, 0.1)

    rows = []
    forms = (("conv3x3_bn_act_flat", xf,
              lambda a: cf.conv3x3_bn_act_flat(a, w, sc, bi, H=H, W=W),
              lambda a: cf.conv3x3_bn_act_flat_plain(a, w, sc, bi, H=H, W=W),
              library_flat, x_nchw),
             ("conv3x3_bn_act_stacked", xs,
              lambda a: cf.conv3x3_bn_act_stacked(a, w, sc, bi),
              lambda a: cf.conv3x3_bn_act_stacked_plain(a, w, sc, bi),
              library_stacked, xs))
    for name, inp, kern, plain, lib_fn, lib_inp in forms[:2 if stacked_too else 1]:
        got = kern(inp)
        torch.cuda.synchronize()
        err, ok = kernel_gate(torch, got, plain(inp))
        # the valid columns also against the library conv
        lib_err = (cf.flat_to_nhwc(got, H, W).float()
                   - library_flat(x_nchw).permute(0, 2, 3, 1).float()).abs().max().item()
        log(f"[kernel] {name} {tag} {C}->{O} @{H}x{W} B={B} {dname}: max|kernel-plain| "
            f"{err:.3e}, max|kernel-library| (valid cols) {lib_err:.3e}")
        if not ok or (elem == 4 and not lib_err <= ATOL_KERNEL):
            raise AssertionError(f"{name} {tag} {dname} disagrees with its plain version")
        copies = [(inp.clone(),) for _ in range(n_copies(elem * inp.numel()))]
        lib_copies = [(lib_inp.clone(),) for _ in range(n_copies(elem * lib_inp.numel()))]
        ms = time_cuda(torch, kern, copies)
        eager_ms = time_cuda(torch, kern, copies, graph=False)
        plain_ms = time_cuda(torch, plain, copies, iters=20)
        library_ms = time_cuda(torch, lib_fn, lib_copies)
        del copies, lib_copies
        bound = k2_bound if name == "conv3x3_bn_act_flat" else k3_bound
        bound_ms, bound_by, nbytes, flops = bound(B, C, O, H, W, elem=elem)
        rows.append(dict(
            name=name, shape=tag, C=C, O=O, H=H, W=W, B=B, dtype=dname,
            route="cuda", source=CONV_SRC, replaces=REPLACES[name],
            max_abs_err=err, library_max_abs_err=lib_err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            eager_ms=eager_ms, bytes=nbytes, flops=flops))
        log(f"[kernel] {name} {tag} {C}->{O} B={B} {dname}: {ms * 1e3:.1f} us  (bound "
            f"{bound_ms * 1e3:.1f} us by {bound_by}, plain {plain_ms * 1e3:.1f} us, "
            f"library {library_ms * 1e3:.1f} us; eager call incl. host "
            f"{eager_ms * 1e3:.1f} us)")
    return rows, (k, w, sc, bi)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(torch, F, cf, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    shapes = {"stem": (3, 8, RES, RES), "s2": (8, 16, RES // 2, RES // 2)}
    rows, params = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        # K2 and K3 at the serving batch; K2 also at the eval batch, where
        # the evaluators run the eval-mode stem once per chunk (K3 is off
        # that path); K2 and K3 at the other DarkNet plans' stem shapes,
        # in both types
        for tag, (C, O, H, W) in shapes.items():
            r, params[(tag, dtype)] = conv_rows(torch, F, cf, dev, g, BATCH, tag, C, O, H,
                                                W, dtype, stacked_too=True)
            rows += r
        for tag, (C, O, H, W) in shapes.items():
            rows += conv_rows(torch, F, cf, dev, g, EVAL_BATCH, tag, C, O, H, W, dtype,
                              stacked_too=False)[0]
        # K2 at the train batch in bf16: the cloud plots' student forward
        # (train_kd --vis_every at its defaults)
        for tag, (C, O, H, W) in shapes.items():
            if dtype == torch.bfloat16:
                rows += conv_rows(torch, F, cf, dev, g, VIS_BATCH, tag, C, O, H, W, dtype,
                                  stacked_too=False)[0]
        for tag, C, O, H in VARIANT_SHAPES:
            rows += conv_rows(torch, F, cf, dev, g, BATCH, tag, C, O, H, H, dtype,
                              stacked_too=True)[0]
        conv_edges(torch, cf, dev, g, stacked=False, dtype=dtype)
        conv_edges(torch, cf, dev, g, stacked=True, dtype=dtype)

    # the whole stem segment, both forms, both types, against the plain
    # segment stage by stage (segment_gate: fp32 within ATOL_KERNEL, bf16
    # within one bf16 rounding), fp32 also end to end against the plain
    # segment and the NHWC library chain (bf16's chain rounds its conv
    # before the affine, so that difference is only logged); timed beside
    # the library chain in the same type
    segment = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        x = torch.randn((BATCH, RES, RES, 3), generator=g, device=dev).to(dtype)
        (k1, w1, s1, b1), (k2, w2, s2, b2) = params[("stem", dtype)], params[("s2", dtype)]

        def library_segment(xn):
            y = F.max_pool2d(cf.conv3x3_bn_act_ref(xn, k1, s1, b1).permute(0, 3, 1, 2), 2)
            p1 = y.permute(0, 2, 3, 1)
            y = F.max_pool2d(cf.conv3x3_bn_act_ref(p1, k2, s2, b2).permute(0, 3, 1, 2), 2)
            return p1, y.permute(0, 2, 3, 1)

        ref = library_segment(x)
        for stacked in (False, True):
            kern = lambda a: cf.stem_s2_segment_flat(a, w1, s1, b1, w2, s2, b2,
                                                     stacked=stacked)
            plain = lambda a: cf.stem_s2_segment_flat_plain(a, w1, s1, b1, w2, s2, b2,
                                                            stacked=stacked)
            got, want = kern(x), plain(x)
            torch.cuda.synchronize()
            err, ok = segment_gate(torch, cf, got, x, w1, s1, b1, w2, s2, b2)
            end_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            lib_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
            log(f"[kernel] stem_s2_segment_flat stacked={stacked} {dname}: max|seg-plain| "
                f"stage by stage {err:.3e}, end to end {end_err:.3e}; max|seg-library| "
                f"{lib_err:.3e}")
            if not ok or (dtype == torch.float32
                          and not max(end_err, lib_err) <= ATOL_KERNEL):
                raise AssertionError(f"segment stacked={stacked} {dname} disagrees")
            copies = [(x.clone(),) for _ in range(n_copies(x.element_size() * x.numel()))]
            segment.append(dict(stacked=stacked, dtype=dname, max_abs_err=err,
                                end_to_end_max_abs_err=end_err,
                                library_max_abs_err=lib_err,
                                ms=time_cuda(torch, kern, copies, iters=20),
                                plain_ms=time_cuda(torch, plain, copies, iters=20),
                                library_ms=time_cuda(torch, library_segment, copies,
                                                     iters=20)))
            log(f"[kernel] segment stacked={stacked} {dname}: {json.dumps(segment[-1])}")
    return rows, segment


def conv_edges(torch, cf, dev, g, stacked: bool, dtype):
    """K2 at K2_EDGES, or K3 at K3_EDGES (stacked), in `dtype`: the edges of
    their thread mappings and shapes of conv3x3_igemm. All columns
    against the plain version (kernel_gate), in fp32 the valid ones also
    against the library conv; each time is logged, not a row of the
    kernels line."""
    name = "conv3x3_bn_act_stacked" if stacked else "conv3x3_bn_act_flat"
    elem = 2 if dtype == torch.bfloat16 else 4
    for B, C, O, H, W in K3_EDGES if stacked else K2_EDGES:
        k, w, sc, bi, x_nhwc, xf = conv_case(torch, cf, g, dev, B, C, O, H, W, dtype)
        if stacked:
            inp = cf.stack_taps(xf, H, W)
            kern = lambda a: cf.conv3x3_bn_act_stacked(a, w, sc, bi)
        else:
            inp = xf
            kern = lambda a: cf.conv3x3_bn_act_flat(a, w, sc, bi, H=H, W=W)
        got = kern(inp)
        torch.cuda.synchronize()
        err, ok = kernel_gate(torch, got, cf.conv3x3_bn_act_flat_plain(xf, w, sc, bi, H=H,
                                                                       W=W))
        lib_err = (cf.flat_to_nhwc(got, H, W).float()
                   - cf.conv3x3_bn_act_ref(x_nhwc, k, sc, bi).float()).abs().max().item()
        ms = time_cuda(torch, kern, [(inp.clone(),)
                                     for _ in range(n_copies(elem * inp.numel()))])
        log(f"[kernel] {name} edge B={B} {C}->{O} @{H}x{W} {dtype}: max|kernel-plain| "
            f"{err:.3e}, max|kernel-library| (valid cols) {lib_err:.3e}; {ms * 1e3:.2f} us")
        if not ok or (elem == 4 and not lib_err <= ATOL_KERNEL):
            raise AssertionError(f"{name} disagrees at B={B} {C}->{O} @{H}x{W} {dtype}")
        if not stacked and (C, O) in ((3, 8), (8, 16)) and (H, W) in ((33, 30), (67, 61)):
            # the serving instances on a slab that starts one element past a
            # 16-byte boundary (a contiguous view at an odd offset)
            off = torch.empty(xf.numel() + 1, device=dev, dtype=dtype)[1:].view_as(xf)
            off.copy_(xf)
            got = kern(off)
            torch.cuda.synchronize()
            err, ok = kernel_gate(torch, got, cf.conv3x3_bn_act_flat_plain(
                xf, w, sc, bi, H=H, W=W))
            log(f"[kernel] {name} edge B={B} {C}->{O} @{H}x{W} {dtype}, slab at an odd "
                f"element offset: max|kernel-plain| {err:.3e}")
            if not ok:
                raise AssertionError(f"{name} disagrees on an offset slab at {C}->{O} {dtype}")


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
    import dataclasses

    from kd6d_pose_adlp_tpu_torch.config import Config
    from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
    from kd6d_pose_adlp_tpu_torch.engine.serving import SINGLE_KEYS, build_infer_fn
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net

    cfg = Config()
    assert (cfg.model.backbone, cfg.model.input_res, cfg.model.compute_dtype) == (
        "darknet_tiny_h", RES, "float32")
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
    # (C, O) shapes of the segment, and nothing else
    seg_shapes = ((3, 8), (8, 16))

    def check_launches(name, n_requests, dtype="float32", shapes=seg_shapes):
        by_shape = dict(cf.launches)
        want = {(name, c, o, dtype): n_requests for c, o in shapes}
        if by_shape != want:
            raise AssertionError(f"{name} {dtype} was not launched once per request "
                                 f"at each of {shapes}: {by_shape}")
        return by_shape

    def per_kernel(by_shape):
        totals = {}
        for (n, _, _, _), v in by_shape.items():
            totals[n] = totals.get(n, 0) + v
        return totals

    serve(infer, reqs[0], 0)                                # warm-up, not counted
    cf.reset_launch_counts()
    lat = [serve(infer, reqs[1 + r], r)[1] for r in range(n_flat)]
    by_shape_flat = check_launches("conv3x3_bn_act_flat", n_flat)
    counts_flat = per_kernel(by_shape_flat)
    shapes_flat = {f"{n}:{c}->{o}:{d}": v for (n, c, o, d), v in by_shape_flat.items()}
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

    # the same network in bf16 (the JAX serving default's dtype), same
    # weights: its bf16 K2 launched twice a request, its logits within
    # BF16_VS_FP32_LOGITS of the fp32 network's
    variants = {}

    def variant(backbone, dtype, n_requests, shapes, ref=None, sd=None, stacked=False):
        """n_requests through the `backbone` PoseNet in `dtype` (its eval stem
        on K3 when `stacked`) on the card; returns (launches by shape, its
        network outputs on reqs[1], its state_dict)."""
        c = cfg.replace(model=dataclasses.replace(cfg.model, backbone=backbone,
                                                  compute_dtype=dtype))
        v_net = PoseNet(c.model, n_fg=cfg.data.n_fg, stem_stacked=stacked)
        if sd is None:
            init_pose_net(v_net, torch.Generator().manual_seed(0))
        else:
            v_net.load_state_dict(sd, strict=True)
        fn = build_infer_fn(c, ds.consts(device=dev), v_net, device=dev)
        serve(fn, reqs[0], 0)
        cf.reset_launch_counts()
        lat_v = [serve(fn, reqs[1 + r], r)[1] for r in range(n_requests)]
        by = check_launches("conv3x3_bn_act_stacked" if stacked else "conv3x3_bn_act_flat",
                            n_requests, dtype, shapes)
        vc, vr = fn.network(reqs[1]["images"])
        tag = f"{backbone}{' stacked' if stacked else ''}"
        row = dict(backbone=backbone, dtype=dtype, stacked=stacked, requests=n_requests,
                   request_ms=[1e3 * t["total_s"] for t in lat_v],
                   network_ms=[1e3 * t["network_s"] for t in lat_v],
                   launches={f"{n}:{c_}->{o}:{d}": v for (n, c_, o, d), v in by.items()})
        if ref is not None:
            row["logits_vs_fp32"] = (vc - ref[0]).abs().max().item()
            row["reg_vs_fp32"] = (vr - ref[1]).abs().max().item()
        log(f"[serving] {tag} {dtype}, {n_requests} requests: "
            + ", ".join(f"{x:.1f}" for x in row["request_ms"]) + " ms (network "
            + ", ".join(f"{x:.1f}" for x in row["network_ms"]) + f" ms); launches "
            f"{row['launches']}" + ("" if ref is None else
                                    f"; vs the fp32 network: max |logits diff| "
                                    f"{row['logits_vs_fp32']:.3e} (gate "
                                    f"{BF16_VS_FP32_LOGITS}), max |reg diff| "
                                    f"{row['reg_vs_fp32']:.3e}"))
        if ref is not None and not row["logits_vs_fp32"] <= BF16_VS_FP32_LOGITS:
            raise AssertionError(f"{tag} bf16 logits miss the fp32 network's")
        variants[f"{tag}:{dtype}"] = row
        return by, (vc, vr), v_net.state_dict()

    by_variants = {}

    def add(by):
        for key, v in by.items():
            by_variants[key] = by_variants.get(key, 0) + v

    add(variant("darknet_tiny_h", "bfloat16", n_flat, seg_shapes, ref=(gc, gr), sd=state)[0])
    add(variant("darknet_tiny_h", "bfloat16", n_stacked, seg_shapes, ref=(gc, gr), sd=state,
                stacked=True)[0])
    # the paper's other student, darknet_tiny (K2 at its stem's 3 -> 16 and
    # 16 -> 32), and the two experiment students (tiny-h-wide: 3 -> 32, 32 ->
    # 32; the space-to-depth stem: 12 -> 8 and 8 -> 16 at 128²), each in
    # fp32 and in bf16 with the same weights
    for backbone, shapes in (("darknet_tiny", ((3, 16), (16, 32))),
                             ("darknet_tiny_h_wide", ((3, 32), (32, 32))),
                             ("darknet_tiny_h_s2d", ((12, 8), (8, 16)))):
        by32, ref32, sd32 = variant(backbone, "float32", 2, shapes)
        add(by32)
        add(variant(backbone, "bfloat16", 2, shapes, ref=ref32, sd=sd32)[0])

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
        stacked_vs_flat=st_err, profile=prof, variants=variants)
    # busy and wall time of the same (profiled) request
    summary["device_idle_share"] = (
        1.0 - prof["device_busy_ms"] / prof["wall_ms"]
        if prof["device_busy_ms"] > 0 else None)
    # (name, C, O, dtype) -> launches; each run launches only its kernels
    launches = dict(by_shape_flat)
    for by in (by_shape_st, by_variants):
        for key, v in by.items():
            launches[key] = launches.get(key, 0) + v
    return summary, launches


# ---------------------------------------------------------------------------
# pose phase
# ---------------------------------------------------------------------------

def pose_rot_deg(Ra, Rb) -> float:
    """Angle between two rotations in degrees, from the chord |Ra - Rb|_F =
    2 sqrt(2) sin(angle / 2): stable near 0, where arccos of the fp32 trace
    floors at a few hundredths of a degree."""
    import numpy as np
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0))))


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
    R = out["R"][0].cpu().numpy()
    T = out["T"][0].cpu().numpy()
    rot = pose_rot_deg(R_gt, R)
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
    rot_ch = pose_rot_deg(Rh, Rc)
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
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, max_iter=TRAIN_STEPS),
                      model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    cfg_t = cfg.replace(model=dataclasses.replace(cfg.model, backbone="darknet53",
                                                  prior=0.5))
    assert cfg.model.backbone == "darknet_tiny_h" and cfg.model.input_res == RES
    return cfg, cfg_t


def bf16_configs(cfg, cfg_t, remat: bool = False):
    """train_kd's default pair: the student in bf16 (rematerialized when
    `remat`), the teacher in bf16 with its BN folded."""
    import dataclasses
    return (cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16",
                                                  remat=remat)),
            cfg_t.replace(model=dataclasses.replace(cfg_t.model, compute_dtype="bfloat16",
                                                    bn_folded=True)))


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

    bf16, k1_bf16 = train_bf16(torch, sf, dev, cfg, cfg_t, batches, consts, teacher_sd,
                               med)
    return dict(
        bf16=bf16,
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
                                  grad_rel=gd_rel)), k1 + k1_bf16


def step_diff(torch, a, b):
    """Two one_step results (metrics, state_dict, gradients): the largest
    relative metric difference, the worst parameter tensor's gradient
    ||g_a - g_b|| / ||g_b||, BN statistics' max |diff| over their largest
    entry, and the parameters' max |diff|."""
    (ma, sa, ga), (mb, sb, gb) = a, b
    stat = lambda k: k.endswith(("running_mean", "running_var"))  # noqa: E731
    if set(ga) != set(gb):
        raise AssertionError(f"gradients of {sorted(set(ga) ^ set(gb))} in one step only")
    g_rel = {k: float(torch.linalg.vector_norm(ga[k].float() - gb[k].float())
                      / torch.linalg.vector_norm(gb[k].float()).clamp_min(1e-30)) for k in gb}
    return dict(
        metric_rel=max(abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-12) for k in mb),
        grad_rel_worst=max(g_rel.values()),
        bn_stat_rel=max(float((sa[k] - sb[k]).abs().max()
                              / sb[k].abs().max().clamp_min(1e-12)) for k in sa if stat(k)),
        param_max_abs=max(float((sa[k].float() - sb[k].float()).abs().max())
                          for k in sa if sa[k].is_floating_point() and not stat(k)))


def train_bf16(torch, sf, dev, cfg, cfg_t, batches, consts, teacher_sd, fp32_median_ms):
    """train_kd's defaults on the card: the bf16 student against the bf16
    BN-folded darknet53 teacher, TRAIN_STEPS steps of engine/loop.train
    plain and with remat (K1 once per step, finite metrics, median step ms,
    images/s and peak memory beside the fp32 run's); one remat step against
    the plain step from the same weights and draws (the train phase's
    card-vs-CPU limits); the folded teacher's outputs and votes against
    the unfolded teacher's, in fp32 (1e-4 of each field's largest
    magnitude). Returns (summary, K1 launches)."""
    import statistics

    from kd6d_pose_adlp_tpu_torch.engine import steps
    from kd6d_pose_adlp_tpu_torch.engine.loop import train
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
    from kd6d_pose_adlp_tpu_torch.utils.fold_bn import fold_batchnorm
    from kd6d_pose_adlp_tpu_torch.utils.precision import full_fp32

    B = cfg.solver.ims_per_batch
    folded_sd = fold_batchnorm(teacher_sd)
    k1_key = ("sinkhorn_potentials", cfg.solver.max_pos, cfg.kd.max_teacher_cells)
    runs, k1_total = {}, 0
    for remat in (False, True):
        c, c_t = bf16_configs(cfg, cfg_t, remat)
        torch.cuda.reset_peak_memory_stats()
        sf.reset_launch_counts()
        with tempfile.TemporaryDirectory() as wd:
            state, hist = train(c, consts, iter(batches), cfg_t=c_t,
                                teacher_state_dict=folded_sd, device=dev, log_every=1,
                                working_dir=wd, verbose=False)
        k1 = sf.launches.get(k1_key, 0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if state.step != TRAIN_STEPS or len(hist) != TRAIN_STEPS or k1 != TRAIN_STEPS:
            raise AssertionError(f"bf16 train (remat {remat}): {state.step} steps, "
                                 f"{len(hist)} logged, K1 {dict(sf.launches)}")
        for h in hist:
            if not (all(math.isfinite(v) for v in h.values()) and h["loss_kd"] > 0):
                raise AssertionError(f"bf16 train (remat {remat}) metrics {h}")
        step_ms = [h["step_ms"] for h in hist[TRAIN_WARMUP:]]
        med = statistics.median(step_ms)
        tag = "bf16_remat" if remat else "bf16"
        runs[tag] = dict(median_step_ms=med, images_per_sec=1e3 * B / med,
                         peak_memory_gib=peak, step_ms=[h["step_ms"] for h in hist],
                         k1_launches=k1, last=hist[-1])
        k1_total += k1
        log(f"[train] {tag}: student bf16, teacher darknet53 bf16 BN-folded: median step "
            f"{med:.2f} ms over steps {TRAIN_WARMUP + 1}-{TRAIN_STEPS} -> {1e3 * B / med:.1f} "
            f"images/s (fp32 {fp32_median_ms:.2f} ms, {1e3 * B / fp32_median_ms:.1f} "
            f"images/s); peak device memory {peak:.2f} GiB; K1 {k1} launches; last step "
            f"loss_total {hist[-1]['loss_total']:.4f} (kd {hist[-1]['loss_kd']:.5f})")

    # one remat step against the plain step: same weights, batch and draws
    student = init_pose_net(PoseNet(cfg.model, n_fg=cfg.data.n_fg),
                            torch.Generator().manual_seed(2))
    student_sd = {k: v.clone() for k, v in student.state_dict().items()}
    uniform = torch.rand((B, cfg.model.num_cells, batches[0].class_ids.shape[1]),
                         generator=torch.Generator().manual_seed(3))
    one = {remat: one_step(torch, *bf16_configs(cfg, cfg_t, remat), consts, student_sd,
                           folded_sd, batches[0], uniform, dev) for remat in (False, True)}
    d = step_diff(torch, one[True], one[False])
    log(f"[train] one bf16 step B={B}, remat vs plain: metrics {d['metric_rel']:.2e}, "
        f"worst gradient tensor {d['grad_rel_worst']:.2e}, BN statistics "
        f"{d['bn_stat_rel']:.2e}, parameters max |diff| {d['param_max_abs']:.2e} (gates "
        f"1e-3, RTOL_GRADIENTS {RTOL_GRADIENTS:g}, 1e-4)")
    if not (d["metric_rel"] <= 1e-3 and d["grad_rel_worst"] <= RTOL_GRADIENTS
            and d["bn_stat_rel"] <= 1e-4):
        raise AssertionError("the remat step misses the plain step on the card")

    # the folded teacher's votes against the unfolded teacher's, fp32
    import dataclasses
    cfg_tf = cfg_t.replace(model=dataclasses.replace(cfg_t.model, bn_folded=True))
    nets = []
    for c_t, sd in ((cfg_t, teacher_sd), (cfg_tf, folded_sd)):
        t_net = PoseNet(c_t.model, n_fg=cfg.data.n_fg)
        t_net.load_state_dict(sd, strict=True)
        nets.append(t_net.to(dev).eval())
    with full_fp32(), torch.no_grad():
        v_un = steps.teacher_votes(cfg, cfg_t, nets[0], batches[0])
        v_f = steps.teacher_votes(cfg, cfg_tf, nets[1], batches[0])
        outs = [n(batches[0].images) for n in nets]
    # each float field (and the teacher's outputs) within 1e-4 of its largest
    # magnitude, the valid masks equal. Not elementwise: a keypoint near the
    # frame's origin carries the pixel error of its box (reg error x box size,
    # ~1e-3 px), which is no relative error of that coordinate
    fold_rel = {}
    for name, a, b in list(zip(("cls", "reg"), outs[1], outs[0])) + list(
            zip(v_un._fields, v_f, v_un)):
        if a.shape != b.shape or (a.dtype == torch.bool and not torch.equal(a, b)):
            raise AssertionError(f"folded teacher: {name} differs in shape or mask")
        fold_rel[name] = ((a.float() - b.float()).abs().max()
                          / b.float().abs().max().clamp_min(1e-30)).item()
    log(f"[train] folded vs unfolded darknet53 teacher, fp32, B={B}: max |diff| over "
        f"max |value|: " + ", ".join(f"{k} {v:.2e}" for k, v in fold_rel.items())
        + f" (gate 1e-4); valid masks equal, {int(v_un.valid.sum())} valid votes")
    if not max(fold_rel.values()) <= 1e-4:
        raise AssertionError("the folded teacher's votes miss the unfolded teacher's")
    return dict(runs=runs, remat_vs_plain=d, folded_vs_unfolded_rel=fold_rel), k1_total


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


def live_vs_cached(torch, cfg, cfg_t, consts, teacher, pool, dev, det: bool = True):
    """4 fp32 multi-steps over the first 3 batches of `pool` from one seeded
    student and one set of SSC draws, once with the live teacher and once
    with its votes cached, both under deterministic algorithms (unless not
    `det`): both runs' metrics, the largest relative difference of the
    losses, the largest |difference| of a parameter, whether the BN
    statistics agree within rtol 1e-3 / atol 1e-4, and whether the two
    runs' metrics and state dicts are bit-equal.

    The two paths take the same votes into the same step, so under
    deterministic algorithms they agree bit for bit (the cli_spread
    phase). Under the nondeterministic sums (cuDNN's backward, atomic
    scatters) run-to-run noise alone parts them, and a tail of that noise
    once broke the 1e-4 / 5e-3 bounds this check held before."""
    from kd6d_pose_adlp_tpu_torch.engine import steps
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net

    n_fg, B = cfg.data.n_fg, cfg.solver.ims_per_batch
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

    with deterministic(torch) if det else contextlib.nullcontext():
        (m_live, sd_live), (m_cache, sd_cache) = run(False), run(True)
    stat = lambda kk: kk.endswith(("running_mean", "running_var"))  # noqa: E731
    return dict(
        live=m_live, cached=m_cache,
        bit_equal=(m_live == m_cache and sd_live.keys() == sd_cache.keys()
                   and all(torch.equal(sd_cache[kk], v) for kk, v in sd_live.items())),
        metric_rel=max(abs(m_cache[kk] - m_live[kk]) / max(abs(m_live[kk]), 1e-12)
                       for kk in ("loss_total", "loss_cls", "loss_reg", "loss_kd")),
        param_max_abs=max(float((sd_cache[kk] - v).abs().max()) for kk, v in sd_live.items()
                          if v.is_floating_point() and not stat(kk)),
        bn_stats_ok=all(torch.allclose(sd_cache[kk], v, rtol=1e-3, atol=1e-4)
                        for kk, v in sd_live.items() if stat(kk)))


def cli_spread_phase(torch, dev):
    """The cli phase's (c), CLI_SPREAD_REPS times with and as many without
    deterministic algorithms, on the cli phase's pool and teacher: each
    repetition's readings are logged; the deterministic ones must be
    bit-equal (live against cached, and each run against the first)."""
    from kd6d_pose_adlp_tpu_torch.data import loaders
    from kd6d_pose_adlp_tpu_torch.data.batch import Batch
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net

    cfg, cfg_t = train_configs()
    data = loaders.build(cfg, kind="synthetic", device=dev)
    it = data.train_iter()
    pool = Batch.stack([next(it) for _ in range(CLI_POOL)]).to(dev)
    teacher = init_pose_net(PoseNet(cfg_t.model, n_fg=cfg.data.n_fg),
                            torch.Generator().manual_seed(1)).to(dev).eval()
    out = {}
    for det in (True, False):
        tag = "deterministic" if det else "default"
        out[tag] = [live_vs_cached(torch, cfg, cfg_t, data.consts, teacher, pool, dev, det)
                    for _ in range(CLI_SPREAD_REPS)]
        for r, c in enumerate(out[tag]):
            log(f"[cli_spread] {tag} {r}: loss_total live {c['live']['loss_total']!r} "
                f"cached {c['cached']['loss_total']!r}; largest relative loss difference "
                f"{c['metric_rel']:.3e}, parameters max |diff| {c['param_max_abs']:.3e}, BN "
                f"statistics ok {c['bn_stats_ok']}, num_pos {c['live']['num_pos']} / "
                f"{c['cached']['num_pos']}, bit-equal {c['bit_equal']}")
        log(f"[cli_spread] {tag}, {CLI_SPREAD_REPS} repetitions: largest relative loss "
            f"difference {max(c['metric_rel'] for c in out[tag]):.3e}, parameters max "
            f"|diff| {max(c['param_max_abs'] for c in out[tag]):.3e}")
    first = out["deterministic"][0]
    if not all(c["bit_equal"] and c["live"] == first["live"] for c in out["deterministic"]):
        raise AssertionError("deterministic live/cached multi-steps are not bit-equal")
    return out


def cli_phase(torch, sf, cf, dev, tf32_defaults):
    """The training entry point's path on the card: the device pool, the
    cached teacher, K steps per call, K1 in every step, checkpoints and
    resume, and the student's evaluation (K2) at the end. (a) the pool's
    cached votes against live votes; (b) engine/loop.train with the pool
    and the cache, 10 steps in 2 calls, then timed and profiled cached
    steps; (c) live against cached multi-steps from the same weights and
    draws, bit-equal under deterministic algorithms; (d) train_kd.main to 6 steps, then resumed to 8; (f)
    train_kd.main --quant_teacher, then export_model --check on its
    final.ckpt; (e) evaluate.main on the (d) run's final.ckpt."""
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

    # (c) live against cached multi-steps, same weights and draws, under
    # deterministic algorithms: bit-equal
    c = live_vs_cached(torch, cfg, cfg_t, consts, teacher, pool, dev)
    m_live, m_cache = c["live"], c["cached"]
    log(f"[cli] (c) 4 steps over a 3-batch pool, live vs cached teacher, deterministic "
        f"algorithms: metrics {m_live} vs {m_cache} (largest relative difference "
        f"{c['metric_rel']:.2e}); parameters max |diff| {c['param_max_abs']:.2e}; BN "
        f"statistics within rtol 1e-3 / atol 1e-4: {c['bn_stats_ok']}; metrics and state "
        f"dicts bit-equal (gate): {c['bit_equal']}")
    if not (m_live["loss_kd"] > 0 and c["bit_equal"]):
        raise AssertionError("the cached-teacher multi-step misses the live one")

    # (d) the entry point, then its resume; (e) the evaluation CLI
    tmp = tempfile.TemporaryDirectory()
    wd = tmp.name
    wf = os.path.join(wd, "teacher.pt")
    torch.save(teacher_sd, wf)
    n_chunks = -(-CLI_EVAL_IMAGES // cfg.test.ims_per_batch)
    shapes = ((3, 8), (8, 16))
    # the CLI's defaults: bf16 student and teacher, the teacher's BN folded
    args = ["--config_file", CLI_CONFIG_FILE, "--data", "synthetic", "--device_pool",
            str(CLI_POOL), "--steps_per_dispatch", "5", "--cache_teacher",
            "--weight_file_t", wf, "--working_dir", wd]
    # the CLIs' K2 launches, by batch: train_kd's evaluations at TestConfig's
    # batch, evaluate.main's at its --ims_per_batch
    k2_launches = {cfg.test.ims_per_batch: {}, EVAL_BATCH: {}}
    runs = {}
    for max_iters in (6, 8):
        sf.reset_launch_counts()
        cf.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            st, h = train_kd.main(args + ["--max_iters", str(max_iters),
                                          "--vis_every", "0"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        printed = buf.getvalue()
        k1 = sf.launches.get(k1_key, 0)
        k2 = {f"{c}->{o}": cf.launches.get(("conv3x3_bn_act_flat", c, o, "bfloat16"), 0)
              for c, o in shapes}
        for key, v in cf.launches.items():
            k2_launches[cfg.test.ims_per_batch][key] = (
                k2_launches[cfg.test.ims_per_batch].get(key, 0) + v)
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
                and "teacher: BN folded into conv weights" in printed
                and (first or want_resume in printed)):
            raise AssertionError(f"train_kd.main --max_iters {max_iters}: steps, launches, "
                                 "evaluations or resume not as expected")
        missing = [f for f in ("latest.ckpt", "final.ckpt", "cfg.json", "info.txt",
                               "scalars.jsonl") if not os.path.exists(os.path.join(wd, f))]
        if missing:
            raise AssertionError(f"train_kd.main did not write {missing}")
        runs[max_iters] = dict(seconds=secs, k1=k1, k2=k2, history=h)

    # (f) the int8 teacher: train_kd.main --quant_teacher with the cached
    # votes, then export_model --check on that run's final.ckpt
    from kd6d_pose_adlp_tpu_torch import export_model
    qwd = os.path.join(wd, "quant")
    sf.reset_launch_counts()
    cf.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        st_q, h_q = train_kd.main(args[:-2] + ["--working_dir", qwd, "--quant_teacher",
                                               "--max_iters", str(CLI_QUANT_STEPS),
                                               "--vis_every", "0"])
    torch.cuda.synchronize()
    q_secs = time.perf_counter() - t0
    printed = buf.getvalue()
    k1_q = sf.launches.get(k1_key, 0)
    k2_q = {f"{c}->{o}": cf.launches.get(("conv3x3_bn_act_flat", c, o, "bfloat16"), 0)
            for c, o in shapes}
    for key, v in cf.launches.items():
        k2_launches[cfg.test.ims_per_batch][key] = (
            k2_launches[cfg.test.ims_per_batch].get(key, 0) + v)
    log(f"[cli] (f) train_kd.main --quant_teacher --max_iters {CLI_QUANT_STEPS} "
        f"({q_secs:.1f} s): step {st_q.step}, K1 {k1_q} launches, K2 {k2_q}; "
        + "; ".join(f"step {x['step']}: loss_total {x['loss_total']:.4f} (kd "
                    f"{x['loss_kd']:.5f})" for x in h_q) + "; printed: "
        + " | ".join(line for line in printed.splitlines() if line.startswith("teacher")))
    if not (st_q.step == CLI_QUANT_STEPS and k1_q == CLI_QUANT_STEPS
            and sum(sf.launches.values()) == CLI_QUANT_STEPS
            and set(k2_q.values()) == {n_chunks} and sum(cf.launches.values()) == 2 * n_chunks
            and all(math.isfinite(v) for x in h_q for v in x.values())
            and "teacher: int8-quantized (4 calib batches)" in printed
            and "teacher knowledge cached for" in printed):
        raise AssertionError("train_kd.main --quant_teacher: steps, launches, losses or "
                             "the int8 teacher not as expected")
    cf.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        meta = export_model.main(["--weight_file", os.path.join(qwd, "final.ckpt"),
                                  "--batch_size", str(BATCH), "--check",
                                  "--out", os.path.join(wd, "student.pt2")])
    printed = buf.getvalue()
    k2_launches.setdefault(BATCH, {})
    for key, v in cf.launches.items():
        k2_launches[BATCH][key] = k2_launches[BATCH].get(key, 0) + v
    log(f"[cli] (f) export_model --check on its final.ckpt ({time.perf_counter() - t0:.1f} "
        f"s): {meta['bytes']} bytes, K2 {dict(cf.launches)}; "
        + " | ".join(line for line in printed.splitlines()
                     if line.startswith(("loaded", "round-trip"))))
    if not ("round-trip check OK" in printed and printed.startswith("loaded ")
            and set(cf.launches.values()) == {2}):
        raise AssertionError("export_model --check on the run's final.ckpt failed")
    runs["quant_teacher"] = dict(seconds=q_secs, k1=k1_q, k2=k2_q, history=h_q,
                                 export_bytes=meta["bytes"])

    buf = io.StringIO()
    cf.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        ev = evaluate.main(["--config_file", CLI_CONFIG_FILE, "--weight_file",
                            os.path.join(wd, "final.ckpt"), "--data", "synthetic",
                            "--ims_per_batch", str(EVAL_BATCH),
                            "--working_dir", os.path.join(wd, "eval")])
    printed = buf.getvalue()
    k2_launches[EVAL_BATCH] = dict(cf.launches)
    n_eval_chunks = -(-CLI_EVAL_IMAGES // EVAL_BATCH)
    if k2_launches[EVAL_BATCH] != {("conv3x3_bn_act_flat", c, o, "bfloat16"): n_eval_chunks
                                   for c, o in shapes}:
        raise AssertionError(f"evaluate.main at its bf16 default: K2 launches "
                             f"{k2_launches[EVAL_BATCH]}, not once per chunk in bf16")
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
        live_vs_cached=c,
        train_kd=runs, k2_launches={str(b): {":".join(map(str, k)): v for k, v in by.items()}
                                    for b, by in k2_launches.items()}), \
        k1_b + runs[6]["k1"] + runs[8]["k1"] + k1_q, k2_launches


# ---------------------------------------------------------------------------
# bop phase
# ---------------------------------------------------------------------------

def bop_tree_phase(png, native, make_bop_dataset, root):
    """(a) The tree: make_bop_dataset's frames and masks written, each PNG
    re-read bit-equal to the array that was written, png_unfilter against
    its numpy version on random rows. Returns (config path, summary)."""
    import numpy as np

    from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset

    t0 = time.perf_counter()
    yaml_path = make_bop_dataset.write_dataset(root, BOP_TRAIN_FRAMES, BOP_TEST_FRAMES,
                                               n_fg=15, single_class=0, seed=0)
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    ds = SyntheticPoseDataset(n_fg=15, single_class=0, seed=0)
    frame_s = mask_s = 0.0
    for split, n, base in (("train", BOP_TRAIN_FRAMES, 1000), ("test", BOP_TEST_FRAMES, 0)):
        scene = os.path.join(root, split, "000001")
        for j in range(n):
            s = ds.sample_internal(base + j)
            t0 = time.perf_counter()
            img = png.read(os.path.join(scene, "rgb", f"{j:06d}.png"))
            t1 = time.perf_counter()
            mask = png.read(os.path.join(scene, "mask_visib", f"{j:06d}_000000.png"))
            frame_s += t1 - t0
            mask_s += time.perf_counter() - t1
            if not (np.array_equal(img, s["img"][:, :, ::-1]) and np.array_equal(mask, s["mask"])):
                raise AssertionError(f"{split} frame {j}: the PNG read back differs from the "
                                     "array written")
    rng = np.random.default_rng(0)
    for bpp in (1, 2, 3, 4, 6, 8):
        rows, stride = 64, 97 * bpp
        raw = rng.integers(0, 256, (rows, stride + 1), dtype=np.uint8)
        raw[:, 0] = rng.integers(0, 5, rows)
        if not np.array_equal(native.png_unfilter(raw, rows, stride, bpp),
                              png.unfilter_plain(raw, rows, stride, bpp)):
            raise AssertionError(f"png_unfilter at {bpp} bytes a pixel differs from its "
                                 "numpy version")
    n = BOP_TRAIN_FRAMES + BOP_TEST_FRAMES
    log(f"[bop] (a) make_bop_dataset: {BOP_TRAIN_FRAMES} train + {BOP_TEST_FRAMES} test "
        f"640x480 frames, {nbytes / 2**20:.1f} MiB, in {write_s:.1f} s; every frame and mask "
        f"read back bit-equal, {1e3 * frame_s / n:.2f} ms a frame, {1e3 * mask_s / n:.2f} ms "
        f"a mask; png_unfilter equals its numpy version at 1-8 bytes a pixel")
    return yaml_path, dict(write_s=write_s, mib=nbytes / 2**20,
                           frame_read_ms=1e3 * frame_s / n, mask_read_ms=1e3 * mask_s / n)


def bop_samples_phase(cfg, yaml_path):
    """(b) BOPPoseDataset slow and fast, train and eval: the sample
    contract; eval crops' GT poses against scene_gt.json; the loader's
    images/s at B = 16 with 1, 2 and 4 threads (warm decode cache)."""
    import dataclasses

    import numpy as np

    from kd6d_pose_adlp_tpu_torch.data import bop
    from kd6d_pose_adlp_tpu_torch.data.pipeline import BOPPoseDataset, PrefetchLoader

    res, G = cfg.model.input_res, cfg.solver.max_objs
    with open(os.path.join(os.path.dirname(cfg.data.test_list), "test", "000001",
                           "scene_gt.json")) as f:
        scene_gt = json.load(f)
    worst_r = worst_t = 0.0
    rates = {}
    for fast in (False, True):
        c = cfg.replace(data=dataclasses.replace(cfg.data, fast_pipeline=fast))
        tag = "fast" if fast else "slow"
        for train in (False, True):
            ds = BOPPoseDataset(c, c.data.train_list if train else c.data.test_list, train)
            items = ds.eval_items() if not train else [(i, None) for i in range(16)]
            if not train and len(items) != BOP_TEST_FRAMES:
                raise AssertionError(f"{len(items)} eval items for {BOP_TEST_FRAMES} frames")
            for i, obj in items:
                s = ds.sample(i, seed=1, focus_obj=obj)
                if s is None:
                    raise AssertionError(f"{tag} {'train' if train else 'eval'} sample {i} "
                                         "dropped")
                want = ((res, res, 3), np.uint8), ((res, res), np.int32), ((G,), np.int32), \
                    ((G, 3, 3), np.float32), ((G, 3), np.float32), ((2, 3), np.float32)
                for k, (shape, dt) in zip(("image", "mask", "class_ids", "rotations",
                                           "translations", "bbox_trans"), want):
                    if s[k].shape != shape or s[k].dtype != dt:
                        raise AssertionError(f"sample {k}: {s[k].shape} {s[k].dtype}")
                if list(s["class_ids"]) != [0] + [-1] * (G - 1):
                    raise AssertionError(f"class ids {s['class_ids']}")
                if not all(np.isfinite(s[k]).all() for k in ("rotations", "translations",
                                                              "bbox_trans")):
                    raise AssertionError("non-finite pose or crop affine")
                if not (s["mask"] == 1).any():
                    raise AssertionError(f"{tag} sample {i}: the object's mask is empty")
                if not train:
                    gt = scene_gt[str(i)][0]
                    worst_r = max(worst_r, float(np.abs(
                        s["rotations"][0] - np.reshape(gt["cam_R_m2c"], (3, 3))).max()))
                    worst_t = max(worst_t, float(np.abs(
                        s["translations"][0] - np.asarray(gt["cam_t_m2c"])).max()))
            if train:
                for p in ds.images:             # every frame decoded into the cache
                    bop.read_image(p)
                    bop.get_single_bop_annotation(p, ds.obj2cls)
                for n_threads in BOP_THREADS:
                    it = iter(PrefetchLoader(ds, BOP_BATCH, train=True, num_threads=n_threads,
                                             seed=n_threads))
                    next(it)
                    t0 = time.perf_counter()
                    for _ in range(BOP_LOADER_BATCHES):
                        next(it)
                    rates[f"{tag}_{n_threads}"] = (BOP_LOADER_BATCHES * BOP_BATCH
                                                   / (time.perf_counter() - t0))
                    it.close()
    log(f"[bop] (b) samples slow and fast, train and eval: contract held; eval crops' GT "
        f"poses against scene_gt.json: R max |diff| {worst_r:.2e} (gate 1e-5), T "
        f"{worst_t:.2e} mm (gate 1e-3)")
    log(f"[bop] (b) PrefetchLoader images/s at B={BOP_BATCH}, frames decoded and cached: "
        + ", ".join(f"{k} threads {v:.1f}" for k, v in rates.items())
        + f" (host: {os.cpu_count()} cores)")
    if not (worst_r <= 1e-5 and worst_t <= 1e-3):
        raise AssertionError("the eval crops' remapped GT poses miss scene_gt.json")
    return dict(gt_rot_max_abs=worst_r, gt_trans_max_abs_mm=worst_t, loader_images_per_s=rates)


def bop_phase(torch, sf, cf, dev):
    """The BOP host pipeline on the card at full width: (a) a tree written by
    make_bop_dataset; (b) samples and the loader; the live bf16 BOP step
    beside the live synthetic step, one profiled BOP step; (c)
    train_kd.main --data bop to 6 steps and resumed to 8; (d)
    evaluate.main --data bop with --test_file and with --fast_pipeline;
    (e) export_model --data bop --check. Returns (summary, K1 launches, K2
    launches by batch)."""
    import contextlib
    import dataclasses
    import io
    import statistics
    import threading

    from kd6d_pose_adlp_tpu_torch import evaluate, export_model, make_bop_dataset, train_kd
    from kd6d_pose_adlp_tpu_torch.config import load_yaml_config
    from kd6d_pose_adlp_tpu_torch.data import loaders, native, png
    from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
    from kd6d_pose_adlp_tpu_torch.engine import steps
    from kd6d_pose_adlp_tpu_torch.engine.loop import train
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
    from kd6d_pose_adlp_tpu_torch.utils.fold_bn import fold_batchnorm

    tmp = tempfile.TemporaryDirectory()
    root = os.path.join(tmp.name, "tree")
    yaml_path, tree = bop_tree_phase(png, native, make_bop_dataset, root)
    cfg = load_yaml_config(yaml_path)
    _, cfg_t = train_configs()
    cfg_t = cfg_t.replace(data=cfg.data)
    n_fg, B = cfg.data.n_fg, cfg.solver.ims_per_batch
    if (n_fg, B, cfg.model.input_res, cfg.model.backbone) != (15, BOP_BATCH, RES,
                                                               "darknet_tiny_h"):
        raise AssertionError("the tree's config is not the full-width one")
    samples = bop_samples_phase(cfg, yaml_path)
    k1_key = ("sinkhorn_potentials", cfg.solver.max_pos, cfg.kd.max_teacher_cells)
    shapes = ((3, 8), (8, 16))

    # the live bf16 step (train_kd's defaults) on BOP batches from the loader
    # beside the same step on synthetic batches rendered beforehand (host
    # tensors, as the loader's), one profiled BOP step
    c, c_t = bf16_configs(cfg.replace(solver=dataclasses.replace(
        cfg.solver, max_iter=BOP_TIMED_STEPS)), cfg_t)
    teacher = init_pose_net(PoseNet(cfg_t.model, n_fg=n_fg), torch.Generator().manual_seed(1))
    teacher_sd = teacher.state_dict()
    folded_sd = fold_batchnorm(teacher_sd)
    data = loaders.build(c, kind="bop", device=dev)
    syn = SyntheticPoseDataset(n_fg=n_fg, input_res=RES, single_class=0, seed=0)
    syn_batches = [syn.batch(range(B * i, B * (i + 1))) for i in range(BOP_TIMED_STEPS)]
    live, k1_live = {}, 0
    for tag in ("bop", "synthetic"):
        sf.reset_launch_counts()
        it = data.train_iter(BOP_WORKERS) if tag == "bop" else iter(syn_batches)
        consts = data.consts if tag == "bop" else syn.consts(device=dev)
        with tempfile.TemporaryDirectory() as wd:
            state, hist = train(c, consts, it, cfg_t=c_t, teacher_state_dict=folded_sd,
                                device=dev, log_every=1, working_dir=wd, verbose=False)
        if tag == "bop":
            it.close()
            bop_state = state
        k1 = sf.launches.get(k1_key, 0)
        k1_live += k1
        if k1 != BOP_TIMED_STEPS or not all(
                math.isfinite(v) for h in hist for v in h.values()) or hist[-1]["loss_kd"] <= 0:
            raise AssertionError(f"live {tag} steps: K1 {k1}, last {hist[-1]}")
        ms = [h["step_ms"] for h in hist[TRAIN_WARMUP:]]
        live[tag] = dict(step_ms=[h["step_ms"] for h in hist], median_ms=statistics.median(ms))
    it = data.train_iter(BOP_WORKERS)
    batch = next(it).to(dev)
    it.close()
    teacher_dev = PoseNet(c_t.model, n_fg=n_fg)
    teacher_dev.load_state_dict(folded_sd, strict=True)
    step = steps.build_train_step(c, c_t, data.consts, bop_state.net,
                                  teacher_dev.to(dev).eval(), steps.make_optimizer(c))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sf.reset_launch_counts()
    prof = profile_request(torch, lambda: step(bop_state, batch, generator=gen))
    k1_live += sf.launches.get(k1_key, 0)
    idle = 1.0 - prof["device_busy_ms"] / prof["wall_ms"]
    log(f"[bop] live bf16 step, B={B}, on {gpu_name_and_power()}: BOP batches from "
        f"{BOP_WORKERS} loader threads median {live['bop']['median_ms']:.2f} ms "
        f"({1e3 * B / live['bop']['median_ms']:.1f} images/s), synthetic host batches "
        f"{live['synthetic']['median_ms']:.2f} ms, steps {TRAIN_WARMUP + 1}-"
        f"{BOP_TIMED_STEPS}; profiled BOP step: {prof['device_kernels']} device kernels, busy "
        f"{prof['device_busy_ms']:.1f} ms of {prof['wall_ms']:.1f} ms (idle share {idle:.3f})")

    # (c) the training CLI at its defaults on the tree, then its resume
    wd = os.path.join(tmp.name, "run")
    wf = os.path.join(tmp.name, "teacher.pt")
    torch.save(teacher_sd, wf)
    args = ["--config_file", yaml_path, "--data", "bop", "--num_workers", str(BOP_WORKERS),
            "--weight_file_t", wf, "--working_dir", wd]
    n_chunks = -(-BOP_TEST_FRAMES // cfg.test.ims_per_batch)
    k2_launches = {cfg.test.ims_per_batch: {}, EVAL_BATCH: {}, BATCH: {}}

    def add(b):
        for key, v in cf.launches.items():
            k2_launches[b][key] = k2_launches[b].get(key, 0) + v

    runs, k1_cli = {}, 0
    for max_iters in BOP_STEPS:
        sf.reset_launch_counts()
        cf.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            st, h = train_kd.main(args + ["--max_iters", str(max_iters),
                                          "--vis_every", "0"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        printed = buf.getvalue()
        k1 = sf.launches.get(k1_key, 0)
        k1_cli += k1
        k2 = {f"{a}->{o}": cf.launches.get(("conv3x3_bn_act_flat", a, o, "bfloat16"), 0)
              for a, o in shapes}
        add(cfg.test.ims_per_batch)
        first = max_iters == BOP_STEPS[0]
        n_steps = max_iters - (0 if first else BOP_STEPS[0])
        log(f"[bop] (c) train_kd.main --data bop --max_iters {max_iters} ({secs:.1f} s): "
            f"step {st.step}, K1 {k1}, K2 {k2}; "
            + "; ".join(f"step {x['step']}: loss_total {x['loss_total']:.4f} (kd "
                        f"{x['loss_kd']:.5f})" for x in h) + "; printed: "
            + " | ".join(line for line in printed.splitlines()
                         if line.startswith(("teacher", "resumed", "[valid"))))
        want_resume = f"resumed from {os.path.join(wd, 'latest.ckpt')} @ step {BOP_STEPS[0]}"
        if not (st.step == max_iters and k1 == n_steps and sum(sf.launches.values()) == n_steps
                and set(k2.values()) == {n_chunks} and sum(cf.launches.values()) == 2 * n_chunks
                and all(math.isfinite(v) for x in h for v in x.values())
                and all(x["loss_kd"] > 0 for x in h)
                and printed.count("[valid @ step") == 2
                and f"[valid @ step {max_iters}]" in printed
                and "teacher: BN folded into conv weights" in printed
                and (first or want_resume in printed)):
            raise AssertionError(f"train_kd.main --data bop --max_iters {max_iters}: steps, "
                                 "launches, losses, evaluations or resume not as expected")
        missing = [f for f in ("latest.ckpt", "final.ckpt", "cfg.json", "info.txt",
                               "scalars.jsonl") if not os.path.exists(os.path.join(wd, f))]
        if missing:
            raise AssertionError(f"train_kd.main --data bop did not write {missing}")
        if [t.name for t in threading.enumerate() if "(producer)" in t.name]:
            raise AssertionError("the BOP loader's threads outlived train_kd.main")
        runs[max_iters] = dict(seconds=secs, k1=k1, k2=k2, history=h)

    # (d) the evaluation CLI on the run's final.ckpt
    n_tensors = len(PoseNet(cfg.model, n_fg=n_fg).state_dict())
    n_eval_chunks = -(-BOP_TEST_FRAMES // EVAL_BATCH)
    evals = {}
    for extra in (["--test_file", cfg.data.test_list], ["--fast_pipeline"]):
        cf.reset_launch_counts()
        ewd = os.path.join(tmp.name, "eval")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            ev = evaluate.main(["--config_file", yaml_path, "--weight_file",
                                os.path.join(wd, "final.ckpt"), "--data", "bop",
                                "--ims_per_batch", str(EVAL_BATCH), "--working_dir", ewd,
                                *extra])
        secs = time.perf_counter() - t0
        printed = buf.getvalue()
        with open(os.path.join(ewd, "preds.json")) as f:
            n_preds = len(json.load(f))
        k2 = dict(cf.launches)
        add(EVAL_BATCH)
        log(f"[bop] (d) evaluate.main --data bop {' '.join(extra)} ({secs:.1f} s): "
            f"{printed.splitlines()[0]}; {n_preds} predictions; K2 {k2}")
        if not (printed.startswith(f"loaded {n_tensors} tensors from") and ev["table"] in printed
                and n_preds == BOP_TEST_FRAMES
                and k2 == {("conv3x3_bn_act_flat", a, o, "bfloat16"): n_eval_chunks
                           for a, o in shapes}):
            raise AssertionError(f"evaluate.main --data bop {extra}: tensors, table, "
                                 "predictions or K2 launches not as expected")
        evals[extra[0]] = dict(seconds=secs, predictions=n_preds)

    # (e) the export CLI with the tree's task constants
    cf.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        meta = export_model.main(["--weight_file", os.path.join(wd, "final.ckpt"),
                                  "--config_file", yaml_path, "--data", "bop",
                                  "--batch_size", str(BATCH), "--check",
                                  "--out", os.path.join(tmp.name, "student.pt2")])
    printed = buf.getvalue()
    add(BATCH)
    log(f"[bop] (e) export_model --data bop --check: {meta['bytes']} bytes, K2 "
        f"{dict(cf.launches)}; " + " | ".join(line for line in printed.splitlines()
                                              if line.startswith(("loaded", "round-trip"))))
    if not ("round-trip check OK" in printed and set(cf.launches.values()) == {2}):
        raise AssertionError("export_model --data bop --check failed")
    tmp.cleanup()
    return dict(tree=tree, samples=samples, live=live, profile=prof, device_idle_share=idle,
                train_kd=runs, evaluate=evals, export_bytes=meta["bytes"]), \
        k1_live + k1_cli, k2_launches


# ---------------------------------------------------------------------------
# export phase
# ---------------------------------------------------------------------------

def outputs_equal(torch, got: dict, want: dict, rtol: float = 1e-5, atol: float = 1e-5):
    """(max |diff| over the float outputs, passed): the same keys in the same
    order, ints and bools equal, floats within rtol / atol (JAX's
    scripts/export_model.py --check)."""
    if list(got) != list(want):
        return float("inf"), False
    worst, ok = 0.0, True
    for k, w in want.items():
        g = got[k].to(w.device)
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf"), False
        if w.is_floating_point():
            worst = max(worst, (g - w).abs().max().item() if w.numel() else 0.0)
            ok = ok and bool(torch.allclose(g, w, rtol=rtol, atol=atol))
        else:
            ok = ok and bool(torch.equal(g, w))
    return worst, ok


def export_phase(torch, cf, dev):
    """(a) the raw-frame endpoint, (b) the exported artifact's round trips,
    (c) int8 PTQ of the darknet53 teacher and an int8 student artifact, all
    on the card at full width. Returns (summary, K2 launches by batch)."""
    import dataclasses
    import statistics

    import numpy as np

    from kd6d_pose_adlp_tpu_torch.config import Config
    from kd6d_pose_adlp_tpu_torch.data import loaders
    from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
    from kd6d_pose_adlp_tpu_torch.data.transforms import internal_frame_matrix
    from kd6d_pose_adlp_tpu_torch.engine.serving import (build_frame_infer_fn, build_infer_fn,
                                                         export_inference, load_serving)
    from kd6d_pose_adlp_tpu_torch.models.blocks import conv2d_int8
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
    from kd6d_pose_adlp_tpu_torch.ops import warp
    from kd6d_pose_adlp_tpu_torch.utils.fold_bn import fold_batchnorm
    from kd6d_pose_adlp_tpu_torch.utils.quant import quantize_posenet

    cfg = Config()
    assert (cfg.model.backbone, cfg.model.input_res, cfg.model.out_channel,
            cfg.model.use_higher_levels, cfg.data.n_fg) == ("darknet_tiny_h", RES, 128, True, 15)
    ds = SyntheticPoseDataset(n_fg=cfg.data.n_fg, input_res=RES, seed=0)
    consts = ds.consts(device=dev)
    net = init_pose_net(PoseNet(cfg.model, n_fg=cfg.data.n_fg),
                        torch.Generator().manual_seed(0)).to(dev).eval()
    seg = {("conv3x3_bn_act_flat", 3, 8, "float32"), ("conv3x3_bn_act_flat", 8, 16, "float32")}
    launches = {BATCH: {}, 1: {}}

    def k2_per_request(n, what, batch=BATCH):
        by = dict(cf.launches)
        if set(by) != seg or set(by.values()) != {n}:
            raise AssertionError(f"{what}: K2 launches {by}, not once per request at each "
                                 f"of the stem's two shapes over {n} requests")
        for key, v in by.items():
            launches[batch][key] = launches[batch].get(key, 0) + v
        return {f"{c}->{o}": v for (_, c, o, _), v in by.items()}

    def timed(fn, n):
        """(outputs of the last call, host ms of each call, synchronized)."""
        ms, out = [], None
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return out, ms

    # (a) the raw-frame endpoint: B=8 raw 480x640 frames -> 256² crops
    fh, fw = EXPORT_FRAME_HW
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (BATCH, fh, fw, 3), dtype=np.uint8)
    centers = np.stack([rng.uniform(40, 600, BATCH), rng.uniform(40, 440, BATCH)],
                       axis=1).astype(np.float32)
    scales = rng.uniform(120, 400, BATCH).astype(np.float32)
    ids = rng.integers(0, cfg.data.n_fg, BATCH).astype(np.int32)
    frame_fn = build_frame_infer_fn(cfg, consts, net, (fh, fw), device=dev)
    crop_fn = build_infer_fn(cfg, consts, net, device=dev)
    frame_fn(frames, centers, scales, ids, seed=0)                 # warm-up, not counted
    crops, bt = frame_fn.crops(frames, centers, scales)
    M_int = torch.from_numpy(internal_frame_matrix(fw, fh, cfg.data.internal_width,
                                                   cfg.data.internal_height)[:2].copy())
    crops_cpu, bt_cpu = warp.frame_to_crop(torch.from_numpy(frames), M_int,
                                           torch.from_numpy(centers), torch.from_numpy(scales),
                                           RES)
    crop_diff = (crops.cpu().int() - crops_cpu.int()).abs()
    crop_lsb, crop_off = int(crop_diff.max()), float((crop_diff > 0).float().mean())
    bt_err = (bt.cpu() - bt_cpu).abs().max().item()
    cf.reset_launch_counts()
    warp_ms, frame_ms = [], []
    for r in range(EXPORT_REQUESTS):
        tm = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_f = frame_fn(frames, centers, scales, ids, seed=r, timings=tm)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        warp_ms.append(1e3 * tm["warp_s"])
    k2_frame = k2_per_request(EXPORT_REQUESTS, "the frame endpoint")
    out_c = crop_fn(crops, bt, ids, seed=EXPORT_REQUESTS - 1)
    pose_err, pose_ok = outputs_equal(torch, out_f, out_c, rtol=0.0, atol=1e-4)
    log(f"[export] (a) frame endpoint, B={BATCH} raw {fh}x{fw} frames -> {RES}² crops: crops "
        f"card vs CPU max {crop_lsb} LSB ({crop_off:.2e} of values off), bbox_trans max |diff| "
        f"{bt_err:.2e}; poses vs build_infer_fn on its own crops, same draws: max |diff| "
        f"{pose_err:.2e} (gate 1e-4, ints and masks equal); K2 {k2_frame} in "
        f"{EXPORT_REQUESTS} requests; warp median {statistics.median(warp_ms):.3f} ms, "
        f"request median {statistics.median(frame_ms):.2f} ms")
    if not (crop_lsb <= 1 and bt_err <= 1e-4 and pose_ok):
        raise AssertionError("the frame endpoint's crops or poses miss their references")

    # (b) export round trips: single B=8, frame, a symbolic batch at B=1 and 8
    reqs = [ds.requests(range(BATCH * r, BATCH * (r + 1))) for r in range(2)]
    req = reqs[1]
    tmp = tempfile.TemporaryDirectory()
    rows = {}

    def export_row(tag, mode, batch_size, frame_hw=None):
        path = os.path.join(tmp.name, f"{tag}.pt2")
        t0 = time.perf_counter()
        meta = export_inference(cfg, consts, net, path, batch_size=batch_size, mode=mode,
                                frame_hw=frame_hw, device=dev)
        t1 = time.perf_counter()
        serve, _ = load_serving(path, device=dev)
        rows[tag] = dict(export_s=t1 - t0, load_s=time.perf_counter() - t1,
                         bytes=meta["bytes"])
        return serve

    serve = export_row("single_b8", "single", BATCH)
    call_e = lambda: crop_fn(req["images"], req["bbox_trans"], req["class_ids"], seed=3)  # noqa: E731
    call_x = lambda: serve(req["images"], req["bbox_trans"], req["class_ids"], seed=3)  # noqa: E731
    call_x()                                                       # warm-up
    cf.reset_launch_counts()
    got, ms_x = timed(call_x, EXPORT_REQUESTS)
    k2_loaded = k2_per_request(EXPORT_REQUESTS, "the loaded program")
    want, ms_e = timed(call_e, EXPORT_REQUESTS)
    err, ok = outputs_equal(torch, got, want)
    rows["single_b8"].update(max_abs_diff=err, k2=k2_loaded, exported_ms=ms_x, eager_ms=ms_e)
    log(f"[export] (b) single B={BATCH}: exported in {rows['single_b8']['export_s']:.1f} s, "
        f"loaded in {rows['single_b8']['load_s']:.1f} s, {rows['single_b8']['bytes']} bytes; "
        f"loaded vs eager, seed 3: max |diff| {err:.2e} (gate rtol/atol 1e-5); K2 from inside "
        f"the loaded program {k2_loaded} in {EXPORT_REQUESTS} requests; request median "
        f"exported {statistics.median(ms_x):.2f} ms vs eager {statistics.median(ms_e):.2f} ms "
        f"on {gpu_name_and_power()}")
    if not ok:
        raise AssertionError("the loaded single-mode program misses the eager endpoint")

    serve_f = export_row("frame_b8", "frame", BATCH, (fh, fw))
    cf.reset_launch_counts()
    got = serve_f(frames, centers, scales, ids, seed=5)
    k2_per_request(1, "the loaded frame program")
    err, ok = outputs_equal(torch, got, frame_fn(frames, centers, scales, ids, seed=5))
    rows["frame_b8"]["max_abs_diff"] = err
    log(f"[export] (b) frame B={BATCH}: exported in {rows['frame_b8']['export_s']:.1f} s; "
        f"loaded vs eager frame endpoint: max |diff| {err:.2e}")
    if not ok:
        raise AssertionError("the loaded frame program misses the eager frame endpoint")

    serve_s = export_row("symbolic", "single", 0)
    for n in (1, BATCH):
        r = ds.requests(range(n))
        cf.reset_launch_counts()
        got = serve_s(r["images"], r["bbox_trans"], r["class_ids"], seed=n)
        k2_per_request(1, f"the symbolic program at B={n}", batch=1 if n == 1 else BATCH)
        err, ok = outputs_equal(torch, got, crop_fn(r["images"], r["bbox_trans"],
                                                    r["class_ids"], seed=n))
        rows["symbolic"][f"max_abs_diff_b{n}"] = err
        log(f"[export] (b) symbolic batch served at B={n}: R {tuple(got['R'].shape)}, vs eager "
            f"max |diff| {err:.2e}")
        if not (ok and got["R"].shape[0] == n):
            raise AssertionError(f"the symbolic program at B={n} misses the eager endpoint")

    serve_m = export_row("multi_b8", "multi", BATCH)
    multi_fn = build_infer_fn(cfg, consts, net, mode="multi", device=dev)
    cf.reset_launch_counts()
    got, ms_xm = timed(lambda: serve_m(req["images"], req["bbox_trans"], req["class_ids"],
                                       seed=6), 1)
    k2_multi = k2_per_request(1, "the loaded multi program")
    want, ms_em = timed(lambda: multi_fn(req["images"], req["bbox_trans"], req["class_ids"],
                                         seed=6), 1)
    err, ok = outputs_equal(torch, got, want)
    rows["multi_b8"].update(max_abs_diff=err, k2=k2_multi, exported_ms=ms_xm, eager_ms=ms_em)
    log(f"[export] (b) multi B={BATCH}: exported in {rows['multi_b8']['export_s']:.1f} s, "
        f"loaded in {rows['multi_b8']['load_s']:.1f} s; R {tuple(got['R'].shape)}, loaded vs "
        f"eager multi endpoint, seed 6: max |diff| {err:.2e} (gate rtol/atol 1e-5); K2 from "
        f"inside the loaded program {k2_multi}; request exported {ms_xm[0]:.1f} ms vs eager "
        f"{ms_em[0]:.1f} ms")
    if not (ok and tuple(got["R"].shape) == (BATCH, cfg.data.n_fg, 3, 3)):
        raise AssertionError("the loaded multi program misses the eager multi endpoint")

    # (c) int8 PTQ of the darknet53 teacher (FPN 256), B=16, folded,
    # calibrated on 4 synthetic batches. The head's prior is the config's
    # (0.01), the condition of JAX's 0.05 bound (tests/test_quant.py:96-124)
    cfg_t = cfg.replace(model=dataclasses.replace(cfg.model, backbone="darknet53",
                                                  bn_folded=True))
    assert cfg_t.model.out_channel == 256 and cfg.solver.ims_per_batch == 16
    data = loaders.build(cfg, kind="synthetic", device=dev)
    it = data.train_iter()
    batches = [next(it).images.to(dev) for _ in range(EXPORT_CALIB + 1)]
    raw = init_pose_net(PoseNet(dataclasses.replace(cfg_t.model, bn_folded=False),
                                n_fg=cfg.data.n_fg), torch.Generator().manual_seed(1))
    folded = fold_batchnorm(raw)
    t0 = time.perf_counter()
    t_int8, q_state = quantize_posenet(cfg_t.model, cfg.data.n_fg, folded,
                                       batches[:EXPORT_CALIB], device=dev)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    x = batches[-1]
    forwards = {}
    for tag, dtype in (("fp32_folded", "float32"), ("bf16_folded", "bfloat16")):
        m = PoseNet(dataclasses.replace(cfg_t.model, compute_dtype=dtype), n_fg=cfg.data.n_fg)
        m.load_state_dict(folded, strict=True)
        forwards[tag] = m.to(dev).eval()
    forwards["int8"] = t_int8
    fwd = {}
    for tag, m in forwards.items():
        with torch.no_grad():
            m(x)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = time_cuda(torch, m, [(x,)], iters=EXPORT_FWD_ITERS, warmup=2, graph=False)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            fwd[tag] = dict(ms=ms, peak_gib=peak, out=m(x))
    c32, r32 = fwd["fp32_folded"]["out"]
    c8, r8 = fwd["int8"]["out"]
    rel = ((c8 - c32).abs().max() / c32.abs().max()).item()
    rel_reg = ((r8 - r32).abs().max() / r32.abs().max()).item()
    # one full-width QConv's int32 sums, card and CPU: the first cls-tower
    # conv (256 -> 256) on its P5 input (8x8), captured on the card
    conv = t_int8.head.cls_tower[0]
    seen = []
    hook = conv.register_forward_hook(lambda m_, i_, o_: seen.append(i_[0].detach()))
    with torch.no_grad():
        t_int8(x)
    hook.remove()
    xin = seen[2]
    xq = torch.clamp(torch.round(xin.float() / conv.in_scale), -127, 127).to(torch.int8)
    acc_card = conv2d_int8(xq, conv.kernel_q, conv.stride, conv.padding)
    acc_cpu = conv2d_int8(xq.cpu(), conv.kernel_q.cpu(), conv.stride, conv.padding)
    acc_equal = bool(torch.equal(acc_card.cpu(), acc_cpu))
    log(f"[export] (c) int8 darknet53 teacher, B={x.shape[0]} at {RES}², calibrated on "
        f"{EXPORT_CALIB} batches ({quant_s:.1f} s): logits vs the folded fp32 teacher max "
        f"|diff| {(c8 - c32).abs().max().item():.3e} = {rel:.4f} of max |logit| (gate "
        f"{INT8_LOGITS_RTOL}), regression {rel_reg:.4f}; cls_tower.0 int32 sums at "
        f"{tuple(acc_card.shape)} (K = {xq.shape[1] * 9}) card == CPU: {acc_equal}")
    for tag, f in fwd.items():
        log(f"[export] (c) teacher forward {tag}: {f['ms']:.2f} ms, peak {f['peak_gib']:.2f} "
            f"GiB above the weights, on {gpu_name_and_power()}")
    if not (acc_equal and rel <= INT8_LOGITS_RTOL and bool(torch.isfinite(r8).all())):
        raise AssertionError("the int8 teacher misses the folded one, or its int32 sums "
                             "differ between card and CPU")

    # an int8 student exported and reloaded: no K2 in it (its stem is int8)
    cfg_s = cfg.replace(model=dataclasses.replace(cfg.model, bn_folded=True))
    s_int8, _ = quantize_posenet(cfg_s.model, cfg.data.n_fg, fold_batchnorm(net),
                                 [b[:BATCH] for b in batches[:EXPORT_CALIB]], device=dev)
    cfg_q = cfg_s.replace(model=dataclasses.replace(cfg_s.model, quant_mode="quant"))
    path = os.path.join(tmp.name, "int8.pt2")
    meta = export_inference(cfg_q, consts, s_int8, path, batch_size=BATCH, device=dev)
    serve_q, _ = load_serving(path, device=dev)
    cf.reset_launch_counts()
    got = serve_q(req["images"], req["bbox_trans"], req["class_ids"], seed=4)
    no_k2 = not cf.launches
    err, ok = outputs_equal(torch, got, build_infer_fn(cfg_q, consts, s_int8, device=dev)(
        req["images"], req["bbox_trans"], req["class_ids"], seed=4))
    rows["int8_student"] = dict(bytes=meta["bytes"], max_abs_diff=err)
    log(f"[export] (c) int8 tiny_h artifact: {meta['bytes']} bytes (float "
        f"{rows['single_b8']['bytes']}), loaded vs eager max |diff| {err:.2e}, no K2: {no_k2}")
    if not (ok and no_k2):
        raise AssertionError("the int8 student artifact misses its eager endpoint")
    tmp.cleanup()

    summary = dict(
        frame=dict(batch=BATCH, frame_hw=[fh, fw], crop_max_lsb=crop_lsb,
                   crop_off_share=crop_off, bbox_trans_err=bt_err, pose_max_abs_diff=pose_err,
                   k2=k2_frame, warp_ms=warp_ms, request_ms=frame_ms),
        artifacts=rows,
        int8_teacher=dict(batch=int(x.shape[0]), calib_batches=EXPORT_CALIB, quant_s=quant_s,
                          logits_rel=rel, reg_rel=rel_reg, acc_card_equals_cpu=acc_equal,
                          forwards={k: dict(ms=v["ms"], peak_gib=v["peak_gib"])
                                    for k, v in fwd.items()}))
    return summary, launches


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
    assert (cfg.model.backbone, cfg.model.input_res, cfg.model.compute_dtype) == (
        "darknet_tiny_h", RES, "float32")
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
        got = {f"{c}->{o}": cf.launches.get(("conv3x3_bn_act_flat", c, o, "float32"), 0)
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
                                 "synthetic", "--compute_dtype", "float32",
                                 "--working_dir", os.path.join(tmp, "eval")])
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


# ---------------------------------------------------------------------------
# zebra phase
# ---------------------------------------------------------------------------

def zebra_configs(dtype: str = "float32"):
    """The dense binary-code configuration at full width (darknet_tiny_h, FPN
    128, P6/P7, 15 classes, 256², ZEBRA_BITS-bit codes, train_zebra's
    defaults) in `dtype`."""
    import dataclasses

    from kd6d_pose_adlp_tpu_torch.config import Config
    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype=dtype,
                                                code_bits=ZEBRA_BITS))
    m = cfg.model
    assert (m.backbone, m.input_res, m.out_channel, m.use_higher_levels, cfg.data.n_fg) == (
        "darknet_tiny_h", RES, 128, True, 15)
    return cfg


def zebra_oracle_outputs(tgt, n_fg: int, n_bits: int, rng=None):
    """(cls_logits, code_pred) numpy network outputs that decode to the
    targets `tgt` (numpy ZebraTargets): each positive slot's cell at logit
    +10 for its class, the rest -10, its code as saturated logits and its
    offset (tests/test_zebra.py:155). With a numpy `rng`, offsets are
    jittered by N(0, 0.1/32) of the anchor size and a sixth of the slots
    get their leading code bit wrong, so RANSAC meets outliers."""
    import numpy as np
    B, A = tgt.labels.shape
    cls_logits = np.full((B, A, n_fg), -10.0, np.float32)
    code_pred = np.zeros((B, A, n_fg * (n_bits + 2)), np.float32)
    for b in range(B):
        for p in np.flatnonzero(tgt.s_valid[b]):
            a, c = int(tgt.sidx[b, p]), int(tgt.cls_idx[b, p])
            cls_logits[b, a, c] = 10.0
            code = np.array(tgt.code_tgt[b, p], np.float32)
            off = np.array(tgt.off_tgt[b, p], np.float32)
            if rng is not None:
                off += rng.normal(0.0, 0.1 / 32, 2).astype(np.float32)
                if rng.random() < 1 / 6:
                    code[0] = 1.0 - code[0]
            base = c * (n_bits + 2)
            code_pred[b, a, base:base + n_bits] = (2.0 * code - 1.0) * 10.0
            code_pred[b, a, base + n_bits:base + n_bits + 2] = off
    return cls_logits, code_pred


def one_zebra_step(torch, cfg, consts, student_sd, teacher_sd, batch, uniform, dev):
    """One distilling zebra step from the given weights on `dev`: (metrics,
    the step's gradient of each parameter on the CPU)."""
    from kd6d_pose_adlp_tpu_torch.engine import steps, zebra
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet

    n_fg = cfg.data.n_fg
    net = PoseNet(cfg.model, n_fg=n_fg)
    net.load_state_dict(student_sd, strict=True)
    teacher = PoseNet(cfg.model, n_fg=n_fg)
    teacher.load_state_dict(teacher_sd, strict=True)
    opt = steps.make_optimizer(cfg)
    state = steps.create_train_state(cfg, net.to(dev), opt)
    step = zebra.build_zebra_train_step(cfg, consts.to(dev), net, teacher.to(dev), opt, n_fg,
                                        distill=True)
    _, m = step(state, batch.to(dev), uniform=uniform.to(dev))
    return ({k: float(v) for k, v in m.items()},
            {k: p.grad.detach().cpu() for k, p in net.named_parameters()
             if p.grad is not None})


def zebra_phase(torch, cf, dev):
    """The dense binary-code head on the card at full width. (a) one
    distilling step card vs CPU; (b) train_zebra.main at its defaults (bf16)
    with a darknet53 zebra teacher file, then its step timed live and
    pooled; (c) the oracle round trip; (d) the dense postprocess card vs
    CPU with the same draws, timed beside the corner postprocess and
    profiled. Returns (summary, K2 launches by batch)."""
    import contextlib
    import dataclasses
    import io
    import statistics

    import numpy as np

    from kd6d_pose_adlp_tpu_torch import train_zebra
    from kd6d_pose_adlp_tpu_torch.data.batch import Batch
    from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
    from kd6d_pose_adlp_tpu_torch.engine import steps, zebra
    from kd6d_pose_adlp_tpu_torch.engine.postprocess import build_postprocess
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
    from kd6d_pose_adlp_tpu_torch.ops.epnp import sample_gumbel

    cfg = zebra_configs()
    n_fg, nb, t = cfg.data.n_fg, ZEBRA_BITS, cfg.test
    ds = SyntheticPoseDataset(n_fg=n_fg, input_res=RES, seed=0)
    consts = ds.consts(device=dev, code_bits=nb, verts_per_axis=ZEBRA_VERTS)
    consts_cpu = consts.to("cpu")
    V = int(consts.verts.shape[1])
    log(f"[zebra] darknet_tiny_h zebra head at {RES}², {n_fg} classes, {nb}-bit codes over "
        f"{V} vertices a class, {n_fg * (nb + 2)} code channels on {cfg.model.num_cells} cells")
    seg = {("conv3x3_bn_act_flat", 3, 8, "float32"), ("conv3x3_bn_act_flat", 8, 16, "float32")}
    seg16 = {(n, c, o, "bfloat16") for n, c, o, _ in seg}

    # (a) one distilling step, B=2, fp32, card vs CPU, a tiny_h zebra teacher
    # (head prior 0.5) whose eval-mode stem runs K2
    student_sd = init_pose_net(PoseNet(cfg.model, n_fg=n_fg),
                               torch.Generator().manual_seed(2)).state_dict()
    teacher_sd = init_pose_net(PoseNet(cfg.model, n_fg=n_fg), torch.Generator().manual_seed(3),
                               prior=0.5).state_dict()
    small = ds.batch(range(2))
    uniform = torch.rand((2, cfg.model.num_cells, ds.max_objs),
                         generator=torch.Generator().manual_seed(3))
    cf.reset_launch_counts()
    mc, gc = one_zebra_step(torch, cfg, consts, student_sd, teacher_sd, small, uniform, dev)
    k2_a = dict(cf.launches)
    mh, gh = one_zebra_step(torch, cfg, consts_cpu, student_sd, teacher_sd, small, uniform,
                            "cpu")
    if set(gc) != set(gh):
        raise AssertionError(f"zebra gradients differ in their parameters: {set(gc) ^ set(gh)}")
    met_rel = {k: abs(mc[k] - mh[k]) / max(abs(mh[k]), 1e-12) for k in mh}
    g_rel = {k: float(torch.linalg.vector_norm(gc[k] - gh[k])
                      / torch.linalg.vector_norm(gh[k]).clamp_min(1e-30)) for k in gh}
    worst = max(g_rel, key=g_rel.get)
    log(f"[zebra] (a) one distilling step B=2, fp32, card vs CPU: metrics {mc} (largest "
        f"relative difference {max(met_rel.values()):.2e}, gate 1e-3); gradients of "
        f"{len(gh)} tensors: worst ||g_card - g_cpu|| / ||g_cpu|| {g_rel[worst]:.2e} "
        f"({worst}; gate RTOL_GRADIENTS {RTOL_GRADIENTS:g}); K2 in the teacher's forward "
        f"{k2_a}")
    if not (mc["loss_kd"] > 0 and mc["num_pos"] == mh["num_pos"] > 0
            and max(met_rel.values()) <= 1e-3 and g_rel[worst] <= RTOL_GRADIENTS):
        raise AssertionError("the zebra step on the card and on the CPU disagree")
    if k2_a != {key: 1 for key in seg}:
        raise AssertionError(f"the tiny_h zebra teacher's forward launched K2 {k2_a}, "
                             "not once at each of the stem's shapes")

    # (b) train_zebra.main at its defaults (bf16, 256², 16 bits) but the
    # cuts: a pool of ZEBRA_POOL batches of 16, ZEBRA_STEPS steps,
    # ZEBRA_PER_CALL a call, ZEBRA_EVAL eval images; a darknet53 zebra
    # teacher file (head prior 0.5) for --kd_weight 1
    cfg_t = cfg.replace(model=dataclasses.replace(cfg.model, backbone="darknet53"))
    t_net = init_pose_net(PoseNet(cfg_t.model, n_fg=n_fg), torch.Generator().manual_seed(1),
                          prior=0.5)
    wd = tempfile.TemporaryDirectory()
    t_path = os.path.join(wd.name, "zebra_teacher.pt")
    torch.save(t_net.state_dict(), t_path)
    argv = ["--batches", str(ZEBRA_POOL), "--batch_size", str(ZEBRA_BATCH), "--input_res",
            str(RES), "--steps", str(ZEBRA_STEPS), "--steps_per_dispatch",
            str(ZEBRA_PER_CALL), "--log_every", str(ZEBRA_PER_CALL), "--eval_n",
            str(ZEBRA_EVAL), "--kd_weight", "1", "--weight_file_t", t_path,
            "--working_dir", os.path.join(wd.name, "run")]
    defaults = vars(train_zebra.build_parser().parse_args([]))
    assert (defaults["batch_size"], defaults["input_res"], defaults["code_bits"],
            defaults["backbone_t"]) == (16, 256, 16, "darknet53")
    buf = io.StringIO()
    cf.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = train_zebra.main(argv)
    run_s = time.perf_counter() - t0
    k2_b = dict(cf.launches)
    printed = buf.getvalue().splitlines()
    for line in printed:
        log(f"[zebra] (b) train_zebra: {line}")
    step_lines = [ln for ln in printed if ln.startswith("step ")]
    losses = [{k: float(ln.split(f" {k} ")[1].split()[0]) for k in ("cls", "code", "off", "kd")}
              for ln in step_lines]
    res_line = next((json.loads(ln) for ln in printed if ln.startswith('{"ADD.10d"')), None)
    n_eval_batches = -(-ZEBRA_EVAL // t.ims_per_batch)
    log(f"[zebra] (b) train_zebra.main, {ZEBRA_STEPS} steps of B={ZEBRA_BATCH} ({run_s:.1f} s "
        f"with the pool, the teacher and the eval): K2 {k2_b} over {n_eval_batches} eval batches of "
        f"{t.ims_per_batch}; final.ckpt "
        f"{os.path.exists(os.path.join(wd.name, 'run', 'final.ckpt'))}")
    if not (len(losses) == ZEBRA_STEPS // ZEBRA_PER_CALL
            and all(math.isfinite(v) for ls in losses for v in ls.values())
            and all(ls["kd"] > 0 for ls in losses)):
        raise AssertionError(f"train_zebra's losses: {losses}")
    if not (os.path.exists(os.path.join(wd.name, "run", "final.ckpt")) and res_line is not None
            and out["final"] == res_line and res_line["n_eval"] == ZEBRA_EVAL):
        raise AssertionError("train_zebra wrote no final.ckpt or printed no result line")
    if k2_b != {key: n_eval_batches for key in seg16}:
        raise AssertionError(f"train_zebra's eval launched K2 {k2_b}, not once per eval batch "
                             "at each of the stem's shapes in bf16")
    wd.cleanup()

    # the same bf16 step timed: live (each batch moved from the host, one
    # step a call) and pooled (ZEBRA_PER_CALL steps a call over the pool)
    cfg16 = zebra_configs("bfloat16")
    cfg16 = cfg16.replace(solver=dataclasses.replace(cfg16.solver, max_iter=ZEBRA_STEPS))
    cfg16_t = cfg16.replace(model=dataclasses.replace(cfg16.model, backbone="darknet53"))
    ds1 = SyntheticPoseDataset(n_fg=n_fg, input_res=RES, single_class=0, seed=0)
    consts1 = ds1.consts(device=dev, code_bits=nb, verts_per_axis=ZEBRA_VERTS)
    host = [ds1.batch(range(1000 + ZEBRA_BATCH * b, 1000 + ZEBRA_BATCH * (b + 1)))
            for b in range(ZEBRA_POOL)]
    pool = Batch.stack(host).to(dev)
    teacher16 = PoseNet(cfg16_t.model, n_fg=n_fg)
    teacher16.load_state_dict(t_net.state_dict(), strict=True)
    teacher16 = teacher16.to(dev).eval()
    net16 = init_pose_net(PoseNet(cfg16.model, n_fg=n_fg), torch.Generator().manual_seed(0))
    opt16 = steps.make_optimizer(cfg16)
    state16 = steps.create_train_state(cfg16, net16.to(dev), opt16)
    step16 = zebra.build_zebra_train_step(cfg16, consts1, net16, teacher16, opt16, n_fg,
                                          distill=True)
    multi16 = zebra.build_zebra_multi_step(cfg16, consts1, net16, teacher16, opt16, n_fg,
                                           ZEBRA_POOL, distill=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    torch.cuda.reset_peak_memory_stats()
    live_ms = []
    for i in range(ZEBRA_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state16, m = step16(state16, host[i % ZEBRA_POOL].to(dev), generator=gen)
        float(m["loss_total"])
        live_ms.append(1e3 * (time.perf_counter() - t0))
    pooled_ms = []
    for c in range(ZEBRA_TIMED // ZEBRA_PER_CALL + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state16, m = multi16(state16, pool, c * ZEBRA_PER_CALL, ZEBRA_PER_CALL, generator=gen)
        float(m["loss_total"])
        pooled_ms.append(1e3 * (time.perf_counter() - t0) / ZEBRA_PER_CALL)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    live_med, pooled_med = statistics.median(live_ms[1:]), statistics.median(pooled_ms[1:])
    if not all(math.isfinite(float(v)) for v in m.values()):
        raise AssertionError(f"the timed zebra steps' metrics {m}")
    log(f"[zebra] (b) bf16 step, B={ZEBRA_BATCH}, darknet53 zebra teacher: live median "
        f"{live_med:.2f} ms ({1e3 * ZEBRA_BATCH / live_med:.1f} images/s) over {ZEBRA_TIMED} "
        f"steps, pooled median {pooled_med:.2f} ms ({1e3 * ZEBRA_BATCH / pooled_med:.1f} "
        f"images/s) over "
        f"{ZEBRA_TIMED // ZEBRA_PER_CALL} calls of {ZEBRA_PER_CALL}; peak device memory "
        f"{peak_gb:.2f} GiB; on {gpu_name_and_power()}")

    # (c) the oracle round trip on the card: eval crops, perfect outputs
    eval_batch = ds.batch(range(BATCH), train=False).to(dev)
    tgt = zebra.zebra_targets(eval_batch, consts, cfg,
                              generator=torch.Generator(device=dev).manual_seed(0))
    tgt_np = type(tgt)(*(x.cpu().numpy() for x in tgt))
    if not (tgt_np.s_valid.sum(1) >= 6).all():
        raise AssertionError(f"fewer than 6 positives in an eval crop: {tgt_np.s_valid.sum(1)}")
    post = zebra.build_zebra_postprocess(cfg, consts, n_fg)
    cls_o, code_o = zebra_oracle_outputs(tgt_np, n_fg, nb)
    gen_p = torch.Generator(device=dev)
    gen_p.manual_seed(3)
    out = post(torch.as_tensor(cls_o, device=dev), torch.as_tensor(code_o, device=dev),
               eval_batch.class_ids[:, 0], eval_batch.bbox_trans, generator=gen_p)
    r_err = float((out["R"] - eval_batch.rotations[:, 0]).abs().max())
    t_err = float((out["T"] - eval_batch.translations[:, 0]).abs().max())
    log(f"[zebra] (c) oracle round trip, B={BATCH}: max |R - R_gt| {r_err:.2e} (gate 0.02), "
        f"max |T - T_gt| {t_err:.3f} mm (gate 5); valid {out['valid'].tolist()}")
    if not (bool(out["valid"].all()) and r_err < 0.02 and t_err < 5.0):
        raise AssertionError("the dense postprocess misses the oracle poses on the card")

    # (d) the dense postprocess, card vs CPU, the same draws; then timed
    # beside the corner postprocess on the same B=8 crops, and profiled
    cls_n, code_n = zebra_oracle_outputs(tgt_np, n_fg, nb, np.random.default_rng(6))
    gumbel = sample_gumbel((BATCH, t.ransac_iters, t.max_votes),
                           torch.Generator().manual_seed(4), "cpu")
    args = (torch.as_tensor(cls_n), torch.as_tensor(code_n), eval_batch.class_ids[:, 0].cpu(),
            eval_batch.bbox_trans.cpu())
    card = post(*(a.to(dev) for a in args), gumbel=gumbel.to(dev))
    hostp = zebra.build_zebra_postprocess(cfg, consts_cpu, n_fg)(*args, gumbel=gumbel)
    rot = max(pose_rot_deg(card["R"][b].cpu().numpy(), hostp["R"][b].numpy())
              for b in range(BATCH))
    trans = float((card["T"].cpu() - hostp["T"]).norm(dim=-1).max())
    same = {k: bool(torch.equal(card[k].cpu(), hostp[k]))
            for k in ("n_inliers", "valid", "pt_valid")}
    log(f"[zebra] (d) dense postprocess B={BATCH}, card vs CPU, same draws: {same}, rotation "
        f"{rot:.4f} deg, translation {trans:.4f} mm (gates: equal, 0.1 deg, 0.5 mm); inliers "
        f"{card['n_inliers'].tolist()} of {card['pt_valid'].sum(1).tolist()}")
    if not (all(same.values()) and rot < 0.1 and trans < 0.5):
        raise AssertionError("the dense postprocess on the card and on the CPU disagree")

    corner_post = build_postprocess(cfg, consts)
    g = torch.Generator().manual_seed(5)
    cls_r = torch.randn((BATCH, cfg.model.num_cells, n_fg), generator=g).to(dev)
    reg_r = (0.3 * torch.randn((BATCH, cfg.model.num_cells, n_fg * 16), generator=g)).to(dev)
    calls = {
        "dense": lambda: post(*(a.to(dev) for a in args), generator=gen_p),
        "corner": lambda: corner_post(cls_r, reg_r, eval_batch.class_ids[:, 0],
                                      eval_batch.bbox_trans, generator=gen_p)}
    post_ms = {k: [] for k in calls}
    for _ in range(ZEBRA_POST_RUNS + 1):
        for k, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            post_ms[k].append(1e3 * (time.perf_counter() - t0))
    post_med = {k: statistics.median(v[1:]) for k, v in post_ms.items()}
    prof = profile_request(torch, calls["dense"])
    idle = 1.0 - prof["device_busy_ms"] / prof["wall_ms"]
    log(f"[zebra] (d) postprocess per B={BATCH} batch, median of {ZEBRA_POST_RUNS}: dense "
        f"({t.max_votes} correspondences) {post_med['dense']:.2f} ms, corner "
        f"({t.max_votes} votes x 8) {post_med['corner']:.2f} ms; one profiled dense "
        f"postprocess: {prof['device_kernels']} device kernels, busy {prof['device_busy_ms']:.2f} "
        f"ms of {prof['wall_ms']:.2f} ms (idle share {idle:.3f}); top {prof['top']}")

    summary = dict(
        vertices=V, code_bits=nb,
        step_card_vs_cpu=dict(card=mc, cpu=mh, metric_rel=met_rel, grad_rel_worst=g_rel[worst],
                              grad_rel_worst_tensor=worst, k2={str(k): v for k, v in k2_a.items()}),
        train_zebra=dict(argv=argv[:-4], run_s=run_s, losses=losses, result=res_line,
                         k2={str(k): v for k, v in k2_b.items()}),
        step_bf16=dict(live_ms=live_ms, pooled_ms=pooled_ms, live_median_ms=live_med,
                       pooled_median_ms=pooled_med,
                       live_images_per_sec=1e3 * ZEBRA_BATCH / live_med,
                       pooled_images_per_sec=1e3 * ZEBRA_BATCH / pooled_med,
                       peak_memory_gib=peak_gb),
        oracle=dict(r_err=r_err, t_err_mm=t_err),
        postprocess=dict(card_vs_cpu_rotation_deg=rot, card_vs_cpu_translation_mm=trans,
                         ms=post_ms, median_ms=post_med, profile=prof, device_idle_share=idle))
    return summary, {BATCH: k2_b}


# ---------------------------------------------------------------------------
# dist: data parallelism (parallel/mesh) on the card
# ---------------------------------------------------------------------------

def dist_configs():
    """The dist phase's configs: train_configs' fp32 student at a global
    batch of DIST_RANKS * DIST_BATCH, its darknet53 teacher with the BN
    folded (the teacher train_kd builds from a weight file), and the
    evaluated student (head prior 0.5, so its random cells vote) at the
    evaluators' chunk."""
    import dataclasses
    cfg, cfg_t = train_configs()
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, ims_per_batch=DIST_RANKS * DIST_BATCH, max_iter=50))
    cfg_t = cfg_t.replace(model=dataclasses.replace(cfg_t.model, bn_folded=True))
    cfg_e = cfg.replace(model=dataclasses.replace(cfg.model, prior=0.5),
                        test=dataclasses.replace(cfg.test, ims_per_batch=EVAL_BATCH))
    return cfg, cfg_t, cfg_e


def dist_steps(torch, inp, mesh, dtype: str, n: int, dev, perm=None,
               group_bn: bool = False):
    """`n` KD steps from `inp`'s weights and configs with make_optimizer(
    n_devices=DIST_RANKS), in `dtype` (bf16: train_kd's default pair):
    this rank's rows of each global batch and draw under `mesh`, the whole
    of them without one. [(metrics, state_dict on the CPU)] a step (in
    bf16 the last step's state only) and the host-clock ms of each
    synchronized step. Without a mesh, `perm` reorders the images of each
    batch and draw (the same sums, added in another order), and
    `group_bn` has the student's BatchNorms take the group's arithmetic
    (`BatchNorm2d._forward_global` over a one-rank mesh) in place of
    cuDNN's."""
    from kd6d_pose_adlp_tpu_torch.data.batch import TaskConsts
    from kd6d_pose_adlp_tpu_torch.engine import steps
    from kd6d_pose_adlp_tpu_torch.models.blocks import BatchNorm2d
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
    from kd6d_pose_adlp_tpu_torch.parallel.mesh import DataMesh, shard_batch

    cfg, cfg_t, _ = inp["cfgs"]
    if dtype == "bfloat16":
        cfg, cfg_t = bf16_configs(cfg, cfg_t)
    n_fg = cfg.data.n_fg
    consts = TaskConsts.create(*inp["consts"], device=dev)
    net, teacher = PoseNet(cfg.model, n_fg=n_fg), PoseNet(cfg_t.model, n_fg=n_fg)
    net.load_state_dict(inp["student"], strict=True)
    teacher.load_state_dict(inp["teacher"], strict=True)
    if group_bn:
        for m in net.modules():
            if isinstance(m, BatchNorm2d):
                m.mesh = DataMesh(rank=0, size=1, device=dev)
    opt = steps.make_optimizer(cfg, n_devices=DIST_RANKS)
    state = steps.create_train_state(cfg, net.to(dev), opt)
    step = steps.build_train_step(cfg, cfg_t, consts, net, teacher.to(dev).eval(), opt,
                                  mesh=mesh)
    out, ms = [], []
    for b, u in list(zip(inp["batches"], inp["uniforms"]))[:n]:
        if perm is not None:
            b, u = b.take(torch.as_tensor(perm)), u[torch.as_tensor(perm)]
        if mesh is None:
            b, u = b.to(dev), u.to(dev)
        else:
            b, u = shard_batch(b, mesh), shard_batch(u, mesh)
        sync(torch, dev)
        t0 = time.perf_counter()
        state, m = step(state, b, uniform=u)
        m = {k: float(v) for k, v in m.items()}        # synchronizes
        ms.append(1e3 * (time.perf_counter() - t0))
        keep = dtype == "float32" or len(out) == n - 1
        out.append((m, {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
                    if keep else None))
    return out, ms


def dist_eval(torch, inp, dev, rank: int = 0, size: int = 1):
    """ScanEvaluator.run over this process's shard of the synthetic eval
    images that `inp["gumbel"]` draws for (the group's shard under a
    group), each image with its own RANSAC draws: the result and the K2
    launches of the run."""
    from kd6d_pose_adlp_tpu_torch.data import loaders
    from kd6d_pose_adlp_tpu_torch.engine.eval_scan import ScanEvaluator
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet
    from kd6d_pose_adlp_tpu_torch.ops import conv_fused as cf

    cfg = inp["cfgs"][2]
    n_images, chunk = len(inp["gumbel"]), cfg.test.ims_per_batch
    data = loaders.build(cfg, "synthetic", eval_limit=n_images, device=dev)
    net = PoseNet(data.cfg.model, n_fg=data.cfg.data.n_fg)
    net.load_state_dict(inp["eval_net"], strict=True)
    net.to(dev).eval()
    mine = list(range(n_images))[rank::size]
    sev = ScanEvaluator(data.cfg, data.consts, net, data.meshes).prepare(data.eval_batches())
    cf.reset_launch_counts()
    res = sev.run(gumbel_fn=lambda i: inp["gumbel"][mine[i * chunk:(i + 1) * chunk]],
                  verbose=False)
    sync(torch, dev)
    return dict(table=res["table"], preds=res["predictions"], k2=dict(cf.launches))


def dist_rank(inp):
    """One of the DIST_RANKS ranks on the one card (`parallel/mesh.spawn`),
    on `inp["device"]`: gloo on CUDA tensors, since NCCL refuses two ranks
    on one device. The fp32 steps, the bf16 steps, the sharded scan
    evaluation, each rank's K1 and K2 launches (counts zeroed just before,
    read just after); the fp32 steps under deterministic algorithms, as
    the one-process steps they are held against. Everything it sizes by
    comes in `inp`."""
    import torch

    from kd6d_pose_adlp_tpu_torch.ops import sinkhorn_fused as sf
    from kd6d_pose_adlp_tpu_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = pmesh.init_from_env(device=inp["device"], backend="gloo")
    try:
        dev = mesh.device
        sf.reset_launch_counts()
        with deterministic(torch):
            fp32, fp32_ms = dist_steps(torch, inp, mesh, "float32", len(inp["batches"]), dev)
        bf16, bf16_ms = dist_steps(torch, inp, mesh, "bfloat16", inp["bf16_steps"], dev)
        k1 = dict(sf.launches)
        ev = dist_eval(torch, inp, dev, mesh.rank, mesh.size)
        return dict(rank=mesh.rank, fp32=fp32, fp32_ms=fp32_ms, bf16=bf16, bf16_ms=bf16_ms,
                    k1=k1, eval=ev)
    finally:
        torch.distributed.destroy_process_group()


def dist_steps_agree(torch, got, want, start, lrs) -> dict:
    """CPU test (ii)'s bounds (tests/test_torch_port_dist.py): metrics rtol
    5e-3 and num_pos exact each step; after the first step every parameter
    within 2 lr and < 0.5% of its elements off by more than 1e-6; after
    the last, within 2 * sum(lr), the difference's norm <= 0.15 of the
    update's, BN statistics within 5e-3 of their largest entry. The first
    step's 2 lr (Adam's first update is lr * g / |g|, which a near-zero
    gradient's flipped sign turns around) takes the float32 spacing of the
    parameter on top: the update of a BatchNorm scale near 1 rounds to
    1.2e-7, which 2 lr * 1.001 (4e-8 over 2 lr at lr 2e-5) does not hold."""
    stat = ("running_mean", "running_var")
    par = lambda sd: {k: v for k, v in sd.items()  # noqa: E731
                      if not k.endswith(("num_batches_tracked",) + stat)}
    metric_rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                     for (g, _), (w, _) in zip(got, want) for k in w)
    num_pos = all(g["num_pos"] == w["num_pos"] for (g, _), (w, _) in zip(got, want))
    d1 = torch.cat([(got[0][1][k] - v).abs().reshape(-1) for k, v in par(want[0][1]).items()])
    w1 = torch.cat([v.abs().reshape(-1) for v in par(want[0][1]).values()])
    over = float((d1 - torch.nextafter(w1, torch.full_like(w1, math.inf)) + w1).max())
    g, w, s = par(got[-1][1]), par(want[-1][1]), par(start)
    d = torch.cat([(g[k] - w[k]).reshape(-1) for k in w])
    upd = torch.cat([(w[k] - s[k]).reshape(-1) for k in w])
    bn = max(float((got[-1][1][k] - v).abs().max() / v.abs().max().clamp_min(1e-12))
             for k, v in want[-1][1].items() if k.endswith(stat))
    r = dict(metric_rel=metric_rel, num_pos_equal=num_pos, step1_max=float(d1.max()),
             step1_max_less_spacing=over,
             step1_frac=float((d1 > 1e-6).float().mean()), last_max=float(d.abs().max()),
             last_rel=float(d.norm() / upd.norm()), bn_rel=bn,
             two_lr=2 * lrs[0], two_sum_lr=2 * sum(lrs))
    r["ok"] = bool(metric_rel <= 5e-3 and num_pos and over <= 2 * lrs[0] * 1.001
                   and r["step1_frac"] < 5e-3 and r["last_max"] <= 2 * sum(lrs)
                   and r["last_rel"] <= 0.15 and bn <= 5e-3)
    return r


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def deterministic(torch):
    """torch.use_deterministic_algorithms(True) in the body (cuBLAS's
    workspace pinned by CUBLAS_WORKSPACE_CONFIG, set in main before the
    first CUDA call): an op with no deterministic kernel raises. Off again
    after the body."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def dist_inputs(torch, n: int) -> dict:
    """The dist phases' inputs, host tensors only: dist_configs, the task
    constants, the seeded student and BN-folded darknet53 teacher, `n`
    global batches of DIST_RANKS * DIST_BATCH synthetic images and their
    SSC draws, and the evaluation's net and per-image RANSAC draws."""
    import dataclasses

    from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
    from kd6d_pose_adlp_tpu_torch.utils.fold_bn import fold_batchnorm

    cfg, cfg_t, cfg_e = dist_configs()
    n_fg, G = cfg.data.n_fg, DIST_RANKS * DIST_BATCH
    ds = SyntheticPoseDataset(n_fg=n_fg, input_res=RES, seed=0)
    c = ds.consts(device="cpu")
    g = torch.Generator().manual_seed(3)
    unfolded = cfg_t.replace(model=dataclasses.replace(cfg_t.model, bn_folded=False))
    teacher = init_pose_net(PoseNet(unfolded.model, n_fg=n_fg), torch.Generator().manual_seed(1))
    u = torch.rand((DIST_EVAL_IMAGES, cfg_e.test.ransac_iters, cfg_e.test.max_votes * 8),
                   generator=g)
    return dict(
        cfgs=(cfg, cfg_t, cfg_e), bf16_steps=DIST_BF16_STEPS,
        consts=[c.K.numpy(), c.kp3d.numpy(), c.diameters.numpy()],
        student=init_pose_net(PoseNet(cfg.model, n_fg=n_fg),
                              torch.Generator().manual_seed(2)).state_dict(),
        teacher=fold_batchnorm(teacher.eval()),
        batches=[ds.batch(range(G * i, G * (i + 1))) for i in range(n)],
        uniforms=[torch.rand((G, cfg.model.num_cells, ds.max_objs), generator=g)
                  for _ in range(n)],
        eval_net=init_pose_net(PoseNet(cfg_e.model, n_fg=n_fg),
                               torch.Generator().manual_seed(4)).state_dict(),
        gumbel=-torch.log(-torch.log(u.clamp(1e-7, 1 - 1e-7))))


def dist_phase(torch, sf, cf, dev):
    import io

    from kd6d_pose_adlp_tpu_torch import train_kd
    from kd6d_pose_adlp_tpu_torch.engine import steps
    from kd6d_pose_adlp_tpu_torch.parallel import mesh as pmesh

    inp = dist_inputs(torch, DIST_STEPS) | dict(device=str(dev))
    cfg, cfg_t, cfg_e = inp["cfgs"]
    G = DIST_RANKS * DIST_BATCH
    log(f"[dist] (a) {DIST_RANKS} ranks on one card (gloo on CUDA tensors): "
        f"{cfg.model.backbone} student, BN-folded {cfg_t.model.backbone} teacher, "
        f"{RES}², B={DIST_BATCH} a rank, {G} in all, {DIST_STEPS} fp32 steps, "
        f"{DIST_BF16_STEPS} bf16 steps, a scan evaluation of {DIST_EVAL_IMAGES} images")
    t0 = time.perf_counter()
    ranks = pmesh.spawn(dist_rank, DIST_RANKS, args=(inp,))
    spawn_s = time.perf_counter() - t0

    # the one-process fp32 steps on the concatenated batches, on this card,
    # under deterministic algorithms as the ranks' steps
    with deterministic(torch):
        one, one_ms = dist_steps(torch, inp, None, "float32", DIST_STEPS, dev)
    lrs = [steps.make_optimizer(cfg, n_devices=DIST_RANKS).lr_schedule(i)
           for i in range(DIST_STEPS)]
    agree = dist_steps_agree(torch, ranks[0]["fp32"], one, inp["student"], lrs)
    log(f"[dist] fp32, deterministic algorithms, rank 0 vs one process on the {G} images: "
        f"{agree}")
    for i, ((m, _), (w, _)) in enumerate(zip(ranks[0]["fp32"], one)):
        log(f"[dist] step {i + 1}: ranks {m} / one process {w}")
    same = lambda a, b: all(torch.equal(a[k], b[k]) for k in a)  # noqa: E731
    bit_equal = (all(same(a[1], b[1]) and a[0] == b[0]
                     for a, b in zip(ranks[0]["fp32"], ranks[1]["fp32"]))
                 and same(ranks[0]["bf16"][-1][1], ranks[1]["bf16"][-1][1]))
    bf16_finite = all(math.isfinite(v) for r in ranks for m, _ in r["bf16"] for v in m.values())
    for r in ranks:
        log(f"[dist] rank {r['rank']}: fp32 step ms {[round(x, 2) for x in r['fp32_ms']]}, "
            f"bf16 step ms {[round(x, 2) for x in r['bf16_ms']]} (two processes share one "
            f"card: no scaling figure), bf16 metrics {r['bf16'][-1][0]}; K1 launches "
            f"{r['k1']}, K2 launches in its evaluation {r['eval']['k2']}")
    log(f"[dist] one process, fp32 step ms {[round(x, 2) for x in one_ms]}; ranks "
        f"bit-equal: {bit_equal}; bf16 finite: {bf16_finite}; spawn to join {spawn_s:.1f} s")
    if not (agree["ok"] and bit_equal and bf16_finite):
        raise AssertionError("the 2-rank step misses the one-process step, the ranks "
                             "differ, or a bf16 loss is not finite")
    k1_key = ("sinkhorn_potentials", cfg.solver.max_pos, cfg.kd.max_teacher_cells)
    n_chunks = -(-DIST_EVAL_IMAGES // (DIST_RANKS * cfg_e.test.ims_per_batch))
    shapes = ((3, 8), (8, 16))
    for r in ranks:
        if r["k1"] != {k1_key: DIST_STEPS + DIST_BF16_STEPS}:
            raise AssertionError(f"rank {r['rank']}: K1 launched {r['k1']}, not once a step")
        k2 = r["eval"]["k2"]
        if {k2.get(("conv3x3_bn_act_flat", ci, co, "float32"), 0) for ci, co in shapes} \
                != {n_chunks} or sum(k2.values()) != 2 * n_chunks:
            raise AssertionError(f"rank {r['rank']}: K2 launched {k2}, not once a chunk "
                                 "at each stem shape")

    # the one-process evaluation of the whole set
    one_ev = dist_eval(torch, inp, dev)
    tables = [r["eval"]["table"] for r in ranks]
    keys_equal = all(set(r["eval"]["preds"]) == set(one_ev["preds"]) for r in ranks)
    n_valid = sum(bool(e["pred"]) for e in one_ev["preds"].values())
    log(f"[dist] scan evaluation: {len(one_ev['preds'])} predictions, {n_valid} with a "
        f"pose; merged tables equal the one-process table: "
        f"{all(t == one_ev['table'] for t in tables)}; keys equal: {keys_equal}")
    if not (keys_equal and all(t == one_ev["table"] for t in tables)
            and len(one_ev["preds"]) == DIST_EVAL_IMAGES):
        raise AssertionError("the 2-rank evaluation does not merge to the one-process one")

    # (b) train_kd --distributed under a 1-rank NCCL group from torchrun's
    # variables, set here
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(pmesh.free_port()))
    saved = {k: os.environ.get(k) for k in env}
    tmp = tempfile.TemporaryDirectory()
    wd = tmp.name
    buf = io.StringIO()
    os.environ.update(env)
    sf.reset_launch_counts()
    cf.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            st, hist = train_kd.main(["--config_file", CLI_CONFIG_FILE, "--data", "synthetic",
                                      "--max_iters", str(DIST_CLI_STEPS), "--working_dir", wd,
                                      "--vis_every", "0",
                                      "--distributed"])
        sync(torch, dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    cli_s = time.perf_counter() - t0
    printed = buf.getvalue()
    k1_cli = sf.launches.get(k1_key, 0)
    k2_cli = dict(cf.launches)
    files = sorted(os.listdir(wd))
    tmp.cleanup()
    test_batch = train_kd.build_configs(train_kd.get_argparser().parse_args(
        ["--config_file", CLI_CONFIG_FILE]))[0].test.ims_per_batch
    cli_chunks = -(-CLI_EVAL_IMAGES // test_batch)
    log(f"[dist] (b) train_kd --distributed, 1-rank NCCL group ({cli_s:.1f} s): step "
        f"{st.step}, K1 {k1_cli} launches, K2 {k2_cli}, files {files}; printed:\n"
        + "\n".join(line for line in printed.splitlines()
                    if not line.startswith(("ADI", "REP", "AUC", "metric"))))
    if not (st.step == DIST_CLI_STEPS and k1_cli == DIST_CLI_STEPS
            and {k2_cli.get(("conv3x3_bn_act_flat", ci, co, "bfloat16"), 0)
                 for ci, co in shapes} == {cli_chunks}
            and f"[valid @ step {DIST_CLI_STEPS}]" in printed
            and "devices: 1 x" in printed
            and not torch.distributed.is_initialized()
            and {"cfg.json", "final.ckpt", "info.txt", "latest.ckpt", "preds.json",
                 "scalars.jsonl", "eval_scalars.jsonl"} <= set(files)
            and all(math.isfinite(v) for h in hist for v in h.values())):
        raise AssertionError("train_kd --distributed: steps, launches, evaluation or files "
                             "not as expected")

    k1_total = sum(sum(r["k1"].values()) for r in ranks) + k1_cli
    eval_batch = cfg_e.test.ims_per_batch
    k2_by_batch = {eval_batch: {}, test_batch: {}}
    for r in ranks:
        for key, v in r["eval"]["k2"].items():
            k2_by_batch[eval_batch][key] = k2_by_batch[eval_batch].get(key, 0) + v
    for key, v in k2_cli.items():
        k2_by_batch[test_batch][key] = k2_by_batch[test_batch].get(key, 0) + v
    return dict(
        ranks=DIST_RANKS, batch_per_rank=DIST_BATCH, steps=DIST_STEPS,
        bf16_steps=DIST_BF16_STEPS, eval_images=DIST_EVAL_IMAGES, agree=agree,
        ranks_bit_equal=bit_equal, spawn_s=spawn_s, one_process_step_ms=one_ms,
        rank_step_ms={r["rank"]: dict(fp32=r["fp32_ms"], bf16=r["bf16_ms"]) for r in ranks},
        rank_metrics={r["rank"]: dict(fp32=[m for m, _ in r["fp32"]],
                                      bf16=[m for m, _ in r["bf16"]]) for r in ranks},
        one_process_metrics=[m for m, _ in one],
        k1_by_rank={r["rank"]: sum(r["k1"].values()) for r in ranks},
        k2_by_rank={r["rank"]: {f"{n}:{ci}->{co}:{t}": v
                                for (n, ci, co, t), v in r["eval"]["k2"].items()}
                    for r in ranks},
        eval_table=one_ev["table"], eval_valid=n_valid,
        cli=dict(seconds=cli_s, step=st.step, k1=k1_cli,
                 k2={f"{n}:{ci}->{co}:{t}": v for (n, ci, co, t), v in k2_cli.items()},
                 files=files, history=hist)), k1_total, k2_by_batch


def spread_rank(inp):
    """A rank of the dist_spread phase (`parallel/mesh.spawn`): its fp32
    steps alone, under deterministic algorithms."""
    import torch

    from kd6d_pose_adlp_tpu_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = pmesh.init_from_env(device=inp["device"], backend="gloo")
    try:
        with deterministic(torch):
            return dist_steps(torch, inp, mesh, "float32", len(inp["batches"]),
                              mesh.device)[0]
    finally:
        torch.distributed.destroy_process_group()


def dist_spread_phase(torch, dev):
    """The dist phase's fp32 steps over DIST_SPREAD_STEPS, each run read
    against the one process on the images in order (module docstring);
    the one process again is gated bit-equal to it."""
    from kd6d_pose_adlp_tpu_torch.engine import steps
    from kd6d_pose_adlp_tpu_torch.parallel import mesh as pmesh

    n, G = DIST_SPREAD_STEPS, DIST_RANKS * DIST_BATCH
    inp = dist_inputs(torch, n) | dict(device=str(dev))
    ranks = pmesh.spawn(spread_rank, DIST_RANKS, args=(inp,))
    perms = [torch.randperm(G, generator=torch.Generator().manual_seed(40 + i)).tolist()
             for i in range(DIST_PERMS)]
    with deterministic(torch):
        one = dist_steps(torch, inp, None, "float32", n, dev)[0]
        runs = {"one process again": dist_steps(torch, inp, None, "float32", n, dev)[0],
                f"{DIST_RANKS} ranks": ranks[0]}
        for p in perms:
            runs[f"the images reordered ({p[:4]}...)"] = dist_steps(
                torch, inp, None, "float32", n, dev, perm=p)[0]
        runs["the group's BatchNorm arithmetic"] = dist_steps(
            torch, inp, None, "float32", n, dev, group_bn=True)[0]
    lrs = [steps.make_optimizer(inp["cfgs"][0], n_devices=DIST_RANKS).lr_schedule(i)
           for i in range(n)]
    def first_step_bn(r):
        # each BatchNorm's batch statistics of the first step's forward
        # (running = 0.9 * start + 0.1 * batch), the largest gap to one
        # process's over the layer's largest entry, and its layer
        gaps = {}
        for k, w in one[0][1].items():
            if k.endswith(("running_mean", "running_var")):
                s0 = inp["student"][k]
                w, g = (w - 0.9 * s0) / 0.1, (r[0][1][k] - 0.9 * s0) / 0.1
                gaps[k] = float((g - w).abs().max() / w.abs().max().clamp_min(1e-12))
        worst = max(gaps, key=gaps.get)
        return gaps[worst], worst

    out = {}
    for name, r in runs.items():
        out[name] = dict(dist_steps_agree(torch, r, one, inp["student"], lrs),
                         grad_norm=[m["grad_norm"] for m, _ in r],
                         step1_bn=first_step_bn(r))
        log(f"[dist_spread] {n} fp32 steps, {name} against one process in order: "
            f"{out[name]}")
    log(f"[dist_spread] grad_norm by step, one process in order: "
        f"{[m['grad_norm'] for m, _ in one]}")
    again = out["one process again"]
    if not (again["metric_rel"] == again["step1_max"] == again["last_max"]
            == again["bn_rel"] == 0):
        raise AssertionError("one process is not bit-equal to itself under deterministic "
                             "algorithms")
    return out


# ---------------------------------------------------------------------------
# tools phase
# ---------------------------------------------------------------------------

def pytorchcv_zip(torch, path: str) -> str:
    """A pytorchcv / imgclsmob release zip of a seeded darknet_tiny_h
    ImageNet backbone (`{name}-{error}-{sha1}.pth` inside, its keys
    `features.…` and `output.final_conv.*`), written at `path`."""
    import io
    import zipfile

    from kd6d_pose_adlp_tpu_torch.models.darknet import DarkNet

    torch.manual_seed(6)
    bb = DarkNet("tiny-h", include_head=True)
    sd = {("output." + k if k.startswith("final_conv.") else k): v
          for k, v in bb.state_dict().items()}
    buf = io.BytesIO()
    torch.save(sd, buf)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("darknet_tiny_h-2340-cdd2c0c9.pth", buf.getvalue())
    return path


def trace_kernels(path: str) -> dict:
    """Kernel events of a Chrome trace, counted by name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def tools_phase(torch, sf, cf, dev):
    """Reference checkpoints, the cloud plots, the per-depth plot and the
    profiler on the training entry point's path at full width (module
    docstring). Returns (summary, K1 launches, K2 launches by batch). In
    (b) K2 runs at two batches, the plots' B=16 and the evaluations'
    chunks, under one counter: its totals are gated and logged there, and
    only (d)'s launches, all at B=16, go to a batch's row."""
    import dataclasses
    import io

    from kd6d_pose_adlp_tpu_torch import train_kd
    from kd6d_pose_adlp_tpu_torch.data import png
    from kd6d_pose_adlp_tpu_torch.data.synthetic import SyntheticPoseDataset
    from kd6d_pose_adlp_tpu_torch.engine.loop import train
    from kd6d_pose_adlp_tpu_torch.models.pose_net import PoseNet, init_pose_net
    from kd6d_pose_adlp_tpu_torch.tools import visualizer
    from kd6d_pose_adlp_tpu_torch.utils import profiling
    from kd6d_pose_adlp_tpu_torch.utils.checkpoint import load_backbone_init, load_params_loose
    from kd6d_pose_adlp_tpu_torch.utils.fold_bn import fold_batchnorm
    from kd6d_pose_adlp_tpu_torch.utils.precision import full_fp32
    from kd6d_pose_adlp_tpu_torch.utils.torch_convert import imgclsmob_to_backbone_ckpt

    cfg, cfg_t = train_configs()
    n_fg, B = cfg.data.n_fg, cfg.solver.ims_per_batch
    if B != VIS_BATCH:
        raise AssertionError(f"the train batch is {B}, not VIS_BATCH")
    k1_key = ("sinkhorn_potentials", cfg.solver.max_pos, cfg.kd.max_teacher_cells)
    shapes = ((3, 8), (8, 16))
    tmp = tempfile.TemporaryDirectory()
    wd = tmp.name
    secs = {}

    # (a) a reference-layout teacher file, a pytorchcv zip, a file that
    # matches nothing
    t0 = time.perf_counter()
    teacher = init_pose_net(PoseNet(cfg_t.model, n_fg=n_fg), torch.Generator().manual_seed(1))
    sd = teacher.state_dict()
    ref = os.path.join(wd, "latest.pth")
    torch.save({"model": {"module." + k: v for k, v in sd.items()}, "steps": 0, "optim": {},
                "sched": {}}, ref)
    copy = init_pose_net(PoseNet(cfg_t.model, n_fg=n_fg), torch.Generator().manual_seed(9))
    n_ref = load_params_loose(ref, copy)
    images = SyntheticPoseDataset(n_fg=n_fg, input_res=RES, seed=8).batch(
        range(B)).images.to(dev)
    with torch.no_grad(), full_fp32():
        want = teacher.to(dev).eval()(images)
        got = copy.to(dev).eval()(images)
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, want))
    teacher.cpu()
    del copy, got, want
    zpath = pytorchcv_zip(torch, os.path.join(wd, "darknet_tiny_h-2340-cdd2c0c9.pth.zip"))
    imagenet = os.path.join(wd, "imagenet_tiny_h.ckpt")
    n_zip = imgclsmob_to_backbone_ckpt(zpath, "darknet_tiny_h", imagenet)
    n_bb = sum(1 for k in PoseNet(cfg.model, n_fg=n_fg).state_dict()
               if k.startswith("backbone.") and not k.endswith("num_batches_tracked"))
    empty = os.path.join(wd, "nothing.pth")
    torch.save({"model": {"rpn.weight": torch.zeros(3)}}, empty)
    raised = []
    for fn in (load_params_loose, load_backbone_init):
        try:
            fn(empty, PoseNet(cfg.model, n_fg=n_fg))
        except ValueError as e:
            raised.append(empty in str(e))
    secs["a"] = time.perf_counter() - t0
    log(f"[tools] (a) reference-layout darknet53 teacher ({{'model': {{'module.' + k}}}}, "
        f"steps, optim, sched): {n_ref} of {len(sd)} tensors loaded, its B={B} outputs "
        f"bit-equal to the source net's: {bit_equal}; pytorchcv zip -> {n_zip} tensors "
        f"converted ({n_bb} of them a PoseNet backbone's); a file that matches nothing "
        f"raised in {raised} ({secs['a']:.1f} s)")
    if not (n_ref == len(sd) and bit_equal and n_zip == n_bb + 2 and raised == [True, True]):
        raise AssertionError("a reference-format file loaded wrong, or a file that matches "
                             "nothing did not raise")

    # (b) train_kd --vis_every 2 from those files, pooled, then per step;
    # (c) the evaluations' per-depth plots
    n_chunks = -(-CLI_EVAL_IMAGES // cfg.test.ims_per_batch)
    k1_total, runs = 0, {}
    plans = (("pooled", TOOLS_POOLED[1], TOOLS_POOLED_PLOTS,
              ["--device_pool", "2", "--steps_per_dispatch", str(TOOLS_POOLED[0]),
               "--weight_file_t", ref, "--backbone_init", imagenet], (0, TOOLS_POOLED[1])),
             ("per_step", TOOLS_PER_STEP, TOOLS_PER_STEP_PLOTS, [], (TOOLS_PER_STEP,)))
    for name, steps_n, plots, extra, evals in plans:
        run_wd = os.path.join(wd, name)
        sf.reset_launch_counts()
        cf.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            st, hist = train_kd.main(["--config_file", CLI_CONFIG_FILE, "--data", "synthetic",
                                      "--max_iters", str(steps_n), "--vis_every", "2",
                                      "--working_dir", run_wd] + extra)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        printed = buf.getvalue()
        k1 = sf.launches.get(k1_key, 0)
        k2 = {f"{c}->{o}": cf.launches.get(("conv3x3_bn_act_flat", c, o, "bfloat16"), 0)
              for c, o in shapes}
        k1_total += k1
        vis = sorted(os.listdir(os.path.join(run_wd, "vis")))
        depth = sorted(f for f in os.listdir(run_wd) if f.startswith("accuracy_per_depth_"))
        shapes_ok = all(png.read(os.path.join(run_wd, "vis", f)).shape
                        == visualizer.CLOUD_SIZE + (3,) for f in vis) and all(
            png.read(os.path.join(run_wd, f)).shape == visualizer.DEPTH_SIZE + (3,)
            for f in depth)
        runs[name] = dict(seconds=secs[name], k1=k1, k2=k2, plots=vis, depth_plots=depth,
                          history=hist)
        log(f"[tools] (b) train_kd --vis_every 2 {name} to {steps_n} ({secs[name]:.1f} s): "
            f"K1 {k1}, K2 {k2}; plots {vis}; (c) {depth}; printed: "
            + " | ".join(line for line in printed.splitlines()
                         if line.startswith(("teacher:", "backbone init", "device pool"))))
        want_vis = sorted(f"{i}_img_2d.png" for i in plots)
        want_depth = [f"accuracy_per_depth_{i:06d}.png" for i in evals]
        if not (st.step == steps_n and k1 == steps_n and sum(sf.launches.values()) == steps_n
                and set(k2.values()) == {n_chunks + len(plots)}
                and sum(cf.launches.values()) == 2 * (n_chunks + len(plots))
                and vis == want_vis and depth == want_depth and shapes_ok
                and all(math.isfinite(v) for h in hist for v in h.values())
                and (name != "pooled"
                     or (f"teacher: loaded {len(sd)} tensors from {ref}" in printed
                         and f"backbone init: {n_bb} tensors from {imagenet}" in printed))):
            raise AssertionError(f"train_kd --vis_every 2 {name}: steps, launches, plots "
                                 f"(want {want_vis}, {want_depth}) or loads not as expected")

    # (d) loop.train's steps under profiling.trace: the trace names K1's and
    # K2's kernels, as many times as their wrappers counted
    bcfg, bcfg_t = bf16_configs(cfg.replace(solver=dataclasses.replace(
        cfg.solver, max_iter=TOOLS_TRACE_STEPS)), cfg_t)
    ds = SyntheticPoseDataset(n_fg=n_fg, input_res=RES, seed=12)
    batches = [ds.batch(range(B * i, B * (i + 1))) for i in range(TOOLS_TRACE_STEPS)]
    folded = fold_batchnorm(teacher.eval())
    sf.reset_launch_counts()
    cf.reset_launch_counts()
    t0 = time.perf_counter()
    with profiling.trace(os.path.join(wd, "prof")) as prof:
        train(bcfg, ds.consts(device="cpu"), iter(batches), cfg_t=bcfg_t,
              teacher_state_dict=folded, device=dev, vis_every=2,
              working_dir=os.path.join(wd, "traced"), verbose=False)
    secs["d"] = time.perf_counter() - t0
    kernels = trace_kernels(prof.trace_path)
    k1_trace = sum(v for k, v in kernels.items() if "k1_" in k)
    k2_trace = sum(v for k, v in kernels.items() if "conv3x3_" in k)
    k1_d, k2_d = sf.launches.get(k1_key, 0), dict(cf.launches)
    plots_d = sorted(os.listdir(os.path.join(wd, "traced", "vis")))
    log(f"[tools] (d) profiling.trace over loop.train, {TOOLS_TRACE_STEPS} bf16 steps with "
        f"plots ({secs['d']:.1f} s, trace {os.path.getsize(prof.trace_path)} bytes): K1 "
        f"{k1_d} launches, {k1_trace} in the trace; K2 {k2_d}, {k2_trace} in the trace; "
        f"kernels {sorted(k for k in kernels if 'k1_' in k or 'conv3x3_' in k)}; "
        f"plots {plots_d}")
    if not (k1_d == TOOLS_TRACE_STEPS == k1_trace > 0
            and sum(k2_d.values()) == k2_trace == 2 * TOOLS_TRACE_STEPS
            and plots_d == [f"{i}_img_2d.png" for i in range(1, TOOLS_TRACE_STEPS + 1)]):
        raise AssertionError("the trace does not name K1 and K2 once a launch")
    k1_total += k1_d
    tmp.cleanup()
    log(f"[tools] seconds: {json.dumps({k: round(v, 2) for k, v in secs.items()})}")
    return dict(reference_tensors=n_ref, outputs_bit_equal=bit_equal, zip_tensors=n_zip,
                seconds=secs, runs=runs, trace_kernels=kernels, trace_k1=k1_trace,
                trace_k2=k2_trace), k1_total, {VIS_BATCH: k2_d}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="kernel,serving,pose,train,eval,export,cli,zebra,bop,tools,dist")
    ap.add_argument("--json_out", default="outputs/chip_smoke.json")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    # cuBLAS's workspace fixed before the first CUDA call: the cli phase's
    # (c) and the dist phase run their fp32 steps under deterministic
    # algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    rows, launches, k1_row, k1_launches = [], {BATCH: {}, EVAL_BATCH: {}, VIS_BATCH: {}}, \
        None, None

    def add_launches(by_batch):
        for b, by in by_batch.items():
            for key, v in by.items():
                launches.setdefault(b, {})[key] = launches.get(b, {}).get(key, 0) + v

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
    if "export" in phases:
        result["export"], k2_export = export_phase(torch, cf, dev)
        add_launches(k2_export)
    if "cli" in phases:
        result["cli"], k1_cli, k2_cli = cli_phase(torch, sf, cf, dev, tf32_defaults)
        k1_launches = (k1_launches or 0) + k1_cli
        add_launches(k2_cli)
    if "zebra" in phases:
        result["zebra"], k2_zebra = zebra_phase(torch, cf, dev)
        add_launches(k2_zebra)
    if "bop" in phases:
        result["bop"], k1_bop, k2_bop = bop_phase(torch, sf, cf, dev)
        k1_launches = (k1_launches or 0) + k1_bop
        add_launches(k2_bop)
    if "tools" in phases:
        result["tools"], k1_tools, k2_tools = tools_phase(torch, sf, cf, dev)
        k1_launches = (k1_launches or 0) + k1_tools
        add_launches(k2_tools)
    if "dist" in phases:
        result["dist"], k1_dist, k2_dist = dist_phase(torch, sf, cf, dev)
        k1_launches = (k1_launches or 0) + k1_dist
        add_launches(k2_dist)
    if "dist_spread" in phases:
        result["dist_spread"] = dist_spread_phase(torch, dev)
    if "cli_spread" in phases:
        result["cli_spread"] = cli_spread_phase(torch, dev)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for r in rows:
        r["launches"] = launches[r["B"]].get((r["name"], r["C"], r["O"], r["dtype"]), 0)
        r = dict(r, name=f"{r['name']}[{r['shape']} {r['C']}->{r['O']} @{r['H']}^2 "
                         f"B={r['B']} {r['dtype']}]")
        kernels.append({k: r[k] for k in keys})
    if k1_row is not None:
        # K1's launches are those of the train phase's run, the cli
        # phase's pooled runs (loop.train, train_kd.main and its resume),
        # the bop phase's live steps and train_kd.main runs, and the dist
        # phase's ranks and train_kd --distributed
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
