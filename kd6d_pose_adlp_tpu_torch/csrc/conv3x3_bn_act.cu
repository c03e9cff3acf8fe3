// Fused 3x3 stride-1 SAME convolution + per-channel affine (eval-mode BN)
// + LeakyReLU, on the flat channel-major slab layout, in fp32 or bf16.
//
// Replaces the two Pallas TPU kernels of
// kd6d_pose_adlp_tpu/ops/conv_pallas.py:
//   conv3x3_bn_act_flat     (K2, body _make_kernel):  x (B, C, (H+2)(W+2)+2)
//   conv3x3_bn_act_stacked  (K3, body _make_kernel_stacked): xs (B, 9, C, M)
// both -> out (B, O, M), M = H * (W + 2). Output column m is
//   out[b, o, m] = act(scale[o] * sum_{t, c} w[t, o, c] * x[b, c, m + off_t]
//                      + bias[o]),   off_t = (t / 3) * (W + 2) + t % 3,
// and the stacked form reads xs[b, t, c, m] in place of x[b, c, m + off_t].
// The last two columns of every output row are wrap-around values of the
// flat formula, exactly as on the TPU; callers drop them.
//
// Types, as on the TPU: x, w and out are all fp32 (the *_flat / *_stacked
// entry points) or all bf16 (*_bf16), scale and bias fp32; every kernel
// sums in fp32 and rounds its output once. The fp32 stem instance
// multiplies on the CUDA cores, every other kernel on the tensor cores:
// bf16 products are native there (mma.sync m16n8k16, fp32 accumulators,
// exact products of bf16 inputs) and kept as bf16 in shared memory, where
// fp32 needs three TF32 products per product. The stacked form's streaming
// instances are fp32 only; in bf16 every stacked shape runs conv3x3_igemm.
//
// What bounds the flat form (K2) on an H100 in fp32, at the two shapes the
// serving stem gives it (B = 8): the stem, 3 -> 8 at 256^2, reads 6.4 MB
// and writes 16.9 MB against 0.12 GFLOP, so it is bound by bytes (~7.0 us
// at 3.35 TB/s); s2, 8 -> 16 at 128^2, moves 13 MB (~3.8 us) against
// 0.31 GFLOP, ~4.6 us of fp32 CUDA-core math at 67 TFLOP/s but ~1.9 us as
// three TF32 tensor-core products each at 495 TFLOP/s, so on the tensor
// cores it too is bound by bytes. In bf16 the same two shapes move half the
// bytes, 11.65 MB (3.48 us) and 6.43 MB (1.92 us); the stem's products
// would take 3.4 us on the CUDA cores even at their full rate, as long as
// its bytes, so both bf16 instances run on the tensor cores, on one kernel
// of their own (conv3x3_flat_tc, below: what it does about its bytes, and
// what was tried and lost). Each fp32 instance has a kernel of its own; C
// and O are constants there, so every tap and channel loop unrolls. Both
// copy their (b, strip) tile's inputs, all C channels plus the 2 (W + 2) + 2 halo,
// into shared memory with cp.async, 4 bytes a thread (a channel row of the
// slab is L * 4 bytes, not a multiple of 16, so TMA does not fit), and
// write each output once in the epilogue, after the affine and LeakyReLU.
//
// The fp32 stem (conv3x3_flat_tiled, CUDA cores): one commit group per
// channel, all issued at once, so the block starts on channel 0 while the others are
// in flight. Each thread owns 4 consecutive output columns for all 8
// outputs: per (input row dy, channel c) it reads the 6 inputs it needs
// with two 16-byte loads and applies the three dx taps, 96 FFMAs against 2
// input loads and 6 broadcast 16-byte weight loads. The 16-byte loads need
// the row's shift dy * (W + 2) in whole float4s; its remainder mod 4 is a
// template parameter, so the 6 values are picked by constant indices. The
// outputs go out 16 bytes a thread where M = H * (W + 2) is a multiple of 4.
//
// s2 in fp32 (conv3x3_flat_mma, tensor cores): on the CUDA cores the same
// loop is bound by its shared-memory weight loads (12 us at B = 8), so s2 runs
// error-compensated TF32 products on the tensor cores instead: O = 16 is
// the mma's M, each tap one k-step over the 8 channels, the weights split
// hi + lo in registers for the whole block, and three m16n8k8 products per
// (tap, 8 columns) that together miss the fp32 product by ~2^-20. Plain
// TF32 (one product) would miss it by ~1e-3 of each term.
//
// The bf16 instances (conv3x3_flat_tc, tensor cores): the strip lands by
// 16-byte cp.async and stays bf16; lanes read 4-byte pairs of adjacent
// elements as the mma's A fragments and store 16 bytes of 8 output columns
// each. On an H100 80GB HBM3 at 700 W (B = 8) the stem takes 6.8-7.0 us and
// s2 5.3-5.7 us, of which ~3.1-3.4 us is a fixed chain every launch pays (a
// graph node, a DRAM round trip, the multiply, the store drain: s2 takes
// 3.2-3.4 us at B = 1); past it each moves its bytes at ~2.8-3.4 TB/s.
//
// The stacked form (K3) reads 9 * C pre-shifted rows for every output
// column: 38.3 MB in and 8.5 MB out at s2 (14.0 us at 3.35 TB/s) against
// 0.31 GFLOP (4.6 us of fp32 FMA), 57.1 + 16.9 MB at the stem (22.1 us), so
// it is bound by bytes, and every element is used by exactly one output
// column, so nothing is staged. What held the first design at 1 TB/s at s2
// was memory-level parallelism: one 4-byte load a thread in flight. At its
// two serving instances (conv3x3_stacked_stream) a thread owns 4 columns
// for all O outputs, loads each tap row as one 16-byte streaming load, and
// runs its rows fully unrolled through a ring of registers, D rows ahead of
// its FFMAs (64-96 KB in flight a SM); weights come from shared memory as
// 16-byte broadcasts. At s2 a lone warp's pass over 72 rows took ~11 us,
// longer than the bytes, so the rows are split between two halves of the
// block, which fold their sums through shared memory: 16 warps a SM, each
// with half the chain.
//
// Every other shape of either form, in either type, runs conv3x3_igemm, an
// implicit GEMM on the tensor cores: out (O x M) = A (O x 9C) B (9C x M)
// with B's row (tap t, channel c) the slab shifted by off_t (flat form) or
// the stack's row xs[b, t, c] (stacked form). It replaces K2 at every flat
// shape but 3 -> 8 and 8 -> 16, and K3 at every bf16 shape and every fp32
// shape but those two; on the main path those are the DarkNet variants'
// eval-mode stems (B = 8: 3 -> 16 and 3 -> 32 @256², 16 -> 32, 32 -> 32
// and 12 -> 8 @128², and DarkNet-19's 32 -> 64) and the bf16 serving stem
// under the stacked hook (3 -> 8, 8 -> 16). Counted with the products on
// the tensor cores (fp32 three TF32 products each), the flat form is bound
// by bytes in bf16 (the output is most of them) and in fp32 up to 16 -> 32;
// fp32 at 32 -> 32 and 32 -> 64 is bound by its 3xTF32 products (e.g.
// 14.6 GFLOP at 32 -> 64, 29.5 us at 495 TFLOP/s, against 15.4 us of
// bytes). The stacked form reads 9 C rows a column and is bound by bytes
// at every shape. What the design does about it:
// - one block takes NCOL columns of one image for every output (16 MT a
//   pass, sums in registers, MT x NG m16n8 tiles a warp), so each input
//   element is staged once, and the outputs-by-tiles loop runs over shared
//   memory, not over device memory;
// - the reduction goes through shared memory in stages, one channel octet
//   under all nine taps (flat) or 16 (fp32) / 32 (bf16) stack rows
//   (stacked), with that stage's weights already in mma fragment order (one
//   16-byte load a fragment); a ring of three (two for flat bf16) stages
//   the next while one is multiplied, so any C and O are taken. cp.async
//   fills it where the source is aligned; the flat bf16 strip cannot be
//   (a shifted window, transposed into columns) and is gathered through
//   registers, 4-byte column pairs where the slab's rows allow;
// - the flat form stages, of each channel octet, the window of NCOL + 2 (W
//   + 2) + 2 columns that a tile's nine taps read; past the width where a
//   ring of those windows no longer fits in 227 KB of shared memory (fp32
//   about 550-920 columns at C > 4, 1,700-2,110 at C <= 4; bf16 about
//   2,900-3,300), the flat form runs conv3x3_rows instead (below: its own
//   note);
// - fp32 runs 3xTF32 m16n8k8 (split_tf32; one plain TF32 product misses by
//   ~1e-3 of each term), two taps of four channels a k8 step at C <= 4;
//   bf16 m16n8k16, kept as bf16 in shared memory;
// - the flat form's tap shifts are arbitrary element counts, so its B
//   fragments are 4-byte shared loads at the shifted column (ldmatrix and
//   wgmma descriptors need 16-byte aligned rows): fp32 from channel rows
//   8 words mod 32 apart, bf16 from 16-byte columns of 8 channels (a tap
//   pair's k16 step), both 32 banks a warp; the stacked form has no shift,
//   so its bf16 fragments come by ldmatrix.trans from rows padded to 16
//   bytes mod 128, and its rows by 16-byte cp.async where M allows;
// - mma.sync, not wgmma: with outputs as M, at O <= 64 a 64-row warpgroup
//   tile would be mostly padding, and the shifted B fragments cannot be
//   described to wgmma (conv3x3_rows, below, makes pixels M and loads its
//   shifted operand into registers instead).
// Sums are fp32 in either type; the epilogue applies the affine and the
// LeakyReLU and rounds once. On an H100 80GB HBM3 at 700 W (B = 8) the
// stacked form runs at 1.4-2.1x its byte bound, the flat form at 2.1-5.6x
// (fp32 at C = 32 3.4-4.1x its 3xTF32 bound: mma.sync reaches about half
// the TF32 rate; bf16 waits on its register gather and per-stage loads);
// PERF.md has the times.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// ---------------------------------------------------------------------------
// the flat form at its serving instances
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n commit groups are pending (at most 2 for n > 2,
// which waits longer than needed); n is a constant once the caller's loop
// is unrolled, so the branches fold away
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= 2) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

constexpr int kCols = 4;  // consecutive output columns per thread (FFMA form)
constexpr int kStemThreads = 256;  // a stem block: kStemThreads * kCols columns
constexpr int kStemMinBlocks = 4;  // the launch bound: 64 registers a thread

// One input row (dy, c) for the thread's kCols output columns and O
// outputs. xa is 16-byte aligned and lies R floats before the thread's
// first input; the kCols + 2 inputs the three dx taps need come in two
// 16-byte loads (three when R = 3). w points at the weights of tap
// (dy, dx = 0), channel c; TS is the stride between dx taps.
template <int O, int R, int TS>
__device__ __forceinline__ void tap_row(const float* xa, const float* w,
                                        float (&acc)[kCols][O]) {
  constexpr int NV = (R + kCols + 2 + 3) / 4;
  float u[4 * NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float4 t = reinterpret_cast<const float4*>(xa)[v];
    u[4 * v + 0] = t.x;
    u[4 * v + 1] = t.y;
    u[4 * v + 2] = t.z;
    u[4 * v + 3] = t.w;
  }
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const float4* w4 = reinterpret_cast<const float4*>(w + dx * TS);
#pragma unroll
    for (int q = 0; q < O / 4; ++q) {
      const float4 wv = w4[q];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float xv = u[R + dx + j];
        acc[j][4 * q + 0] = fmaf(wv.x, xv, acc[j][4 * q + 0]);
        acc[j][4 * q + 1] = fmaf(wv.y, xv, acc[j][4 * q + 1]);
        acc[j][4 * q + 2] = fmaf(wv.z, xv, acc[j][4 * q + 2]);
        acc[j][4 * q + 3] = fmaf(wv.w, xv, acc[j][4 * q + 3]);
      }
    }
  }
}

// The stem instance on the CUDA cores. One block takes one (b, strip of
// kStemThreads * kCols output columns) tile; each thread kCols consecutive columns
// for all O outputs. The strip is copied with one commit group per channel,
// all issued at once, and the block starts on channel 0 as soon as it has
// landed. WM = Wp % 4 makes each input row's shift remainder a constant.
// S: floats per channel row of the strip, a multiple of 4; vec: 4-output
// stores allowed (M % 4 == 0, out aligned to 4 outputs).
template <int C, int O, int WM>
__global__ void __launch_bounds__(kStemThreads, kStemMinBlocks)
conv3x3_flat_tiled(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int Wp, int L, int M, int S, int vec, float alpha) {
  static_assert(O % 4 == 0, "outputs go in float4 groups");
  constexpr int kTile = kStemThreads * kCols;
  constexpr int kTapStride = C * O;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;              // [9][C][O] weights
  float* ss = ws + 9 * C * O;    // [O] scale
  float* bs = ss + O;            // [O] bias
  float* xs = bs + O;            // [C][S] input strip
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kTile;

  // the strip, one commit group per channel; past the slab's end, zeros
  const float* xb = x + (size_t)b * C * L + m0;
  const int n_in = min(S, L - m0);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    for (int i = tid; i < S; i += kStemThreads) {
      if (i >= n_in) {
        xs[c * S + i] = 0.f;
      } else {
        cp_async4(xs + c * S + i, xb + (size_t)c * L + i);
      }
    }
    cp_async_commit();
  }
  for (int i = tid; i < 9 * C * O; i += kStemThreads) {
    const int o = i % O;
    const int tc = i / O;
    ws[i] = w[((tc / C) * O + o) * C + tc % C];
  }
  for (int i = tid; i < O; i += kStemThreads) {
    ss[i] = scale[i];
    bs[i] = bias[i];
  }

  constexpr int R1 = WM & 3;        // (1 * Wp) % 4
  constexpr int R2 = (2 * WM) & 3;  // (2 * Wp) % 4
  float acc[kCols][O];
#pragma unroll
  for (int j = 0; j < kCols; ++j)
#pragma unroll
    for (int q = 0; q < O; ++q) acc[j][q] = 0.f;

  const float* xt = xs + kCols * tid;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // channel c has landed (this thread's copies), and every thread's
    // copies and the weights are visible after the barrier
    cp_async_wait(C - 1 - c);
    __syncthreads();
    const float* xc = xt + c * S;
    const float* wc = ws + c * O;
    tap_row<O, 0, kTapStride>(xc, wc, acc);
    tap_row<O, R1, kTapStride>(xc + Wp - R1, wc + 3 * kTapStride, acc);
    tap_row<O, R2, kTapStride>(xc + 2 * Wp - R2, wc + 6 * kTapStride, acc);
  }

  const int m = m0 + kCols * tid;
#pragma unroll
  for (int o = 0; o < O; ++o) {
    const float sc = ss[o];
    const float bi = bs[o];
    float v[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float t = acc[j][o] * sc + bi;
      v[j] = t >= 0.f ? t : alpha * t;
    }
    float* ob = out + ((size_t)b * O + o) * M + m;
    if (vec && m + kCols <= M) {
      *reinterpret_cast<float4*>(ob) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (m + j < M) ob[j] = v[j];
    }
  }
}

// Launch the FFMA instance if its strip fits in shared memory; *taken =
// false (and nothing launched) if not.
template <int C, int O>
cudaError_t launch_tiled(const float* x, const float* w, const float* scale,
                         const float* bias, float* out, int B, int Wp, int L,
                         int M, float alpha, cudaStream_t stream,
                         bool* taken) {
  constexpr int kTile = kStemThreads * kCols;
  // a thread reads up to 12 floats from its aligned start, which lies up
  // to 2 * Wp past its first column
  const int S = (kTile + 2 * Wp + 8 + 3) / 4 * 4;
  const size_t smem = sizeof(float) * ((size_t)C * S + 9 * C * O + 2 * O);
  *taken = smem <= 227 * 1024;
  if (!*taken) return cudaSuccess;
  void (*kernel)(const float*, const float*, const float*, const float*, float*,
                 int, int, int, int, int, float);
  switch (Wp & 3) {
    case 0: kernel = conv3x3_flat_tiled<C, O, 0>; break;
    case 1: kernel = conv3x3_flat_tiled<C, O, 1>; break;
    case 2: kernel = conv3x3_flat_tiled<C, O, 2>; break;
    default: kernel = conv3x3_flat_tiled<C, O, 3>; break;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int vec = (M % 4 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const dim3 grid((M + kTile - 1) / kTile, B);
  kernel<<<grid, kStemThreads, smem, stream>>>(x, w, scale, bias, out, Wp, L,
                                               M, S, vec, alpha);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// s2 on the tensor cores: error-compensated TF32 (3xTF32) mma.sync
// ---------------------------------------------------------------------------

// a = hi + lo with hi exact in TF32 (the low 13 mantissa bits cleared) and
// lo = a - hi exact in fp32; the mma reads lo's top 19 bits, so a product
// a_hi b_hi + a_hi b_lo + a_lo b_hi misses a b by ~2^-20 of |a b|
__device__ __forceinline__ void split_tf32(float a, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kMmaWarps = 4;     // warps a block
constexpr int kMmaGroups = 8;    // groups of 8 output columns a warp
constexpr int kMmaInFlight = 4;  // groups a warp multiplies at a time
constexpr int kMmaTile = kMmaWarps * kMmaGroups * 8;  // columns a block

// C = 8, O = 16. One m16n8k8 product per (tap, 8 output columns): A is the
// tap's (16 outputs x 8 channels) weights, held in registers for the whole
// block, B the 8 channels x 8 columns of the strip at the tap's shift. A
// block of kMmaWarps warps takes a tile of kMmaTile columns; each warp
// kMmaGroups groups of 8, kMmaInFlight at a time. The strip's channel
// stride S is 8 mod 32, so a B fragment's (4 channels x 8 columns) reads
// hit 32 different banks.
__global__ void __launch_bounds__(kMmaWarps * 32)
conv3x3_flat_mma(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 float* __restrict__ out, int Wp, int L, int M, int S,
                 int vec2, float alpha) {
  constexpr int C = 8, O = 16, NI = kMmaInFlight;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // [C][S]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kMmaTile;

  // the strip (one commit group: a tap's product needs all 8 channels);
  // past the slab's end, zeros
  const float* xb = x + (size_t)b * C * L + m0;
  const int n_in = min(S, L - m0);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    for (int i = tid; i < S; i += kMmaWarps * 32) {
      if (i < n_in) {
        cp_async4(xs + c * S + i, xb + (size_t)c * L + i);
      } else {
        xs[c * S + i] = 0.f;
      }
    }
  }
  cp_async_commit();

  // the A fragments of the nine taps, split: rows g, g + 8; columns tg, tg + 4
  unsigned ahi[9][4], alo[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float* wt = w + t * O * C;
    split_tf32(wt[g * C + tg], ahi[t][0], alo[t][0]);
    split_tf32(wt[(g + 8) * C + tg], ahi[t][1], alo[t][1]);
    split_tf32(wt[g * C + tg + 4], ahi[t][2], alo[t][2]);
    split_tf32(wt[(g + 8) * C + tg + 4], ahi[t][3], alo[t][3]);
  }
  const float sc0 = scale[g], sc1 = scale[g + 8];
  const float bi0 = bias[g], bi1 = bias[g + 8];
  cp_async_wait(0);
  __syncthreads();

  const float* x0 = xs + tg * S + g;        // channel tg, column g
  const float* x1 = xs + (tg + 4) * S + g;  // channel tg + 4
#pragma unroll 1
  for (int n0 = warp * kMmaGroups; n0 < (warp + 1) * kMmaGroups; n0 += NI) {
    float d[NI][4];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) d[i][r] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int off = (t / 3) * Wp + t % 3;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int col = (n0 + i) * 8 + off;
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(x0[col], bh0, bl0);
        split_tf32(x1[col], bh1, bl1);
        mma_tf32(d[i], alo[t], bh0, bh1);
        mma_tf32(d[i], ahi[t], bl0, bl1);
        mma_tf32(d[i], ahi[t], bh0, bh1);
      }
    }
    // D: rows (outputs) g, g + 8; columns 2 tg, 2 tg + 1 of the group
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int m = m0 + (n0 + i) * 8 + 2 * tg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sc = h ? sc1 : sc0, bi = h ? bi1 : bi0;
        float v0 = d[i][2 * h] * sc + bi, v1 = d[i][2 * h + 1] * sc + bi;
        v0 = v0 >= 0.f ? v0 : alpha * v0;
        v1 = v1 >= 0.f ? v1 : alpha * v1;
        float* ob = out + ((size_t)b * O + g + 8 * h) * M + m;
        if (vec2 && m + 2 <= M) {
          *reinterpret_cast<float2*>(ob) = make_float2(v0, v1);
        } else {
          if (m < M) ob[0] = v0;
          if (m + 1 < M) ob[1] = v1;
        }
      }
    }
  }
}

cudaError_t launch_mma(const float* x, const float* w, const float* scale,
                       const float* bias, float* out, int B, int Wp, int L,
                       int M, float alpha, cudaStream_t stream, bool* taken) {
  // reads reach 2 * Wp + 2 + 7 past a group's first column
  const int S = (kMmaTile + 2 * Wp + 16 + 31) / 32 * 32 + 8;
  const size_t smem = sizeof(float) * (size_t)8 * S;
  *taken = smem <= 227 * 1024;
  if (!*taken) return cudaSuccess;
  auto kernel = conv3x3_flat_mma;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int vec2 = (M % 2 == 0) && (reinterpret_cast<uintptr_t>(out) % 8 == 0);
  const dim3 grid((M + kMmaTile - 1) / kMmaTile, B);
  kernel<<<grid, kMmaWarps * 32, smem, stream>>>(x, w, scale, bias, out, Wp,
                                                 L, M, S, vec2, alpha);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// s2 on the tensor cores in bf16: mma.sync m16n8k16, fp32 accumulators
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned pack_bf16(bf16 lo, bf16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of 16 bytes of which the first n (0..16) come from src and the
// rest are zeros (n = 0 reads nothing)
__device__ __forceinline__ void cp_async_16z(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(n)
               : "memory");
}

// The flat form's two bf16 serving instances, 3 -> 8 (the stem) and 8 -> 16
// (s2), on the tensor cores. Both are bound by bytes (the output is 73% and
// 66% of them); what held their first bf16 versions at 3.4x and 4.5x that
// bound was how the bytes moved: the strip staged by synchronous 2-byte
// loads (widened to an fp32 strip at the stem, gathered into 16-byte
// columns at s2), the stem's 0.23 GFLOP as FFMAs (3.4 us at the CUDA cores'
// full rate), and half-sector stores at s2. Here:
// - the strip lands by 16-byte cp.async and stays bf16: each channel's row
//   from the 16-byte aligned address at or before the tile's first column
//   (a row of the slab is 2 L bytes, 12 mod 16 at both serving shapes, so
//   rows start 4-byte aligned at best); the row's remainder (0..7 elements)
//   is applied when a lane addresses a window; past the slab's end the
//   copies fill zeros;
// - out (columns x O) = A (columns x K) B (K x O) on mma.sync m16n8k16. K
//   runs over windows (dy, c): a window's first k pair is its dx = 0, 1
//   taps, the second its dx = 2 tap and a zero weight, so the two values
//   of an A register are two adjacent elements of one channel row (a k16
//   step takes 4 windows; the stem's 9 windows fill 3 steps, 75% of K, s2's
//   24 fill 6);
// - the 16 rows of an m16 tile are not 16 consecutive columns: lane
//   (g, tg)'s rows g and g + 8 of tile j (0..3) are the columns 8 g + 2 j
//   and 8 g + 2 j + 1 of a 64-column span, so over the span's four tiles a
//   lane reads the 10 elements 8 g .. 8 g + 9 of its window once (six
//   4-byte loads; a funnel shift evens out a window that starts on an odd
//   element) and ends up holding 8 consecutive output columns of each of
//   its outputs: one 16-byte store each, and a warp's store fills whole
//   128-byte lines. Round r takes windows 4 r .. 4 r + 3, lane tg the
//   window 4 r + tg; windows past 3 C read a zero area and have zero
//   weights. The weights (B fragments) stay in registers for the block;
// - a block runs NW warps over tiles of NW * NS spans, NS spans a warp,
//   walking tiles blockIdx.x, blockIdx.x + gridDim.x, ... over (image,
//   tile) through a ring of NB strips, the next NB - 1 tiles' strips in
//   flight while one is multiplied and stored.
// What was tried and lost (bench_k2.py, a, b, b, a, on an H100 80GB HBM3 at
// 700 W, B = 8 and B = 24): at the stem a grid capped at 4 or 2 blocks an
// SM walking its tiles through the ring lost (9.3 and 12.9 us against
// 7.2): too few strips in flight; tiles of 512 columns (4 warps, 7.2 us),
// 256 (8.7 us: the halo, 2 (W + 2) columns a tile, read again) and 2,048
// (B = 8 as fast, B = 1 edges 1.7x slower) against 1,024; at s2 512-column
// tiles (5.6 us, 12.0 at B = 24 against 10.7), 8 warps a tile (5.5), 2
// warps (5.8), a cap of 2 blocks an SM (6.0); streaming (evict-first)
// stores changed nothing. S: the strip's elements a channel, a multiple of
// 8; vec: 16-byte stores allowed.
template <int C, int O, int NW, int NS, int NB>
struct TcCfg {
  static constexpr int kThreads = NW * 32;
  static constexpr int kTile = NW * NS * 64;        // output columns a tile
  static constexpr int kRounds = (3 * C + 3) / 4;   // k16 steps
  static constexpr int kNT = O / 8;                 // n8 tiles
  static constexpr int kZeroWords = 8;              // the zero area
  // a window reads up to 11 elements past its lane's first (a row's
  // remainder and the funnel shift's extra word), the last span starts 64
  // before the tile's end, and the taps reach 2 Wp past a column
  static __host__ __device__ int strip(int Wp) { return (kTile + 2 * Wp + 18) / 8 * 8; }
  static __host__ __device__ int smem_bytes(int Wp) {
    return NB * C * strip(Wp) * 2 + kZeroWords * 4;
  }
};

template <int C, int O, int NW, int NS, int NB>
__global__ void __launch_bounds__(NW * 32)
conv3x3_flat_tc(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ scale, const float* __restrict__ bias,
                bf16* __restrict__ out, int B, int Wp, int L, int M, int S,
                int vec, float alpha) {
  using Cfg = TcCfg<C, O, NW, NS, NB>;
  constexpr int R = Cfg::kRounds, NT = Cfg::kNT, NCOL = Cfg::kTile;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* strips = reinterpret_cast<bf16*>(smem_tc);  // [NB][C][S]
  unsigned* zero = reinterpret_cast<unsigned*>(strips + NB * C * S);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int tiles = (M + NCOL - 1) / NCOL;
  const int total = B * tiles;
  if (tid < Cfg::kZeroWords) zero[tid] = 0u;

  // the strip of tile t into ring slot buf
  auto stage = [&](int t, int buf) {
    const int b = t / tiles, m0 = (t % tiles) * NCOL;
    const int n_in = L - m0;  // slab elements of a row from m0 on
    bf16* dst = strips + buf * C * S;
    for (int i = tid; i < C * (S / 8); i += NW * 32) {
      const int c = i / (S / 8), k = i % (S / 8);
      const bf16* row = x + ((size_t)b * C + c) * L + m0;
      const int r = static_cast<int>((reinterpret_cast<uintptr_t>(row) & 15) >> 1);
      const bf16* src = row - r + 8 * k;  // 16-byte aligned
      const int valid = n_in - (8 * k - r);  // slab elements from src on
      bf16* d = dst + c * S + 8 * k;
      const int before = static_cast<int>(
          (reinterpret_cast<intptr_t>(x) - reinterpret_cast<intptr_t>(src)) / 2);
      if (before > 0) {
        // the slab itself starts unaligned: its first chunk element by element
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = e >= before && e < valid ? src[e] : __float2bfloat16_rn(0.f);
      } else {
        cp_async_16z(d, src, 2 * max(0, min(8, valid)));
      }
    }
  };

  // the B fragments: round r, n8 tile nt; window q = 4 r + tg, output
  // o = 8 nt + g; b0 = its (dx = 0, dx = 1) weights, b1 = (dx = 2, 0)
  unsigned wb[R][NT][2];
  const bf16 bz = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = 4 * r + tg;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int o = 8 * nt + g;
      if (q < 3 * C) {
        const int dy = q / C, c = q % C;
        const bf16* wq = w + ((3 * dy) * O + o) * C + c;
        wb[r][nt][0] = pack_bf16(wq[0], wq[O * C]);
        wb[r][nt][1] = pack_bf16(wq[2 * O * C], bz);
      } else {
        wb[r][nt][0] = wb[r][nt][1] = 0u;
      }
    }
  }
  float sc[NT][2], bi[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sc[nt][h] = scale[8 * nt + 2 * tg + h];
      bi[nt][h] = bias[8 * nt + 2 * tg + h];
    }

#pragma unroll
  for (int i = 0; i + 1 < NB; ++i) {
    const int tt = blockIdx.x + i * gridDim.x;
    if (tt < total) stage(tt, i);
    cp_async_commit();
  }
  int t = blockIdx.x;
#pragma unroll 1
  for (int it = 0; t < total; ++it, t += gridDim.x) {
    const int tn = t + (NB - 1) * gridDim.x;
    if (tn < total) stage(tn, (it + NB - 1) % NB);
    cp_async_commit();
    cp_async_wait(NB - 1);  // this tile's strip has landed (this thread's copies)
    __syncthreads();        // ... and every thread's, and the zero area

    const int b = t / tiles, m0 = (t % tiles) * NCOL;
    const bf16* xs = strips + (it % NB) * C * S;
    // each window's first element for this lane, in 4-byte words of the
    // strip, and whether it starts on an odd element (the row's remainder
    // and the tap row's shift decide it)
    int wofs[R], wodd[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = 4 * r + tg;
      if (q < 3 * C) {
        const int dy = q / C, c = q % C;
        const bf16* row = x + ((size_t)b * C + c) * L + m0;
        const int rem = static_cast<int>((reinterpret_cast<uintptr_t>(row) & 15) >> 1);
        const int e = c * S + rem + dy * Wp + 8 * g;
        wofs[r] = e >> 1;
        wodd[r] = (e & 1) * 16;
      } else {
        wofs[r] = static_cast<int>(zero - reinterpret_cast<const unsigned*>(xs));
        wodd[r] = 0;
      }
    }
    const unsigned* xw = reinterpret_cast<const unsigned*>(xs);

#pragma unroll 1
    for (int sp = 0; sp < NS; ++sp) {
      const int s0 = (sp * NW + warp) * 64;  // the span's first column in the tile
      if (m0 + s0 >= M) break;
      float acc[4][NT][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // elements 8 g + 0 .. 9 of window 4 r + tg at the span, as pairs
        // v[i] = (element 2 i, element 2 i + 1)
        const unsigned* p = xw + wofs[r] + (4 * r + tg < 3 * C ? s0 / 2 : 0);
        unsigned u[6], v[5];
#pragma unroll
        for (int i = 0; i < 6; ++i) u[i] = p[i];
#pragma unroll
        for (int i = 0; i < 5; ++i) v[i] = __funnelshift_r(u[i], u[i + 1], wodd[r]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // rows g, g + 8 of tile j: columns 8 g + 2 j, 8 g + 2 j + 1
          const unsigned a[4] = {v[j], __byte_perm(v[j], v[j + 1], 0x5432),
                                 v[j + 1] & 0xffffu, v[j + 1] >> 16};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[j][nt], a, wb[r][nt][0], wb[r][nt][1]);
        }
      }
      // lane: outputs 8 nt + 2 tg + h, columns 8 g .. 8 g + 7 of the span
      const int m = m0 + s0 + 8 * g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float y[8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float y0 = acc[j][nt][h] * sc[nt][h] + bi[nt][h];
            const float y1 = acc[j][nt][2 + h] * sc[nt][h] + bi[nt][h];
            y[2 * j] = y0 >= 0.f ? y0 : alpha * y0;
            y[2 * j + 1] = y1 >= 0.f ? y1 : alpha * y1;
          }
          bf16* ob = out + ((size_t)b * O + 8 * nt + 2 * tg + h) * M + m;
          if (vec && m + 8 <= M) {
            uint4 pk;
            pk.x = pack_bf16(__float2bfloat16_rn(y[0]), __float2bfloat16_rn(y[1]));
            pk.y = pack_bf16(__float2bfloat16_rn(y[2]), __float2bfloat16_rn(y[3]));
            pk.z = pack_bf16(__float2bfloat16_rn(y[4]), __float2bfloat16_rn(y[5]));
            pk.w = pack_bf16(__float2bfloat16_rn(y[6]), __float2bfloat16_rn(y[7]));
            *reinterpret_cast<uint4*>(ob) = pk;
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i)
              if (m + i < M) ob[i] = __float2bfloat16_rn(y[i]);
          }
        }
    }
    __syncthreads();  // every warp is done with this slot before it is refilled
  }
}

// Launch a bf16 serving instance if its NB strips fit in shared memory;
// *taken = false (and nothing launched) if not. The grid covers every
// (image, tile) once, capped at CAP blocks an SM (0: no cap).
template <int C, int O, int NW, int NS, int NB, int CAP>
cudaError_t launch_tc(const bf16* x, const bf16* w, const float* scale,
                      const float* bias, bf16* out, int B, int Wp, int L, int M,
                      float alpha, cudaStream_t stream, bool* taken) {
  using Cfg = TcCfg<C, O, NW, NS, NB>;
  const size_t smem = Cfg::smem_bytes(Wp);
  *taken = smem <= 227 * 1024;
  if (!*taken) return cudaSuccess;
  auto kernel = conv3x3_flat_tc<C, O, NW, NS, NB>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int grid = B * ((M + Cfg::kTile - 1) / Cfg::kTile);
  if (CAP > 0) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    grid = min(grid, CAP * sms);
  }
  const int vec = M % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kernel<<<grid, Cfg::kThreads, smem, stream>>>(x, w, scale, bias, out, B, Wp, L, M,
                                                Cfg::strip(Wp), vec, alpha);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// every other shape: implicit GEMM on the tensor cores (conv3x3_igemm)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async_16b(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// four 8x8 bf16 matrices, transposed: thread (g, tg) gets, of each matrix,
// the elements (rows 2 tg, 2 tg + 1; column g) in one register; lanes
// 8 i .. 8 i + 7 give the 16-byte row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

constexpr int kIgWarps = 8;
constexpr int kIgThreads = kIgWarps * 32;

// The k structure of one staged chunk of the reduction (a "stage"):
//   flat form, one channel octet (8 channels, zero past C) under all nine
//     taps: fp32 one m16n8k8 step a tap (k = the 8 channels); bf16 one
//     m16n8k16 step a tap pair (k 0..7 tap 2p, 8..15 tap 2p + 1; a tenth
//     tap of zeros);
//   stacked form, kRows consecutive rows k = t * C + c of the (9 C, M) tap
//     stack, zero past 9 C: two mma steps a stage.
//   QUAD (flat fp32, C <= 4): one m16n8k8 step a tap pair, k 0..3 tap 2p's
//     four channels, 4..7 tap 2p + 1's: five steps, not nine.
// A block tile is kCols output columns, NG groups of 8 a warp, by MT m16
// tiles of outputs (16 MT outputs a pass over the stages).
template <typename T, bool STACKED, int MT, int NG, bool QUAD = false>
struct IgCfg {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr int kK = kF32 ? 8 : 16;                         // k a step
  static constexpr int kSteps = STACKED ? 2 : (kF32 && !QUAD ? 9 : 5);  // steps a stage
  static constexpr int kRows = 2 * kK;                             // stacked rows a stage
  static constexpr int kCols = kIgWarps * NG * 8;
  static constexpr int kWBytes = kSteps * MT * 32 * 16;            // A fragments
  // stages in the ring: the cp.async forms keep two in flight while one is
  // multiplied; the flat bf16 strip is gathered through registers
  static constexpr int kBufs = STACKED || kF32 ? 3 : 2;
  // input bytes of a ring stage for row stride S: flat fp32 [8][S] floats
  // ([4][S] in QUAD); flat bf16 [S] columns of 8 channels, 16 bytes each;
  // stacked [kRows][S] elements
  static __host__ __device__ constexpr int in_bytes(int S) {
    return STACKED ? kRows * S * (int)sizeof(T) : (kF32 ? (QUAD ? 16 : 32) : 16) * S;
  }
  static __host__ __device__ int stages(int C) {
    return STACKED ? (9 * C + kRows - 1) / kRows : (C + 7) / 8;
  }
};

// Stage `st` of the reduction for outputs o0 .. o0 + 16 MT - 1 of the tile
// at column m0 into ring buffer `buf`: its A fragments (weights, zero past
// O, C and the ninth tap) in fragment order, [step][mt][lane] 16 bytes each,
// then its input, by cp.async where the source allows it (fp32 always; bf16
// weights when C is even, stacked rows 16 bytes at a time with `vec`),
// plain loads otherwise, a thread's loads all ahead of its stores;
// zeros are stored directly. The flat bf16 strip is gathered through
// registers into 16-byte columns of 8 channels: column pairs by 4-byte
// loads where the slab's rows are 4-byte aligned (`vec`), else by 2-byte
// loads.
template <typename T, bool STACKED, int MT, int NG, bool QUAD>
__device__ __forceinline__ void ig_stage(unsigned char* buf, const T* __restrict__ x,
                                         const T* __restrict__ w,
                                         int st, int o0, int b, int m0, int C, int O, int L,
                                         int M, int S, int Wp, bool vec) {
  using Cfg = IgCfg<T, STACKED, MT, NG, QUAD>;
  const int tid = threadIdx.x;
  // weights: word e of the stage's fragments, for output o and reduction
  // index kk of its step; fp32 a word an element, bf16 a word a pair of
  // consecutive k
  unsigned* wd = reinterpret_cast<unsigned*>(buf);
  constexpr int NW = Cfg::kWBytes / 4;
  auto word = [&](int e, int& o, int& kk) {
    const int r = e & 3, ln = (e >> 2) & 31;
    o = o0 + ((e >> 7) % MT) * 16 + (ln >> 2) + 8 * (r & 1);
    kk = Cfg::kF32 ? (ln & 3) + 4 * (r >> 1) : 2 * (ln & 3) + 8 * (r >> 1);
  };
  // (tap, channel) of reduction index kk of word e's step, and whether the
  // weight exists (tap < 9, channel < C, output < O)
  auto tap_ch = [&](int e, int o, int kk, int& t, int& c) {
    const int step = (e >> 7) / MT;
    if constexpr (STACKED) {
      const int k = st * Cfg::kRows + step * Cfg::kK + kk;
      t = k / C;
      c = k - t * C;
    } else if constexpr (QUAD) {
      t = 2 * step + (kk >> 2);
      c = kk & 3;
    } else if constexpr (Cfg::kF32) {
      t = step;
      c = 8 * st + kk;
    } else {
      t = 2 * step + (kk >> 3);
      c = 8 * st + (kk & 7);
    }
    return o < O && t < 9 && c < C;
  };
  if (Cfg::kF32 || (C & 1) == 0) {
    // a word is one fp32 weight, or (bf16, C even) two neighbours of one
    // tap, 4-byte aligned, or absent as a whole
    for (int e = tid; e < NW; e += kIgThreads) {
      int o, kk, t, c;
      word(e, o, kk);
      if (tap_ch(e, o, kk, t, c)) {
        cp_async4(reinterpret_cast<float*>(wd + e),
                  reinterpret_cast<const float*>(w + ((size_t)t * O + o) * C + c));
      } else {
        wd[e] = 0u;
      }
    }
  } else if constexpr (!Cfg::kF32) {
    // C odd: two 2-byte loads a word, all of a thread's ahead of its
    // stores
    constexpr int PER = (NW + kIgThreads - 1) / kIgThreads;
    const bf16 zero = __float2bfloat16_rn(0.f);
    unsigned v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * kIgThreads;
      bf16 lo = zero, hi = zero;
      if (e < NW) {
        int o, kk, t, c;
        word(e, o, kk);
        if (tap_ch(e, o, kk, t, c)) lo = w[((size_t)t * O + o) * C + c];
        if (tap_ch(e, o, kk + 1, t, c)) hi = w[((size_t)t * O + o) * C + c];
      }
      v[k] = pack_bf16(lo, hi);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (tid + k * kIgThreads < NW) wd[tid + k * kIgThreads] = v[k];
  }

  unsigned char* in = buf + Cfg::kWBytes;
  constexpr int NCOL = Cfg::kCols;
  if constexpr (STACKED) {
    // kRows rows of the (9 C, M) stack of image b: row k is xs[b, k / C, k % C]
    constexpr int R = Cfg::kRows;
    const int K = 9 * C;
    const int k0 = st * R;
    T* tile = reinterpret_cast<T*>(in);
    const T* xb = x + (size_t)b * K * M + m0;
    if (vec) {
      constexpr int V = 16 / sizeof(T);  // elements a 16-byte copy
      for (int e = tid; e < R * NCOL / V; e += kIgThreads) {
        const int kk = e / (NCOL / V), i = (e % (NCOL / V)) * V;
        T* d = tile + kk * S + i;
        if (k0 + kk < K && m0 + i < M) {
          cp_async_16b(d, xb + (size_t)(k0 + kk) * M + i);
        } else {
          *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    } else if constexpr (Cfg::kF32) {
      for (int e = tid; e < R * NCOL; e += kIgThreads) {
        const int kk = e / NCOL, i = e % NCOL;
        float* d = tile + kk * S + i;
        if (k0 + kk < K && m0 + i < M) {
          cp_async4(d, xb + (size_t)(k0 + kk) * M + i);
        } else {
          *d = 0.f;
        }
      }
    } else {
      // rows not 16-byte aligned: 2-byte loads, eight a thread in flight
      constexpr int NE = R * NCOL / kIgThreads, CH = 8;
      static_assert(NE % CH == 0, "the tile splits into batches of CH a thread");
#pragma unroll 1
      for (int k0e = 0; k0e < NE; k0e += CH) {
        bf16 v[CH];
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          const int e = tid + (k0e + k) * kIgThreads;
          const int kk = e / NCOL, i = e % NCOL;
          v[k] = k0 + kk < K && m0 + i < M ? xb[(size_t)(k0 + kk) * M + i]
                                           : __float2bfloat16_rn(0.f);
        }
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          const int e = tid + (k0e + k) * kIgThreads;
          tile[(e / NCOL) * S + e % NCOL] = v[k];
        }
      }
    }
  } else {
    // the strip of octet st: columns m0 .. m0 + S - 1 of channels 8 st ..
    // 8 st + 7; zeros past the slab's end and past C. Strip position i
    // reads slab column m0 + col(i), if col(i) < n_in.
    const T* xb = x + (size_t)b * C * L + m0;
    const int n_in = min(S, L - m0);
    auto col = [](int i) { return i; };
    if constexpr (Cfg::kF32) {
      float* strip = reinterpret_cast<float*>(in);  // [8][S], QUAD [4][S]
#pragma unroll 1
      for (int ch = 0; ch < (QUAD ? 4 : 8); ++ch) {
        const int c = 8 * st + ch;
        float* d = strip + ch * S;
        if (c < C) {
          const float* src = xb + (size_t)c * L;
          for (int i = tid; i < S; i += kIgThreads) {
            const int j = col(i);
            if (j < n_in) {
              cp_async4(d + i, src + j);
            } else {
              d[i] = 0.f;
            }
          }
        } else {
          for (int i = tid; i < S / 4; i += kIgThreads)
            reinterpret_cast<float4*>(d)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    } else {
      const int nc = min(8, C - 8 * st);
      const T* src = xb + (size_t)(8 * st) * L;
      uint4* cols = reinterpret_cast<uint4*>(in);  // [S] columns of 8 channels
      const bf16 zero = __float2bfloat16_rn(0.f);
      if (vec) {
        // column pairs: a 4-byte load a channel, split into the two
        // columns' words (low halves: column i; high: i + 1)
        constexpr int PER = 3;  // pairs a thread in flight
#pragma unroll 1
        for (int i0 = 2 * tid; i0 < S; i0 += 2 * PER * kIgThreads) {
          unsigned v[PER][8];
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            const int i = i0 + 2 * k * kIgThreads;
            const int j = col(i);
#pragma unroll
            for (int ch = 0; ch < 8; ++ch) {
              v[k][ch] = 0u;
              if (ch < nc && j + 1 < n_in) {
                v[k][ch] = *reinterpret_cast<const unsigned*>(src + (size_t)ch * L + j);
              } else if (ch < nc && j < n_in) {
                v[k][ch] = pack_bf16(src[(size_t)ch * L + j], zero);
              }
            }
          }
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            const int i = i0 + 2 * k * kIgThreads;
            if (i < S) {
              cols[i] = make_uint4(__byte_perm(v[k][0], v[k][1], 0x5410),
                                   __byte_perm(v[k][2], v[k][3], 0x5410),
                                   __byte_perm(v[k][4], v[k][5], 0x5410),
                                   __byte_perm(v[k][6], v[k][7], 0x5410));
              cols[i + 1] = make_uint4(__byte_perm(v[k][0], v[k][1], 0x7632),
                                       __byte_perm(v[k][2], v[k][3], 0x7632),
                                       __byte_perm(v[k][4], v[k][5], 0x7632),
                                       __byte_perm(v[k][6], v[k][7], 0x7632));
            }
          }
        }
      } else {
        // rows not 4-byte aligned: two columns (16 2-byte loads) a thread in
        // flight
        constexpr int CH = 2;
#pragma unroll 1
        for (int i0 = tid; i0 < S; i0 += CH * kIgThreads) {
          bf16 v[CH][8];
#pragma unroll
          for (int k = 0; k < CH; ++k) {
            const int j = col(i0 + k * kIgThreads);
#pragma unroll
            for (int ch = 0; ch < 8; ++ch)
              v[k][ch] = (ch < nc && j < n_in) ? src[(size_t)ch * L + j] : zero;
          }
#pragma unroll
          for (int k = 0; k < CH; ++k)
            if (i0 + k * kIgThreads < S)
              cols[i0 + k * kIgThreads] =
                  make_uint4(pack_bf16(v[k][0], v[k][1]), pack_bf16(v[k][2], v[k][3]),
                             pack_bf16(v[k][4], v[k][5]), pack_bf16(v[k][6], v[k][7]));
        }
      }
    }
  }
}

// The products of one staged chunk into acc[mt][j] (outputs mt * 16 + g,
// + 8; columns wcol + 8 j + 2 tg, + 1 of the tile). B fragments come from
// shared memory with 4-byte loads at each tap's shift (flat form: the
// shifts are arbitrary element counts, so no ldmatrix), or with ldmatrix
// (stacked bf16: no shift, rows 16-byte aligned); A fragments are one
// 16-byte load a (step, m tile), each used for NG column groups.
template <typename T, bool STACKED, int MT, int NG, bool QUAD>
__device__ __forceinline__ void ig_compute(const unsigned char* buf, float (&acc)[MT][NG][4],
                                           int wcol, int Wp, int S) {
  using Cfg = IgCfg<T, STACKED, MT, NG, QUAD>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const uint4* wf = reinterpret_cast<const uint4*>(buf) + lane;
  const unsigned char* xin = buf + Cfg::kWBytes;

  if constexpr (Cfg::kF32) {
    const float* xs = reinterpret_cast<const float*>(xin);
#pragma unroll
    for (int step = 0; step < Cfg::kSteps; ++step) {
      // B: rows tg, tg + 4 of the step's 8 k; flat: channel rows of the
      // strip at the tap's shift (QUAD: channel row tg at taps 2 step and
      // 2 step + 1); stacked: rows of the tile
      const int t0 = QUAD ? 2 * step : step, t1 = 2 * step + 1;
      const float* x0 = STACKED ? xs + (step * 8 + tg) * S + wcol + g
                                : xs + tg * S + wcol + g + (t0 / 3) * Wp + t0 % 3;
      const float* x1 = STACKED || !QUAD ? x0 + 4 * S
                                         : xs + tg * S + wcol + g + (t1 / 3) * Wp + t1 % 3;
      unsigned bh[NG][2], bl[NG][2];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        split_tf32(x0[8 * j], bh[j][0], bl[j][0]);
        if (QUAD && t1 >= 9) {
          bh[j][1] = bl[j][1] = 0u;
        } else {
          split_tf32(x1[8 * j], bh[j][1], bl[j][1]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 a = wf[(step * MT + mt) * 32];
        unsigned ahi[4], alo[4];
        split_tf32(__uint_as_float(a.x), ahi[0], alo[0]);
        split_tf32(__uint_as_float(a.y), ahi[1], alo[1]);
        split_tf32(__uint_as_float(a.z), ahi[2], alo[2]);
        split_tf32(__uint_as_float(a.w), ahi[3], alo[3]);
        // the three products of a column group go to one accumulator: take
        // each term across the NG groups, so NG products lie between two
        // that depend on each other
#pragma unroll
        for (int j = 0; j < NG; ++j) mma_tf32(acc[mt][j], alo, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NG; ++j) mma_tf32(acc[mt][j], ahi, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NG; ++j) mma_tf32(acc[mt][j], ahi, bh[j][0], bh[j][1]);
      }
    }
  } else {
#pragma unroll
    for (int step = 0; step < Cfg::kSteps; ++step) {
      unsigned bf[NG][2];
      if constexpr (STACKED) {
        // rows step * 16 .. + 15 of the tile; matrix i of an x4 load: k half
        // i & 1 of column group 2 jj + (i >> 1)
        const bf16* tile = reinterpret_cast<const bf16*>(xin);
        const int mi = lane >> 3;
        const bf16* p = tile + (step * 16 + (mi & 1) * 8 + (lane & 7)) * S + wcol + (mi >> 1) * 8;
#pragma unroll
        for (int jj = 0; jj < NG / 2; ++jj) {
          unsigned r[4];
          ldmatrix_x4_trans(r, p + 16 * jj);
          bf[2 * jj][0] = r[0];
          bf[2 * jj][1] = r[1];
          bf[2 * jj + 1][0] = r[2];
          bf[2 * jj + 1][1] = r[3];
        }
      } else {
        // channel pair (2 tg, 2 tg + 1) of column c: word 4 c + tg
        const unsigned* xw = reinterpret_cast<const unsigned*>(xin) + tg;
        const int t0 = 2 * step, t1 = 2 * step + 1;
        const int c0 = wcol + g + (t0 / 3) * Wp + t0 % 3;
        const int c1 = wcol + g + (t1 / 3) * Wp + t1 % 3;
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          bf[j][0] = xw[4 * (c0 + 8 * j)];
          bf[j][1] = t1 < 9 ? xw[4 * (c1 + 8 * j)] : 0u;
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 a4 = wf[(step * MT + mt) * 32];
        const unsigned a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int j = 0; j < NG; ++j) mma_bf16(acc[mt][j], a, bf[j][0], bf[j][1]);
      }
    }
  }
}

// The implicit GEMM: out[o, m] = act(scale[o] * sum_k A[o, k] B[k, m] +
// bias[o]) over k = (tap, channel), on the tensor cores (fp32 as 3xTF32,
// bf16 native). A block takes kCols output columns of image b = blockIdx.y
// for all O outputs (16 MT a pass, the sums in registers) and walks the
// reduction's stages through a ring: stages q + 1 .. q + NB - 1 are staged
// while stage q is multiplied. Each input element is staged once per pass
// over the outputs; the epilogue applies the affine and LeakyReLU and
// rounds once.
template <typename T, bool STACKED, int MT, int NG, bool QUAD>
__global__ void __launch_bounds__(kIgThreads, 2)
conv3x3_igemm(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ scale, const float* __restrict__ bias,
              T* __restrict__ out, int C, int O, int Wp, int L, int M, int S,
              int vec, int vec2, float alpha) {
  using Cfg = IgCfg<T, STACKED, MT, NG, QUAD>;
  constexpr int NB = Cfg::kBufs;
  constexpr int NCOL = Cfg::kCols;
  extern __shared__ __align__(16) unsigned char ig_smem[];
  const int stage_bytes = Cfg::kWBytes + Cfg::in_bytes(S);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y;
  const int wcol = warp * NG * 8;
  const int m0 = blockIdx.x * NCOL;
  const int nst = Cfg::stages(C);
  const int nq = (O + 16 * MT - 1) / (16 * MT) * nst;  // stages of the block

  // stage q of this block: output group q / nst, reduction chunk q % nst
  auto stage_in = [&](int q) {
    ig_stage<T, STACKED, MT, NG, QUAD>(ig_smem + (q % NB) * stage_bytes, x, w, q % nst,
                                            q / nst * 16 * MT, b, m0, C, O, L, M, S, Wp, vec);
  };

  float acc[MT][NG][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0.f;

  // one commit group a stage (empty past the last), so "all but the NB - 1
  // newest groups" is always "stage q"
#pragma unroll
  for (int p = 0; p < NB - 1; ++p) {
    if (p < nq) stage_in(p);
    cp_async_commit();
  }
#pragma unroll 1
  for (int q = 0; q < nq; ++q) {
    if (q + NB - 1 < nq) stage_in(q + NB - 1);
    cp_async_commit();
    cp_async_wait(NB - 1);
    __syncthreads();
    ig_compute<T, STACKED, MT, NG, QUAD>(ig_smem + (q % NB) * stage_bytes, acc, wcol, Wp, S);
    __syncthreads();

    if (q % nst == nst - 1) {
      // the last stage of an output group: D rows (outputs) g, g + 8 of
      // each m tile, columns 2 tg, 2 tg + 1 of each group
      const int o0 = q / nst * 16 * MT;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = o0 + mt * 16 + g + 8 * h;
          if (o >= O) continue;
          const float sc = scale[o], bi = bias[o];
          T* ob = out + ((size_t)b * O + o) * M;
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            const int m = m0 + wcol + 8 * j + 2 * tg;
            float v0 = acc[mt][j][2 * h] * sc + bi, v1 = acc[mt][j][2 * h + 1] * sc + bi;
            v0 = v0 >= 0.f ? v0 : alpha * v0;
            v1 = v1 >= 0.f ? v1 : alpha * v1;
            if (vec2 && m + 2 <= M) {
              if constexpr (Cfg::kF32) {
                *reinterpret_cast<float2*>(ob + m) = make_float2(v0, v1);
              } else {
                *reinterpret_cast<__nv_bfloat162*>(ob + m) = __floats2bfloat162_rn(v0, v1);
              }
            } else {
              if (m < M) ob[m] = from_f<T>(v0);
              if (m + 1 < M) ob[m + 1] = from_f<T>(v1);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0.f;
    }
  }
}

template <typename T, bool STACKED, int MT, int NG, bool QUAD>
cudaError_t launch_ig(const T* x, const T* w, const float* scale, const float* bias,
                      T* out, int B, int C, int O, int Wp, int L, int M, int S,
                      size_t smem, int vec, float alpha, cudaStream_t stream) {
  using Cfg = IgCfg<T, STACKED, MT, NG, QUAD>;
  auto kernel = conv3x3_igemm<T, STACKED, MT, NG, QUAD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int vec2 = M % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
  const dim3 grid((M + Cfg::kCols - 1) / Cfg::kCols, B);
  kernel<<<grid, kIgThreads, smem, stream>>>(x, w, scale, bias, out, C, O, Wp, L,
                                             M, S, vec, vec2, alpha);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the flat form past the width where conv3x3_igemm's window fits:
// conv3x3_rows
// ---------------------------------------------------------------------------
//
// K2 (kd6d_pose_adlp_tpu/ops/conv_pallas.py:105, conv3x3_bn_act_flat) at
// every shape where a ring of conv3x3_igemm's windows (NCOL + 2 (W + 2) + 2
// columns of a channel octet) overflows 227 KB of shared memory: fp32 past
// about 550-920 columns (C > 4), 1,700-2,100 (C <= 4), bf16 past about
// 2,900-3,300. The main path gives it one shape, the wide plan's eval s2
// conv at input_res 1,920 (32 -> 32 @960², B = 1, fp32): 17 GFLOP, 51 as
// three TF32 products, 0.104 ms at 495 TFLOP/s against 0.071 ms of bytes,
// so it is bound by its products; the four-row shapes of chip_smoke's
// K2_WIDE are a few microseconds of either, so they are bound by how soon
// the card fills and drains. What the design does about it:
// - pixels are the products' M and outputs their N, 8, 16 or 32 a pass
//   (more outputs in groups: more blocks), so no O pads past 8: fp32 at C > 4 on wgmma (m64nNk8, 3xTF32: A, a warp's 16
//   pixels by 8 channels, from registers, loaded from the strip at the
//   tap's shift and split hi / lo once for all N; B, the weights, from
//   shared memory through a descriptor, K-major core matrices without
//   swizzle), fp32 at C <= 4 (two taps of four channels a k8 step) and
//   bf16 on mma.sync (m16n8k8 3xTF32, m16n8k16), two m16 tiles a warp;
// - a tile is 256 output columns as R image rows of 256 / R (R = 1 .. 8,
//   no taller than the image), whose nine taps read R + 2 row segments of
//   256 / R + 2 columns, so each input element is staged (R + 2)(256 / R
//   + 2) / 256 times (1.33 at R = 8; the row segments of a one-row tile
//   staged it 3.02 times);
// - the grid is persistent: a block keeps its channel octets' weights,
//   split hi / lo once, in shared memory (bf16 by cp.async beside its
//   first strip where C is even), and walks its tiles, across images,
//   through one cp.async ring of (tile, octet) stages, so a tile's
//   epilogue runs while the next tile's first stages land; weights that do
//   not fit (large C O) are reloaded a chunk of `cw` octets at a time;
// - where tiles are fewer than the card's block slots, the plan takes
//   fewer outputs a pass (more output groups) and a thread-block cluster
//   of ks blocks splits the channel octets: each block sums its octets,
//   the cluster hands its partial sums over in distributed shared memory,
//   and each pixel's sum is taken over the ranks in rank order, so the
//   result does not depend on timing; the affine and LeakyReLU apply once,
//   after the whole sum, and lanes swap a value so each stores two
//   neighbouring columns;
// - the launch plan (outputs a pass, R, ks, the grid, cw) is worked out on
//   the host (ops/conv_fused.rows_plan) from the shape and the SM count and
//   checked here against the shared memory this source lays out.
// The slab's channel rows are L * 4 bytes apart (L = (H + 2)(W + 2) + 2)
// and a row segment starts at any element, so neither 16-byte cp.async nor
// TMA tiles fit its source: the fp32 strip lands by 4-byte cp.async,
// channel rows 8 words mod 32 apart (an A fragment's 4-byte loads hit 32
// banks), the bf16 strip is gathered through registers into 16-byte columns
// of 8 channels. On an H100 80GB HBM3 at 700 W (scripts/bench_k2.py
// --wide; PERF.md has every shape) the main-path shape takes ~0.33 ms
// (3.1x its bound; the former row-segment form 0.47, cuDNN 0.88). Tried and lost
// there: mma.sync for fp32 at C > 4 (0.372 ms), a third A-register set so
// wgmma waits on the group before last (0.344), 4- and 16-row tiles
// (0.337, 0.328 against 0.320 at 8), streaming stores (no change), and
// 16-byte cp.async strips from each segment's aligned superset, the
// remainder folded into the A loads (0.356: remainders that differ by
// channel cost those loads their bank spread; a version that shifted each
// segment into place instead read 0.58 and failed its gate). Taken out
// one at a time, the strip staging (0.224 ms without it; 0.301 with every
// copy from one address, so it is the 4-byte cp.async instructions more
// than the traffic), the products (0.204) and the stores (0.249) each cost
// their own share: the three add up rather than overlap, which a kernel
// whose warps issue all three in turn, 16 warps an SM, does not hide.

// wgmma (sm_90a), m64nNk8 TF32 with A from registers (a warp's 16 rows as
// in mma.sync's m16n8k8 A fragment) and B from shared memory through a
// descriptor: no swizzle, K-major core matrices of 8 rows x 16 bytes, LBO
// the byte step between the two core matrices along K, SBO the step
// between 8-row groups along N
__device__ __forceinline__ uint64_t wg_desc(const void* p, unsigned lbo, unsigned sbo) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3FFFu) | (uint64_t)((lbo >> 4) & 0x3FFFu) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFFu) << 32;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[nt][e] += A (64 x 8, registers) B (8 x 8 NT, descriptor); d in the
// layout of NT m16n8 D fragments of the warp's 16 rows
template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NT][4], const unsigned (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_tf32<1>(float (&d)[1][4], const unsigned (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<2>(float (&d)[2][4], const unsigned (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<4>(float (&d)[4][4], const unsigned (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}


constexpr int kRowsWarps = 8;
constexpr int kRowsThreads = kRowsWarps * 32;
constexpr int kRowsMw = 2;                             // m16 tiles a warp
constexpr int kRowsPix = kRowsWarps * kRowsMw * 16;    // output columns a tile
constexpr long kRowsSmemMax = 227 * 1024;

// channel rows of an fp32 strip of n columns: 8 words mod 32
__host__ __device__ constexpr int rows_f32_stride(int n) { return (n - 8 + 31) / 32 * 32 + 8; }

// One kind of the form: fp32 at C > 4 (a stage is a channel octet under the
// nine taps, a k8 step a tap), fp32 at C <= 4 (QUAD: one stage of four
// channels, a k8 step two taps), bf16 (a stage an octet, a k16 step two
// taps, a tenth tap of zeros); NT n tiles of 8 outputs.
template <typename T, bool QUAD, int NT>
struct RowsCfg {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr bool kWg = kF32 && !QUAD;  // wgmma; mma.sync otherwise
  static constexpr int kSteps = kF32 && !QUAD ? 9 : 5;
  static constexpr int kCh = QUAD ? 4 : 8;
  // B operands of one octet: wgmma's core matrices [tap][hi, lo][nt]
  // (kWg), else mma.sync's fragments [step][nt][lane], fp32 (b0 hi, b1 hi,
  // b0 lo, b1 lo), bf16 (b0, b1)
  static constexpr int kWBytes = kSteps * NT * 32 * (kF32 ? 16 : 8);
  static constexpr int kBufs = kF32 ? 3 : 2;
  static constexpr int kRedBytes = kRowsThreads * kRowsMw * NT * 4 * 4;
  // a ring stage of RS strip positions: fp32 [kCh][rows_f32_stride(RS)]
  // floats, bf16 [RS] columns of 8 channels
  static __host__ __device__ constexpr int strip_bytes(int RS) {
    return kF32 ? kCh * 4 * rows_f32_stride(RS) : 16 * RS;
  }
};

// out[b, o, m] for the tiles and output group of this block's cluster:
// tile t (of ntiles = B nbands nchunks) is image t / (nbands nchunks), rows
// [R band, + R), columns [NC chunk, + NC) of the (H, Wp) output rows;
// cluster c takes output group c % ngo and tiles c / ngo + k (clusters /
// ngo); its rank r sums channel octets [r n8 / ks, (r + 1) n8 / ks).
template <typename T, bool QUAD, int NT>
__global__ void __launch_bounds__(kRowsThreads, 2)
conv3x3_rows(const T* __restrict__ x, const T* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ bias,
             T* __restrict__ out, int C, int O, int H, int Wp, int L, int M, int R,
             int ks, int ngo, int cw, int nbands, int nchunks, int ntiles, int vec,
             int vec2, int wvec, float alpha) {
  using Cfg = RowsCfg<T, QUAD, NT>;
  constexpr int NB = Cfg::kBufs;
  extern __shared__ __align__(16) unsigned char rw_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int NC = kRowsPix / R, SR = NC + 2, RS = (R + 2) * SR;
  const int SB = Cfg::strip_bytes(RS), CS = rows_f32_stride(RS);
  unsigned char* wsm = rw_smem;
  unsigned char* ring = rw_smem + cw * Cfg::kWBytes;
  float* red = reinterpret_cast<float*>(ring + NB * SB);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = ks > 1 ? (int)cluster.block_rank() : 0;
  const int cl = blockIdx.x / ks, ncl = gridDim.x / ks;
  const int o0 = cl % ngo * 8 * NT;
  const int n8 = QUAD ? 1 : (C + 7) / 8;
  const int oct0 = rank * n8 / ks, noct = (rank + 1) * n8 / ks - oct0;
  const int t0 = cl / ngo, tstep = ncl / ngo;
  const int ntl = t0 < ntiles ? (ntiles - 1 - t0) / tstep + 1 : 0;
  const int nq = ntl * noct;
  const int nchk = (noct + cw - 1) / cw;
  const unsigned mSR = 0xffffffffu / SR + 1u;  // i / SR = umulhi(i, mSR) here

  // strip position of pixel row g of each m16 tile of the warp at tap 0
  int pos[kRowsMw];
#pragma unroll
  for (int mw = 0; mw < kRowsMw; ++mw) {
    const int i = mw * kRowsWarps + warp, ri = i / (NC / 16);
    pos[mw] = ri * SR + (i - ri * (NC / 16)) * 16 + g;
  }

  auto tile = [&](int it, int& b, int& h0, int& w0) {
    const int t = t0 + it * tstep;
    b = t / (nbands * nchunks);
    const int r = t - b * nbands * nchunks, band = r / nchunks;
    h0 = band * R;
    w0 = (r - band * nchunks) * NC;
  };

  // the B fragments of local octets k0 .. k0 + cnt - 1 into weight slots
  // 0 .. cnt - 1, zero past O, C and the ninth tap; entry e = ((slot *
  // kSteps + step) NT + nt) 32 + lane, U entries a thread loaded before any
  // is stored. fp32 at C > 4: the weights of tap `step` as wgmma's B,
  // [tap][hi, lo][nt][k half][8 outputs][4 channels], core matrices of 128
  // bytes; QUAD and bf16: mma.sync's B fragments, [step][nt][lane]
  auto load_w = [&](int k0, int cnt, bool async) {
    constexpr int U = 8;
    constexpr int NV = Cfg::kF32 ? 2 : 4;
    auto wv = [&](int t, int o, int c) {
      return t < 9 && o < O && c < C ? w[((size_t)t * O + o) * C + c] : from_f<T>(0.f);
    };
    const int n = cnt * Cfg::kSteps * NT * 32;
    if constexpr (!Cfg::kF32) {
      if (async) {
        // bf16 at C even: each word a channel pair of one tap, 4-byte
        // aligned, by cp.async into the caller's commit group
        for (int e = tid; e < n; e += kRowsThreads) {
          const int ln = e & 31, nt = (e >> 5) % NT, sp = (e >> 5) / NT;
          const int st = sp % Cfg::kSteps, oct = oct0 + k0 + sp / Cfg::kSteps;
          const int o = o0 + 8 * nt + (ln >> 2), c = 8 * oct + 2 * (ln & 3);
          unsigned* d = reinterpret_cast<unsigned*>(wsm) + 2 * e;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int t = 2 * st + hf;
            if (t < 9 && o < O && c < C) {
              cp_async4(reinterpret_cast<float*>(d + hf),
                        reinterpret_cast<const float*>(w + ((size_t)t * O + o) * C + c));
            } else {
              d[hf] = 0u;
            }
          }
        }
        return;
      }
    }
#pragma unroll 1
    for (int e0 = tid; e0 < n; e0 += U * kRowsThreads) {
      T v[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * kRowsThreads;
        const int ln = e & 31, nt = (e >> 5) % NT, sp = (e >> 5) / NT;
        const int st = sp % Cfg::kSteps, oct = oct0 + k0 + sp / Cfg::kSteps;
        const int o = e < n ? o0 + 8 * nt + (ln >> 2) : O;
        if constexpr (Cfg::kF32) {
          // k tg, tg + 4 of the step: channels tg, tg + 4 at tap st, or
          // (QUAD) channel tg at taps 2 st, 2 st + 1
          const int c = QUAD ? (ln & 3) : 8 * oct + (ln & 3);
          v[u][0] = QUAD ? wv(2 * st, o, c) : wv(st, o, c);
          v[u][1] = QUAD ? wv(2 * st + 1, o, c) : wv(st, o, c + 4);
        } else {
          // k 2 tg, 2 tg + 1 of tap 2 st (b0) and of tap 2 st + 1 (b1)
          const int c = 8 * oct + 2 * (ln & 3);
          v[u][0] = wv(2 * st, o, c);
          v[u][1] = wv(2 * st, o, c + 1);
          v[u][2] = wv(2 * st + 1, o, c);
          v[u][3] = wv(2 * st + 1, o, c + 1);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * kRowsThreads;
        if (e < n) {
          if constexpr (Cfg::kWg) {
            const int ln = e & 31, nt = (e >> 5) % NT, sp = (e >> 5) / NT;
            unsigned* d = reinterpret_cast<unsigned*>(wsm + sp / 9 * Cfg::kWBytes) +
                          ((sp % 9 * 2) * NT + nt) * 64 + (ln >> 2) * 4 + (ln & 3);
            split_tf32(v[u][0], d[0], d[NT * 64]);
            split_tf32(v[u][1], d[32], d[NT * 64 + 32]);
          } else if constexpr (Cfg::kF32) {
            uint4 f;
            split_tf32(v[u][0], f.x, f.z);
            split_tf32(v[u][1], f.y, f.w);
            reinterpret_cast<uint4*>(wsm)[e] = f;
          } else {
            reinterpret_cast<uint2*>(wsm)[e] = make_uint2(pack_bf16(v[u][0], v[u][1]),
                                                          pack_bf16(v[u][2], v[u][3]));
          }
        }
      }
    }
  };

  // stage q (tile q / noct, local octet q % noct) into ring slot q % NB:
  // strip position i = r SR + j reads slab column mb + r Wp + j of each
  // channel, zero past the slab's end and past C
  auto stage_in = [&](int q) {
    const int it = q / noct, k = q - it * noct;
    int b, h0, w0;
    tile(it, b, h0, w0);
    const int mb = h0 * Wp + w0;
    const int cb = QUAD ? 0 : 8 * (oct0 + k);
    const int nc = min(Cfg::kCh, C - cb);
    const T* xb = x + ((size_t)b * C + cb) * L;
    unsigned char* buf = ring + (q % NB) * SB;
    auto col = [&](int i) {
      const int r = __umulhi((unsigned)i, mSR);
      return mb + r * Wp + (i - r * SR);
    };
    if constexpr (Cfg::kF32) {
      float* strip = reinterpret_cast<float*>(buf);
      const unsigned mRS = 0xffffffffu / RS + 1u;
      for (int e = tid; e < Cfg::kCh * RS; e += kRowsThreads) {
        const int ch = __umulhi((unsigned)e, mRS), i = e - ch * RS;
        const int f = col(i);
        float* d = strip + ch * CS + i;
        if (ch < nc && f < L) {
          cp_async4(d, xb + (size_t)ch * L + f);
        } else {
          *d = 0.f;
        }
      }
    } else {
      uint4* cols = reinterpret_cast<uint4*>(buf);
      const bf16 zero = __float2bfloat16_rn(0.f);
      if (vec) {
        // column pairs (i even: one row segment, SR even; the slab column
        // even, L and Wp even): a 4-byte load a channel, split into the two
        // columns' words
        constexpr int PER = 3;
#pragma unroll 1
        for (int i0 = 2 * tid; i0 < RS; i0 += 2 * PER * kRowsThreads) {
          unsigned v[PER][8];
#pragma unroll
          for (int k2 = 0; k2 < PER; ++k2) {
            const int i = i0 + 2 * k2 * kRowsThreads;
            const int j = i < RS ? col(i) : L;
#pragma unroll
            for (int ch = 0; ch < 8; ++ch) {
              v[k2][ch] = 0u;
              if (ch < nc && j + 1 < L) {
                v[k2][ch] = *reinterpret_cast<const unsigned*>(xb + (size_t)ch * L + j);
              } else if (ch < nc && j < L) {
                v[k2][ch] = pack_bf16(xb[(size_t)ch * L + j], zero);
              }
            }
          }
#pragma unroll
          for (int k2 = 0; k2 < PER; ++k2) {
            const int i = i0 + 2 * k2 * kRowsThreads;
            if (i < RS) {
              cols[i] = make_uint4(__byte_perm(v[k2][0], v[k2][1], 0x5410),
                                   __byte_perm(v[k2][2], v[k2][3], 0x5410),
                                   __byte_perm(v[k2][4], v[k2][5], 0x5410),
                                   __byte_perm(v[k2][6], v[k2][7], 0x5410));
              cols[i + 1] = make_uint4(__byte_perm(v[k2][0], v[k2][1], 0x7632),
                                       __byte_perm(v[k2][2], v[k2][3], 0x7632),
                                       __byte_perm(v[k2][4], v[k2][5], 0x7632),
                                       __byte_perm(v[k2][6], v[k2][7], 0x7632));
            }
          }
        }
      } else {
        // 2-byte loads, two columns a thread in flight
        constexpr int CH = 2;
#pragma unroll 1
        for (int i0 = tid; i0 < RS; i0 += CH * kRowsThreads) {
          bf16 v[CH][8];
#pragma unroll
          for (int k2 = 0; k2 < CH; ++k2) {
            const int i = i0 + k2 * kRowsThreads;
            const int j = i < RS ? col(i) : L;
#pragma unroll
            for (int ch = 0; ch < 8; ++ch)
              v[k2][ch] = ch < nc && j < L ? xb[(size_t)ch * L + j] : zero;
          }
#pragma unroll
          for (int k2 = 0; k2 < CH; ++k2)
            if (i0 + k2 * kRowsThreads < RS)
              cols[i0 + k2 * kRowsThreads] =
                  make_uint4(pack_bf16(v[k2][0], v[k2][1]), pack_bf16(v[k2][2], v[k2][3]),
                             pack_bf16(v[k2][4], v[k2][5]), pack_bf16(v[k2][6], v[k2][7]));
        }
      }
    }
  };

  float acc[kRowsMw][NT][4];
#pragma unroll
  for (int mw = 0; mw < kRowsMw; ++mw)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mw][nt][e] = 0.f;

  // the products of one stage (strip `buf`, weight slot ws); A rows g,
  // g + 8 of each m16 tile: the tile's pixels at the tap's shift
  auto compute = [&](const unsigned char* buf, int ws) {
    if constexpr (Cfg::kWg) {
      // a warpgroup's m64 tile mw is its four warps' m16 tiles mw; per tap
      // the three products of both tiles are one commit group, and the A
      // registers alternate between two sets, so a tap's loads and splits
      // overlap the products of the one before
      const float* xs = reinterpret_cast<const float*>(buf) + tg * CS;
      const unsigned char* wb = wsm + ws * Cfg::kWBytes;
      unsigned ah[2][kRowsMw][4], al[2][kRowsMw][4];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int off = t / 3 * SR + t % 3;
#pragma unroll
        for (int mw = 0; mw < kRowsMw; ++mw) {
          const float* p = xs + pos[mw] + off;
          split_tf32(p[0], ah[t & 1][mw][0], al[t & 1][mw][0]);
          split_tf32(p[8], ah[t & 1][mw][1], al[t & 1][mw][1]);
          split_tf32(p[4 * CS], ah[t & 1][mw][2], al[t & 1][mw][2]);
          split_tf32(p[4 * CS + 8], ah[t & 1][mw][3], al[t & 1][mw][3]);
        }
        const uint64_t dh = wg_desc(wb + 2 * t * NT * 256, 128, 256);
        const uint64_t dl = wg_desc(wb + (2 * t + 1) * NT * 256, 128, 256);
        wg_fence();
#pragma unroll
        for (int mw = 0; mw < kRowsMw; ++mw) wgmma_tf32<NT>(acc[mw], al[t & 1][mw], dh);
#pragma unroll
        for (int mw = 0; mw < kRowsMw; ++mw) wgmma_tf32<NT>(acc[mw], ah[t & 1][mw], dl);
#pragma unroll
        for (int mw = 0; mw < kRowsMw; ++mw) wgmma_tf32<NT>(acc[mw], ah[t & 1][mw], dh);
        wg_commit();
        wg_wait<1>();
      }
      wg_wait<0>();
    } else if constexpr (Cfg::kF32) {
      // QUAD: k tg, tg + 4 are channel tg at taps 2 st, 2 st + 1
      const float* xs = reinterpret_cast<const float*>(buf) + tg * CS;
      const uint4* wf = reinterpret_cast<const uint4*>(wsm + ws * Cfg::kWBytes) + lane;
#pragma unroll
      for (int st = 0; st < 5; ++st) {
        const int ta = 2 * st, tb = 2 * st + 1;
        const int offa = ta / 3 * SR + ta % 3, offb = tb / 3 * SR + tb % 3;
        unsigned ah[kRowsMw][4], al[kRowsMw][4];
#pragma unroll
        for (int mw = 0; mw < kRowsMw; ++mw) {
          const float* p = xs + pos[mw];
          split_tf32(p[offa], ah[mw][0], al[mw][0]);
          split_tf32(p[offa + 8], ah[mw][1], al[mw][1]);
          if (tb >= 9) {
            ah[mw][2] = al[mw][2] = ah[mw][3] = al[mw][3] = 0u;
          } else {
            split_tf32(p[offb], ah[mw][2], al[mw][2]);
            split_tf32(p[offb + 8], ah[mw][3], al[mw][3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint4 bw = wf[(st * NT + nt) * 32];
          // small terms first; MW products lie between two that depend on
          // each other
#pragma unroll
          for (int mw = 0; mw < kRowsMw; ++mw) mma_tf32(acc[mw][nt], al[mw], bw.x, bw.y);
#pragma unroll
          for (int mw = 0; mw < kRowsMw; ++mw) mma_tf32(acc[mw][nt], ah[mw], bw.z, bw.w);
#pragma unroll
          for (int mw = 0; mw < kRowsMw; ++mw) mma_tf32(acc[mw][nt], ah[mw], bw.x, bw.y);
        }
      }
    } else {
      // channel pair (2 tg, 2 tg + 1) of strip column c: word 4 c + tg
      const unsigned* xw = reinterpret_cast<const unsigned*>(buf) + tg;
      const uint2* wf = reinterpret_cast<const uint2*>(wsm + ws * Cfg::kWBytes) + lane;
#pragma unroll
      for (int st = 0; st < 5; ++st) {
        const int ta = 2 * st, tb = 2 * st + 1;
        const int offa = ta / 3 * SR + ta % 3, offb = tb / 3 * SR + tb % 3;
        unsigned a[kRowsMw][4];
#pragma unroll
        for (int mw = 0; mw < kRowsMw; ++mw) {
          a[mw][0] = xw[4 * (pos[mw] + offa)];
          a[mw][1] = xw[4 * (pos[mw] + 8 + offa)];
          a[mw][2] = tb < 9 ? xw[4 * (pos[mw] + offb)] : 0u;
          a[mw][3] = tb < 9 ? xw[4 * (pos[mw] + 8 + offb)] : 0u;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 bw = wf[(st * NT + nt) * 32];
#pragma unroll
          for (int mw = 0; mw < kRowsMw; ++mw) mma_bf16(acc[mw][nt], a[mw], bw.x, bw.y);
        }
      }
    }
  };

  // tile `it` done: (ks > 1) the ranks' partial sums through distributed
  // shared memory, each m16 tile finished by rank i % ks, summed over the
  // ranks in order; then the affine and LeakyReLU, rounded once. D rows
  // (pixels) g, g + 8, columns (outputs) 2 tg, 2 tg + 1 of each n tile.
  auto finish = [&](int it) {
    int b, h0, w0;
    tile(it, b, h0, w0);
    if (ks > 1) {
#pragma unroll
      for (int mw = 0; mw < kRowsMw; ++mw)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[((mw * NT + nt) * 4 + e) * kRowsThreads + tid] = acc[mw][nt][e];
      cluster.sync();
    }
#pragma unroll
    for (int mw = 0; mw < kRowsMw; ++mw) {
      const int i = mw * kRowsWarps + warp, ri = i / (NC / 16);
      const int h = h0 + ri, c0 = w0 + (i - ri * (NC / 16)) * 16 + g;
      if (h >= H || (ks > 1 && i % ks != rank)) continue;
      if (ks > 1) {
        // rank r's sums, all of a rank's loads in flight at once
#pragma unroll 1
        for (int r = 0; r < ks; ++r) {
          const float* rr = cluster.map_shared_rank(red, r) + mw * NT * 4 * kRowsThreads + tid;
          float v[NT][4];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) v[nt][e] = rr[(nt * 4 + e) * kRowsThreads];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mw][nt][e] = r == 0 ? v[nt][e] : acc[mw][nt][e] + v[nt][e];
        }
      }
      T* ob = out + (size_t)b * O * M + (size_t)h * Wp;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = o0 + 8 * nt + 2 * tg + (e & 1);
          const float v = o < O ? acc[mw][nt][e] * scale[o] + bias[o] : 0.f;
          y[e] = v >= 0.f ? v : alpha * v;
        }
        if (vec2) {
          // lanes g, g ^ 1 swap a value, so lane g even holds columns c0,
          // c0 + 1 of output 2 tg, lane g odd columns c0 - 1, c0 of output
          // 2 tg + 1 (and the same 8 columns on): one 2-element store each
          const int odd = g & 1;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float r = __shfl_xor_sync(0xffffffffu, odd ? y[2 * hh] : y[2 * hh + 1], 4);
            const int o = o0 + 8 * nt + 2 * tg + odd, c = c0 + 8 * hh - odd;
            if (o < O && c < Wp) {
              const float lo = odd ? r : y[2 * hh], hi = odd ? y[2 * hh + 1] : r;
              if constexpr (Cfg::kF32) {
                *reinterpret_cast<float2*>(ob + (size_t)o * M + c) = make_float2(lo, hi);
              } else {
                *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)o * M + c) =
                    __floats2bfloat162_rn(lo, hi);
              }
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = o0 + 8 * nt + 2 * tg + (e & 1), c = c0 + 8 * (e >> 1);
            if (o < O && c < Wp) ob[(size_t)o * M + c] = from_f<T>(y[e]);
          }
        }
      }
    }
    if (ks > 1) cluster.sync();  // every rank's sums read before they are rewritten
#pragma unroll
    for (int mw = 0; mw < kRowsMw; ++mw)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mw][nt][e] = 0.f;
  };

  // one commit group a stage (empty past the last), so "all but the NB - 1
  // newest groups" is always "stage q"; weights that stay for the whole
  // walk ride with stage 0 where they come by cp.async, else load while the
  // first stages land
  if (nchk == 1 && wvec) load_w(0, noct, true);
#pragma unroll
  for (int p = 0; p < NB - 1; ++p) {
    if (p < nq) stage_in(p);
    cp_async_commit();
  }
  if (nchk == 1 && !wvec) load_w(0, noct, false);
#pragma unroll 1
  for (int q = 0; q < nq; ++q) {
    if (q + NB - 1 < nq) stage_in(q + NB - 1);
    cp_async_commit();
    cp_async_wait(NB - 1);
    const int k = q % noct;
    if (nchk > 1 && k % cw == 0) load_w(k, min(cw, noct - k), false);
    __syncthreads();
    compute(ring + (q % NB) * SB, k % cw);
    __syncthreads();
    if (k == noct - 1) finish(q / noct);
  }
}

// One kind and n-tile count of conv3x3_rows on the caller's plan, checked
// against this source's layout: a plan that does not fit returns
// cudaErrorInvalidValue and launches nothing.
template <typename T, bool QUAD, int NT>
cudaError_t launch_rows_nt(const T* x, const T* w, const float* scale, const float* bias,
                           T* out, int B, int C, int O, int Wp, int L, int M, float alpha,
                           cudaStream_t stream, const int* plan) {
  using Cfg = RowsCfg<T, QUAD, NT>;
  const int R = plan[1], ks = plan[2], grid = plan[3], ngo = plan[4], cw = plan[5];
  const int n8 = QUAD ? 1 : (C + 7) / 8, H = M / Wp;
  if ((R != 1 && R != 2 && R != 4 && R != 8) || ks < 1 || ks > 8 || ks > n8 ||
      ngo != (O + 8 * NT - 1) / (8 * NT) || grid < ngo || grid % ngo != 0 || cw < 1)
    return cudaErrorInvalidValue;
  const int NC = kRowsPix / R, RS = (R + 2) * (NC + 2);
  const long smem = (long)cw * Cfg::kWBytes + (long)Cfg::kBufs * Cfg::strip_bytes(RS) +
                    (ks > 1 ? Cfg::kRedBytes : 0);
  if (smem != plan[6] || smem > kRowsSmemMax) return cudaErrorInvalidValue;
  auto kernel = conv3x3_rows<T, QUAD, NT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int nbands = (H + R - 1) / R, nchunks = (Wp + NC - 1) / NC;
  const int vec = !Cfg::kF32 && L % 2 == 0 && Wp % 2 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 4 == 0;
  // two output columns a store: pairs start at even columns of even rows
  const int vec2 = Wp % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
  // bf16 weights by 4-byte cp.async: channel pairs aligned
  const int wvec = !Cfg::kF32 && C % 2 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid * ks);
  cfg.blockDim = dim3(kRowsThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ks > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, w, scale, bias, out, C, O, H, Wp,
                                           L, M, R, ks, ngo, cw, nbands, nchunks,
                                           B * nbands * nchunks, vec, vec2, wvec, alpha);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// conv3x3_rows at the plan's n-tile count (plan[0]): fp32 at C <= 4 pairs
// its taps (QUAD)
template <typename T, bool QUAD>
cudaError_t launch_rows_kind(const T* x, const T* w, const float* scale, const float* bias,
                             T* out, int B, int C, int O, int Wp, int L, int M, float alpha,
                             cudaStream_t s, const int* plan) {
  switch (plan[0]) {
    case 1: return launch_rows_nt<T, QUAD, 1>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s, plan);
    case 2: return launch_rows_nt<T, QUAD, 2>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s, plan);
    case 4: return launch_rows_nt<T, QUAD, 4>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s, plan);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_rows(const T* x, const T* w, const float* scale, const float* bias,
                        T* out, int B, int C, int O, int Wp, int L, int M, float alpha,
                        cudaStream_t s, const int* plan) {
  if (plan == nullptr) return cudaErrorInvalidValue;
  if constexpr (std::is_same_v<T, float>) {
    if (C <= 4)
      return launch_rows_kind<T, true>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s,
                                       plan);
  }
  return launch_rows_kind<T, false>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s, plan);
}

// The implicit GEMM at one tiling. The flat form stages the window of
// NCOL + 2 Wp + 2 columns its taps read; where W makes that too large for
// shared memory, the launch goes to conv3x3_rows on the caller's plan
// (*rows = 1).
template <typename T, bool STACKED, int MT, int NG, bool QUAD = false>
cudaError_t launch_igemm(const T* x, const T* w, const float* scale,
                         const float* bias, T* out, int B, int C, int O, int Wp,
                         int L, int M, float alpha, cudaStream_t stream, int* rows,
                         const int* plan) {
  using Cfg = IgCfg<T, STACKED, MT, NG, QUAD>;
  constexpr int NCOL = Cfg::kCols;
  constexpr size_t kMaxSmem = 227 * 1024;
  auto smem_of = [](int S) {
    return (size_t)Cfg::kBufs * (Cfg::kWBytes + Cfg::in_bytes(S));
  };
  // fp32 channel rows 8 words mod 32 apart: the 4-byte B loads of 4 rows x 8
  // columns hit 32 banks
  auto f32_row = [](int n) { return (n - 8 + 31) / 32 * 32 + 8; };
  if constexpr (STACKED) {
    // rows NCOL + 8 elements apart: fp32 8 words mod 32 (the 4-byte B loads
    // of 4 rows x 8 columns hit 32 banks); bf16 16 bytes mod 128 (the 8 rows
    // of an ldmatrix hit 8 different 16-byte bank groups)
    const int S = NCOL + 8;
    const int vec = M % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (smem_of(S) > kMaxSmem) return cudaErrorInvalidConfiguration;
    return launch_ig<T, true, MT, NG, QUAD>(x, w, scale, bias, out, B, C, O, Wp, L, M, S,
                                            smem_of(S), vec, alpha, stream);
  } else {
    // reads reach 2 Wp + 2 past the tile's last column (fp32: channel rows
    // of f32_row; bf16: column pairs)
    const int S = Cfg::kF32 ? f32_row(NCOL + 2 * Wp + 2) : (NCOL + 2 * Wp + 2 + 1) / 2 * 2;
    // bf16: the slab's rows 4-byte aligned, so column pairs load 4 bytes at
    // a time
    const bool x4 = L % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
    if (smem_of(S) <= kMaxSmem)
      return launch_ig<T, false, MT, NG, QUAD>(x, w, scale, bias, out, B, C, O, Wp, L, M, S,
                                               smem_of(S), x4, alpha, stream);
    if (rows != nullptr) *rows = 1;
    return launch_rows(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, stream, plan);
  }
}

// Every shape outside the serving instances, both forms, both types: the
// m16 tiles and column groups a warp by O (at most 64 sums a thread).
template <typename T, bool STACKED>
cudaError_t dispatch_igemm(const T* x, const T* w, const float* scale,
                           const float* bias, T* out, int B, int C, int O,
                           int Wp, int L, int M, float alpha, cudaStream_t s,
                           int* rows = nullptr, const int* plan = nullptr) {
  if (B < 1 || C < 1 || O < 1 || M < 1) return cudaErrorInvalidValue;
  if constexpr (std::is_same_v<T, float> && !STACKED) {
    if (C <= 4) {
      if (O <= 16)
        return launch_igemm<T, false, 1, 8, true>(x, w, scale, bias, out, B, C, O, Wp, L, M,
                                                  alpha, s, rows, plan);
      if (O <= 32)
        return launch_igemm<T, false, 2, 4, true>(x, w, scale, bias, out, B, C, O, Wp, L, M,
                                                  alpha, s, rows, plan);
      if (O <= 64)
        return launch_igemm<T, false, 4, 4, true>(x, w, scale, bias, out, B, C, O, Wp, L, M,
                                                  alpha, s, rows, plan);
      return launch_igemm<T, false, 8, 2, true>(x, w, scale, bias, out, B, C, O, Wp, L, M,
                                                alpha, s, rows, plan);
    }
  }
  if (O <= 16)
    return launch_igemm<T, STACKED, 1, 8>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s,
                                          rows, plan);
  if (O <= 32)
    return launch_igemm<T, STACKED, 2, 4>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s,
                                          rows, plan);
  if (O <= 64)
    return launch_igemm<T, STACKED, 4, 4>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s,
                                          rows, plan);
  // 128 outputs a pass, 128 columns a block
  return launch_igemm<T, STACKED, 8, 2>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s,
                                        rows, plan);
}

// The flat form: the serving stem's two (C, O) instances on their own
// kernels, every other shape on the implicit GEMM (*rows = 1 where it
// runs conv3x3_rows). A launch error returns.
template <typename T>
cudaError_t dispatch_flat(const T* x, const T* w, const float* scale,
                          const float* bias, T* out, int B, int C, int O,
                          int Wp, int L, int M, float alpha, cudaStream_t s,
                          int* rows, const int* plan) {
  if (B < 1 || C < 1 || O < 1 || M < 1) return cudaErrorInvalidValue;
  bool taken = false;
  cudaError_t e = cudaSuccess;
  if constexpr (std::is_same_v<T, float>) {
    if (C == 3 && O == 8) {
      // stem: 256 threads, 1024 columns a block
      e = launch_tiled<3, 8>(x, w, scale, bias, out, B, Wp, L, M, alpha, s, &taken);
    } else if (C == 8 && O == 16) {
      // s2: 4 warps, 256 columns a block (520 blocks at B = 8, 128^2)
      e = launch_mma(x, w, scale, bias, out, B, Wp, L, M, alpha, s, &taken);
    }
  } else {
    if (C == 3 && O == 8) {
      // stem: 8 warps, 1,024 columns a tile, one tile a block (520 blocks
      // at B = 8, 256^2)
      e = launch_tc<3, 8, 8, 2, 2, 0>(x, w, scale, bias, out, B, Wp, L, M, alpha, s, &taken);
    } else if (C == 8 && O == 16) {
      // s2: 4 warps, 256 columns a tile, a ring of 3 strips, at most 4
      // blocks an SM (520 tiles at B = 8, 128^2: one a block; 1,560 at 24)
      e = launch_tc<8, 16, 4, 1, 3, 4>(x, w, scale, bias, out, B, Wp, L, M, alpha, s, &taken);
    }
  }
  if (taken || e != cudaSuccess) return e;
  return dispatch_igemm<T, false>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha,
                                 s, rows, plan);
}

// ---------------------------------------------------------------------------
// the stacked form (K3) at its serving instances: streaming FFMA
// ---------------------------------------------------------------------------

constexpr int kStackCols = 4;       // output columns a thread
constexpr int kStackThreads = 256;  // a block

// One (C, O) instance of the stacked form. The block's NT = kStackThreads
// threads form S parts of NTC = NT / S threads; thread ctid of every part
// owns the same kStackCols output columns, and part p sums the tap rows
// [p * R / S, (p + 1) * R / S) of them for all O outputs, reading each of
// its rows once. VEC (rows 16-byte aligned): one 16-byte streaming load a
// row, columns kStackCols * ctid + j of the block's tile; otherwise four
// 4-byte loads a row, columns ctid + j * NTC, each coalesced across the
// warp. The row loop is unrolled through a ring of D + 1 register sets:
// row r + D is loaded before row r is multiplied, so D rows a thread stay
// in flight, and the first D are issued before the weights are staged. The
// weights are read from shared memory as 16-byte broadcasts, laid out
// [tap][c][o]. With S = 2 each part hands the other, through shared
// memory, its sums of the O / 2 outputs that the other finishes.
template <int C, int O, int MINB, int D, int S, bool VEC>
__global__ void __launch_bounds__(kStackThreads, MINB)
conv3x3_stacked_stream(const float* __restrict__ xs,
                       const float* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int M, float alpha) {
  static_assert(S == 1 || S == 2, "one part, or two that fold their sums");
  constexpr int R = 9 * C;   // tap rows, r = tap * C + c
  constexpr int RS = R / S;  // rows a part
  constexpr int OS = O / S;  // outputs a part finishes
  static_assert(RS * S == R && OS % 4 == 0, "rows and float4 output groups split evenly");
  constexpr int NR = D + 1;
  constexpr int NT = kStackThreads;
  constexpr int NTC = NT / S;
  constexpr int kTile = NTC * kStackCols;
  __shared__ __align__(16) float ws[R * O];
  __shared__ float ss[O], bs[O];
  __shared__ float red[S == 1 ? 1 : NT * OS * kStackCols];
  const int tid = threadIdx.x;
  const int part = S == 1 ? 0 : tid / NTC;
  const int ctid = S == 1 ? tid : tid % NTC;
  const int b = blockIdx.y;
  const int m = blockIdx.x * kTile + (VEC ? kStackCols * ctid : ctid);
  const int r0 = part * RS;
  const float* xb = xs + ((size_t)b * R + r0) * M + m;

  float x[NR][kStackCols];
  auto load_row = [&](int r, float (&v)[kStackCols]) {
    const float* p = xb + (size_t)r * M;
    if (VEC) {
      const float4 t = m < M ? __ldcs(reinterpret_cast<const float4*>(p))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < kStackCols; ++j)
        v[j] = m + j * NTC < M ? __ldcs(p + j * NTC) : 0.f;
    }
  };
#pragma unroll
  for (int r = 0; r < D && r < RS; ++r) load_row(r, x[r]);

  for (int i = tid; i < R * O; i += NT) {
    const int o = i % O;
    const int r = i / O;
    ws[i] = w[((r / C) * O + o) * C + r % C];
  }
  if (tid < O) {
    ss[tid] = scale[tid];
    bs[tid] = bias[tid];
  }
  __syncthreads();

  float acc[kStackCols][O];
#pragma unroll
  for (int j = 0; j < kStackCols; ++j)
#pragma unroll
    for (int q = 0; q < O; ++q) acc[j][q] = 0.f;

  const float* wp = ws + r0 * O;
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    if (r + D < RS) load_row(r + D, x[(r + D) % NR]);
    const float(&xv)[kStackCols] = x[r % NR];
    const float4* w4 = reinterpret_cast<const float4*>(wp + r * O);
#pragma unroll
    for (int q = 0; q < O / 4; ++q) {
      const float4 wv = w4[q];
#pragma unroll
      for (int j = 0; j < kStackCols; ++j) {
        acc[j][4 * q + 0] = fmaf(wv.x, xv[j], acc[j][4 * q + 0]);
        acc[j][4 * q + 1] = fmaf(wv.y, xv[j], acc[j][4 * q + 1]);
        acc[j][4 * q + 2] = fmaf(wv.z, xv[j], acc[j][4 * q + 2]);
        acc[j][4 * q + 3] = fmaf(wv.w, xv[j], acc[j][4 * q + 3]);
      }
    }
  }

  // part p finishes outputs [p * OS, (p + 1) * OS): its own sums of them,
  // plus (S = 2) the other part's, handed over in red[part][q][j][ctid]
  float fin[kStackCols][OS];
#pragma unroll
  for (int j = 0; j < kStackCols; ++j)
#pragma unroll
    for (int q = 0; q < OS; ++q)
      fin[j][q] = part == 0 ? acc[j][q] : acc[j][O - OS + q];
  if (S == 2) {
    float* mine = red + part * (OS * kStackCols * NTC) + ctid;
    const float* theirs = red + (1 - part) * (OS * kStackCols * NTC) + ctid;
#pragma unroll
    for (int q = 0; q < OS; ++q)
#pragma unroll
      for (int j = 0; j < kStackCols; ++j)
        mine[(q * kStackCols + j) * NTC] = part == 0 ? acc[j][OS + q] : acc[j][q];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < OS; ++q)
#pragma unroll
      for (int j = 0; j < kStackCols; ++j)
        fin[j][q] += theirs[(q * kStackCols + j) * NTC];
  }

#pragma unroll
  for (int q = 0; q < OS; ++q) {
    const int o = part * OS + q;
    const float sc = ss[o];
    const float bi = bs[o];
    float v[kStackCols];
#pragma unroll
    for (int j = 0; j < kStackCols; ++j) {
      const float t = fin[j][q] * sc + bi;
      v[j] = t >= 0.f ? t : alpha * t;
    }
    float* ob = out + ((size_t)b * O + o) * M + m;
    if (VEC) {
      if (m < M)
        __stcs(reinterpret_cast<float4*>(ob), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int j = 0; j < kStackCols; ++j)
        if (m + j * NTC < M) __stcs(ob + j * NTC, v[j]);
    }
  }
}

template <int C, int O, int MINB, int D, int S>
cudaError_t launch_stacked(const float* xs, const float* w, const float* scale,
                           const float* bias, float* out, int B, int M,
                           float alpha, cudaStream_t stream) {
  const bool vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  constexpr int kTile = kStackThreads / S * kStackCols;
  const dim3 grid((M + kTile - 1) / kTile, B);
  if (vec) {
    conv3x3_stacked_stream<C, O, MINB, D, S, true>
        <<<grid, kStackThreads, 0, stream>>>(xs, w, scale, bias, out, M, alpha);
  } else {
    conv3x3_stacked_stream<C, O, MINB, D, S, false>
        <<<grid, kStackThreads, 0, stream>>>(xs, w, scale, bias, out, M, alpha);
  }
  return cudaGetLastError();
}

// The stacked form in fp32: the serving stem's two (C, O) instances on
// their own kernels, every other shape on the implicit GEMM.
cudaError_t dispatch_stacked(const float* xs, const float* w,
                             const float* scale, const float* bias, float* out,
                             int B, int C, int O, int M, float alpha,
                             cudaStream_t s) {
  if (B < 1 || C < 1 || O < 1 || M < 1) return cudaErrorInvalidValue;
  if (C == 3 && O == 8) {
    // stem: 1,024 columns a block, 4 blocks (64 registers a thread) a SM
    return launch_stacked<3, 8, 4, 3, 1>(xs, w, scale, bias, out, B, M, alpha,
                                         s);
  }
  if (C == 8 && O == 16) {
    // s2: two parts of 128 threads, 512 columns a block (264 blocks at
    // B = 8, 128^2), 8 rows ahead
    return launch_stacked<8, 16, 2, 8, 2>(xs, w, scale, bias, out, B, M,
                                          alpha, s);
  }
  return dispatch_igemm<float, true>(xs, w, scale, bias, out, B, C, O, 0, 0, M,
                                    alpha, s);
}

}  // namespace

// x (B, C, (H+2)*(W+2)+2), w (9, O, C), scale/bias (O,), out (B, O, H*(W+2)).
// Returns the cudaError_t of the launch (0 = launched); sets *rows (when
// not null) to 1 if the launch ran conv3x3_rows (past the width where
// conv3x3_igemm's window fits), and leaves it otherwise. `plan` is
// conv3x3_rows' launch plan (7 ints: nt, R, ks, grid, ngo, cw, smem;
// ops/conv_fused.rows_plan),
// read only where that form runs: a missing or inconsistent plan there
// returns cudaErrorInvalidValue.
extern "C" int conv3x3_bn_act_flat(const float* x, const float* w,
                                   const float* scale, const float* bias,
                                   float* out, int B, int C, int O, int H,
                                   int W, float alpha, void* stream, int* rows,
                                   const int* plan) {
  const int Wp = W + 2;
  return (int)dispatch_flat<float>(x, w, scale, bias, out, B, C, O, Wp,
                                   (H + 2) * Wp + 2, H * Wp, alpha,
                                   (cudaStream_t)stream, rows, plan);
}

// xs (B, 9, C, M), w (9, O, C), scale/bias (O,), out (B, O, M).
extern "C" int conv3x3_bn_act_stacked(const float* xs, const float* w,
                                      const float* scale, const float* bias,
                                      float* out, int B, int C, int O, int M,
                                      float alpha, void* stream) {
  return (int)dispatch_stacked(xs, w, scale, bias, out, B, C, O, M, alpha,
                               (cudaStream_t)stream);
}

// The bf16 forms: x, w and out bf16, scale and bias fp32, the same shapes.
extern "C" int conv3x3_bn_act_flat_bf16(const bf16* x, const bf16* w,
                                        const float* scale, const float* bias,
                                        bf16* out, int B, int C, int O, int H,
                                        int W, float alpha, void* stream, int* rows,
                                        const int* plan) {
  const int Wp = W + 2;
  return (int)dispatch_flat<bf16>(x, w, scale, bias, out, B, C, O, Wp,
                                  (H + 2) * Wp + 2, H * Wp, alpha,
                                  (cudaStream_t)stream, rows, plan);
}

// K3 in bf16 runs the implicit GEMM at every (C, O)
extern "C" int conv3x3_bn_act_stacked_bf16(const bf16* xs, const bf16* w,
                                           const float* scale,
                                           const float* bias, bf16* out,
                                           int B, int C, int O, int M,
                                           float alpha, void* stream) {
  return (int)dispatch_igemm<bf16, true>(xs, w, scale, bias, out, B, C, O, 0, 0,
                                         M, alpha, (cudaStream_t)stream);
}
