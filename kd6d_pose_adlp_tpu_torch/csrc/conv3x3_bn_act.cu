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
// sums in fp32 and rounds its output once. Each form below takes the
// element type T as a template parameter and converts on load; shared
// memory holds fp32. In bf16 each load moves half the bytes, and the s2
// instance runs native bf16 tensor-core products (conv3x3_flat_mma_bf16,
// mma.sync m16n8k16, fp32 accumulators): one product per pair of taps and
// 8 columns, exact products of bf16 inputs, where fp32 needs three TF32
// products per tap. The stacked form's streaming instances are fp32 only;
// in bf16 every stacked shape runs the general kernel.
//
// What bounds the flat form (K2) on an H100, at the two shapes the serving
// stem gives it (B = 8): the stem, 3 -> 8 at 256^2, reads 6.4 MB and writes
// 16.9 MB against 0.12 GFLOP, so it is bound by bytes (~7.0 us at
// 3.35 TB/s); s2, 8 -> 16 at 128^2, moves 13 MB (~3.8 us) against
// 0.31 GFLOP, ~4.6 us of fp32 CUDA-core math at 67 TFLOP/s but ~1.9 us as
// three TF32 tensor-core products each at 495 TFLOP/s, so on the tensor
// cores it too is bound by bytes. Each instance has a kernel of its own; C and O are
// constants there, so every tap and channel loop unrolls. Both copy their
// (b, strip) tile's inputs, all C channels plus the 2 * (W + 2) + 2 halo,
// into shared memory with cp.async, 4 bytes a thread (a channel row of the
// slab is L * 4 bytes, not a multiple of 16, so TMA does not fit), and
// write each output once in the epilogue, after the affine and LeakyReLU.
//
// The stem (conv3x3_flat_tiled, CUDA cores): one commit group per channel,
// all issued at once, so the block starts on channel 0 while the others are
// in flight. Each thread owns 4 consecutive output columns for all 8
// outputs: per (input row dy, channel c) it reads the 6 inputs it needs
// with two 16-byte loads and applies the three dx taps, 96 FFMAs against 2
// input loads and 6 broadcast 16-byte weight loads. The 16-byte loads need
// the row's shift dy * (W + 2) in whole float4s; its remainder mod 4 is a
// template parameter, so the 6 values are picked by constant indices. The
// outputs go out 16 bytes a thread where M = H * (W + 2) is a multiple of 4.
//
// s2 (conv3x3_flat_mma, tensor cores): on the CUDA cores the same loop is
// bound by its shared-memory weight loads (12 us at B = 8), so s2 runs
// error-compensated TF32 products on the tensor cores instead: O = 16 is
// the mma's M, each tap one k-step over the 8 channels, the weights split
// hi + lo in registers for the whole block, and three m16n8k8 products per
// (tap, 8 columns) that together miss the fp32 product by ~2^-20. Plain
// TF32 (one product) would miss it by ~1e-3 of each term.
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
// Every other flat and stacked shape runs conv3x3_bn_act_kernel, the first
// design: one block per (b, strip of P * 256 columns) with the strip staged
// synchronously (flat form) or read straight from global memory (stacked
// form), runtime C, O tiled by OT, weights in shared memory transposed to
// [tap][c][o] for 16-byte broadcast loads. P (columns per thread) is picked
// per shape to keep at least two blocks per SM in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kNumSMs = 132;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// four consecutive outputs, 16 bytes (fp32) or 8 (bf16) at p
template <typename T>
__device__ __forceinline__ void store4(T* p, float v0, float v1, float v2,
                                       float v3) {
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(p) = make_float4(v0, v1, v2, v3);
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v2, v3);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
}

template <typename T, int OT, int P, bool STACKED>
__global__ void __launch_bounds__(kThreads)
conv3x3_bn_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ out,
                      int C, int O, int OP, int Wp, int L, int M, float alpha) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kTile = kThreads * P;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int span = kTile + 2 * Wp + 2;

  float* ws = smem;               // [9][C][OP] weights, zero past O
  float* ss = ws + 9 * C * OP;    // [OP] scale
  float* bs = ss + OP;            // [OP] bias
  float* xs = bs + OP;            // [C][span] input strip (flat form)

  for (int i = tid; i < 9 * C * OP; i += kThreads) {
    const int o = i % OP;
    const int tc = i / OP;
    const int c = tc % C;
    const int t = tc / C;
    ws[i] = o < O ? to_f(w[(t * O + o) * C + c]) : 0.f;
  }
  for (int i = tid; i < OP; i += kThreads) {
    ss[i] = i < O ? scale[i] : 0.f;
    bs[i] = i < O ? bias[i] : 0.f;
  }
  if (!STACKED) {
    const T* xb = x + (size_t)b * C * L;
    for (int c = 0; c < C; ++c) {
      for (int i = tid; i < span; i += kThreads) {
        const int g = m0 + i;
        xs[c * span + i] = g < L ? to_f(xb[(size_t)c * L + g]) : 0.f;
      }
    }
  }
  __syncthreads();

  for (int o0 = 0; o0 < OP; o0 += OT) {
    float acc[P][OT];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int q = 0; q < OT; ++q) acc[p][q] = 0.f;

#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int off = (t / 3) * Wp + (t % 3);
#pragma unroll 1
      for (int c = 0; c < C; ++c) {
        float xv[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int ml = p * kThreads + tid;
          if (STACKED) {
            const int m = m0 + ml;
            xv[p] = m < M ? to_f(x[(((size_t)b * 9 + t) * C + c) * M + m]) : 0.f;
          } else {
            xv[p] = xs[c * span + ml + off];
          }
        }
        const float4* w4 =
            reinterpret_cast<const float4*>(ws + (t * C + c) * OP + o0);
#pragma unroll
        for (int q = 0; q < OT / 4; ++q) {
          const float4 wv = w4[q];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            acc[p][4 * q + 0] = fmaf(wv.x, xv[p], acc[p][4 * q + 0]);
            acc[p][4 * q + 1] = fmaf(wv.y, xv[p], acc[p][4 * q + 1]);
            acc[p][4 * q + 2] = fmaf(wv.z, xv[p], acc[p][4 * q + 2]);
            acc[p][4 * q + 3] = fmaf(wv.w, xv[p], acc[p][4 * q + 3]);
          }
        }
      }
    }

#pragma unroll
    for (int q = 0; q < OT; ++q) {
      const int o = o0 + q;
      if (o < O) {
        const float sc = ss[o];
        const float bi = bs[o];
        T* ob = out + ((size_t)b * O + o) * M;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int m = m0 + p * kThreads + tid;
          if (m < M) {
            const float v = acc[p][q] * sc + bi;
            ob[m] = from_f<T>(v >= 0.f ? v : alpha * v);
          }
        }
      }
    }
  }
}

template <typename T, int OT, int P, bool STACKED>
cudaError_t launch(const T* x, const T* w, const float* scale,
                   const float* bias, T* out, int B, int C, int O, int Wp,
                   int L, int M, float alpha, cudaStream_t stream) {
  const int OP = (O + OT - 1) / OT * OT;
  constexpr int kTile = kThreads * P;
  size_t smem = sizeof(float) * (size_t)(9 * C * OP + 2 * OP);
  if (!STACKED) smem += sizeof(float) * (size_t)C * (kTile + 2 * Wp + 2);
  if (smem > 227 * 1024) return cudaErrorInvalidConfiguration;
  auto kernel = conv3x3_bn_act_kernel<T, OT, P, STACKED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((M + kTile - 1) / kTile, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, scale, bias, out, C, O, OP,
                                           Wp, L, M, alpha);
  return cudaGetLastError();
}

// columns per thread: the widest strip that still leaves >= 2 blocks per SM
int pick_p(int M, int B) {
  for (int p = 4; p > 1; p /= 2) {
    const long blocks = (long)((M + kThreads * p - 1) / (kThreads * p)) * B;
    if (blocks >= 2L * kNumSMs) return p;
  }
  return 1;
}

template <typename T, bool STACKED>
cudaError_t dispatch(const T* x, const T* w, const float* scale,
                     const float* bias, T* out, int B, int C, int O,
                     int Wp, int L, int M, float alpha, cudaStream_t s) {
  if (B < 1 || C < 1 || O < 1 || M < 1) return cudaErrorInvalidValue;
  const int p = pick_p(M, B);
  if (O <= 8) {
    if (p == 4) return launch<T, 8, 4, STACKED>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s);
    if (p == 2) return launch<T, 8, 2, STACKED>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s);
    return launch<T, 8, 1, STACKED>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s);
  }
  if (p == 4) return launch<T, 16, 4, STACKED>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s);
  if (p == 2) return launch<T, 16, 2, STACKED>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s);
  return launch<T, 16, 1, STACKED>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s);
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
// stores allowed (M % 4 == 0, out aligned to 4 outputs). A bf16 strip is
// read with plain loads and widened to fp32 on its way into shared memory.
template <typename T, int C, int O, int WM>
__global__ void __launch_bounds__(kStemThreads, kStemMinBlocks)
conv3x3_flat_tiled(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out,
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
  const T* xb = x + (size_t)b * C * L + m0;
  const int n_in = min(S, L - m0);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    for (int i = tid; i < S; i += kStemThreads) {
      if (i >= n_in) {
        xs[c * S + i] = 0.f;
      } else if constexpr (std::is_same_v<T, float>) {
        cp_async4(xs + c * S + i, xb + (size_t)c * L + i);
      } else {
        xs[c * S + i] = to_f(xb[(size_t)c * L + i]);
      }
    }
    cp_async_commit();
  }
  for (int i = tid; i < 9 * C * O; i += kStemThreads) {
    const int o = i % O;
    const int tc = i / O;
    ws[i] = to_f(w[((tc / C) * O + o) * C + tc % C]);
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
    T* ob = out + ((size_t)b * O + o) * M + m;
    if (vec && m + kCols <= M) {
      store4(ob, v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (m + j < M) ob[j] = from_f<T>(v[j]);
    }
  }
}

// Launch the FFMA instance if its strip fits in shared memory; *taken =
// false (and nothing launched) if not.
template <typename T, int C, int O>
cudaError_t launch_tiled(const T* x, const T* w, const float* scale,
                         const float* bias, T* out, int B, int Wp, int L,
                         int M, float alpha, cudaStream_t stream,
                         bool* taken) {
  constexpr int kTile = kStemThreads * kCols;
  // a thread reads up to 12 floats from its aligned start, which lies up
  // to 2 * Wp past its first column
  const int S = (kTile + 2 * Wp + 8 + 3) / 4 * 4;
  const size_t smem = sizeof(float) * ((size_t)C * S + 9 * C * O + 2 * O);
  *taken = smem <= 227 * 1024;
  if (!*taken) return cudaSuccess;
  void (*kernel)(const T*, const T*, const float*, const float*, T*, int,
                 int, int, int, int, float);
  switch (Wp & 3) {
    case 0: kernel = conv3x3_flat_tiled<T, C, O, 0>; break;
    case 1: kernel = conv3x3_flat_tiled<T, C, O, 1>; break;
    case 2: kernel = conv3x3_flat_tiled<T, C, O, 2>; break;
    default: kernel = conv3x3_flat_tiled<T, C, O, 3>; break;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int vec = (M % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0);
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

constexpr int kTapPairs = 5;  // k = 16 takes two taps of 8 channels; tap 9 is 0

// C = 8, O = 16, bf16. The block's tiling is conv3x3_flat_mma's (kMmaWarps
// warps, kMmaTile columns, groups of 8 columns, kMmaInFlight at a time),
// but one m16n8k16 product takes two taps: its k = 0..7 are tap 2p's 8
// channels, k = 8..15 tap 2p + 1's, so 5 products cover the 9 taps of a
// group (the tenth tap's weights are 0). The strip is staged column-major,
// [S][8] bf16, 16 bytes a column: a B register is the (2 tg, 2 tg + 1)
// channel pair at one column, one 4-byte shared load, and a warp's 32
// loads hit 32 consecutive words. Products of bf16 values are exact in
// fp32; the sums are fp32.
__global__ void __launch_bounds__(kMmaWarps * 32)
conv3x3_flat_mma_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, bf16* __restrict__ out,
                      int Wp, int L, int M, int S, int vec2, float alpha) {
  constexpr int C = 8, O = 16, NI = kMmaInFlight;
  extern __shared__ __align__(16) uint4 smem_cols[];  // [S] columns of 8 channels
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kMmaTile;

  // the strip: each thread gathers the 8 channels of a column (loads
  // coalesced across the warp, channel by channel) into one 16-byte store;
  // past the slab's end, zeros
  const bf16* xb = x + (size_t)b * C * L + m0;
  const int n_in = min(S, L - m0);
  for (int i = tid; i < S; i += kMmaWarps * 32) {
    uint4 col = make_uint4(0u, 0u, 0u, 0u);
    if (i < n_in) {
      const bf16* p = xb + i;
      col.x = pack_bf16(p[0], p[(size_t)L]);
      col.y = pack_bf16(p[(size_t)2 * L], p[(size_t)3 * L]);
      col.z = pack_bf16(p[(size_t)4 * L], p[(size_t)5 * L]);
      col.w = pack_bf16(p[(size_t)6 * L], p[(size_t)7 * L]);
    }
    smem_cols[i] = col;
  }

  // the A fragments of the five tap pairs: rows g, g + 8; k 2 tg, 2 tg + 1
  // (tap 2p) and 2 tg + 8, 2 tg + 9 (tap 2p + 1)
  const bf16 zero = __float2bfloat16_rn(0.f);
  unsigned a[kTapPairs][4];
#pragma unroll
  for (int p = 0; p < kTapPairs; ++p) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = 2 * p + h;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int o = g + 8 * r;
        a[p][2 * h + r] =
            t < 9 ? pack_bf16(w[(t * O + o) * C + 2 * tg], w[(t * O + o) * C + 2 * tg + 1])
                  : pack_bf16(zero, zero);
      }
    }
  }
  const float sc0 = scale[g], sc1 = scale[g + 8];
  const float bi0 = bias[g], bi1 = bias[g + 8];
  __syncthreads();

  // channel pair (2 tg, 2 tg + 1) of column c: word 4 c + tg of the strip
  const unsigned* xw = reinterpret_cast<const unsigned*>(smem_cols) + tg;
#pragma unroll 1
  for (int n0 = warp * kMmaGroups; n0 < (warp + 1) * kMmaGroups; n0 += NI) {
    float d[NI][4];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) d[i][r] = 0.f;
#pragma unroll
    for (int p = 0; p < kTapPairs; ++p) {
      const int t0 = 2 * p, t1 = 2 * p + 1;
      const int off0 = (t0 / 3) * Wp + t0 % 3;
      const int off1 = (t1 / 3) * Wp + t1 % 3;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int col = (n0 + i) * 8 + g;
        const unsigned b0 = xw[4 * (col + off0)];
        const unsigned b1 = t1 < 9 ? xw[4 * (col + off1)] : 0u;
        mma_bf16(d[i], a[p], b0, b1);
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
        bf16* ob = out + ((size_t)b * O + g + 8 * h) * M + m;
        if (vec2 && m + 2 <= M) {
          *reinterpret_cast<__nv_bfloat162*>(ob) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (m < M) ob[0] = __float2bfloat16_rn(v0);
          if (m + 1 < M) ob[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

cudaError_t launch_mma_bf16(const bf16* x, const bf16* w, const float* scale,
                            const float* bias, bf16* out, int B, int Wp, int L,
                            int M, float alpha, cudaStream_t stream,
                            bool* taken) {
  // reads reach 2 * Wp + 2 + 7 past a group's first column
  const int S = (kMmaTile + 2 * Wp + 16 + 7) / 8 * 8;
  const size_t smem = sizeof(uint4) * (size_t)S;
  *taken = smem <= 227 * 1024;
  if (!*taken) return cudaSuccess;
  auto kernel = conv3x3_flat_mma_bf16;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int vec2 = (M % 2 == 0) && (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  const dim3 grid((M + kMmaTile - 1) / kMmaTile, B);
  kernel<<<grid, kMmaWarps * 32, smem, stream>>>(x, w, scale, bias, out, Wp,
                                                 L, M, S, vec2, alpha);
  return cudaGetLastError();
}

// The flat form: the serving stem's two (C, O) instances on their own
// kernels, every other shape on the general one. A launch error returns.
template <typename T>
cudaError_t dispatch_flat(const T* x, const T* w, const float* scale,
                          const float* bias, T* out, int B, int C, int O,
                          int Wp, int L, int M, float alpha, cudaStream_t s) {
  if (B < 1 || C < 1 || O < 1 || M < 1) return cudaErrorInvalidValue;
  bool taken = false;
  cudaError_t e = cudaSuccess;
  if (C == 3 && O == 8) {
    // stem: 256 threads, 1024 columns a block
    e = launch_tiled<T, 3, 8>(x, w, scale, bias, out, B, Wp, L, M, alpha, s,
                              &taken);
  } else if (C == 8 && O == 16) {
    // s2: 4 warps, 256 columns a block (520 blocks at B = 8, 128^2)
    if constexpr (std::is_same_v<T, float>) {
      e = launch_mma(x, w, scale, bias, out, B, Wp, L, M, alpha, s, &taken);
    } else {
      e = launch_mma_bf16(x, w, scale, bias, out, B, Wp, L, M, alpha, s,
                          &taken);
    }
  }
  if (taken || e != cudaSuccess) return e;
  return dispatch<T, false>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s);
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

// The stacked form: the serving stem's two (C, O) instances on their own
// kernels, every other shape on the general one.
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
  return dispatch<float, true>(xs, w, scale, bias, out, B, C, O, 0, 0, M, alpha,
                              s);
}

}  // namespace

// x (B, C, (H+2)*(W+2)+2), w (9, O, C), scale/bias (O,), out (B, O, H*(W+2)).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int conv3x3_bn_act_flat(const float* x, const float* w,
                                   const float* scale, const float* bias,
                                   float* out, int B, int C, int O, int H,
                                   int W, float alpha, void* stream) {
  const int Wp = W + 2;
  return (int)dispatch_flat<float>(x, w, scale, bias, out, B, C, O, Wp,
                                   (H + 2) * Wp + 2, H * Wp, alpha,
                                   (cudaStream_t)stream);
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
                                        int W, float alpha, void* stream) {
  const int Wp = W + 2;
  return (int)dispatch_flat<bf16>(x, w, scale, bias, out, B, C, O, Wp,
                                  (H + 2) * Wp + 2, H * Wp, alpha,
                                  (cudaStream_t)stream);
}

// K3 in bf16 runs the general kernel at every (C, O)
extern "C" int conv3x3_bn_act_stacked_bf16(const bf16* xs, const bf16* w,
                                           const float* scale,
                                           const float* bias, bf16* out,
                                           int B, int C, int O, int M,
                                           float alpha, void* stream) {
  return (int)dispatch<bf16, true>(xs, w, scale, bias, out, B, C, O, 0, 0, M,
                                   alpha, (cudaStream_t)stream);
}
