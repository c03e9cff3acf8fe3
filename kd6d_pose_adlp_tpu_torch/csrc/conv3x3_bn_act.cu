// Fused 3x3 stride-1 SAME convolution + per-channel affine (eval-mode BN)
// + LeakyReLU, fp32, on the flat channel-major slab layout.
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
// What bounds it on an H100: at the darknet_tiny_h stem/s2 widths (C <= 8,
// O <= 16) each input value feeds at most 9 * O = 144 FMAs, far below the
// ~20 FLOP/byte an H100 needs before fp32 CUDA-core math (67 TFLOP/s) rather
// than HBM (3.35 TB/s) limits; the stem is bound by bytes (read 6.4 MB,
// write 16.9 MB at B=8, 256^2: ~7 us) and s2 is close to balanced (13 MB,
// ~3.8 us of bytes against 0.31 GFLOP, ~4.6 us of fp32 math). Tensor cores
// do not help at K = 9 * C <= 72 with O <= 16.
//
// Design (not the TPU's one-image-per-grid-step blocks, which would give 8
// blocks for 132 SMs): one block takes one (b, strip of P * 256 output
// columns) tile and computes all O outputs for it. The flat form stages the
// strip plus its 2 * (W + 2) + 2 halo of all C channels in shared memory
// once, so each input byte leaves HBM once (the halo re-reads hit L2), and
// the nine taps become nine shifted shared-memory reads instead of the TPU's
// lane rotates. The 9 * O * C weights sit in shared memory transposed to
// [tap][c][o], so a thread reads four output channels' weights with one
// 16-byte broadcast load and applies them to its P columns (P * 4 FMAs per
// load). Accumulation is fp32 in registers; the affine and LeakyReLU run in
// the epilogue, and each output value is written once, coalesced. The
// stacked form reads its taps straight from global memory (every element
// is used by exactly one output column, so staging buys nothing).
// P (columns per thread) is picked per shape to keep at least two blocks per
// SM in flight.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNumSMs = 132;

template <int OT, int P, bool STACKED>
__global__ void __launch_bounds__(kThreads)
conv3x3_bn_act_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, float* __restrict__ out,
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
    ws[i] = o < O ? w[(t * O + o) * C + c] : 0.f;
  }
  for (int i = tid; i < OP; i += kThreads) {
    ss[i] = i < O ? scale[i] : 0.f;
    bs[i] = i < O ? bias[i] : 0.f;
  }
  if (!STACKED) {
    const float* xb = x + (size_t)b * C * L;
    for (int c = 0; c < C; ++c) {
      for (int i = tid; i < span; i += kThreads) {
        const int g = m0 + i;
        xs[c * span + i] = g < L ? xb[(size_t)c * L + g] : 0.f;
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
            xv[p] = m < M ? x[(((size_t)b * 9 + t) * C + c) * M + m] : 0.f;
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
        float* ob = out + ((size_t)b * O + o) * M;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int m = m0 + p * kThreads + tid;
          if (m < M) {
            const float v = acc[p][q] * sc + bi;
            ob[m] = v >= 0.f ? v : alpha * v;
          }
        }
      }
    }
  }
}

template <int OT, int P, bool STACKED>
cudaError_t launch(const float* x, const float* w, const float* scale,
                   const float* bias, float* out, int B, int C, int O, int Wp,
                   int L, int M, float alpha, cudaStream_t stream) {
  const int OP = (O + OT - 1) / OT * OT;
  constexpr int kTile = kThreads * P;
  size_t smem = sizeof(float) * (size_t)(9 * C * OP + 2 * OP);
  if (!STACKED) smem += sizeof(float) * (size_t)C * (kTile + 2 * Wp + 2);
  if (smem > 227 * 1024) return cudaErrorInvalidConfiguration;
  auto kernel = conv3x3_bn_act_kernel<OT, P, STACKED>;
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

template <bool STACKED>
cudaError_t dispatch(const float* x, const float* w, const float* scale,
                     const float* bias, float* out, int B, int C, int O,
                     int Wp, int L, int M, float alpha, cudaStream_t s) {
  if (B < 1 || C < 1 || O < 1 || M < 1) return cudaErrorInvalidValue;
  const int p = pick_p(M, B);
  if (O <= 8) {
    if (p == 4) return launch<8, 4, STACKED>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s);
    if (p == 2) return launch<8, 2, STACKED>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s);
    return launch<8, 1, STACKED>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s);
  }
  if (p == 4) return launch<16, 4, STACKED>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s);
  if (p == 2) return launch<16, 2, STACKED>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s);
  return launch<16, 1, STACKED>(x, w, scale, bias, out, B, C, O, Wp, L, M, alpha, s);
}

}  // namespace

// x (B, C, (H+2)*(W+2)+2), w (9, O, C), scale/bias (O,), out (B, O, H*(W+2)).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int conv3x3_bn_act_flat(const float* x, const float* w,
                                   const float* scale, const float* bias,
                                   float* out, int B, int C, int O, int H,
                                   int W, float alpha, void* stream) {
  const int Wp = W + 2;
  return (int)dispatch<false>(x, w, scale, bias, out, B, C, O, Wp,
                              (H + 2) * Wp + 2, H * Wp, alpha,
                              (cudaStream_t)stream);
}

// xs (B, 9, C, M), w (9, O, C), scale/bias (O,), out (B, O, M).
extern "C" int conv3x3_bn_act_stacked(const float* xs, const float* w,
                                      const float* scale, const float* bias,
                                      float* out, int B, int C, int O, int M,
                                      float alpha, void* stream) {
  return (int)dispatch<true>(xs, w, scale, bias, out, B, C, O, 0, 0, M,
                             alpha, (cudaStream_t)stream);
}
