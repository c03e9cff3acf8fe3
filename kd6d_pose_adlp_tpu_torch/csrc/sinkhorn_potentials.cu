// Sinkhorn potential solve (the eps-annealing loop of the debiased,
// unbalanced Sinkhorn divergence), fp32.
//
// Replaces the Pallas TPU kernel of
// kd6d_pose_adlp_tpu/ops/sinkhorn_pallas.py:128 `_solve_potentials`
// (body `_make_kernel`): for each of N independent problems, clouds
// x (P, 2), y (T, 2) and log-weights a_log (P), b_log (T) give the four dual
// potentials a_x (P), b_y (T), a_y (T), b_x (P). Per eps of the schedule:
//   h <- log-weights + potential / eps          (eps > first)
//   f_i = -eps * (log sum_j exp(m_ij - max_j m_ij) + max_j m_ij),
//   m_ij = h_j - C_ij / eps,  C = |x_i - y_j|^p / p
//   pot <- lam * f (first eps)  or  0.5 * (pot + lam * f)   (Jacobi average)
// for the four pairs (b_x: x over y, a_y: y over x, a_x: x over x,
// b_y: y over y; the last two only with debias). The eps and lam = 1 /
// (1 + eps / rho) lists come from the host; rho enters only through lam.
// Padding is JAX's: log-weight -1e30, so a padded column adds exp(-huge) = 0,
// and a row whose columns are all padded gives log(count) after the
// max-subtract. No gradient: the caller extrapolates once outside.
//
// What bounds it on an H100: at the KD loss's shape (N = B * 8 = 128,
// P = T = 64, 12 eps values) it computes 128 * 12 * 4 * 64 * 64 = 25.2 M
// expf, and reads/writes ~0.2 MB. The special-function units (16 results
// per clock per SM, ~4.2 T/s over 132 SMs at 1.98 GHz) bound it at ~6 us;
// the bytes and the fp32 arithmetic are below that. The 12 dependent eps
// steps, each ending in a block barrier, keep it latency-bound above that.
//
// Design (not the TPU's 8 problems per program padded to a multiple of 8,
// which Mosaic's (8, 128) tiling forced): one thread block per problem, no
// padding of N; 128 problems fill the 132 SMs once. Coordinates, weights
// and the four potentials stay in shared memory for the whole schedule; the
// cost entries are recomputed from the coordinates (a few FMAs, cheaper
// than holding four P x T matrices, which at P = T = 128 would not fit).
// Each softmin row is one warp: lane l owns columns l, l + 32, l + 64, l + 96
// (their coordinates and h values sit in registers), takes the row max and
// the sum of expf by warp shuffles, and lane 0 applies logf and the update.
// The Jacobi update reads old potentials only through the h vectors built
// before a barrier, so each row updates its own potential in place.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxPts = 128;
constexpr int kMaxEps = 64;
constexpr int kCols = kMaxPts / 32;   // columns per lane
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Schedule {
  int n;
  float eps[kMaxEps];
  float lam[kMaxEps];
};

__device__ __forceinline__ float cost(float dx, float dy, float p) {
  const float d2 = dx * dx + dy * dy;
  if (p == 2.f) return d2 * 0.5f;
  const float d = sqrtf(fmaxf(d2, 1e-20f));
  if (p == 1.f) return d;
  return powf(d, p) / p;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One softmin pass: rows (nr points at rows[2 * r]) over columns (nc points
// at cols[2 * j], h values at h[j]); pot[r] takes the (averaged) result.
__device__ __forceinline__ void softmin_rows(
    const float* rows, int nr, const float* cols, const float* h, int nc,
    float* pot, float eps, float lam, bool first, float p, int warp, int lane) {
  float cx[kCols], cy[kCols], hv[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int j = lane + 32 * k;
    const bool ok = j < nc;
    cx[k] = ok ? cols[2 * j] : 0.f;
    cy[k] = ok ? cols[2 * j + 1] : 0.f;
    hv[k] = ok ? h[j] : 0.f;
  }
  const float inv_eps = 1.f / eps;
  for (int r = warp; r < nr; r += kWarps) {
    const float rx = rows[2 * r], ry = rows[2 * r + 1];
    float m[kCols];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      m[k] = hv[k] - cost(rx - cx[k], ry - cy[k], p) * inv_eps;
      if (lane + 32 * k < nc) mx = fmaxf(mx, m[k]);
    }
    mx = warp_max(mx);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (lane + 32 * k < nc) s += expf(m[k] - mx);
    s = warp_sum(s);
    if (lane == 0) {
      const float f = lam * (-eps * (logf(s) + mx));
      pot[r] = first ? f : 0.5f * (pot[r] + f);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sinkhorn_potentials_kernel(const float* __restrict__ x, const float* __restrict__ y,
                           const float* __restrict__ a_log,
                           const float* __restrict__ b_log,
                           float* __restrict__ ax_out, float* __restrict__ by_out,
                           float* __restrict__ ay_out, float* __restrict__ bx_out,
                           int P, int T, Schedule sched, float p, int debias) {
  __shared__ float xs[2 * kMaxPts], ys[2 * kMaxPts];
  __shared__ float al[kMaxPts], bl[kMaxPts];
  __shared__ float ax[kMaxPts], by[kMaxPts], ay[kMaxPts], bx[kMaxPts];
  // h vectors of the four passes: over y for b_x, over x for a_y,
  // over x for a_x, over y for b_y
  __shared__ float h_bx[kMaxPts], h_ay[kMaxPts], h_ax[kMaxPts], h_by[kMaxPts];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < 2 * P; i += kThreads) xs[i] = x[(size_t)n * 2 * P + i];
  for (int i = tid; i < 2 * T; i += kThreads) ys[i] = y[(size_t)n * 2 * T + i];
  for (int i = tid; i < P; i += kThreads) { al[i] = a_log[(size_t)n * P + i]; ax[i] = 0.f; }
  for (int i = tid; i < T; i += kThreads) { bl[i] = b_log[(size_t)n * T + i]; by[i] = 0.f; }
  __syncthreads();

  for (int e = 0; e < sched.n; ++e) {
    const float eps = sched.eps[e], lam = sched.lam[e];
    const bool first = e == 0;
    // h from the OLD potentials (the Jacobi step reads them all before any
    // is overwritten)
    for (int i = tid; i < P; i += kThreads) {
      h_ay[i] = first ? al[i] : al[i] + bx[i] / eps;
      h_ax[i] = first ? al[i] : al[i] + ax[i] / eps;
    }
    for (int j = tid; j < T; j += kThreads) {
      h_bx[j] = first ? bl[j] : bl[j] + ay[j] / eps;
      h_by[j] = first ? bl[j] : bl[j] + by[j] / eps;
    }
    __syncthreads();
    softmin_rows(xs, P, ys, h_bx, T, bx, eps, lam, first, p, warp, lane);
    softmin_rows(ys, T, xs, h_ay, P, ay, eps, lam, first, p, warp, lane);
    if (debias) {
      softmin_rows(xs, P, xs, h_ax, P, ax, eps, lam, first, p, warp, lane);
      softmin_rows(ys, T, ys, h_by, T, by, eps, lam, first, p, warp, lane);
    }
    __syncthreads();
  }

  for (int i = tid; i < P; i += kThreads) {
    ax_out[(size_t)n * P + i] = ax[i];
    bx_out[(size_t)n * P + i] = bx[i];
  }
  for (int j = tid; j < T; j += kThreads) {
    by_out[(size_t)n * T + j] = by[j];
    ay_out[(size_t)n * T + j] = ay[j];
  }
}

}  // namespace

// x (N, P, 2), y (N, T, 2), a_log (N, P), b_log (N, T) -> a_x (N, P),
// b_y (N, T), a_y (N, T), b_x (N, P); all fp32, contiguous, on the device.
// eps / lam: host arrays of n_eps floats. Returns the CUDA error code of the
// launch (0 on success); launches nothing for N == 0.
extern "C" int sinkhorn_potentials(const float* x, const float* y,
                                   const float* a_log, const float* b_log,
                                   float* a_x, float* b_y, float* a_y, float* b_x,
                                   int N, int P, int T, const float* eps,
                                   const float* lam, int n_eps, float p,
                                   int debias, void* stream) {
  if (N < 0 || P < 1 || P > kMaxPts || T < 1 || T > kMaxPts || n_eps < 1 ||
      n_eps > kMaxEps)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Schedule s;
  s.n = n_eps;
  for (int i = 0; i < kMaxEps; ++i) {
    s.eps[i] = i < n_eps ? eps[i] : 1.f;
    s.lam[i] = i < n_eps ? lam[i] : 1.f;
  }
  sinkhorn_potentials_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      x, y, a_log, b_log, a_x, b_y, a_y, b_x, P, T, s, p, debias);
  return (int)cudaGetLastError();
}
