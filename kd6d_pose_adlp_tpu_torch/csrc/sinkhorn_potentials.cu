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
// for the four passes (b_x: x over y, a_y: y over x, a_x: x over x,
// b_y: y over y; the last two only with debias). The eps and lam = 1 /
// (1 + eps / rho) lists come from the host; rho enters only through lam.
// Padding is JAX's: log-weight -1e30, so a padded column adds exp(-huge) = 0,
// and a row whose columns are all padded gives log(count) after the
// max-subtract. No gradient: the caller extrapolates once outside. Like the
// JAX package, it takes any P, T >= 1 and a schedule of any length.
//
// The schedule. The caller passes eps, lam and 1 / eps (rounded once on the
// host, as the plain version's division by a host scalar is) as one array
// in device memory, which its wrapper caches per schedule and device. A
// launch then takes a schedule of any length; each step's three values are
// uniform loads, fetched one step ahead; and a call copies nothing from the
// host, so a step that has run once can be captured in a CUDA graph.
// Chained launches of a fixed-size schedule passed by value would compose
// exactly too, but each would stage the clouds and the kept costs again.
//
// What bounds it on an H100: at the KD loss's shape (N = B * 8 = 128,
// P = T = 64, 12 eps values) it computes 128 * 12 * 4 * 64 * 64 = 25.2 M
// expf and reads/writes ~0.3 MB. The special-function units (16 results
// per clock per SM, ~4.2 T/s over 132 SMs at 1.98 GHz) bound it at ~6 us.
// But an accurate expf is 8 instructions around its one SFU op, and each
// (row, column) pair needs 5 more (scale, subtract, max, subtract, add),
// so the instruction issue rate (4 warp instructions per clock per SM) is
// the floor in practice, about 1.6 times the SFU bound.
//
// Design at P, T <= 128. One thread block of 512 threads per problem, no
// padding of N (128 problems fill the 132 SMs once). Within one eps the
// 2P + 2T softmin rows of the four passes are independent (Jacobi), so
// threads are mapped to rows, not to columns: G = 4, 2 or 1 neighbouring
// lanes share a row (the largest G with G * rows <= 512; at P = T = 64, 256
// rows and G = 2), and the G lanes combine their partial max and sum by one
// or two shuffles. Each thread's exponentials are independent of each
// other, so 16 warps keep the pipelines full. The cost C_ij does not depend
// on eps: a lane owns K * 32 / G columns of its row (K = ceil(max(P, T) /
// 32)), and when those are at most 32 (`k1_kept`, the main path) it
// computes their C entries once and keeps them in registers for the whole
// schedule, so a pair costs one multiply, one subtract and one max before
// its exponential. The h vectors live in shared memory, permuted so that a
// lane's columns are contiguous (float4 loads; the lanes of a warp read the
// same few addresses, a broadcast). The thread that owns a row keeps its
// potential in a register, applies lam and the Jacobi average, and writes
// the next eps's h entry into the other of two h buffers (ping-pong): one
// barrier per eps, no separate h phase, and at the main shape each pass
// group (b_x with a_y, a_x, b_y) waits only for itself. Longer shares (G =
// 2 with P or T above 64, and G = 1, as at P = T = 128) take `k1_streamed`:
// one lane per row, C recomputed from the coordinates in both sweeps.
//
// Design past 128 points (`k1_wide`). A whole warp takes a row, its 32
// lanes the 32 lanes of the reference reduction below, and the 16 warps of
// a block take rows r, r + 16, ... of the 2P + 2T (P + T without debias);
// a row recomputes its costs from the coordinates in both sweeps (max, then
// the sum). Lane 0 of the row's warp applies lam and the Jacobi average to
// the row's potential, which lives in its output array between steps, and
// writes the next eps's h entry. Two routes share that body:
//   shared: one block per problem runs the whole schedule with the clouds
//     and the two h buffers in its shared memory (24 bytes a point: P + T
//     <= 9,685 on an H100), one barrier per eps;
//   global: the clouds are read where they lie, the h buffers live in a
//     workspace of N * 4 (P + T) floats that the wrapper allocates, and one
//     launch per eps has a block per 16 rows of every problem, so the limit
//     is device memory.
// The shared route keeps its operands on chip and needs one launch, but
// runs N blocks: below the SM count it leaves SMs idle, and its time does
// not fall with N. The global route fills the card at any N, its time
// proportional to N, but costs ~1.3-1.7 times as much per pair (its loads
// go through L1). On an H100 (132 SMs, 12 eps; scripts/bench_k1.py
// --pin_routes) the two cross at N = 76 (P = T = 1,000), 84 (P = T = 256)
// and 97 (P = 129, T = 64): at P = T = 256 the shared route takes 1.17 ms
// from N = 16 to 128, the global one 0.245 ms at N = 16, 1.12 at 80, 1.34
// at 96 and 1.77 at 128. So `route` takes the shared route where it fits
// and 3 N >= 2 SMs (N >= 88 there), the global one otherwise.
//
// Rounding. The self potentials a_x, b_y at real points are ~1e-6 at the
// last eps, and float32 rounding in the earlier eps steps, most of it in
// the sum near 1.0 (the max term), moves them by ~1e-5 of that. So the
// kernel rounds as the plain version (`solve_potentials_plain`, whose
// torch.logsumexp runs on the card) does: C = d2 * 0.5 (p = 2), C / eps as
// C * (1 / eps), h as log-weight + pot * (1 / eps), no FMA contraction,
// accurate expf and logf, and the sum in the order of PyTorch's CUDA row
// reduction (ATen/native/cuda/Reduce.cuh, a row of M contiguous columns,
// 32 lanes a row): below M = 128 lane l adds columns l, l + 32, l + 64,
// l + 96 in turn; from M = 128 the lanes read 16-byte vectors: the row
// starts `shift` = (row * M) % 4 elements past a 16-byte boundary, lanes
// shift .. 3 first take its 4 - shift head columns (none when shift = 0),
// then lane l's four accumulators take the vectors l, l + 32, ... that
// follow, the ragged tail goes to lanes 0 .. by one column each, and the
// four accumulators are added in order; then a shuffle-down tree with
// offsets 16, 8, 4, 2, 1. A thread of a G-lane group holds the partial
// sums of the lanes l = sub + G q and runs the first steps of that tree in
// registers; the last log2(G) steps are the shuffles. PyTorch splits a row
// over several warps only past 32,767 columns (8,191 when fewer than 16
// rows are reduced): there the kernel's sum order differs from the plain
// version's, and the two agree to float32 rounding, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSmallPts = 128;   // clouds of k1_kept / k1_streamed (static shared memory)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 32;       // lanes of the reference row reduction

// The schedule in device memory: eps[n], lam[n], inv[n] = 1 / eps.
struct Sched {
  const float* v;
  int n;
  __device__ __forceinline__ float eps(int e) const { return __ldg(v + e); }
  __device__ __forceinline__ float lam(int e) const { return __ldg(v + n + e); }
  __device__ __forceinline__ float inv(int e) const { return __ldg(v + 2 * n + e); }
};

// What the update at the end of eps step e needs, loaded at its start.
struct Step {
  float lam, eps, inv_next;
  bool first, more;
};

__device__ __forceinline__ Step step_at(const Sched& s, int e) {
  Step t;
  t.lam = s.lam(e);
  t.eps = s.eps(e);
  t.first = e == 0;
  t.more = e + 1 < s.n;
  t.inv_next = t.more ? s.inv(e + 1) : 1.f;
  return t;
}

// lam * f and the Jacobi average with the previous potential.
__device__ __forceinline__ float update(const Step& t, float lse, float pot) {
  const float lf = __fmul_rn(t.lam, __fmul_rn(-t.eps, lse));
  return t.first ? lf : __fmul_rn(0.5f, __fadd_rn(pot, lf));
}

struct Problem {
  const float *x, *y, *a_log, *b_log;
  float *a_x, *b_y, *a_y, *b_x;
  int P, T, debias;
  float p;
};

// C = |d|^p / p of one pair, rounded as the plain version's cost_matrix.
template <int PK>   // 2 or 1 for p = 2 or p = 1, 0 for any other p
__device__ __forceinline__ float cost(float dx, float dy, float p) {
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  if (PK == 2) return __fmul_rn(d2, 0.5f);
  const float d = sqrtf(fmaxf(d2, 1e-20f));
  if (PK == 1) return d;
  return __fmul_rn(powf(d, p), 1.f / p);
}

// The reference's shuffle-down tree over the 32 lane sums, in two parts.
// In a thread: v[q] (lane l = sub + G q) += v[q + O] for q < O, then the
// same with O / 2, ..., 1 (the tree's offsets 16 .. G).
template <int O>
__device__ __forceinline__ void fold(float* v) {
  if constexpr (O > 0) {
#pragma unroll
    for (int q = 0; q < O; ++q) v[q] = __fadd_rn(v[q], v[q + O]);
    fold<O / 2>(v);
  }
}

// Across the G lanes of a group: offsets O = G / 2, ..., 1 (every lane of
// the group ends with the same bits). The whole warp takes part.
template <int O>
__device__ __forceinline__ float group_sum(float s) {
  if constexpr (O > 0)
    return group_sum<O / 2>(__fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, O)));
  else
    return s;
}

template <int O>
__device__ __forceinline__ float group_max(float s) {
  if constexpr (O > 0)
    return group_max<O / 2>(fmaxf(s, __shfl_xor_sync(0xffffffffu, s, O)));
  else
    return s;
}

// Slot of column j in a pass's h vector: lane l = j % 32 of the reference
// reduction, sub = l % G of its group, q = l / G, k = j / 32; each sub's
// columns are contiguous, in the order (k, q).
template <int G>
__device__ __forceinline__ int h_slot(int j) {
  constexpr int Q = kLanes / G;
  const int l = j % kLanes;
  return (l % G) * (kSmallPts / G) + (j / kLanes) * Q + l / G;
}

// Shared state of one problem: the clouds, and per pass the h vector in
// h_slot order (-inf past the pass's column count), two buffers.
struct Smem {
  float2 pts[2][kSmallPts];                 // x, y
  __align__(16) float h[2][4][kSmallPts];   // [buffer][pass][slot]
};

// One thread's row: pass 0 (b_x: x over y, h from b_log and a_y), 1 (a_y:
// y over x; a_log, b_x), 2 (a_x: x over x; a_log, a_x), 3 (b_y: y over y;
// b_log, b_y); rows run P, T, P, T.
struct Row {
  bool active;
  int pass, i, nc, feed;   // feed: the pass whose h this row's potential sets
  float2 pt;               // the row's point
  float logw;              // the row's log-weight
  const float2* cols;      // the column cloud
};

template <int G>
__device__ __forceinline__ Row setup(Smem& sm, const Problem& pr, int n) {
  const int tid = threadIdx.x, P = pr.P, T = pr.T;
  const float* an = pr.a_log + (size_t)n * P;
  const float* bn = pr.b_log + (size_t)n * T;
  // points past a cloud's count are (0, 0), so their costs stay finite
  for (int j = tid; j < kSmallPts; j += kThreads) {
    const float* xn = pr.x + (size_t)n * 2 * P;
    const float* yn = pr.y + (size_t)n * 2 * T;
    sm.pts[0][j] = j < P ? make_float2(xn[2 * j], xn[2 * j + 1]) : make_float2(0.f, 0.f);
    sm.pts[1][j] = j < T ? make_float2(yn[2 * j], yn[2 * j + 1]) : make_float2(0.f, 0.f);
  }
  for (int idx = tid; idx < 4 * kSmallPts; idx += kThreads) {
    const int pass = idx / kSmallPts, j = idx % kSmallPts;
    const bool on_y = pass == 0 || pass == 3;
    const float h = j < (on_y ? T : P) ? (on_y ? bn[j] : an[j]) : -INFINITY;
    sm.h[0][pass][h_slot<G>(j)] = h;
    sm.h[1][pass][h_slot<G>(j)] = h;
  }
  Row r;
  const int rows = (pr.debias ? 2 : 1) * (P + T);
  int i = tid / G, pass = 0;
  r.active = i < rows;
  if (i >= P) { i -= P; pass = 1; }
  if (pass == 1 && i >= T) { i -= T; pass = 2; }
  if (pass == 2 && i >= P) { i -= P; pass = 3; }
  r.pass = pass;
  r.i = i;
  const bool row_on_x = pass == 0 || pass == 2;
  r.nc = (pass == 0 || pass == 3) ? T : P;
  r.feed = pass == 0 ? 1 : pass == 1 ? 0 : pass;
  r.cols = sm.pts[row_on_x ? (pass == 0 ? 1 : 0) : (pass == 1 ? 0 : 1)];
  r.pt = make_float2(0.f, 0.f);
  r.logw = 0.f;
  if (r.active) {
    r.pt = make_float2(row_on_x ? pr.x[(size_t)n * 2 * P + 2 * i] : pr.y[(size_t)n * 2 * T + 2 * i],
                       row_on_x ? pr.x[(size_t)n * 2 * P + 2 * i + 1]
                                : pr.y[(size_t)n * 2 * T + 2 * i + 1]);
    r.logw = row_on_x ? an[i] : bn[i];
  }
  return r;
}

// The barrier that ends an eps step. Passes 0 and 1 (b_x, a_y) feed each
// other, pass 2 (a_x) and pass 3 (b_y) only themselves. When every thread
// has a row and each of those groups fills whole warps, each group waits
// only for itself (named barriers 1 .. 3): the groups drift out of step,
// and one group's sweeps fill the others' serial tails (shuffles, logf,
// the update). Otherwise the whole block waits.
struct Barrier {
  int id, count;   // id 0: the whole block
  __device__ __forceinline__ void sync() const {
    if (id == 0) __syncthreads();
    else asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
  }
};

template <int G>
__device__ __forceinline__ Barrier eps_barrier(const Problem& pr, int pass) {
  const int P = pr.P, T = pr.T;
  if (!pr.debias || 2 * G * (P + T) != kThreads || (G * P) % 32 || (G * T) % 32)
    return Barrier{0, kThreads};
  return pass < 2 ? Barrier{1, G * (P + T)} : pass == 2 ? Barrier{2, G * P} : Barrier{3, G * T};
}

// After the row's log-sum-exp at eps e: the potential, and the next eps's h
// entry of the pass it feeds (written by one lane of the group).
template <int G>
__device__ __forceinline__ void finish(Smem& sm, const Row& r, const Step& t, int e,
                                       float lse, float& pot) {
  pot = update(t, lse, pot);
  if (threadIdx.x % G == 0 && t.more)
    sm.h[(e + 1) & 1][r.feed][h_slot<G>(r.i)] =
        __fadd_rn(r.logw, __fmul_rn(pot, t.inv_next));
}

__device__ __forceinline__ void store(const Problem& pr, const Row& r, int n, float pot) {
  if (!r.active) return;
  float* out = r.pass == 0 ? pr.b_x + (size_t)n * pr.P : r.pass == 1 ? pr.a_y + (size_t)n * pr.T
             : r.pass == 2 ? pr.a_x + (size_t)n * pr.P : pr.b_y + (size_t)n * pr.T;
  out[r.i] = pot;
}

__device__ __forceinline__ void zero_self_potentials(const Problem& pr, int n) {
  if (pr.debias) return;
  for (int j = threadIdx.x; j < pr.P; j += kThreads) pr.a_x[(size_t)n * pr.P + j] = 0.f;
  for (int j = threadIdx.x; j < pr.T; j += kThreads) pr.b_y[(size_t)n * pr.T + j] = 0.f;
}

// A lane's C entries (lane l = sub + G q: columns l + 32 k); zero past the
// row's column count, where h = -inf makes the column's m -inf.
template <int PK, int G, int K>
__device__ __forceinline__ void kept_costs(const Row& r, int sub, float p,
                                           float (&C)[K][kLanes / G]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int q = 0; q < kLanes / G; ++q) {
      const int j = sub + G * q + kLanes * k;
      const float2 c = r.cols[j];
      C[k][q] = r.active && j < r.nc
                    ? cost<PK>(__fsub_rn(r.pt.x, c.x), __fsub_rn(r.pt.y, c.y), p) : 0.f;
    }
}

// Every pass has at most 32 K columns and a lane owns K * 32 / G <= 32 of
// them (lane l = sub + G q of the reference reduction: columns l + 32 k),
// whose C entries it keeps in registers for the whole schedule.
template <int G, int K>
__global__ void __launch_bounds__(kThreads, 1)
k1_kept(Problem pr, Sched s) {
  constexpr int Q = kLanes / G;
  static_assert(Q * K <= 32 && (Q * K) % 4 == 0, "a lane keeps <= 32 columns, float4s");
  __shared__ Smem sm;
  const int n = blockIdx.x;
  const Row r = setup<G>(sm, pr, n);
  const int sub = threadIdx.x % G;
  __syncthreads();

  float C[K][Q];
  if (pr.p == 2.f) kept_costs<2, G, K>(r, sub, pr.p, C);
  else if (pr.p == 1.f) kept_costs<1, G, K>(r, sub, pr.p, C);
  else kept_costs<0, G, K>(r, sub, pr.p, C);

  // every thread runs the sweeps (an idle one on a dummy row of zero
  // costs), so the shuffles see whole warps; only active rows write
  const Barrier bar = eps_barrier<G>(pr, r.pass);
  float pot = 0.f;
  float inv_eps = s.inv(0);
  for (int e = 0; e < s.n; ++e) {
    const Step t = step_at(s, e);
    const float4* h4 =
        reinterpret_cast<const float4*>(&sm.h[e & 1][r.pass][sub * (kSmallPts / G)]);
    float m[K][Q];
    float mx0 = -INFINITY, mx1 = -INFINITY;   // two chains; max is exact in any order
#pragma unroll
    for (int u = 0; u < Q * K; u += 4) {
      const float4 hv = h4[u / 4];
      const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = (u + c) / Q, q = (u + c) % Q;
        m[k][q] = __fsub_rn(hs[c], __fmul_rn(C[k][q], inv_eps));
        if (c % 2) mx1 = fmaxf(mx1, m[k][q]);
        else mx0 = fmaxf(mx0, m[k][q]);
      }
    }
    const float mx = group_max<G / 2>(fmaxf(mx0, mx1));
    float v[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      v[q] = expf(__fsub_rn(m[0][q], mx));
#pragma unroll
      for (int k = 1; k < K; ++k) v[q] = __fadd_rn(v[q], expf(__fsub_rn(m[k][q], mx)));
    }
    fold<Q / 2>(v);
    const float lse = __fadd_rn(logf(group_sum<G / 2>(v[0])), mx);
    if (r.active) finish<G>(sm, r, t, e, lse, pot);
    bar.sync();
    inv_eps = t.inv_next;
  }
  if (sub == 0) store(pr, r, n, pot);
  zero_self_potentials(pr, n);
}

// Any column count up to 128, one lane per row, C recomputed from the
// coordinates in both sweeps. A row of exactly 128 columns sums lane l's
// columns 4l .. 4l + 3, any other l, l + 32, l + 64, l + 96.
template <int PK>
__global__ void __launch_bounds__(kThreads, 1)
k1_streamed(Problem pr, Sched s) {
  __shared__ Smem sm;
  const int n = blockIdx.x;
  const Row r = setup<1>(sm, pr, n);
  __syncthreads();

  float pot = 0.f;
  float inv_eps = s.inv(0);
  for (int e = 0; e < s.n; ++e) {
    const Step t = step_at(s, e);
    if (r.active) {
      const float* h = sm.h[e & 1][r.pass];   // h_slot<1> is the identity
      const bool vec = r.nc == kSmallPts;
      auto m_of = [&](int q, int k) {
        const int j = vec ? 4 * q + k : q + kLanes * k;
        const float2 c = r.cols[j];
        return __fsub_rn(h[j], __fmul_rn(cost<PK>(__fsub_rn(r.pt.x, c.x),
                                                  __fsub_rn(r.pt.y, c.y), pr.p), inv_eps));
      };
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < kLanes; ++q) mx = fmaxf(mx, m_of(q, k));
      float v[kLanes];
#pragma unroll
      for (int q = 0; q < kLanes; ++q) {
        v[q] = expf(__fsub_rn(m_of(q, 0), mx));
#pragma unroll
        for (int k = 1; k < 4; ++k) v[q] = __fadd_rn(v[q], expf(__fsub_rn(m_of(q, k), mx)));
      }
      fold<kLanes / 2>(v);
      finish<1>(sm, r, t, e, __fadd_rn(logf(v[0]), mx), pot);
    }
    __syncthreads();
    inv_eps = t.inv_next;
  }
  store(pr, r, n, pot);
  zero_self_potentials(pr, n);
}

// ---------------------------------------------------------------------------
// clouds past 128 points: a warp a row
// ---------------------------------------------------------------------------

// The log-sum-exp of one row of M columns, in the reference's order (see
// the header); cols holds the column cloud as (x, y) pairs, h the pass's h
// vector. Every lane of the warp takes part and returns the same bits.
template <int PK>
__device__ __forceinline__ float row_lse(float px, float py, const float* cols,
                                         const float* h, int M, int shift, float inv,
                                         float p) {
  const int l = threadIdx.x % kLanes;
  auto m_of = [&](int j) {
    return __fsub_rn(h[j], __fmul_rn(cost<PK>(__fsub_rn(px, cols[2 * j]),
                                              __fsub_rn(py, cols[2 * j + 1]), p), inv));
  };
  float mx = -INFINITY;
  for (int j = l; j < M; j += kLanes) mx = fmaxf(mx, m_of(j));
  mx = group_max<kLanes / 2>(mx);
  auto e_of = [&](int j) { return expf(__fsub_rn(m_of(j), mx)); };
  float v0 = 0.f;
  if (M < 128) {
    for (int j = l; j < M; j += kLanes) v0 = __fadd_rn(v0, e_of(j));
  } else {
    const int hd = shift ? 4 - shift : 0;   // head columns before the first 16-byte boundary
    if (shift && l >= shift && l < 4) v0 = e_of(l - shift);
    const int end = M - hd;
    float v1 = 0.f, v2 = 0.f, v3 = 0.f;
    for (int q = l; 4 * q + 3 < end; q += kLanes) {
      const int j = hd + 4 * q;
      v0 = __fadd_rn(v0, e_of(j));
      v1 = __fadd_rn(v1, e_of(j + 1));
      v2 = __fadd_rn(v2, e_of(j + 2));
      v3 = __fadd_rn(v3, e_of(j + 3));
    }
    const int tail = end - end % 4;
    if (tail + l < end) v0 = __fadd_rn(v0, e_of(hd + tail + l));
    v0 = __fadd_rn(__fadd_rn(__fadd_rn(v0, v1), v2), v3);
  }
  return __fadd_rn(logf(group_sum<kLanes / 2>(v0)), mx);
}

// Offset of a pass's h vector in a buffer of 2 (P + T) entries: pass 0 (T
// entries, over y), 1 (P, over x), 2 (P), 3 (T).
__device__ __forceinline__ int h_offset(int pass, int P, int T) {
  return pass == 0 ? 0 : pass == 1 ? T : pass == 2 ? T + P : T + 2 * P;
}

// SHARED: one block per problem (blockIdx.x) runs eps steps e0 .. e1 - 1
// with the clouds and the h buffers in dynamic shared memory. Otherwise a
// block takes rows 16 blockIdx.x .. + 15 of problem n0 + blockIdx.y at the
// one eps step e0 (e1 = e0 + 1), the h buffers in the workspace ws (per
// problem, two buffers of 2 (P + T) floats). h at the first eps is the
// log-weights, read where they lie.
template <int PK, bool SHARED>
__global__ void __launch_bounds__(kThreads, 2)
k1_wide(Problem pr, Sched s, float* ws, int n0, int e0, int e1) {
  extern __shared__ __align__(16) float wide_sm[];
  const int P = pr.P, T = pr.T, tid = threadIdx.x;
  const int lane = tid % kLanes, warp = tid / kLanes;
  const int n = SHARED ? blockIdx.x : n0 + blockIdx.y;
  const int HV = 2 * (P + T);
  const int rows = (pr.debias ? 2 : 1) * (P + T);
  const float* xn = pr.x + (size_t)n * 2 * P;
  const float* yn = pr.y + (size_t)n * 2 * T;
  const float* an = pr.a_log + (size_t)n * P;
  const float* bn = pr.b_log + (size_t)n * T;
  const float *cx = xn, *cy = yn;
  float* hb;
  if constexpr (SHARED) {
    for (int j = tid; j < 2 * P; j += kThreads) wide_sm[j] = xn[j];
    for (int j = tid; j < 2 * T; j += kThreads) wide_sm[2 * P + j] = yn[j];
    cx = wide_sm;
    cy = wide_sm + 2 * P;
    hb = wide_sm + 2 * (P + T);
    __syncthreads();
  } else {
    hb = ws + (size_t)n * 2 * HV;
  }
  if (SHARED || (blockIdx.x == 0 && e0 == 0)) zero_self_potentials(pr, n);
  const int r0 = SHARED ? 0 : blockIdx.x * kWarps;
  const int r1 = SHARED ? rows : min(rows, r0 + kWarps);
  float inv = s.inv(e0);
  for (int e = e0; e < e1; ++e) {
    const Step t = step_at(s, e);
    for (int r = r0 + warp; r < r1; r += kWarps) {
      int pass = 0, i = r;
      if (i >= P) { i -= P; pass = 1; }
      if (pass == 1 && i >= T) { i -= T; pass = 2; }
      if (pass == 2 && i >= P) { i -= P; pass = 3; }
      const bool row_x = pass == 0 || pass == 2, col_y = pass == 0 || pass == 3;
      const int R = row_x ? P : T, M = col_y ? T : P;
      const float* rc = row_x ? cx : cy;
      const float* h = e == 0 ? (col_y ? bn : an) : hb + (e & 1) * HV + h_offset(pass, P, T);
      float* out = (pass == 0 ? pr.b_x : pass == 1 ? pr.a_y : pass == 2 ? pr.a_x : pr.b_y)
                   + (size_t)n * R;
      const float old = e > 0 && lane == 0 ? out[i] : 0.f;
      // the row's place in the plain version's (N, R, M) exp tensor
      const int shift = (int)((((size_t)n * R + i) & 3) * (M & 3) & 3);
      const float lse = row_lse<PK>(rc[2 * i], rc[2 * i + 1], col_y ? cy : cx, h, M, shift,
                                    inv, pr.p);
      if (lane == 0) {
        const float pot = update(t, lse, old);
        out[i] = pot;
        if (t.more) {
          const int feed = pass == 0 ? 1 : pass == 1 ? 0 : pass;
          hb[((e + 1) & 1) * HV + h_offset(feed, P, T) + i] =
              __fadd_rn(row_x ? an[i] : bn[i], __fmul_rn(pot, t.inv_next));
        }
      }
    }
    if constexpr (SHARED) __syncthreads();
    inv = t.inv_next;
  }
}

enum Route { kSmall, kShared, kGlobal };

size_t wide_smem(int P, int T) { return sizeof(float) * 6 * ((size_t)P + T); }

// The route of N problems of P and T points (see the header). Built with
// -DK1_WIDE_ROUTE=1 (shared) or 2 (global), the route past 128 points is
// pinned where the shared one fits, for bench_k1.py to time both.
Route route(int N, int P, int T) {
  if (P <= kSmallPts && T <= kSmallPts) return kSmall;
  int dev = 0, optin = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      wide_smem(P, T) > (size_t)optin)
    return kGlobal;
#ifdef K1_WIDE_ROUTE
  if (K1_WIDE_ROUTE) return K1_WIDE_ROUTE == 1 ? kShared : kGlobal;
#endif
  return 3 * N >= 2 * sms ? kShared : kGlobal;
}

template <bool SHARED>
void (*wide_kernel(float p))(Problem, Sched, float*, int, int, int) {
  return p == 2.f ? k1_wide<2, SHARED> : p == 1.f ? k1_wide<1, SHARED> : k1_wide<0, SHARED>;
}

}  // namespace

// Floats of device workspace that sinkhorn_potentials needs at (N, P, T):
// N * 4 (P + T) on the global route, else 0.
extern "C" long long sinkhorn_potentials_workspace(int N, int P, int T) {
  if (N < 1 || P < 1 || T < 1 || route(N, P, T) != kGlobal) return 0;
  return (long long)N * 4 * ((long long)P + T);
}

// x (N, P, 2), y (N, T, 2), a_log (N, P), b_log (N, T) -> a_x (N, P),
// b_y (N, T), a_y (N, T), b_x (N, P); all fp32, contiguous, on the device.
// sched: 3 n_eps floats on the device, eps, lam and 1 / eps. workspace:
// sinkhorn_potentials_workspace(N, P, T) floats on the device (may be null
// when that is 0). Returns the CUDA error code of the launches (0 on
// success); launches nothing for N == 0.
extern "C" int sinkhorn_potentials(const float* x, const float* y,
                                   const float* a_log, const float* b_log,
                                   float* a_x, float* b_y, float* a_y, float* b_x,
                                   int N, int P, int T, const float* sched, int n_eps,
                                   float p, int debias, float* workspace, void* stream) {
  if (N < 0 || P < 1 || T < 1 || n_eps < 1 || sched == nullptr)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const Problem pr{x, y, a_log, b_log, a_x, b_y, a_y, b_x, P, T, debias, p};
  const Sched s{sched, n_eps};
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = (debias ? 2 : 1) * (P + T);
  const Route rt = route(N, P, T);
  if (rt == kSmall) {
    // lanes per row: the most that still give every row its own group; a
    // lane keeps its columns' costs in registers if they are at most 32
    const int G = 4 * rows <= kThreads ? 4 : 2 * rows <= kThreads ? 2 : 1;
    const int K = ((P > T ? P : T) + kLanes - 1) / kLanes;   // column blocks of 32
    const dim3 grid(N), block(kThreads);
    if (G == 4 && K == 1) k1_kept<4, 1><<<grid, block, 0, st>>>(pr, s);
    else if (G == 4 && K == 2) k1_kept<4, 2><<<grid, block, 0, st>>>(pr, s);
    else if (G == 4 && K == 3) k1_kept<4, 3><<<grid, block, 0, st>>>(pr, s);
    else if (G == 4) k1_kept<4, 4><<<grid, block, 0, st>>>(pr, s);
    else if (G == 2 && K == 1) k1_kept<2, 1><<<grid, block, 0, st>>>(pr, s);
    else if (G == 2 && K == 2) k1_kept<2, 2><<<grid, block, 0, st>>>(pr, s);
    else if (p == 2.f) k1_streamed<2><<<grid, block, 0, st>>>(pr, s);
    else if (p == 1.f) k1_streamed<1><<<grid, block, 0, st>>>(pr, s);
    else k1_streamed<0><<<grid, block, 0, st>>>(pr, s);
    return (int)cudaGetLastError();
  }
  if (rt == kShared) {
    const size_t smem = wide_smem(P, T);
    const auto kernel = wide_kernel<true>(p);
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<N, kThreads, smem, st>>>(pr, s, nullptr, 0, 0, n_eps);
    return (int)cudaGetLastError();
  }
  if (workspace == nullptr) return (int)cudaErrorInvalidValue;
  const auto kernel = wide_kernel<false>(p);
  const int bx = (rows + kWarps - 1) / kWarps;
  constexpr int kMaxGridY = 65535;
  for (int e = 0; e < n_eps; ++e) {
    for (int n0 = 0; n0 < N; n0 += kMaxGridY) {
      const int ny = N - n0 < kMaxGridY ? N - n0 : kMaxGridY;
      kernel<<<dim3(bx, ny), kThreads, 0, st>>>(pr, s, workspace, n0, e, e + 1);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}
