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
// Design past 128 points: thread-block clusters, one launch a solve
// (`k1_cluster_kept`, `k1_cluster_streamed`). A problem runs on a cluster
// of cs blocks of 512 threads, and the clusters walk the problems c, c +
// ncl, ... Every block of a cluster holds both clouds (x and y coordinates
// apart, 16-byte aligned) and two h buffers of the four passes in its
// shared memory, 24 bytes a point; every row has one owner warp in the
// cluster, which keeps the row's potential in a register of one of its
// lanes for the whole schedule and, at the end of an eps step, writes the
// row's next h entry into the other buffer of every block of the cluster
// (distributed shared memory); then one cluster barrier. The output is
// stored once, at the end. Two forms:
//   kept (P, T multiples of 4 from 128 to 256, as at the train phase's
//     256-point step): a warp takes 8 rows of one pass and a lane their
//     costs at its 8 columns (4 l + 128 k + c, the reference's at shift 0),
//     computed once a problem and kept in registers, so a pair costs a
//     multiply, a subtract and a max in the first sweep and the same two
//     before the exp in the second. The 8 rows share their h loads (two
//     16-byte loads a lane), their lane values are reduced transposed (9
//     shuffles for 8 rows, one logf a lane; transposed_reduce8), and their
//     8 new h entries go to each block as two 16-byte stores. 1,024 rows
//     at P = T = 256 need 128 warps: clusters of 8.
//   streamed (any other P, T): a warp takes 4 rows at a time (a slot: rows
//     of one residue mod 4 within 16, so one pass and one shift), 8 lanes a
//     row; a lane plays 4 reference lanes side by side and folds their sums
//     through the tree's first steps in registers (as k1_kept's groups do),
//     costs recomputed from the coordinates in both sweeps, every column
//     read by 16-byte loads (a shifted row through the two aligned vectors
//     around each of its own; no bank conflicts).
// The plan (`wide_plan`, host code that the CPU tests compile with g++)
// takes the form, then the cluster size, 1-16 (past 8 only where the
// device runs such clusters: cudaOccupancyMaxActiveClusters, queried once
// per size and kernel), that costs the fewest rounds of clusters over N
// times a round's work (kept: one chunk a warp; streamed: a block's
// batches), the smallest of equals. An H100 runs 15 clusters of 7 or 8
// blocks at once, 17 of 6, 30 of 4 and 7 of 10-16 (one block an SM), so
// N = 16 kept problems take two rounds. Past ~9,685 points (P + T) the
// clouds and buffers pass one block's shared memory and the global route
// (`k1_wide<PK, false>`) remains: a block per 16 rows of every problem, a
// warp a row, the h buffers in a workspace of N * 4 (P + T) floats that the
// wrapper allocates, one launch per eps. Built with -DK1_WIDE_ROUTE=1, the
// source takes the shared route instead (`k1_wide<PK, true>`: a block a
// problem) where it fits, with 2 the global route, with 3 the cluster
// route (its default), so bench_k1.py --pin_routes times all three.
//
// Measured on an H100 80GB HBM3 at a 700 W power limit (scripts/
// bench_k1.py, 12 eps unless said): the kept form 0.099 ms at N = 16, P =
// T = 256 (the one launch an eps before it: 0.245; bound 0.0121) and 0.444
// ms at N = 128 (1.18); streamed, 0.055 ms at N = 16, P = 129, T = 64
// (0.088) and 5.92 ms at N = 8, P = T = 1,000, 74 eps (9.06). A kept eps
// of one round takes ~3.7 us: the exp sweep ~1.9 at the issue rate (12
// instructions a pair, 8 of them the accurate expf), the cluster barrier
// ~0.7, the first sweep and the reductions ~1.1.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace {

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// clouds past 128 points on thread-block clusters: the plan (host and device
// code that the CPU tests also compile with g++, from here to "plan end")
// ---------------------------------------------------------------------------

constexpr int kPlanWarps = 16;                       // warps a block (kThreads / 32)
constexpr int kKeptKV = 2;                           // kept costs: column vectors a lane a row
constexpr int kKeptRW = 8;                           // kept costs: rows a warp
constexpr int kKeptRegs = kKeptRW * kKeptKV * 4;     // kept costs a lane: 64 registers
constexpr int kMaxPotRegs = 8;                       // streamed: potential registers a lane
constexpr int kStreamG = 8;                          // streamed: lanes a row
constexpr int kStreamRows = 32 / kStreamG;           // streamed: rows a warp at once

// Pass 0 (b_x) and 2 (a_x) have a row per point of x, 1 (a_y) and 3 (b_y)
// one per point of y; passes 0 and 3 have a column per point of y, 1 and
// 2 one per point of x.
__host__ __device__ inline int pass_rows(int pass, int P, int T) { return pass % 2 ? T : P; }
__host__ __device__ inline int pass_cols(int pass, int P, int T) {
  return pass == 0 || pass == 3 ? T : P;
}

// Row f of a problem's 2P + 2T (P + T without debias) in pass order: its
// index in its pass.
__host__ __device__ inline int split_row(int f, int P, int T, int* pass) {
  int p = 0;
  if (f >= P) { f -= P; p = 1; }
  if (p == 1 && f >= T) { f -= T; p = 2; }
  if (p == 2 && f >= P) { f -= P; p = 3; }
  *pass = p;
  return f;
}

__host__ __device__ inline int kept_chunks(int P, int T, int npass) {
  int c = 0;
  for (int p = 0; p < npass; ++p) c += (pass_rows(p, P, T) + kKeptRW - 1) / kKeptRW;
  return c;
}

// Kept costs: warp g of a cluster (rank * 16 + warp) takes chunk g, rows
// i0 .. i0 + kKeptRW - 1 of one pass (those past the pass's rows idle);
// returns i0, or -1 where the chunks run out before g.
__host__ __device__ inline int kept_chunk(int g, int P, int T, int npass, int* pass) {
  *pass = 0;
  for (int p = 0; p < npass; ++p) {
    const int c = (pass_rows(p, P, T) + kKeptRW - 1) / kKeptRW;
    if (g < c) { *pass = p; return g * kKeptRW; }
    g -= c;
  }
  return -1;
}

// Streamed rows: a batch (slot s) is kStreamRows rows that share their
// residue mod 4, one a group of kStreamG lanes: rows 16 (s / 4) + s % 4 +
// 4 grp of split_row's order, so that its rows share a pass and a shift
// (but near a pass's end) and its groups run the same branches. Warp g of
// the cluster's W = cs * 16 takes slots g, g + W, ...; in its b-th, group
// grp's lane b % 8 keeps the row's potential in register b / 8.
__host__ __device__ inline int slot_row(int s, int grp) { return 16 * (s / 4) + s % 4 + 4 * grp; }
__host__ __device__ inline int stream_slots(int rows) { return 4 * ((rows + 15) / 16); }

struct WidePlan {
  int route;          // 3: cluster; 2: global (the clouds pass one block's shared memory)
  int cs, ncl;        // blocks a cluster; clusters launched, each walking problems c, c + ncl, ...
  int kept;           // 1: costs kept in registers; 0: recomputed in both sweeps (streamed)
  int pr;             // streamed: potential registers a lane (1 or kMaxPotRegs)
  int cloud[4];       // float offsets of x's x, x's y, y's x and y's y coordinates
  int hoff[4];        // float offset of each pass's h vector in an h buffer
  int h0, hbuf;       // float offset of h buffer 0, floats a buffer (buffer 1 follows)
  long long smem;     // dynamic shared memory a block, bytes
};

// a[i] of a 4-entry array of the plan, by selects (a kernel parameter
// indexed at run time would be copied to local memory)
__host__ __device__ inline int pick4(const int (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// Kept costs take clouds of 16-byte column vectors (P, T % 4 == 0, so every
// row's shift is 0) of 128 .. 128 kKeptKV points.
__host__ __device__ inline bool keeps_costs(int P, int T) {
  return P % 4 == 0 && T % 4 == 0 && (P < T ? P : T) >= 128 && (P > T ? P : T) <= 128 * kKeptKV;
}

// A block's shared memory: the clouds, then two h buffers of four pass
// vectors (four whatever debias says, so the route does not depend on it),
// every array on a 16-byte boundary. A kept lane reads its h entries
// 4 lane + 128 k + c for k < kKeptKV, so a pass's vector spans 128 kKeptKV
// floats there, zero past its columns.
inline void wide_layout(int P, int T, int kept, WidePlan& pl) {
  const int PA = (P + 3) & ~3, TA = (T + 3) & ~3;
  pl.cloud[0] = 0;
  pl.cloud[1] = PA;
  pl.cloud[2] = 2 * PA;
  pl.cloud[3] = 2 * PA + TA;
  int off = 0;
  for (int p = 0; p < 4; ++p) {
    pl.hoff[p] = off;
    off += kept ? 128 * kKeptKV : (pass_cols(p, P, T) + 3) & ~3;
  }
  pl.h0 = 2 * (PA + TA);
  pl.hbuf = off;
  pl.smem = 4LL * (pl.h0 + 2LL * pl.hbuf);
}

// The plan of N problems past 128 points. live(cs, kept) is how many
// clusters of cs blocks of that kernel the device runs at once (0 where it
// runs none, or refuses the size). The cluster size is the smallest of the
// fastest: kept costs need a warp for each chunk, streamed rows at most
// 8 kMaxPotRegs batches a warp; the time is the rounds of clusters over N
// times, kept, one chunk (the same work on every warp at any size), or,
// streamed, the batches a block runs (its SM's issue slots bound them).
// Whether the clouds and h buffers fit one block's shared memory (optin
// bytes): the cluster route, else the global route.
inline bool cluster_fits(int P, int T, long long optin) {
  WidePlan lay = {};
  wide_layout(P, T, 0, lay);
  return lay.smem <= optin;
}

template <class Live>
WidePlan wide_plan(int N, int P, int T, int debias, long long optin, Live live) {
  WidePlan pl = {};
  pl.route = cluster_fits(P, T, optin) ? 3 : 2;
  if (pl.route != 3) return pl;
  const int npass = debias ? 4 : 2, rows = npass / 2 * (P + T);
  for (int kept = keeps_costs(P, T) ? 1 : 0; kept >= 0; --kept) {
    wide_layout(P, T, kept, pl);
    pl.kept = kept;
    long long best = -1;
    for (int cs = 1; cs <= 16; ++cs) {
      const int n_live = live(cs, kept);
      const int warps = cs * kPlanWarps, slots = stream_slots(rows);
      if (n_live < 1 || (kept ? kept_chunks(P, T, npass) > warps
                              : (slots + warps - 1) / warps > 8 * kMaxPotRegs))
        continue;
      // kept: a warp's chunk a round; streamed: a block's batches a round
      const long long cost =
          (long long)((N + n_live - 1) / n_live) * (kept ? 1 : (slots + cs - 1) / cs);
      if (best < 0 || cost < best) {
        best = cost;
        pl.cs = cs;
        pl.ncl = N < n_live ? N : n_live;
      }
    }
    if (best >= 0) break;
  }
  // streamed: one potential register a lane up to 8 batches a warp, else 8
  const int warps = pl.cs * kPlanWarps;
  pl.pr = pl.cs > 0 && !pl.kept && (stream_slots(rows) + warps - 1) / warps > 8 ? kMaxPotRegs : 1;
  return pl;   // cs = 0: no cluster size runs; the launch reports it
}

// plan end

// The problems' clouds in SoA form and their log-weights as h buffer 0.
__device__ __forceinline__ void load_problem(float* sm, const WidePlan& pl, const Problem& pr,
                                             int n, int npass) {
  const int P = pr.P, T = pr.T;
  const float* xn = pr.x + (size_t)n * 2 * P;
  const float* yn = pr.y + (size_t)n * 2 * T;
  for (int j = threadIdx.x; j < P; j += kThreads) {
    sm[pl.cloud[0] + j] = xn[2 * j];
    sm[pl.cloud[1] + j] = xn[2 * j + 1];
  }
  for (int j = threadIdx.x; j < T; j += kThreads) {
    sm[pl.cloud[2] + j] = yn[2 * j];
    sm[pl.cloud[3] + j] = yn[2 * j + 1];
  }
  for (int p = 0; p < npass; ++p) {
    const bool col_y = p == 0 || p == 3;
    const float* w = col_y ? pr.b_log + (size_t)n * T : pr.a_log + (size_t)n * P;
    float* hp = sm + pl.h0 + pick4(pl.hoff, p);
    for (int j = threadIdx.x; j < (col_y ? T : P); j += kThreads) hp[j] = w[j];
  }
}

__device__ __forceinline__ float* pass_out(const Problem& pr, int pass, int n) {
  return pass == 0 ? pr.b_x + (size_t)n * pr.P : pass == 1 ? pr.a_y + (size_t)n * pr.T
       : pass == 2 ? pr.a_x + (size_t)n * pr.P : pr.b_y + (size_t)n * pr.T;
}

// The row's next h entry (column i of the pass it feeds) into h buffer
// `buf` of every block of the cluster.
__device__ __forceinline__ void broadcast_h(cg::cluster_group& cluster, float* hb,
                                            const WidePlan& pl, int buf, int pass, int i,
                                            float v) {
  const int feed = pass == 0 ? 1 : pass == 1 ? 0 : pass;
  float* dst = hb + buf * pl.hbuf + pick4(pl.hoff, feed) + i;
  for (int r = 0; r < pl.cs; ++r) *cluster.map_shared_rank(dst, r) = v;
}

__device__ __forceinline__ float4 ld4(const float* a, int q) {
  return reinterpret_cast<const float4*>(a)[q];
}

// Eight rows' lane values a[r] (lane l holds reference lane l's) reduced
// over the warp with op, transposed: each step halves the rows a lane
// keeps and trades the others with its partner, so lane l ends with the
// total of row (l >> 2) & 7 after 9 shuffles (8 x 5 one row at a time).
// Each addition pairs the same two partial sums as the reference's
// shuffle-down tree (offsets 16, 8, 4, 2, 1), the lower position's first or
// the other way round, which rounds the same; every lane of a row's four
// ends with the same bits.
template <class Op>
__device__ __forceinline__ float transposed_reduce8(const float (&a)[8], Op op) {
  const int l = threadIdx.x % kLanes;
  const bool h16 = l & 16, h8 = l & 8, h4 = l & 4;
  float b[4], c[2];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    b[k] = op(h16 ? a[k + 4] : a[k], __shfl_xor_sync(0xffffffffu, h16 ? a[k] : a[k + 4], 16));
#pragma unroll
  for (int k = 0; k < 2; ++k)
    c[k] = op(h8 ? b[k + 2] : b[k], __shfl_xor_sync(0xffffffffu, h8 ? b[k] : b[k + 2], 8));
  float d = op(h4 ? c[1] : c[0], __shfl_xor_sync(0xffffffffu, h4 ? c[0] : c[1], 4));
  d = op(d, __shfl_xor_sync(0xffffffffu, d, 2));
  return op(d, __shfl_xor_sync(0xffffffffu, d, 1));
}

// Kept costs: warp g of the cluster takes the kKeptRW = 8 rows of chunk g
// (kept_chunk), computes their costs once a problem and keeps them in
// registers for the whole schedule (lane l: columns 4 l + 128 k + c, +inf
// past the row's count, which then adds exp(-inf) = 0 exactly; the
// reference's order at shift 0: accumulator c takes the columns 4 q + c of
// the vectors q = l, l + 32, ...). An eps step loads the pass's h entries
// once for the eight rows, sweeps them for the lane maxima, reduces those
// transposed, sweeps again for the sums and reduces those transposed, so
// lane 4 r ends with row r's log-sum-exp and keeps its potential; the
// eight new h entries go to every block of the cluster as two 16-byte
// stores a block. One launch runs every problem and every eps step.
template <int PK, int KV>
__global__ void __launch_bounds__(kThreads, 1)
k1_cluster_kept(Problem pr, Sched s, WidePlan pl, int N) {
  constexpr int RW = kKeptRW;
  static_assert(RW == 8 && RW * KV * 4 <= kKeptRegs, "eight rows a warp, kept costs a lane");
  extern __shared__ __align__(16) float csm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int P = pr.P, T = pr.T, tid = threadIdx.x, lane = tid % kLanes;
  const int npass = pr.debias ? 4 : 2;
  int pass;
  const int i0 = kept_chunk((int)cluster.block_rank() * kWarps + tid / kLanes, P, T, npass,
                            &pass);
  const int R = pass_rows(pass, P, T), M = pass_cols(pass, P, T);
  const bool row_x = pass % 2 == 0, col_y = pass == 0 || pass == 3;
  const int feed = pass == 0 ? 1 : pass == 1 ? 0 : pass;
  const int my_row = i0 + lane / 4;                            // lane 4 r: row r's potential
  const bool mine = i0 >= 0 && lane % 4 == 0 && my_row < R;
  float* hb = csm + pl.h0;
  const float *rx = csm + pick4(pl.cloud, row_x ? 0 : 2), *ry = csm + pick4(pl.cloud, row_x ? 1 : 3);
  const float *cx = csm + pick4(pl.cloud, col_y ? 2 : 0), *cy = csm + pick4(pl.cloud, col_y ? 3 : 1);
  const int h_in = pick4(pl.hoff, pass), h_out = pick4(pl.hoff, feed);
  // the pads past each pass's columns, read with +inf costs, stay zero (a
  // chunk's rows past its pass write zeros there)
  for (int j = tid; j < 2 * pl.hbuf; j += kThreads) hb[j] = 0.f;
  cluster.sync();   // every block of the cluster runs before any writes into it
  for (int n = (int)(blockIdx.x / pl.cs); n < N; n += pl.ncl) {
    load_problem(csm, pl, pr, n, npass);
    if (cluster.block_rank() == 0 && !pr.debias) zero_self_potentials(pr, n);
    __syncthreads();
    float C[RW][KV][4];
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int q = lane + kLanes * k;   // 16-byte loads: no bank conflicts
      const bool cols = 4 * q < M;       // M % 4 == 0: a vector is whole or past the row
      const float4 X = cols ? ld4(cx, q) : float4{}, Y = cols ? ld4(cy, q) : float4{};
      const float xs[4] = {X.x, X.y, X.z, X.w}, ys[4] = {Y.x, Y.y, Y.z, Y.w};
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const bool on = i0 >= 0 && i0 + r < R && cols;
        const float px = on ? rx[i0 + r] : 0.f, py = on ? ry[i0 + r] : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          C[r][k][c] = on ? cost<PK>(__fsub_rn(px, xs[c]), __fsub_rn(py, ys[c]), pr.p) : INFINITY;
      }
    }
    const float logw = mine ? (row_x ? pr.a_log[(size_t)n * P + my_row]
                                     : pr.b_log[(size_t)n * T + my_row]) : 0.f;
    float pot = 0.f;
    float inv = s.inv(0);
    for (int e = 0; e < s.n; ++e) {
      const Step t = step_at(s, e);
      if (i0 >= 0) {
        const float* h = hb + (e & 1) * pl.hbuf + h_in;
        float4 hv[KV];
#pragma unroll
        for (int k = 0; k < KV; ++k) hv[k] = ld4(h, lane + kLanes * k);
        float hs[KV][4];
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          hs[k][0] = hv[k].x;
          hs[k][1] = hv[k].y;
          hs[k][2] = hv[k].z;
          hs[k][3] = hv[k].w;
        }
        float part[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          float mx0 = -INFINITY, mx1 = -INFINITY;   // two chains; max is exact in any order
#pragma unroll
          for (int k = 0; k < KV; ++k)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float m = __fsub_rn(hs[k][c], __fmul_rn(C[r][k][c], inv));
              if (c % 2) mx1 = fmaxf(mx1, m);
              else mx0 = fmaxf(mx0, m);
            }
          part[r] = fmaxf(mx0, mx1);
        }
        const float row_mx = transposed_reduce8(part, [](float u, float v) { return fmaxf(u, v); });
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float mx = __shfl_sync(0xffffffffu, row_mx, 4 * r);
          float v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            v[c] = 0.f;
#pragma unroll
            for (int k = 0; k < KV; ++k) {
              const float m = __fsub_rn(hs[k][c], __fmul_rn(C[r][k][c], inv));
              v[c] = k ? __fadd_rn(v[c], expf(__fsub_rn(m, mx))) : expf(__fsub_rn(m, mx));
            }
          }
          part[r] = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), v[2]), v[3]);
        }
        const float sum = transposed_reduce8(part, [](float u, float v) { return __fadd_rn(u, v); });
        float hn = 0.f;   // the row's next h entry; zero past the pass's rows
        if (mine) {
          pot = update(t, __fadd_rn(logf(sum), row_mx), pot);
          hn = __fadd_rn(logw, __fmul_rn(pot, t.inv_next));
        }
        if (t.more) {
          // lane 2 b + q: rows 4 q .. 4 q + 3 into block b
          const int q = lane & 1;
          float4 w;
          w.x = __shfl_sync(0xffffffffu, hn, 16 * q);
          w.y = __shfl_sync(0xffffffffu, hn, 16 * q + 4);
          w.z = __shfl_sync(0xffffffffu, hn, 16 * q + 8);
          w.w = __shfl_sync(0xffffffffu, hn, 16 * q + 12);
          if (lane < 2 * pl.cs) {
            float4* dst =
                reinterpret_cast<float4*>(hb + ((e + 1) & 1) * pl.hbuf + h_out + i0) + q;
            *cluster.map_shared_rank(dst, lane / 2) = w;
          }
        }
      }
      cluster.sync();
      inv = t.inv_next;
    }
    if (mine) pass_out(pr, pass, n)[my_row] = pot;
  }
}

// Component i of the 8 floats (a, b).
__device__ __forceinline__ float comp8(const float4& a, const float4& b, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : i == 3 ? a.w
       : i == 4 ? b.x : i == 5 ? b.y : i == 6 ? b.z : b.w;
}

// The reference lanes' sums of a row of M >= 128 columns whose first HD
// columns come before a 16-byte boundary (HD = 4 - shift, or 0): lane l's
// head column, then its vectors q = l, l + 32, ... (columns HD + 4 q + c,
// read as components HD + c of the aligned vectors q and q + 1: 16-byte
// loads, no bank conflicts), then its tail column; accumulator c takes
// component c; the four added in order. Lane sub of a group of G plays
// the reference lanes sub + G qq, their vectors side by side.
template <int HD, int G, class E>
__device__ __forceinline__ void lane_sums(const float* cx, const float* cy, const float* h,
                                          int M, E e_of, float (&sums)[kLanes / G]) {
  constexpr int Q = kLanes / G;
  const int sub = threadIdx.x % G;
  const int end = M - HD, nvec = end / 4, tail = 4 * nvec;
  float acc[Q][4];
#pragma unroll
  for (int qq = 0; qq < Q; ++qq) {
    const int l = sub + G * qq, j = l - (4 - HD);
    acc[qq][0] = HD && l < 4 && j >= 0 ? e_of(cx[j], cy[j], h[j]) : 0.f;
    acc[qq][1] = acc[qq][2] = acc[qq][3] = 0.f;
  }
  for (int k = 0; sub + kLanes * k < nvec; ++k) {
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) {
      const int q = sub + G * qq + kLanes * k;
      if (q < nvec) {
        const float4 X = ld4(cx, q), Y = ld4(cy, q), H = ld4(h, q);
        const float4 X2 = HD ? ld4(cx, q + 1) : X, Y2 = HD ? ld4(cy, q + 1) : Y,
                     H2 = HD ? ld4(h, q + 1) : H;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[qq][c] = __fadd_rn(acc[qq][c], e_of(comp8(X, X2, HD + c), comp8(Y, Y2, HD + c),
                                                  comp8(H, H2, HD + c)));
      }
    }
  }
#pragma unroll
  for (int qq = 0; qq < Q; ++qq) {
    const int j = HD + tail + sub + G * qq;
    if (j < M) acc[qq][0] = __fadd_rn(acc[qq][0], e_of(cx[j], cy[j], h[j]));
    sums[qq] = __fadd_rn(__fadd_rn(__fadd_rn(acc[qq][0], acc[qq][1]), acc[qq][2]), acc[qq][3]);
  }
}

// The log-sum-exp of a row (px, py) over the M columns (cx, cy) with h
// vector h, by a group of G lanes (all lanes of the warp take part, a
// group without a row (on false) on junk): lane sub of the group plays the
// reference lanes l = sub + G q, q < 32 / G, each with row_lse's columns
// and accumulators, folds their sums through the reference tree's offsets
// 16 .. G in registers and shuffles the rest. Every lane of the group
// returns the same bits.
template <int PK, int G>
__device__ __forceinline__ float group_lse(float px, float py, const float* cx, const float* cy,
                                           const float* h, int M, int shift, float inv, float p,
                                           bool on) {
  constexpr int Q = kLanes / G;
  const int sub = threadIdx.x % G;
  auto m_of = [&](float x, float y, float hh) {
    return __fsub_rn(hh, __fmul_rn(cost<PK>(__fsub_rn(px, x), __fsub_rn(py, y), p), inv));
  };
  // the max in any order (it is exact): vectors first, then the ragged end
  float mx0 = -INFINITY, mx1 = -INFINITY;
  if (on) {
    for (int q = sub; 4 * q + 3 < M; q += G) {
      const float4 X = ld4(cx, q), Y = ld4(cy, q), H = ld4(h, q);
      mx0 = fmaxf(mx0, m_of(X.x, Y.x, H.x));
      mx1 = fmaxf(mx1, m_of(X.y, Y.y, H.y));
      mx0 = fmaxf(mx0, m_of(X.z, Y.z, H.z));
      mx1 = fmaxf(mx1, m_of(X.w, Y.w, H.w));
    }
    for (int j = (M & ~3) + sub; j < M; j += G) mx0 = fmaxf(mx0, m_of(cx[j], cy[j], h[j]));
  }
  const float mx = group_max<G / 2>(fmaxf(mx0, mx1));
  auto e_of = [&](float x, float y, float hh) { return expf(__fsub_rn(m_of(x, y, hh), mx)); };
  float sums[Q];
#pragma unroll
  for (int qq = 0; qq < Q; ++qq) sums[qq] = 0.f;
  if (on && M < 128) {
    // lane l: columns l, l + 32, l + 64, l + 96 into one accumulator
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int qq = 0; qq < Q; ++qq) {
        const int j = sub + G * qq + kLanes * k;
        if (j < M) sums[qq] = __fadd_rn(sums[qq], e_of(cx[j], cy[j], h[j]));
      }
  } else if (on) {
    switch (shift) {
      case 0: lane_sums<0, G>(cx, cy, h, M, e_of, sums); break;
      case 1: lane_sums<3, G>(cx, cy, h, M, e_of, sums); break;
      case 2: lane_sums<2, G>(cx, cy, h, M, e_of, sums); break;
      default: lane_sums<1, G>(cx, cy, h, M, e_of, sums); break;
    }
  }
  fold<Q / 2>(sums);
  return __fadd_rn(logf(group_sum<G / 2>(sums[0])), mx);
}

// Streamed rows: warp g of the cluster takes the slots g, g + W, ... (W =
// cs * 16; slot_row), a batch of kStreamRows rows at a time, one a group
// of kStreamG lanes, with costs recomputed from the SoA clouds in both
// sweeps; in its b-th batch, group grp's lane b % 8 keeps the row's
// potential in register b / 8 (so b < 8 PR). One launch runs every problem
// and every eps step.
template <int PK, int PR>
__global__ void __launch_bounds__(kThreads, 1)
k1_cluster_streamed(Problem pr, Sched s, WidePlan pl, int N) {
  constexpr int G = kStreamG;
  extern __shared__ __align__(16) float csm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int P = pr.P, T = pr.T, lane = threadIdx.x % kLanes;
  const int grp = lane / G, sub = lane % G;
  const int npass = pr.debias ? 4 : 2, rows = npass / 2 * (P + T), slots = stream_slots(rows);
  const int W = pl.cs * kWarps;
  const int g = (int)cluster.block_rank() * kWarps + threadIdx.x / kLanes;
  float* hb = csm + pl.h0;
  // the row of this lane's k-th potential register (batch k * 8 + sub)
  auto owned = [&](int k) { return slot_row(g + (k * G + sub) * W, grp); };
  cluster.sync();   // every block of the cluster runs before any writes into it
  for (int n = (int)(blockIdx.x / pl.cs); n < N; n += pl.ncl) {
    load_problem(csm, pl, pr, n, npass);
    if (cluster.block_rank() == 0 && !pr.debias) zero_self_potentials(pr, n);
    __syncthreads();
    float pot[PR], logw[PR];
#pragma unroll
    for (int k = 0; k < PR; ++k) {
      const int f = owned(k);
      int pass;
      const int i = split_row(f < rows ? f : 0, P, T, &pass);
      pot[k] = 0.f;
      logw[k] = f >= rows ? 0.f : pass % 2 == 0 ? pr.a_log[(size_t)n * P + i]
                                                : pr.b_log[(size_t)n * T + i];
    }
    float inv = s.inv(0);
    for (int e = 0; e < s.n; ++e) {
      const Step t = step_at(s, e);
      const float* h = hb + (e & 1) * pl.hbuf;
      for (int b = 0, sl = g; sl < slots; ++b, sl += W) {
        const int f = slot_row(sl, grp);
        const bool on = f < rows;
        int pass;
        const int i = split_row(on ? f : 0, P, T, &pass);
        const bool row_x = pass % 2 == 0, col_y = pass == 0 || pass == 3;
        const int R = pass_rows(pass, P, T), M = pass_cols(pass, P, T);
        // the row's place in the plain version's (N, R, M) exp tensor
        const int shift = (int)((((size_t)n * R + i) & 3) * (M & 3) & 3);
        const float lse = group_lse<PK, G>(
            csm[pick4(pl.cloud, row_x ? 0 : 2) + i], csm[pick4(pl.cloud, row_x ? 1 : 3) + i],
            csm + pick4(pl.cloud, col_y ? 2 : 0), csm + pick4(pl.cloud, col_y ? 3 : 1),
            h + pick4(pl.hoff, pass), M, shift, inv, pr.p, on);
        if (on && sub == b % G) {
#pragma unroll
          for (int k = 0; k < PR; ++k)
            if (k == b / G) {
              pot[k] = update(t, lse, pot[k]);
              if (t.more)
                broadcast_h(cluster, hb, pl, (e + 1) & 1, pass, i,
                            __fadd_rn(logw[k], __fmul_rn(pot[k], t.inv_next)));
            }
        }
      }
      cluster.sync();
      inv = t.inv_next;
    }
#pragma unroll
    for (int k = 0; k < PR; ++k) {
      const int f = owned(k);
      if (f < rows) {   // a slot past the last one has rows past the problem's
        int pass;
        const int i = split_row(f, P, T, &pass);
        pass_out(pr, pass, n)[i] = pot[k];
      }
    }
  }
}

enum Route { kSmall, kShared, kGlobal, kCluster };

size_t wide_smem(int P, int T) { return sizeof(float) * 6 * ((size_t)P + T); }

using ClusterKernel = void (*)(Problem, Sched, WidePlan, int);

ClusterKernel cluster_kernel(float p, int kept, int pr) {
  if (kept) return p == 2.f ? k1_cluster_kept<2, kKeptKV>
                 : p == 1.f ? k1_cluster_kept<1, kKeptKV> : k1_cluster_kept<0, kKeptKV>;
  if (pr == 1) return p == 2.f ? k1_cluster_streamed<2, 1>
                    : p == 1.f ? k1_cluster_streamed<1, 1> : k1_cluster_streamed<0, 1>;
  return p == 2.f ? k1_cluster_streamed<2, kMaxPotRegs>
       : p == 1.f ? k1_cluster_streamed<1, kMaxPotRegs> : k1_cluster_streamed<0, kMaxPotRegs>;
}

// A kernel's shared memory and cluster-size attributes.
cudaError_t cluster_attributes(ClusterKernel kernel, long long smem, int cs) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess && cs > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

cudaLaunchConfig_t cluster_config(int blocks, long long smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr, int cs) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of cs blocks of the kernel the current device runs at
// once (cudaOccupancyMaxActiveClusters; 0 where it refuses the size),
// cached per device, kernel, size and shared memory.
int live_clusters(ClusterKernel kernel, int cs, long long smem) {
  static std::mutex mu;
  static std::map<std::tuple<int, uintptr_t, int, long long>, int> cache;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const auto key = std::make_tuple(dev, reinterpret_cast<uintptr_t>(kernel), cs, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  int n = 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cs, smem, nullptr, attr, cs);
  if (cluster_attributes(kernel, smem, cs) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    (void)cudaGetLastError();   // the query's error, not a launch's
    n = 0;
  }
  cache[key] = n;
  return n;
}

// The shared memory a block of the current device can opt in to.
bool smem_optin(int* optin) {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess &&
         cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) ==
             cudaSuccess;
}

WidePlan device_plan(int N, int P, int T, int debias, float p) {
  int optin = 0;
  if (!smem_optin(&optin)) {
    WidePlan pl = {};
    pl.route = kGlobal;
    return pl;
  }
  return wide_plan(N, P, T, debias, optin, [&](int cs, int kept) {
    WidePlan lay = {};
    wide_layout(P, T, kept, lay);
    return live_clusters(cluster_kernel(p, kept, 1), cs, lay.smem);
  });
}

// The route of N problems of P and T points (see the header). Built with
// -DK1_WIDE_ROUTE=1 (shared), 2 (global) or 3 (cluster), the route past
// 128 points is pinned where the clouds fit one block's shared memory, for
// bench_k1.py to time all three.
Route route(int N, int P, int T) {
  if (P <= kSmallPts && T <= kSmallPts) return kSmall;
  int optin = 0;
  if (!smem_optin(&optin) || !cluster_fits(P, T, optin)) return kGlobal;
#ifdef K1_WIDE_ROUTE
  if (K1_WIDE_ROUTE == 1 && wide_smem(P, T) <= (size_t)optin) return kShared;
  if (K1_WIDE_ROUTE == 2) return kGlobal;
#endif
  return kCluster;
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

// The route sinkhorn_potentials takes at (N, P, T): 0 small (k1_kept /
// k1_streamed), 1 shared, 2 global, 3 cluster; -1 for sizes it refuses.
extern "C" int sinkhorn_potentials_route(int N, int P, int T) {
  if (N < 1 || P < 1 || T < 1) return -1;
  return (int)route(N, P, T);
}

// The cluster route's plan at (N, P, T, debias, p) into out[5]: cluster
// size, clusters launched, kept costs (1) or streamed rows (0), potential
// registers a lane, shared memory bytes. Returns 0, or -1 where the route
// is not the cluster route.
extern "C" int sinkhorn_potentials_plan(int N, int P, int T, int debias, float p, int* out) {
  if (N < 1 || P < 1 || T < 1 || route(N, P, T) != kCluster) return -1;
  const WidePlan pl = device_plan(N, P, T, debias, p);
  const int v[5] = {pl.cs, pl.ncl, pl.kept, pl.pr, (int)pl.smem};
  for (int k = 0; k < 5; ++k) out[k] = v[k];
  return 0;
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
  if (rt == kCluster) {
    const WidePlan pl = device_plan(N, P, T, debias, p);
    if (pl.cs < 1) return (int)cudaErrorInvalidConfiguration;   // no cluster size runs
    const ClusterKernel kernel = cluster_kernel(p, pl.kept, pl.pr);
    cudaError_t e = cluster_attributes(kernel, pl.smem, pl.cs);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(pl.cs * pl.ncl, pl.smem, st, attr, pl.cs);
    e = cudaLaunchKernelEx(&cfg, kernel, pr, s, pl, N);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
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
