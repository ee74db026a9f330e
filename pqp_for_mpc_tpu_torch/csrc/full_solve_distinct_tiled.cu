// K6: the whole PQP solve for DISTINCT instances too large for K5, in one
// launch, each instance's Hessian read from device memory once and kept, as
// far as it fits, in the shared memory of the blocks that solve it.
//
// Replaces the TPU kernel pqp_for_mpc_tpu/ops/distinct_tiled_kernel.py:
// fused_full_solve_distinct_tiled (its Pallas body _kernel): for each
// instance rounds of one check pass (Y'Qd_hat for the costs and the gap,
// Y'Gp for U = -Qp^-1 (Gp'Y + Fp), then the Gp rows for feasibility; the
// explicit or the complementarity gap), check_every update sweeps on
// Qd_hat = Qd with diagonal max(diag, 0) + theta (the splits rebuilt by
// relu), the safeguarded accel step at the check cadence (three more
// passes), the stall freeze over the whole round (updates and accel) and
// the final check.  A certified instance keeps its at-check iterate.
//
// What bounds it on an H100.  Read once, the inputs of a whole solve are
// small beside its thousands of updates, so the least time for the function
// is its float32 operations.  An instance's Qd_hat is n^2 x 4 bytes (16.8 MB
// at n = 2048); eight of them exceed the 50 MB L2, so a design that reads
// them from device memory on every pass (the previous one: one cluster of
// 16 blocks per instance) is held to 40 us per update.
//
// Design.  A cooperative persistent launch (one block of 512 threads per
// SM) whose blocks form `slots` groups of `per_inst` blocks; a slot solves
// instances slot, slot + slots, ... one after the other, so when an
// instance certifies its blocks take the next one.  A block copies its
// rows of Qd_hat into shared memory once per instance (cp.async) as far as
// they fit, and every update, check and accel pass reads them from there;
// the rows past its shared memory, and Gp, Qp and Qp^-1 at the check
// cadence, come from global memory and L2.  The plan (ops/
// distinct_tiled_kernel.py: k6_plan) picks the layout: at n = 2048,
// m = 512 two instances side by side, each over 66 SMs with 19 of a
// block's 32 rows resident.  Each block keeps full copies of y, the accel
// vectors and U; new rows travel through an exchange buffer in global
// memory (two alternating halves, so one barrier per exchange suffices)
// and a slot's barrier is an arrival counter in global memory (release,
// then acquire).  So what holds it above its floor is latency, not bytes:
// a barrier and an L2 round trip per update, and the check's and accel
// step's chains of barriers and reductions; instances side by side share
// those waits.
// Every instance sum keeps the previous design's float32 order: row dots
// are one warp per row as before (dist::warp_row_dot), and every scalar
// and every column of Gp'y is summed over the previous design's 16 row
// ranges (its blocks per instance) in its thread order, then over the
// ranges in order, whichever block owns a row: each block computes the
// scalars redundantly from the exchanged rows, so every block of a slot
// takes the same branches, and a relaunch repeats every bit.  A launch the
// card refuses (cooperative residency, shared memory) raises in the
// wrapper; there is no fallback.
//
// Semantics match pqp_for_mpc_tpu_torch/ops/distinct_tiled_kernel.py:
// fused_full_solve_distinct_tiled_reference up to float32 summation order.
// Lane codes as K1's (0 max_iters, 1 certified, 2 stalled).

#include <cuda_runtime.h>

#include "distinct_common.cuh"
#include "pqp_common.cuh"

namespace pqp {
namespace k6 {

constexpr int kK6Threads = 512;
constexpr int kK6Warps = kK6Threads / 32;
constexpr int kK6MaxRanks = 16;  // the previous design's blocks per instance
constexpr int kK6MaxK = 3;       // values of one rank-ordered reduction

struct K6Args {
  const float *qh, *theta, *gp;        // (B, n, n), (B, n), (B, n, m)
  long long gp_stride;                 // instance stride of gp (0 = shared)
  const float *qp, *qpi;               // (B, m, m) or shared
  long long qp_stride;
  const float *fp, *fd, *fdp, *fdn, *kps, *mp, *md, *y0;  // (B, len)
  float *y_out, *u_out;                // (B, n), (B, m)
  int *iters_out, *state_out;          // (B)
  float* xch;                          // per slot: two halves of ldx floats
  unsigned* arrive;                    // per slot: arrivals, 0 at launch
  int n, m, B, max_iters, check_every, accel;
  float eaj, erj;
  int strict;
  float den_eps;
  int gap_comp;
  int per_inst, slots, resident, staged, ranks, ldx;
};

// Shared memory of one block, in floats: its resident rows of Qd_hat; y, p,
// yn, y at the check, Fd (n each); t, U, Fp (m each); when staged, the
// exchanged rows a reduction reads (2 n + m); theta, Fd^-, Fd^+, Kp_slack
// and the accel gradient on its own rows; reductions; the ranks' first rows
// of n and of m.
__host__ __device__ inline size_t k6_smem_floats(int n, int m, int per_inst,
                                                 int resident, int staged) {
  const int rows = (n + per_inst - 1) / per_inst;
  return (size_t)round4(resident * n) +
         (staged ? 7 : 5) * (size_t)round4(n) +
         (staged ? 4 : 3) * (size_t)round4(m) + 5 * (size_t)round4(rows) +
         kK6MaxRanks * kK6MaxK * (kK6Warps + 1) + kK6MaxK +
         2 * (kK6MaxRanks + 4);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// One block's part of the instance its slot solves.
struct Part {
  int n, m, P, rank, L, r0, rows, m0, mrows, res;
  bool vq, vg;
  const float *qb, *gpb, *qpb, *qpib;  // this instance's matrices
  float* sq;                           // resident rows (shared), stride n
  float *y, *p, *yn, *yold, *fd, *t, *u, *fp;  // full vectors
  float* xb;                           // exchanged rows (staged), or null
  const float* xr;                     // the rows a reduction reads
  float *th, *fdn, *fdp, *kps, *gr;    // own rows
  float *red, *tot;
  int *ro_n, *ro_m;                    // rank r's rows: [ro[r], ro[r + 1])
  float* xch;
  int ldx;
  unsigned xc, gen;
  unsigned* arrive;
  float mp, md;

  __device__ __forceinline__ float* half() {
    return xch + (size_t)(xc & 1u) * ldx;
  }

  // Every block of the slot has written its part of the current half.
  __device__ __forceinline__ void barrier() {
    __syncthreads();
    if (threadIdx.x == 0) {
      ++gen;
      const unsigned target = gen * (unsigned)P;
      __threadfence();
      atomicAdd(arrive, 1u);
      while ((int)(ld_acquire(arrive) - target) < 0) {
      }
      __threadfence();
    }
    __syncthreads();
  }

  // Copy len floats of the current half into dst, then move to the other
  // half: it is written again only after the next barrier, which every
  // block passes after this read.
  __device__ __forceinline__ void gather(float* dst, int len) {
    const float* xs = half();
#pragma unroll 4
    for (int i = threadIdx.x; i < len; i += kK6Threads)
      dst[i] = __ldcg(xs + i);
    ++xc;
    __syncthreads();
  }

  // The exchanged rows of the current half, for a reduction: copied into
  // shared memory when the plan left room, else read from L2 in place.
  __device__ __forceinline__ void stage(int len) {
    if (xb) {
      gather(xb, len);
      xr = xb;
    } else {
      xr = half();
      ++xc;
    }
  }
  __device__ __forceinline__ float xv(int i) const {
    return xb ? xr[i] : __ldcg(xr + i);
  }

  // f(i, row) for the owned rows of Qd_hat, one warp each: resident rows
  // from shared memory, then the rest from global memory.
  template <class F>
  __device__ __forceinline__ void own_rows(F f) {
    const int warp = threadIdx.x >> 5;
    for (int i = warp; i < res; i += kK6Warps) f(i, sq + (size_t)i * n);
    for (int i = res + warp; i < rows; i += kK6Warps)
      f(i, qb + (long long)(r0 + i) * n);
  }

  // out(i) = (Qd x)_{r0+i}: the row dot with Qd_hat minus theta_i x_{r0+i}
  // (Qd with its diagonal clamped); f runs on lane 0.
  template <class F>
  __device__ __forceinline__ void qd_rows(const float* x, F f) {
    own_rows([&](int i, const float* row) {
      const float s = dist::warp_row_dot(row, x, n, vq);
      if ((threadIdx.x & 31) == 0) f(i, s - th[i] * x[r0 + i]);
    });
  }

  // Totals of K values over `total` rows (n or m) in the previous design's
  // order: rows split over L ranks (split_rows); in a rank, thread t of 512
  // takes rows t, t + 512, ..., each warp v of 16 sums its threads 32 v +
  // lane by the butterfly, then the warps in order, then the ranks in
  // order.  f(i, v) adds row i's terms to v.  Here the (rank, warp) pairs
  // that hold rows are dealt out to this block's warps in turn (lane l
  // computes that warp's thread 32 v + l), the others sum exact zeros.
  // Every block computes the same totals.
  template <int K, class F>
  __device__ __forceinline__ void rank_sums(const int* ro, F f,
                                            float (&out)[K]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int e = threadIdx.x; e < L * K * kK6Warps; e += kK6Threads)
      red[e] = 0.f;
    __syncthreads();
    int first = 0;  // pairs with rows in the ranks before r
    // rolled: sixteen inlined copies of f overflow the instruction cache
#pragma unroll 1
    for (int r = 0; r < L; ++r) {
      const int off = ro[r], cnt = ro[r + 1] - off;
      const int warps_r = min(kK6Warps, (cnt + 31) / 32);
      const int v = ((warp - first) % kK6Warps + kK6Warps) % kK6Warps;
      if (v < warps_r) {
        float s[K];
#pragma unroll
        for (int k = 0; k < K; ++k) s[k] = 0.f;
        for (int i = 32 * v + lane; i < cnt; i += kK6Threads) f(off + i, s);
#pragma unroll
        for (int k = 0; k < K; ++k) s[k] = dist::warp_sum(s[k]);
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < K; ++k) red[(r * K + k) * kK6Warps + v] = s[k];
        }
      }
      first += warps_r;
    }
    __syncthreads();
    // each (rank, value): its warps in order, one thread each; then each
    // value: the ranks in order
    float* part = tot + kK6MaxK;
    if (threadIdx.x < L * K) {
      const float* w = red + threadIdx.x * kK6Warps;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kK6Warps; ++k) acc += w[k];
      part[threadIdx.x] = acc;
    }
    __syncthreads();
    if (threadIdx.x < K) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < kK6MaxRanks; ++r)
        if (r < L) acc += part[r * K + threadIdx.x];
      tot[threadIdx.x] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = tot[k];
    __syncthreads();  // red and tot are free again
  }

  // One update: the owned rows into the exchange, then the whole new y.
  __device__ __forceinline__ void update(float den_eps) {
    float* xs = half();
    own_rows([&](int i, const float* row) {
      float neg, pos;
      dist::warp_row_relu_dots(row, y, n, vq, neg, pos);
      if ((threadIdx.x & 31) == 0) {
        const float yi = y[r0 + i];
        const float num = neg + th[i] * yi + fdn[i];
        const float den = guard_den(pos + fdp[i], den_eps);
        xs[r0 + i] = (num / den) * yi;
      }
    });
    barrier();
    gather(y, n);
  }

  // The four-part verdict at y (as the TPU kernels' check).  Leaves U in u.
  __device__ __forceinline__ bool check(const K6Args& a) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // Gp'y per column over each rank's rows, one thread per (rank, column)
    float* xs = half();
    for (int j = (warp * P + rank) * 32 + lane; j < L * m;
         j += P * kK6Threads) {
      const int r = j / m, k = j - r * m;
      const int off = ro_n[r], cnt = ro_n[r + 1] - off;
      const float* g = gpb + (long long)off * m + k;
      float acc = 0.f;
#pragma unroll 16
      for (int i = 0; i < cnt; ++i)
        acc = fmaf(g[(long long)i * m], y[off + i], acc);
      xs[j] = acc;
    }
    barrier();
    for (int k = threadIdx.x; k < m; k += kK6Threads) {
      float part[kK6MaxRanks];
#pragma unroll
      for (int r = 0; r < kK6MaxRanks; ++r)
        part[r] = r < L ? __ldcg(xs + r * m + k) : 0.f;
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < kK6MaxRanks; ++r)
        if (r < L) acc += part[r];
      t[k] = acc + fp[k];
    }
    ++xc;
    __syncthreads();
    // the owned rows of u = -Qp^-1 t, then all of u
    xs = half();
    for (int r = warp; r < mrows; r += kK6Warps) {
      const float v =
          dist::warp_row_dot(qpib + (long long)(m0 + r) * m, t, m, vg);
      if (lane == 0) xs[m0 + r] = -v;
    }
    barrier();
    gather(u, m);
    // own rows: violations of Gp u <= Kp_slack and Qd y; own m-rows: Qp u
    xs = half();
    for (int i = warp; i < rows; i += kK6Warps) {
      const float v =
          dist::warp_row_dot(gpb + (long long)(r0 + i) * m, u, m, vg);
      if (lane == 0) xs[n + r0 + i] = (v > kps[i]) ? 1.f : 0.f;
    }
    qd_rows(y, [&](int i, float v) { xs[r0 + i] = v; });
    for (int r = warp; r < mrows; r += kK6Warps) {
      const float v =
          dist::warp_row_dot(qpb + (long long)(m0 + r) * m, u, m, vg);
      if (lane == 0) xs[2 * n + m0 + r] = v;
    }
    barrier();
    stage(2 * n + m);
    float s[3], q[2];  // Y'Qd Y, Fd'Y, violations; U'Qp U, Fp'U
    rank_sums<3>(ro_n, [&](int i, float (&v)[3]) {
      const float yi = y[i];
      v[0] = fmaf(yi, xv(i), v[0]);
      v[1] = fmaf(fd[i], yi, v[1]);
      v[2] += xv(n + i);
    }, s);
    rank_sums<2>(ro_m, [&](int r, float (&v)[2]) {
      const float ur = u[r];
      v[0] = fmaf(ur, xv(2 * n + r), v[0]);
      v[1] = fmaf(fp[r], ur, v[1]);
    }, q);
    const float s1 = s[0], s2 = s[1];
    const float jd = 0.5f * s1 + s2 + 0.5f * md;
    const float jp = 0.5f * q[0] + q[1] + 0.5f * mp;
    float gap;
    bool weak_fail;
    if (a.gap_comp) {  // Jp(U(Y)) + Jd(Y) = Y'(Qd Y + Fd)
      gap = s1 + s2;
      weak_fail = gap > 0.f;
    } else {
      gap = jp + jd;
      weak_fail = jp > -jd;
    }
    bool fail = (s[2] > 0.f) || (gap > a.eaj) || (gap / fabsf(jd) > a.erj);
    if (a.strict) fail = fail || weak_fail;
    return !fail;
  }

  // The safeguarded projected-gradient step (solver.accel_step): three
  // passes of the owned rows of Qd.
  __device__ __forceinline__ void accel_step() {
    float* xs = half();
    qd_rows(y, [&](int i, float v) {
      const float yv = y[r0 + i];
      const float g = v + fd[r0 + i];
      gr[i] = g;
      xs[r0 + i] = (yv > 0.f || g < 0.f) ? -g : 0.f;
    });
    barrier();
    gather(p, n);
    xs = half();
    qd_rows(p, [&](int i, float v) {
      xs[r0 + i] = v;
      xs[n + r0 + i] = gr[i];
    });
    barrier();
    stage(2 * n);
    float a[3];  // p'Qd p, p'p, y'(grad + Fd)
    rank_sums<3>(ro_n, [&](int i, float (&v)[3]) {
      const float pi = p[i];
      v[0] = fmaf(pi, xv(i), v[0]);
      v[1] = fmaf(pi, pi, v[1]);
      v[2] = fmaf(y[i], xv(n + i) + fd[i], v[2]);
    }, a);
    const float alpha = (a[0] > 0.f) ? a[1] / fmaxf(a[0], 1e-30f) : 0.f;
    xs = half();
    for (int i = threadIdx.x; i < rows; i += kK6Threads)
      xs[r0 + i] = relu_nan(y[r0 + i] + alpha * p[r0 + i]);
    barrier();
    gather(yn, n);
    xs = half();
    qd_rows(yn, [&](int i, float v) { xs[r0 + i] = v; });
    barrier();
    stage(n);
    float b[2];  // yn'Qd yn, Fd'yn
    rank_sums<2>(ro_n, [&](int i, float (&v)[2]) {
      const float ynv = yn[i];
      v[0] = fmaf(ynv, xv(i), v[0]);
      v[1] = fmaf(fd[i], ynv, v[1]);
    }, b);
    if (0.5f * b[0] + b[1] <= 0.5f * a[2]) {
      float* tmp = y;
      y = yn;
      yn = tmp;
    }
  }
};

// The whole solve of instance b on this block's slot.
__device__ __forceinline__ void solve_instance(Part& S, const K6Args& a,
                                               int b) {
  const int n = S.n, m = S.m;
  const long long on = (long long)b * n, om = (long long)b * m;
  S.qb = a.qh + on * n;
  S.gpb = a.gp + b * a.gp_stride;
  S.qpb = a.qp + b * a.qp_stride;
  S.qpib = a.qpi + b * a.qp_stride;
  // the resident rows, once per instance
  const float* from = S.qb + (long long)S.r0 * n;
  const int count = S.res * n;
  if (S.vq) {
    for (int c = threadIdx.x; c < count / 4; c += kK6Threads)
      cp_async16(S.sq + 4 * c, from + 4 * c);
  } else {
    for (int c = threadIdx.x; c < count; c += kK6Threads)
      cp_async4(S.sq + c, from + c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = threadIdx.x; i < n; i += kK6Threads) {
    S.y[i] = a.y0[on + i];
    S.fd[i] = a.fd[on + i];
  }
  for (int k = threadIdx.x; k < m; k += kK6Threads) S.fp[k] = a.fp[om + k];
  for (int i = threadIdx.x; i < S.rows; i += kK6Threads) {
    const long long e = on + S.r0 + i;
    S.th[i] = a.theta[e];
    S.fdn[i] = a.fdn[e];
    S.fdp[i] = a.fdp[e];
    S.kps[i] = a.kps[e];
  }
  S.mp = a.mp[b];
  S.md = a.md[b];
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  int state = kActive, iters = 0;
  for (int h = 1;; h += a.check_every) {
    const bool ok = S.check(a);
    // certified here (the at-check iterate stays), out of iterations (the
    // final verdict), or stalled in the previous round
    if (state != kActive || h > a.max_iters || ok) {
      if (state == kActive) {
        iters = h;
        if (ok) state = kCertified;
      }
      break;
    }
    for (int i = threadIdx.x; i < n; i += kK6Threads) S.yold[i] = S.y[i];
    for (int j = 0; j < a.check_every; ++j) S.update(a.den_eps);
    if (a.accel) S.accel_step();
    // stall freeze: the round (updates and accel) left y bit-identical
    float diff[1];
    S.rank_sums<1>(S.ro_n, [&](int i, float (&v)[1]) {
      v[0] += fabsf(S.y[i] - S.yold[i]);
    }, diff);
    if (diff[0] == 0.f) {
      state = kStalled;
      iters = h + a.check_every;
    }
  }
  for (int i = threadIdx.x; i < S.rows; i += kK6Threads)
    a.y_out[on + S.r0 + i] = S.y[S.r0 + i];
  for (int r = threadIdx.x; r < S.mrows; r += kK6Threads)
    a.u_out[om + S.m0 + r] = S.u[S.m0 + r];
  if (S.rank == 0 && threadIdx.x == 0) {
    a.iters_out[b] = iters;
    a.state_out[b] = state;
  }
  __syncthreads();  // shared memory is loaded again for the next instance
}

__global__ void __launch_bounds__(kK6Threads, 1)
full_solve_distinct_tiled_kernel(const K6Args a) {
  extern __shared__ float4 smem4[];
  const int n = a.n, m = a.m, P = a.per_inst;
  const int slot = blockIdx.x / P;
  Part S;
  S.n = n;
  S.m = m;
  S.P = P;
  S.rank = blockIdx.x % P;
  S.L = a.ranks;
  split_rows(n, P, S.rank, S.r0, S.rows);
  split_rows(m, P, S.rank, S.m0, S.mrows);
  S.res = min(a.resident, S.rows);
  S.vq = (n % 4) == 0;
  S.vg = (m % 4) == 0;
  const int ldn = round4(n), ldm = round4(m);
  const int ldr = round4((n + P - 1) / P);
  float* s = reinterpret_cast<float*>(smem4);
  S.sq = s;
  s += round4(a.resident * n);
  S.y = s;
  S.p = S.y + ldn;
  S.yn = S.p + ldn;
  S.yold = S.yn + ldn;
  S.fd = S.yold + ldn;
  S.t = S.fd + ldn;
  S.u = S.t + ldm;
  S.fp = S.u + ldm;
  S.xb = a.staged ? S.fp + ldm : nullptr;
  S.th = S.fp + ldm + (a.staged ? 2 * ldn + ldm : 0);
  S.fdn = S.th + ldr;
  S.fdp = S.fdn + ldr;
  S.kps = S.fdp + ldr;
  S.gr = S.kps + ldr;
  S.red = S.gr + ldr;
  S.tot = S.red + kK6MaxRanks * kK6MaxK * kK6Warps;
  S.ro_n = reinterpret_cast<int*>(S.tot + kK6MaxRanks * kK6MaxK + kK6MaxK);
  S.ro_m = S.ro_n + kK6MaxRanks + 4;
  if (threadIdx.x <= S.L) {
    int off, cnt;
    split_rows(n, S.L, threadIdx.x, off, cnt);
    S.ro_n[threadIdx.x] = off;
    split_rows(m, S.L, threadIdx.x, off, cnt);
    S.ro_m[threadIdx.x] = off;
  }
  __syncthreads();
  S.xch = a.xch + (size_t)slot * 2 * a.ldx;
  S.ldx = a.ldx;
  S.xc = 0;
  S.gen = 0;
  S.arrive = a.arrive + slot;
  for (int b = slot; b < a.B; b += a.slots) solve_instance(S, a, b);
}

}  // namespace k6
}  // namespace pqp

// qh = Qd_hat (B, n, n) and theta (B, n); gp (B, n, m) with instance stride
// gp_stride (0 = shared); qp, qpi (B, m, m) with stride qp_stride.  Panels
// instance-major: fp (B, m); fd, fdp, fdn, kps, y0 (B, n); mp, md (B).
// Outputs: y_out (B, n), u_out (B, m), iters_out, state_out (B).  accel 0
// or 1 (at the check cadence).  The layout comes from the wrapper's plan
// (k6_plan): slots x per_inst blocks, resident rows per block, whether the
// reductions stage their rows in shared memory, the ranks of the sums'
// order; scratch xch (slots x 2 x ldx floats) and arrive (slots
// counters, zero).
extern "C" int full_solve_distinct_tiled_f32(
    const float* qh, const float* theta, const float* gp, long long gp_stride,
    const float* qp, const float* qpi, long long qp_stride, const float* fp,
    const float* fd, const float* fdp, const float* fdn, const float* kps,
    const float* mp, const float* md, const float* y0, float* y_out,
    float* u_out, int* iters_out, int* state_out, float* xch,
    unsigned* arrive, int n, int m, int B,
    int max_iters, int check_every, int accel, float eaj, float erj,
    int strict, float den_eps, int gap_comp, int per_inst, int slots,
    int resident, int staged, int ranks, int ldx, void* stream) {
  const int need = n + n + m > ranks * m ? n + n + m : ranks * m;
  if (n < 1 || m < 1 || B < 1 || check_every < 1 || per_inst < 1 ||
      per_inst > n || slots < 1 || resident < 0 || ranks < 1 ||
      ranks > pqp::k6::kK6MaxRanks || ranks > n || ldx < need)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      pqp::k6::k6_smem_floats(n, m, per_inst, resident, staged) *
      sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  pqp::k6::K6Args a = {};
  a.qh = qh; a.theta = theta; a.gp = gp; a.qp = qp; a.qpi = qpi;
  a.gp_stride = gp_stride; a.qp_stride = qp_stride;
  a.fp = fp; a.fd = fd; a.fdp = fdp; a.fdn = fdn; a.kps = kps;
  a.mp = mp; a.md = md; a.y0 = y0;
  a.y_out = y_out; a.u_out = u_out;
  a.iters_out = iters_out; a.state_out = state_out;
  a.xch = xch; a.arrive = arrive;
  a.n = n; a.m = m; a.B = B; a.max_iters = max_iters;
  a.check_every = check_every; a.accel = accel; a.eaj = eaj; a.erj = erj;
  a.strict = strict; a.den_eps = den_eps; a.gap_comp = gap_comp;
  a.per_inst = per_inst; a.slots = slots; a.resident = resident;
  a.staged = staged;
  a.ranks = ranks; a.ldx = ldx;
  const auto kernel = pqp::k6::full_solve_distinct_tiled_kernel;
  // the cooperative launch refuses a grid whose blocks cannot all be
  // resident at once
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(slots * per_inst), dim3(pqp::k6::kK6Threads),
      params, smem, static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}
