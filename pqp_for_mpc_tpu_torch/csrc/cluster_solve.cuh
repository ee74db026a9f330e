// The cluster body of K5 (full_solve_distinct.cu), the distinct-geometry
// whole solve for instances whose Qd rows fit a cluster's shared memory.
//
// One instance runs on a thread-block CLUSTER of C blocks.  Block rank r
// owns a contiguous range of the n rows (of Qd and of Gp) and of the m rows
// of Qp, Qp^-1 (split_rows), and keeps full copies of the instance's
// iterate y, the accel direction p and candidate yn, t = Gp'y + Fp and U in
// its shared memory.  After each sweep the blocks publish their new rows in
// shared memory and read each other's through distributed shared memory;
// cluster.sync() is the Jacobi barrier.  Exchange buffers alternate between
// two slots, so one cluster barrier per exchange suffices: a slot is
// written again only two exchanges later, after a barrier every reader has
// passed.  Per-instance scalars are block sums over the owned rows in fixed
// order, then the ranks' partials in rank order — the same in every block
// of the cluster, so all its blocks take the same branches and return
// together (the per-instance early exit), and a second launch repeats every
// bit.
//
// The update takes relu(+-Qd) off the diagonal (bit for bit the
// materialized splits' entries, dual.py) and the splits' own diagonals dn,
// dp, read once per instance: num = relu(-Qd)_off y + dn y + Fd^-,
// den = relu(Qd)_off y + dp y + Fd^+.  The owned rows of Qd are resident in
// shared memory, copied once per launch with cp.async and zero-padded to a
// multiple of 4 floats, where they fit, else read from global memory and
// L2; Gp, Qp and Qp^-1 are read from global memory and L2 at the check
// cadence in either case.  The gap is the explicit one; accel_every <
// check_every runs the accel step every accel_every updates.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "distinct_common.cuh"
#include "pqp_common.cuh"

namespace cg = cooperative_groups;

namespace pqp {

struct ClusterSolveArgs {
  const float* q;                      // Qd (B, n, n)
  const float *dn, *dp;                // the splits' diagonals (B, n)
  const float *gp, *qp, *qpi;          // (B, n, m), (B, m, m), or shared
  long long gp_stride, qp_stride;      // instance strides (0 = shared)
  const float *fp, *fd, *fdp, *fdn, *kps, *mp, *md, *y0;  // (B, len)
  float *y_out, *u_out;                // (B, n), (B, m)
  int *iters_out, *state_out;          // (B)
  int n, m, max_iters, check_every, accel_every;
  float eaj, erj;
  int strict;
  float den_eps;
  int resident;                        // Qd rows in shared memory
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Floats of one block's own-row vectors (rows of n or of m, whichever a
// rank owns more of) and of one exchange slot (a full m-vector of partial
// sums, a rank's rows, or eight scalars).
__host__ __device__ inline int own_ld(int n, int m, int C) {
  return round4((imax(n, m) + C - 1) / C);
}
__host__ __device__ inline int slot_ld(int n, int m, int C) {
  return round4(imax(imax(m, (n + C - 1) / C), 8));
}

// Shared memory of one block, in floats: the resident Qd rows, then y, p,
// yn (n); t, u (m); the own-row vectors (9 x own_ld): the split diagonals,
// fd, fdn, fdp, kps, y at the check, gradient or flags, row values; two
// exchange slots; block reductions and cluster totals.
__host__ __device__ inline size_t cluster_smem_floats(int n, int m, int C,
                                                      bool resident) {
  const size_t mat =
      resident ? (size_t)((n + C - 1) / C) * round4(n) : (size_t)0;
  return mat + 3 * (size_t)round4(n) + 2 * (size_t)round4(m) +
         9 * (size_t)own_ld(n, m, C) +
         2 * (size_t)slot_ld(n, m, C) + 8 * 32 + 8;
}

// Copy `rows` rows of `cols` floats (global row stride `cols`) into shared
// rows of stride round4(cols), zero-padded, with cp.async; the caller waits.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows, int cols) {
  const int ld = round4(cols), q = ld / 4;
  const bool vec = (cols % 4) == 0;
  for (int e = threadIdx.x; e < rows * q; e += blockDim.x) {
    const int r = e / q, c = 4 * (e % q);
    float* d = dst + (long long)r * ld + c;
    const float* s = src + (long long)r * cols + c;
    if (vec) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j < cols) cp_async4(d + j, s + j);
        else d[j] = 0.f;
      }
    }
  }
}

// This block's part of one instance.
struct Part {
  cg::cluster_group cl;
  // own rows of Qd, of Gp, of Qp and of Qp^-1: row i at
  // base + i * ld, dotted over ld entries (resident rows are zero-padded to
  // round4; global rows have ld = n or m and are read as float4 when vq/vg)
  const float *qrow, *grow, *prow, *pirow;
  int ldq, ldg;
  bool vq, vg;
  const float* fp;                      // (m), global
  float *y, *p, *yn;                    // full vectors (n)
  float *t, *u;                         // full vectors (m)
  float *th, *fd, *fdn, *fdp, *kps, *yold, *g, *w;  // own rows
  float* dp;                            // own rows (th holds dn)
  float* xch;                           // two exchange slots of ldx
  float *red, *tot;                     // block reductions, cluster totals
  int ldx, xc;                          // slot size, exchange counter
  int n, m, C, rank, r0, rows, m0, mrows;
  float mp, md;

  __device__ float* slot() { return xch + (xc & 1) * ldx; }

  // Every rank has written its `part` of `total` rows into its slot:
  // gather all of them into dst (full length), then move to the next slot.
  // Each thread reads its own entries from the owning ranks, one
  // distributed-shared-memory load each, all in flight at once.
  __device__ void gather(float* dst, int total) {
    float* s = slot();
    cl.sync();
    const int base = total / C, rem = total % C;
    const int edge = rem * (base + 1);  // rows of the ranks with one more
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      int q, off;
      if (i < edge) {
        q = i / (base + 1);
        off = i - q * (base + 1);
      } else {
        q = rem + (i - edge) / base;
        off = i - edge - (q - rem) * base;
      }
      dst[i] = cl.map_shared_rank(s, q)[off];
    }
    ++xc;
    __syncthreads();
  }

  // Block sums of K values over this block's rows, then over the ranks in
  // rank order: the instance's totals, alike in every thread of the
  // cluster.
  template <int K>
  __device__ void sums(float (&v)[K]) {
    dist::block_sums<K>(v, red);
    float* s = slot();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) s[k] = v[k];
    }
    cl.sync();
    if (threadIdx.x < K) {
      float acc = 0.f;
#pragma unroll 16
      for (int q = 0; q < C; ++q) acc += cl.map_shared_rank(s, q)[threadIdx.x];
      tot[threadIdx.x] = acc;
    }
    ++xc;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = tot[k];
    __syncthreads();  // tot is read before its next write
  }

  // out(i) = Qd[r0 + i, :] . x over the owned rows, one warp per row.
  template <class F>
  __device__ void qd_rows(const float* x, F f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = warp; i < rows; i += blockDim.x >> 5) {
      const float s =
          dist::warp_row_dot(qrow + (long long)i * ldq, x, ldq, vq);
      if (lane == 0) f(i, s);
    }
  }
};

// The four-part verdict at y (as the TPU kernels' check).  Leaves U in P.u.
__device__ inline bool check(Part& P, const ClusterSolveArgs& a) {
  const int m = P.m;
  // partial Gp'y over the owned rows, one thread per column
  float* s = P.slot();
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    float acc = 0.f;
    // unrolled so that several row loads from L2 are in flight; the sum
    // keeps its order
#pragma unroll 8
    for (int i = 0; i < P.rows; ++i)
      acc = fmaf(P.grow[(long long)i * P.ldg + k], P.y[P.r0 + i], acc);
    s[k] = acc;
  }
  P.cl.sync();
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    float acc = 0.f;
#pragma unroll 16
    for (int q = 0; q < P.C; ++q) acc += P.cl.map_shared_rank(s, q)[k];
    P.t[k] = acc + P.fp[k];
  }
  ++P.xc;
  __syncthreads();
  // the owned rows of u = -Qp^-1 t, then every rank's
  dist::rows_times(P.pirow, P.mrows, P.ldg, P.t, P.vg,
                   [&](int r, float v) { P.slot()[r] = -v; });
  P.gather(P.u, m);
  // own rows: violations of Gp u <= Kp_slack, Y'Qd Y, Fd'Y; own m-rows:
  // U'Qp U, Fp'U
  dist::rows_times(P.grow, P.rows, P.ldg, P.u, P.vg, [&](int i, float v) {
    P.g[i] = (v > P.kps[i]) ? 1.f : 0.f;
  });
  P.qd_rows(P.y, [&](int i, float v) { P.w[i] = v; });
  __syncthreads();
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < P.rows; i += blockDim.x) {
    const float yi = P.y[P.r0 + i];
    acc[0] = fmaf(yi, P.w[i], acc[0]);
    acc[1] = fmaf(P.fd[i], yi, acc[1]);
    acc[2] += P.g[i];
  }
  __syncthreads();  // w is free again
  dist::rows_times(P.prow, P.mrows, P.ldg, P.u, P.vg,
                   [&](int r, float v) { P.w[r] = v; });
  __syncthreads();
  for (int r = threadIdx.x; r < P.mrows; r += blockDim.x) {
    const float ur = P.u[P.m0 + r];
    acc[3] = fmaf(ur, P.w[r], acc[3]);
    acc[4] = fmaf(P.fp[P.m0 + r], ur, acc[4]);
  }
  P.sums<5>(acc);
  const float s1 = acc[0], s2 = acc[1];
  const float jd = 0.5f * s1 + s2 + 0.5f * P.md;
  const float jp = 0.5f * acc[3] + acc[4] + 0.5f * P.mp;
  const float gap = jp + jd;
  const bool weak_fail = jp > -jd;
  bool fail = (acc[2] > 0.f) || (gap > a.eaj) || (gap / fabsf(jd) > a.erj);
  if (a.strict) fail = fail || weak_fail;
  return !fail;
}

// One update sweep over the owned rows into the exchange slot s, from
// operands passed by value: nothing of the caller's Part is read through
// local memory (the shared-memory carve-out leaves L1 little room for it).
// Inlined: a call would spill the caller's live registers to local memory
// around every update.
__device__ __forceinline__ void update_rows(
    const float* qrow, int ldq, bool vq, const float* y, int r0, int rows,
    const float* th, const float* dp, const float* fdn, const float* fdp,
    float* s, float den_eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < rows; i += blockDim.x >> 5) {
    const float* row = qrow + (long long)i * ldq;
    float neg, pos;
    dist::warp_row_split_dots(row, y, ldq, vq, r0 + i, neg, pos);
    if (lane == 0) {
      const float yi = y[r0 + i];
      // th holds the num split's diagonal
      const float num = (neg + th[i] * yi) + fdn[i];
      const float den = guard_den((pos + dp[i] * yi) + fdp[i], den_eps);
      s[i] = (num / den) * yi;
    }
  }
}

// One update: the owned rows, published and gathered into P.y.
__device__ __forceinline__ void update(Part& P, float den_eps) {
  update_rows(P.qrow, P.ldq, P.vq, P.y, P.r0, P.rows, P.th, P.dp, P.fdn,
              P.fdp, P.slot(), den_eps);
  P.gather(P.y, P.n);
}

// The safeguarded projected-gradient step (solver.accel_step): three passes
// over the owned rows of the Qd product.
__device__ inline void accel_step(Part& P) {
  const int n = P.n;
  // gradient and direction on the owned rows; p gathered
  P.qd_rows(P.y, [&](int i, float v) {
    const float y = P.y[P.r0 + i];
    const float gr = v + P.fd[i];
    P.g[i] = gr;
    P.slot()[i] = (y > 0.f || gr < 0.f) ? -gr : 0.f;
  });
  P.gather(P.p, n);
  P.qd_rows(P.p, [&](int i, float v) { P.w[i] = v; });
  __syncthreads();
  float a[3] = {0.f, 0.f, 0.f};  // p'Qd p, p'p, y'(grad + Fd)
  for (int i = threadIdx.x; i < P.rows; i += blockDim.x) {
    const float pi = P.p[P.r0 + i];
    a[0] = fmaf(pi, P.w[i], a[0]);
    a[1] = fmaf(pi, pi, a[1]);
    a[2] = fmaf(P.y[P.r0 + i], P.g[i] + P.fd[i], a[2]);
  }
  P.sums<3>(a);
  const float alpha = (a[0] > 0.f) ? a[1] / fmaxf(a[0], 1e-30f) : 0.f;
  float* s = P.slot();
  for (int i = threadIdx.x; i < P.rows; i += blockDim.x)
    s[i] = relu_nan(P.y[P.r0 + i] + alpha * P.p[P.r0 + i]);
  P.gather(P.yn, n);
  P.qd_rows(P.yn, [&](int i, float v) { P.w[i] = v; });
  __syncthreads();
  float b[2] = {0.f, 0.f};  // yn'Qd yn, Fd'yn
  for (int i = threadIdx.x; i < P.rows; i += blockDim.x) {
    const float yn = P.yn[P.r0 + i];
    b[0] = fmaf(yn, P.w[i], b[0]);
    b[1] = fmaf(P.fd[i], yn, b[1]);
  }
  P.sums<2>(b);
  if (0.5f * b[0] + b[1] <= 0.5f * a[2]) {
    float* t = P.y;
    P.y = P.yn;
    P.yn = t;
  }
}

// The whole solve of instance blockIdx.x / C on this block's cluster.
__device__ __forceinline__ void cluster_solve(const ClusterSolveArgs& a) {
  extern __shared__ float4 smem4[];
  Part P{cg::this_cluster()};
  const int n = a.n, m = a.m;
  P.C = (int)P.cl.num_blocks();
  P.rank = (int)P.cl.block_rank();
  const int b = blockIdx.x / P.C;
  P.n = n;
  P.m = m;
  split_rows(n, P.C, P.rank, P.r0, P.rows);
  split_rows(m, P.C, P.rank, P.m0, P.mrows);
  const int ldn = round4(n), ldm = round4(m);
  const int ldr = own_ld(n, m, P.C);
  P.ldx = slot_ld(n, m, P.C);
  P.xc = 0;
  const float* qb = a.q + (long long)b * n * n;
  const float* gpb = a.gp + b * a.gp_stride;
  const float* qpb = a.qp + b * a.qp_stride;
  const float* qpib = a.qpi + b * a.qp_stride;
  float* s = reinterpret_cast<float*>(smem4);
  // the resident rows first (16-byte aligned), copied once
  if (a.resident) {
    stage_rows(s, qb + (long long)P.r0 * n, P.rows, n);
    P.qrow = s;
    P.ldq = ldn;
    P.vq = true;
    s += (size_t)((n + P.C - 1) / P.C) * ldn;
  } else {
    P.qrow = qb + (long long)P.r0 * n;
    P.ldq = n;
    P.vq = (n % 4) == 0;
  }
  P.grow = gpb + (long long)P.r0 * m;
  P.prow = qpb + (long long)P.m0 * m;
  P.pirow = qpib + (long long)P.m0 * m;
  P.ldg = m;
  P.vg = (m % 4) == 0;
  asm volatile("cp.async.commit_group;\n" ::);
  P.y = s;
  P.p = P.y + ldn;
  P.yn = P.p + ldn;
  P.t = P.yn + ldn;
  P.u = P.t + ldm;
  P.th = P.u + ldm;
  P.fd = P.th + ldr;
  P.fdn = P.fd + ldr;
  P.fdp = P.fdn + ldr;
  P.kps = P.fdp + ldr;
  P.yold = P.kps + ldr;
  P.g = P.yold + ldr;
  P.w = P.g + ldr;
  P.dp = P.w + ldr;
  P.xch = P.w + 2 * ldr;
  P.red = P.xch + 2 * P.ldx;
  P.tot = P.red + 8 * 32;
  P.fp = a.fp + (long long)b * m;
  P.mp = a.mp[b];
  P.md = a.md[b];
  const long long on = (long long)b * n, om = (long long)b * m;
  // full vectors zero past n: a padded resident row meets zeros there
  for (int i = threadIdx.x; i < ldn; i += blockDim.x) {
    P.y[i] = i < n ? a.y0[on + i] : 0.f;
    P.p[i] = P.yn[i] = 0.f;
  }
  for (int i = threadIdx.x; i < ldm; i += blockDim.x) P.t[i] = P.u[i] = 0.f;
  for (int i = threadIdx.x; i < P.rows; i += blockDim.x) {
    const long long e = on + P.r0 + i;
    P.th[i] = a.dn[e];  // the splits' diagonals: th holds the num side's
    P.dp[i] = a.dp[e];
    P.fd[i] = a.fd[e];
    P.fdn[i] = a.fdn[e];
    P.fdp[i] = a.fdp[e];
    P.kps[i] = a.kps[e];
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int inner = a.accel_every ? a.accel_every : a.check_every;
  const int chunks =
      a.accel_every ? max(1, a.check_every / a.accel_every) : 1;
  int state = kActive, iters = 0;
  for (int h = 1;; h += a.check_every) {
    const bool ok = check(P, a);
    if (state != kActive || h > a.max_iters) {
      if (state == kActive) {  // out of iterations: the final verdict
        iters = h;
        if (ok) state = kCertified;
      }
      for (int i = threadIdx.x; i < P.rows; i += blockDim.x)
        a.y_out[on + P.r0 + i] = P.y[P.r0 + i];
      for (int r = threadIdx.x; r < P.mrows; r += blockDim.x)
        a.u_out[om + P.m0 + r] = P.u[P.m0 + r];
      if (P.rank == 0 && threadIdx.x == 0) {
        a.iters_out[b] = iters;
        a.state_out[b] = state;
      }
      // no block leaves while another may still read its shared memory
      P.cl.sync();
      return;
    }
    if (ok) {  // certified: the at-check iterate stays
      state = kCertified;
      iters = h;
      continue;
    }
    for (int i = threadIdx.x; i < P.rows; i += blockDim.x)
      P.yold[i] = P.y[P.r0 + i];
    for (int c = 0; c < chunks; ++c) {
      for (int j = 0; j < inner; ++j) update(P, a.den_eps);
      if (a.accel_every) accel_step(P);
    }
    // stall freeze: the round (updates and accel) left y bit-identical
    float diff[1] = {0.f};
    for (int i = threadIdx.x; i < P.rows; i += blockDim.x)
      diff[0] += fabsf(P.y[P.r0 + i] - P.yold[i]);
    P.sums<1>(diff);
    if (diff[0] == 0.f) {
      state = kStalled;
      iters = h + a.check_every;
    }
  }
}

// The layout for B instances: the cluster size with the fewest waves times
// rows per block, among the sizes in `sizes` whose blocks fit shared memory
// (with the Qd rows `resident` or not) and that the card can hold at all
// (cudaOccupancyMaxActiveClusters); a tie keeps the larger size.  Outputs
// the size, the shared memory and the active clusters.
template <class Kernel>
cudaError_t pick_cluster(Kernel kernel, int threads, const int* sizes,
                         int nsizes, int n, int m, int B, bool resident,
                         cudaStream_t stream, int& C_out, size_t& smem_out,
                         int& clusters_out) {
  double best = -1.0;
  for (int k = 0; k < nsizes; ++k) {
    const int C = sizes[k];
    if (C > n) continue;
    const size_t smem =
        cluster_smem_floats(n, m, C, resident) * sizeof(float);
    if (smem > 232448) continue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C * B);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) !=
        cudaSuccess) {
      cudaGetLastError();  // a size this card cannot hold: not a fault
      continue;
    }
    if (clusters < 1) continue;
    const int waves = (B + clusters - 1) / clusters;
    const double cost = (double)waves * ((n + C - 1) / C);
    if (best < 0.0 || cost < best) {
      best = cost;
      C_out = C;
      smem_out = smem;
      clusters_out = clusters;
    }
  }
  return best < 0.0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// Launch `kernel` with clusters of C blocks over B instances.
template <class Kernel>
cudaError_t launch_clusters(Kernel kernel, int threads, int C, size_t smem,
                            const ClusterSolveArgs& a, int B,
                            cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace pqp
