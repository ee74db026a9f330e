// K6: the whole PQP solve for DISTINCT instances with each instance's
// Hessian streamed, in one launch.
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
// Design.  The path gives this kernel few instances (B = 8 at n = 2048), so
// one block per instance would leave most of the 132 SMs idle.  Each
// instance runs on a thread-block CLUSTER of C blocks (C = 16, 8, 4, 2 or
// 1, whichever the card can hold with the fewest waves): block rank r owns
// a contiguous range of n / C rows of Qd_hat and Gp (and of the m rows of
// Qp, Qp^-1) and keeps a full copy of the instance's y in shared memory.
// After each sweep the blocks publish their new rows in shared memory and
// read each other's through distributed shared memory; cluster.sync() is
// the Jacobi barrier.  Exchange buffers alternate between two slots, so one
// cluster barrier per exchange suffices: a slot is written again only two
// exchanges later, after a barrier every reader has passed.  Per-instance
// scalars are block sums over the owned rows in fixed order, then the
// ranks' partials in rank order — the same in every block of the cluster,
// so all its blocks take the same branches and return together (the
// per-instance early exit), and a second launch repeats every bit.  The
// product Gp'Y runs one thread per column over the block's rows, its M
// partials summed in rank order.  Chosen over a cooperative grid with
// grid.sync() (K4's design) because clusters are independent: an instance
// that certifies stops streaming while the others go on.  A launch the card
// refuses (cluster or shared memory) raises in the wrapper; there is no
// fallback.
//
// What bounds it on an H100.  Read once, the inputs of a whole solve are
// small beside its thousands of updates, so the least time for the function
// is its float32 operations.  This design is held above that by memory: an
// update reads the instance's n^2 x 4 bytes of Qd_hat (16.8 MB at
// n = 2048) for 4 n^2 flop; the check adds Qd_hat, Gp twice and Qp, Qp^-1;
// the accel step three Qd_hat passes.  Eight such instances (134 MB) exceed
// the 50 MB L2, so each sweep streams from HBM: the design's floor is at
// least 40 us per update at 3.35 TB/s.  The design keeps
// C x B blocks (128 at B = 8) streaming with 16-byte loads (n % 4 == 0).
// Lessons from K4: every loop over a row stays rolled (a 2048-entry row
// unrolled would run ptxas for minutes), and the update body is a function
// of its own (update_rows).
//
// Semantics match pqp_for_mpc_tpu_torch/ops/distinct_tiled_kernel.py:
// fused_full_solve_distinct_tiled_reference up to float32 summation order.
// Lane codes as K1's (0 max_iters, 1 certified, 2 stalled).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "distinct_common.cuh"
#include "pqp_common.cuh"

namespace cg = cooperative_groups;

namespace pqp {

constexpr int kTiledThreads = 512;

struct DistinctTiledArgs {
  const float *qh, *theta;             // (B, n, n), (B, n)
  const float *gp, *qp, *qpi;          // (B, n, m), (B, m, m), or shared
  long long gp_stride, qp_stride;      // instance strides (0 = shared)
  const float *fp, *fd, *fdp, *fdn, *kps, *mp, *md, *y0;  // (B, len)
  float *y_out, *u_out;                // (B, n), (B, m)
  int *iters_out, *state_out;          // (B)
  int n, m, max_iters, check_every, accel;
  float eaj, erj;
  int strict;
  float den_eps;
  int gap_comp;
};

// Rows [off, off + cnt) of `total` split over `parts` ranks as evenly as
// possible, the first total % parts ranks one row more.
__host__ __device__ inline void split_rows(int total, int parts, int rank,
                                           int& off, int& cnt) {
  const int base = total / parts, rem = total % parts;
  cnt = base + (rank < rem ? 1 : 0);
  off = rank * base + (rank < rem ? rank : rem);
}

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

__host__ __device__ inline size_t tiled_smem_floats(int n, int m, int C) {
  // y, p, yn (n); t, u (m); own rows: theta, fd, fdn, fdp, kps, y at the
  // check, gradient or flags, row values (8 x own_ld); two exchange slots;
  // block reductions and cluster totals
  return 3 * (size_t)round4(n) + 2 * (size_t)round4(m) +
         8 * (size_t)own_ld(n, m, C) + 2 * (size_t)slot_ld(n, m, C) +
         8 * 32 + 8;
}

// This block's part of one instance.
struct Part {
  cg::cluster_group cl;
  const float *qh, *gp, *qp, *qpi;      // the instance's, global
  const float* fp;                      // (m), global
  float *y, *p, *yn;                    // full vectors (n)
  float *t, *u;                         // full vectors (m)
  float *th, *fd, *fdn, *fdp, *kps, *yold, *g, *w;  // own rows
  float *xch;                           // two exchange slots of ldx
  float *red, *tot;                     // block reductions, cluster totals
  int ldx, xc;                          // slot size, exchange counter
  int n, m, C, rank, r0, rows, m0, mrows;
  bool vn, vm;
  float mp, md;

  __device__ float* slot() { return xch + (xc & 1) * ldx; }

  // Every rank has written its `part` of `total` rows into its slot:
  // gather all of them into dst (full length), then move to the next slot.
  __device__ void gather(float* dst, int total) {
    float* s = slot();
    cl.sync();
    for (int q = 0; q < C; ++q) {
      const float* src = cl.map_shared_rank(s, q);
      int off, cnt;
      split_rows(total, C, q, off, cnt);
      for (int i = threadIdx.x; i < cnt; i += blockDim.x)
        dst[off + i] = src[i];
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
      for (int q = 0; q < C; ++q) acc += cl.map_shared_rank(s, q)[threadIdx.x];
      tot[threadIdx.x] = acc;
    }
    ++xc;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = tot[k];
    __syncthreads();  // tot is read before its next write
  }

  // out(i) = Qd_hat[r0 + i, :] . x - theta_i x_{r0+i} (Qd with its diagonal
  // clamped, times x) over the owned rows, one warp per row.
  template <class F>
  __device__ void qd_rows(const float* x, F f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = warp; i < rows; i += blockDim.x >> 5) {
      const float s = dist::warp_row_dot(qh + (long long)(r0 + i) * n, x, n,
                                         vn);
      if (lane == 0) f(i, s - th[i] * x[r0 + i]);
    }
  }
};

// The four-part verdict at y (as the TPU kernel's check).  Leaves U in P.u.
__device__ bool check(Part& P, const DistinctTiledArgs& a) {
  const int m = P.m;
  // partial Gp'y over the owned rows, one thread per column
  float* s = P.slot();
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < P.rows; ++i)
      acc = fmaf(P.gp[(long long)(P.r0 + i) * m + k], P.y[P.r0 + i], acc);
    s[k] = acc;
  }
  P.cl.sync();
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    float acc = 0.f;
    for (int q = 0; q < P.C; ++q) acc += P.cl.map_shared_rank(s, q)[k];
    P.t[k] = acc + P.fp[k];
  }
  ++P.xc;
  __syncthreads();
  // the owned rows of u = -Qp^-1 t, then every rank's
  dist::rows_times(P.qpi + (long long)P.m0 * m, P.mrows, m, P.t, P.vm,
                   [&](int r, float v) { P.slot()[r] = -v; });
  P.gather(P.u, m);
  // own rows: violations of Gp u <= Kp_slack, Y'Qd Y, Fd'Y; own m-rows:
  // U'Qp U, Fp'U
  dist::rows_times(P.gp + (long long)P.r0 * m, P.rows, m, P.u, P.vm,
                   [&](int i, float v) {
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
  dist::rows_times(P.qp + (long long)P.m0 * m, P.mrows, m, P.u, P.vm,
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
  float gap;
  bool weak_fail;
  if (a.gap_comp) {  // Jp(U(Y)) + Jd(Y) = Y'(Qd Y + Fd)
    gap = s1 + s2;
    weak_fail = gap > 0.f;
  } else {
    gap = jp + jd;
    weak_fail = jp > -jd;
  }
  bool fail = (acc[2] > 0.f) || (gap > a.eaj) || (gap / fabsf(jd) > a.erj);
  if (a.strict) fail = fail || weak_fail;
  return !fail;
}

// One update sweep over the owned rows (relu splits of Qd_hat, theta on the
// num side), published and gathered into P.y.  A function of its own, as
// K4's update tile.
__device__ __noinline__ void update_rows(Part& P, float den_eps) {
  const int n = P.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* s = P.slot();
  for (int i = warp; i < P.rows; i += blockDim.x >> 5) {
    float neg, pos;
    dist::warp_row_relu_dots(P.qh + (long long)(P.r0 + i) * n, P.y, n, P.vn,
                             neg, pos);
    if (lane == 0) {
      const float y = P.y[P.r0 + i];
      const float num = neg + P.th[i] * y + P.fdn[i];
      const float den = guard_den(pos + P.fdp[i], den_eps);
      s[i] = (num / den) * y;
    }
  }
  P.gather(P.y, n);
}

// The safeguarded projected-gradient step (solver.accel_step) on Qd with
// its diagonal clamped: three passes over the owned rows of Qd_hat.
__device__ void accel_step(Part& P) {
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

__global__ void __launch_bounds__(kTiledThreads)
full_solve_distinct_tiled_kernel(const DistinctTiledArgs a) {
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
  float* s = reinterpret_cast<float*>(smem4);
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
  P.xch = P.w + ldr;
  P.red = P.xch + 2 * P.ldx;
  P.tot = P.red + 8 * 32;
  P.qh = a.qh + (long long)b * n * n;
  P.gp = a.gp + b * a.gp_stride;
  P.qp = a.qp + b * a.qp_stride;
  P.qpi = a.qpi + b * a.qp_stride;
  P.fp = a.fp + (long long)b * m;
  P.vn = (n % 4) == 0;
  P.vm = (m % 4) == 0;
  P.mp = a.mp[b];
  P.md = a.md[b];
  const long long on = (long long)b * n, om = (long long)b * m;
  for (int i = threadIdx.x; i < n; i += blockDim.x) P.y[i] = a.y0[on + i];
  for (int i = threadIdx.x; i < P.rows; i += blockDim.x) {
    const long long e = on + P.r0 + i;
    P.th[i] = a.theta[e];
    P.fd[i] = a.fd[e];
    P.fdn[i] = a.fdn[e];
    P.fdp[i] = a.fdp[e];
    P.kps[i] = a.kps[e];
  }
  __syncthreads();

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
    for (int j = 0; j < a.check_every; ++j) update_rows(P, a.den_eps);
    if (a.accel) accel_step(P);
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

// The cluster size for B instances: the one with the fewest waves times
// rows per block, among those the card can hold at all.
static cudaError_t pick_cluster(const pqp::DistinctTiledArgs& a, int B,
                                cudaStream_t stream, int& C_out,
                                size_t& smem_out) {
  const int sizes[] = {16, 8, 4, 2, 1};
  double best = -1.0;
  for (int C : sizes) {
    if (C > a.n) continue;
    const size_t smem = tiled_smem_floats(a.n, a.m, C) * sizeof(float);
    if (smem > 232448) continue;
    cudaError_t err = cudaFuncSetAttribute(
        full_solve_distinct_tiled_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C * B);
    cfg.blockDim = dim3(kTiledThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters,
                                       full_solve_distinct_tiled_kernel,
                                       &cfg) != cudaSuccess) {
      cudaGetLastError();  // a size this card cannot hold: not a fault
      continue;
    }
    if (clusters < 1) continue;
    const int waves = (B + clusters - 1) / clusters;
    const double cost = (double)waves * ((a.n + C - 1) / C);
    if (best < 0.0 || cost < best) {
      best = cost;
      C_out = C;
      smem_out = smem;
    }
  }
  return best < 0.0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

}  // namespace pqp

// qh = Qd_hat (B, n, n) and theta (B, n); gp (B, n, m) with instance stride
// gp_stride (0 = shared); qp, qpi (B, m, m) with stride qp_stride.  Panels
// instance-major: fp (B, m); fd, fdp, fdn, kps, y0 (B, n); mp, md (B).
// Outputs: y_out (B, n), u_out (B, m), iters_out, state_out (B).  accel 0
// or 1 (at the check cadence).
extern "C" int full_solve_distinct_tiled_f32(
    const float* qh, const float* theta, const float* gp, long long gp_stride,
    const float* qp, const float* qpi, long long qp_stride, const float* fp,
    const float* fd, const float* fdp, const float* fdn, const float* kps,
    const float* mp, const float* md, const float* y0, float* y_out,
    float* u_out, int* iters_out, int* state_out, int n, int m, int B,
    int max_iters, int check_every, int accel, float eaj, float erj,
    int strict, float den_eps, int gap_comp, void* stream) {
  if (n < 1 || m < 1 || B < 1 || check_every < 1)
    return (int)cudaErrorInvalidValue;
  pqp::DistinctTiledArgs a;
  a.qh = qh; a.theta = theta; a.gp = gp; a.qp = qp; a.qpi = qpi;
  a.gp_stride = gp_stride; a.qp_stride = qp_stride;
  a.fp = fp; a.fd = fd; a.fdp = fdp; a.fdn = fdn; a.kps = kps;
  a.mp = mp; a.md = md; a.y0 = y0;
  a.y_out = y_out; a.u_out = u_out;
  a.iters_out = iters_out; a.state_out = state_out;
  a.n = n; a.m = m; a.max_iters = max_iters; a.check_every = check_every;
  a.accel = accel; a.eaj = eaj; a.erj = erj; a.strict = strict;
  a.den_eps = den_eps; a.gap_comp = gap_comp;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      pqp::full_solve_distinct_tiled_kernel,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  int C = 0;
  size_t smem = 0;
  err = pqp::pick_cluster(a, B, s, C, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(pqp::full_solve_distinct_tiled_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * B);
  cfg.blockDim = dim3(pqp::kTiledThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pqp::full_solve_distinct_tiled_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
