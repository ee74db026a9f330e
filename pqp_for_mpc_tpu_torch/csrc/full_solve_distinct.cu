// K5: the whole PQP solve for a batch of DISTINCT instances in one launch.
//
// Replaces the TPU kernel pqp_for_mpc_tpu/ops/distinct_kernel.py:
// fused_full_solve_distinct (its Pallas body _kernel): for each instance its
// own geometry — the materialized splits Qd^- + th, Qd^+ + th and Qd
// (n x n), Gp (n x m), Qp and Qp^-1 (m x m) — multiplicative updates, the
// four-part check with the recovered U and the EXPLICIT gap Jp + Jd (and
// the strict weak-duality test when asked), the safeguarded acceleration in
// check_every / accel_every chunks, the stall freeze (the iterate after a
// whole round bit-identical to the one at its check) and the final check.
//
// Design.  One thread block (kDistinctThreads = 512, 16 warps) per instance
// runs the whole solve; a block that finishes returns, which is the
// per-instance early exit — no grid-wide synchronisation exists.  The
// instance's vectors (three iterates, Fd, Fd^-, Fd^+, the Kp slack, the
// accel's gradient and direction, Fp, Gp'Y + Fp, U) live in shared memory;
// the matrices are read from global memory and L2 on every product.  The
// TPU kernel's (8, N) row-replicated layout and its "full reduce / 8"
// scalars exist for Mosaic and are dropped: every matrix a product needs is
// symmetric except Gp, so one warp reads row i contiguously for output i
// (warp_row_dot), and Gp'Y runs one thread per column over ascending rows.
// Every per-instance scalar is a fixed-order block reduction
// (distinct_common.cuh: block_sums), identical in every thread, so every
// thread takes the same branch and a second launch repeats every bit.
//
// What bounds it on an H100.  Read once, the inputs of a whole solve are
// small beside its thousands of updates, so the least time for the function
// is its float32 operations.  This design is held above that by memory: an
// update reads both splits of the instance, 2 n^2 x 4 bytes (1.28 MB at
// n = 400) for 4 n^2 flop — one flop per two bytes; the check adds Qd, Gp
// twice and Qp, Qp^-1.  At n = 400, m = 100, B = 1024 the geometry is about
// 2.1 GB, far past the 50 MB L2, so the splits stream from HBM on every
// update (three instances' worth of blocks per SM at once), and that stream
// is the design's floor.  Streaming one Qd_hat and rebuilding the splits by
// relu, as K6 does, would halve it.  The design's answer is to read each
// matrix entry exactly once per product with 16-byte loads (n % 4 == 0) and
// to stop an instance's traffic the moment it certifies; staging the splits
// in shared memory (n <= ~120) or fusing several updates per read are
// later work.
//
// Semantics match pqp_for_mpc_tpu_torch/ops/distinct_kernel.py:
// fused_full_solve_distinct_reference up to float32 summation order.  Lane
// codes as K1's (0 max_iters, 1 certified, 2 stalled).

#include <cuda_runtime.h>

#include "distinct_common.cuh"
#include "pqp_common.cuh"

namespace pqp {

constexpr int kDistinctThreads = 512;

struct DistinctSolveArgs {
  const float *qdn, *qdp, *qd;          // (B, n, n)
  const float *gp, *qp, *qpi;           // (B, n, m) and (B, m, m), or shared
  long long gp_stride, qp_stride;       // instance strides (0 = shared)
  const float *fp, *fd, *fdp, *fdn, *kps, *mp, *md, *y0;  // (B, len)
  float *y_out, *u_out;                 // (B, n), (B, m)
  int *iters_out, *state_out;           // (B)
  int n, m, max_iters, check_every, accel_every;
  float eaj, erj;
  int strict;
  float den_eps;
};

__host__ __device__ inline size_t distinct_smem_floats(int n, int m) {
  return 10 * (size_t)round4(n) + 4 * (size_t)round4(m) + 8 * 32;
}

// One instance as its block sees it.
struct Instance {
  const float *qdn, *qdp, *qd, *gp, *qp, *qpi;  // global
  float *fd, *fdn, *fdp, *kps, *g, *p, *w;      // shared, n each
  float *fp, *t, *u, *v;                        // shared, m each
  float* red;                                   // shared, 8 x 32
  float mp, md;
  int n, m;
  bool vn, vm;  // rows of length n (m) read as float4
};

// The four-part test (PQP_CPU.c:673-687) at y, as the TPU kernel's check:
// U = -Qp^-1 (Gp'y + Fp) into I.u, feasibility Gp U <= Kp_slack, explicit
// gap.  Returns "certified", the same in every thread.
__device__ bool check(const Instance& I, const float* y, float eaj,
                      float erj, bool strict) {
  const int n = I.n, m = I.m;
  // t = Gp' y + Fp: one thread per column, rows in ascending order
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < n; ++i) s = fmaf(I.gp[(long long)i * m + k], y[i], s);
    I.t[k] = s + I.fp[k];
  }
  __syncthreads();
  dist::rows_times(I.qpi, m, m, I.t, I.vm,
                   [&](int r, float s) { I.u[r] = -s; });
  __syncthreads();
  dist::rows_times(I.gp, n, m, I.u, I.vm, [&](int i, float s) {
    I.w[i] = (s > I.kps[i]) ? 1.f : 0.f;
  });
  dist::rows_times(I.qd, n, n, y, I.vn, [&](int i, float s) { I.g[i] = s; });
  dist::rows_times(I.qp, m, m, I.u, I.vm, [&](int r, float s) { I.v[r] = s; });
  __syncthreads();
  // Y'Qd Y, Fd'Y, violations, U'Qp U, Fp'U
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    acc[0] = fmaf(y[i], I.g[i], acc[0]);
    acc[1] = fmaf(I.fd[i], y[i], acc[1]);
    acc[2] += I.w[i];
  }
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    acc[3] = fmaf(I.u[r], I.v[r], acc[3]);
    acc[4] = fmaf(I.fp[r], I.u[r], acc[4]);
  }
  dist::block_sums<5>(acc, I.red);
  const float jd = 0.5f * acc[0] + acc[1] + 0.5f * I.md;
  const float jp = 0.5f * acc[3] + acc[4] + 0.5f * I.mp;
  const float gap = jp + jd;
  bool fail = (acc[2] > 0.f) || (gap > eaj) || (gap / fabsf(jd) > erj);
  if (strict) fail = fail || (jp > -jd);
  return !fail;
}

// One multiplicative update y -> yn (update_lane's arithmetic, per row).
__device__ void update(const Instance& I, const float* y, float* yn,
                       float den_eps) {
  const int n = I.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int r = warp; r < n; r += warps) {
    float a, b;
    dist::warp_row_dot2(I.qdn + (long long)r * n, I.qdp + (long long)r * n,
                        y, n, I.vn, a, b);
    if (lane == 0) {
      const float num = a + I.fdn[r];
      const float den = guard_den(b + I.fdp[r], den_eps);
      yn[r] = (num / den) * y[r];
    }
  }
  __syncthreads();
}

// The safeguarded projected-gradient step (solver.accel_step): candidate
// yn = max(y + alpha p, 0) into spare; when f(yn) <= f(y) the iterate moves
// to spare (the pointers swap, alike in every thread).
__device__ void accel(const Instance& I, float*& y, float*& spare) {
  const int n = I.n;
  dist::rows_times(I.qd, n, n, y, I.vn, [&](int i, float s) {
    const float gr = s + I.fd[i];
    I.g[i] = gr;
    I.p[i] = (y[i] > 0.f || gr < 0.f) ? -gr : 0.f;
  });
  __syncthreads();
  dist::rows_times(I.qd, n, n, I.p, I.vn,
                   [&](int i, float s) { I.w[i] = s; });
  __syncthreads();
  float a[3] = {0.f, 0.f, 0.f};  // p'Qd p, p'p, y'(grad + Fd)
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float pi = I.p[i];
    a[0] = fmaf(pi, I.w[i], a[0]);
    a[1] = fmaf(pi, pi, a[1]);
    a[2] = fmaf(y[i], I.g[i] + I.fd[i], a[2]);
  }
  dist::block_sums<3>(a, I.red);
  const float alpha = (a[0] > 0.f) ? a[1] / fmaxf(a[0], 1e-30f) : 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    spare[i] = relu_nan(y[i] + alpha * I.p[i]);
  __syncthreads();
  dist::rows_times(I.qd, n, n, spare, I.vn,
                   [&](int i, float s) { I.w[i] = s; });
  __syncthreads();
  float b[2] = {0.f, 0.f};  // yn'Qd yn, Fd'yn
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    b[0] = fmaf(spare[i], I.w[i], b[0]);
    b[1] = fmaf(I.fd[i], spare[i], b[1]);
  }
  dist::block_sums<2>(b, I.red);
  if (0.5f * b[0] + b[1] <= 0.5f * a[2]) {
    float* t = y;
    y = spare;
    spare = t;
  }
}

__global__ void __launch_bounds__(kDistinctThreads)
full_solve_distinct_kernel(const DistinctSolveArgs a) {
  extern __shared__ float4 smem4[];
  const int n = a.n, m = a.m, ldn = round4(n), ldm = round4(m);
  const int b = blockIdx.x;
  float* s = reinterpret_cast<float*>(smem4);
  float* ybuf[3] = {s, s + ldn, s + 2 * ldn};
  Instance I;
  I.fd = s + 3 * ldn;
  I.fdn = I.fd + ldn;
  I.fdp = I.fdn + ldn;
  I.kps = I.fdp + ldn;
  I.g = I.kps + ldn;
  I.p = I.g + ldn;
  I.w = I.p + ldn;
  I.fp = I.w + ldn;
  I.t = I.fp + ldm;
  I.u = I.t + ldm;
  I.v = I.u + ldm;
  I.red = I.v + ldm;
  const long long nn = (long long)n * n;
  I.qdn = a.qdn + b * nn;
  I.qdp = a.qdp + b * nn;
  I.qd = a.qd + b * nn;
  I.gp = a.gp + b * a.gp_stride;
  I.qp = a.qp + b * a.qp_stride;
  I.qpi = a.qpi + b * a.qp_stride;
  I.n = n;
  I.m = m;
  I.vn = (n % 4) == 0;
  I.vm = (m % 4) == 0;
  I.mp = a.mp[b];
  I.md = a.md[b];
  const long long on = (long long)b * n, om = (long long)b * m;
  // zero-filled past n (m), so a float4 read of a row's tail meets zeros
  for (int i = threadIdx.x; i < ldn; i += blockDim.x) {
    const bool in = i < n;
    I.fd[i] = in ? a.fd[on + i] : 0.f;
    I.fdn[i] = in ? a.fdn[on + i] : 0.f;
    I.fdp[i] = in ? a.fdp[on + i] : 0.f;
    I.kps[i] = in ? a.kps[on + i] : 0.f;
    ybuf[0][i] = in ? a.y0[on + i] : 0.f;
    ybuf[1][i] = ybuf[2][i] = I.g[i] = I.p[i] = I.w[i] = 0.f;
  }
  for (int r = threadIdx.x; r < ldm; r += blockDim.x) {
    I.fp[r] = (r < m) ? a.fp[om + r] : 0.f;
    I.t[r] = I.u[r] = I.v[r] = 0.f;
  }
  __syncthreads();

  const bool strict = a.strict != 0;
  const int inner = a.accel_every ? a.accel_every : a.check_every;
  const int chunks =
      a.accel_every ? max(1, a.check_every / a.accel_every) : 1;
  // yc: the iterate at the check; ya, yb: the round's ping-pong buffers
  float *yc = ybuf[0], *ya = ybuf[1], *yb = ybuf[2];
  int state = kActive, iters = 0;
  for (int h = 1;; h += a.check_every) {
    const bool ok = check(I, yc, a.eaj, a.erj, strict);
    if (state != kActive || h > a.max_iters) {
      if (state == kActive) {  // out of iterations: the final verdict
        iters = h;
        if (ok) state = kCertified;
      }
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        a.y_out[on + i] = yc[i];
      for (int r = threadIdx.x; r < m; r += blockDim.x)
        a.u_out[om + r] = I.u[r];
      if (threadIdx.x == 0) {
        a.iters_out[b] = iters;
        a.state_out[b] = state;
      }
      return;
    }
    if (ok) {
      state = kCertified;
      iters = h;
      continue;
    }
    float* cur = yc;
    for (int c = 0; c < chunks; ++c) {
      for (int t = 0; t < inner; ++t) {
        float* nxt = (cur == ya) ? yb : ya;
        update(I, cur, nxt, a.den_eps);
        cur = nxt;
      }
      if (a.accel_every) {
        float* spare = (cur == ya) ? yb : ya;
        accel(I, cur, spare);
      }
    }
    // stall freeze: bit-identical iterate after a whole round
    float diff[1] = {0.f};
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      diff[0] += fabsf(cur[i] - yc[i]);
    dist::block_sums<1>(diff, I.red);
    if (diff[0] == 0.f) {
      state = kStalled;
      iters = h + a.check_every;
    }
    // the round's result becomes the iterate at the next check
    float* old = yc;
    yc = cur;
    if (ya == cur) ya = old; else yb = old;
    __syncthreads();
  }
}

}  // namespace pqp

// Matrices: qdn, qdp, qd (B, n, n); gp (B, n, m) with instance stride
// gp_stride (0 = shared); qp, qpi (B, m, m) with stride qp_stride.  Panels
// instance-major: fp (B, m); fd, fdp, fdn, kps, y0 (B, n); mp, md (B).
// Outputs: y_out (B, n), u_out (B, m), iters_out, state_out (B).
extern "C" int full_solve_distinct_f32(
    const float* qdn, const float* qdp, const float* qd, const float* gp,
    long long gp_stride, const float* qp, const float* qpi,
    long long qp_stride, const float* fp, const float* fd, const float* fdp,
    const float* fdn, const float* kps, const float* mp, const float* md,
    const float* y0, float* y_out, float* u_out, int* iters_out,
    int* state_out, int n, int m, int B, int max_iters, int check_every,
    int accel_every, float eaj, float erj, int strict, float den_eps,
    void* stream) {
  const size_t smem = pqp::distinct_smem_floats(n, m) * sizeof(float);
  if (n < 1 || m < 1 || B < 1 || check_every < 1 || accel_every < 0 ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  pqp::DistinctSolveArgs a;
  a.qdn = qdn; a.qdp = qdp; a.qd = qd; a.gp = gp; a.qp = qp; a.qpi = qpi;
  a.gp_stride = gp_stride; a.qp_stride = qp_stride;
  a.fp = fp; a.fd = fd; a.fdp = fdp; a.fdn = fdn; a.kps = kps;
  a.mp = mp; a.md = md; a.y0 = y0;
  a.y_out = y_out; a.u_out = u_out;
  a.iters_out = iters_out; a.state_out = state_out;
  a.n = n; a.m = m; a.max_iters = max_iters; a.check_every = check_every;
  a.accel_every = accel_every; a.eaj = eaj; a.erj = erj;
  a.strict = strict; a.den_eps = den_eps;
  cudaError_t err = cudaFuncSetAttribute(
      pqp::full_solve_distinct_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pqp::full_solve_distinct_kernel<<<B, pqp::kDistinctThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
