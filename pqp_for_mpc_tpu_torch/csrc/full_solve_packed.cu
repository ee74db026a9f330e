// K8: the whole batched PQP solve with G instances packed per warp.
//
// Replaces the TPU kernel pqp_for_mpc_tpu/ops/packed_kernel.py:
// fused_full_solve_packed (its Pallas body _kernel).  On the TPU, packing
// G = 128 // n_pad instances of one geometry block-diagonally
// (kron(I_G, A)) fills the MXU's 128-deep contraction axis, and every
// reduction of the check, the accel step and the stall test becomes a
// segment reduction (products with the 0/1 indicator E and its transpose).
// The function it computes is K1's, per instance: the same iterates,
// iteration stamps and state codes (0 max_iters, 1 certified, 2 stalled;
// 3 marks padding and never leaves the wrapper).
//
// Design.  The zero off-diagonal blocks of kron(I_G, A) are free on the
// MXU and pure waste on SIMT, so the geometry is staged once per block in
// shared memory un-kronned: Qd^-+th, Qd^++th, Qd (N x N), Gp (N x M) and
// its transpose, Qp and Qp^-1 (M x M), each row padded to an odd stride so
// that threads reading different rows at one column hit different banks.
// One warp runs one packed column: its G instances are lanes g*Bc + c of
// the batch (c the warp's column, Bc = ceil(B / G)), the TPU layout.  Each
// instance owns T = n_pad / 4 threads of the warp (G * T <= 32: 8 threads
// at N = 28, 16 at N = 64); thread t holds rows t, t + T, t + 2T, t + 3T of
// its instance's y and panels in registers, and loops over the U rows
// t, t + T, ... .  For each product an instance's y (or p, t, U) is
// staged in a per-warp shared-memory slice, read by its T threads as a
// broadcast.  Rows beyond N are never stored: they are the TPU kernel's
// padded coordinates, exact fixed points that add 0 to every sum.
// Segment sums go through a per-warp shared array, each thread adding its
// instance's T partials in thread order — one code path for every T (the
// T = 6, 10, 12, 14 of n_pad = 24, 40, 48, 56 have no shuffle tree), and
// a fixed order, so a second launch repeats every bit.  They run only in
// checks and accel steps; an update needs none.  The warp loops until
// none of its G instances is active or h > max_iters, freezing finished
// instances as the TPU kernel does; h is uniform over the warp, so a
// lane's stamps are those of the TPU block loop.
//
// What bounds it on an H100.  An update costs an instance 2 N^2 FMAs
// whose matrix operands come from shared memory: per column j a thread
// loads y_j once and 8 matrix entries (4 rows, both splits) for 8 FMAs,
// so the shared-memory pipe (one warp-wide load per cycle, broadcasts
// included) caps it near a quarter of the float32 FMA peak.  On an H100
// it runs well below that, latency-bound: unrolling the update's column
// loop 4x instead of 2x (more loads in flight, the same bits) made it
// faster (PERF.md, PR 4, gives the times; tools/probe_k8.py measures the
// variants).
// Plain f32 FMAs throughout (precision="highest"); tensor-core products
// (3xTF32), register blocking over instances and cp.async staging are
// later work.  A warp waits only for the slowest of its G instances, where
// K1's warp waits for the slowest of 32 lanes.
//
// Every clamp and test keeps NaN as the plain version does (guard_den,
// relu_nan; verdicts in the "fail if x > tol" form).

#include <cuda_runtime.h>

#include "pqp_common.cuh"

namespace pqp {

constexpr int kPackedWarps = 8;   // packed columns per block
constexpr int kPackedRows = 4;    // rows of y per thread
constexpr int kRedSlots = 5;      // segment sums per round (the check's)
constexpr unsigned kFullMask = 0xffffffffu;

struct PackedArgs {
  const float *qdn, *qdp, *qd, *gp, *qp, *qpi;
  const float *fp, *fd, *fdp, *fdn, *kps, *mp, *md, *y0;
  int fp_lane, fd_lane, fdp_lane, fdn_lane, kps_lane, mp_lane, md_lane,
      y0_lane;
  float *y_out, *u_out;
  int *iters_out, *state_out;
  int n, m, B, max_iters, check_every, accel_every;
  float eaj, erj;
  int strict;
  float den_eps;
  int gap_comp;
};

// The packing of the TPU kernel (pack_factor) and this kernel's strides.
struct PackedLayout {
  int n_pad, G, T, ldn, ldm;
  size_t mat_floats, warp_floats;
};

__host__ __device__ inline PackedLayout packed_layout(int n, int m) {
  PackedLayout L;
  L.n_pad = ((n > 8 ? n : 8) + 7) / 8 * 8;
  L.G = 128 / L.n_pad;
  L.T = L.n_pad / kPackedRows;
  L.ldn = n | 1;
  L.ldm = m | 1;
  L.mat_floats = (size_t)3 * n * L.ldn + (size_t)n * L.ldm +
                 (size_t)m * L.ldn + (size_t)2 * m * L.ldm;
  // y (and t) staging, p / y_new staging, U, and the segment sums
  L.warp_floats = (size_t)2 * L.G * L.ldn + (size_t)2 * L.G * L.ldm +
                  kRedSlots * 32;
  return L;
}

__host__ inline size_t packed_smem_bytes(int n, int m) {
  const PackedLayout L = packed_layout(n, m);
  return (L.mat_floats + kPackedWarps * L.warp_floats) * sizeof(float);
}

// dot(row[0:n], v[0:n]) in index order with fused multiply-adds
__device__ __forceinline__ float sdot(const float* __restrict__ row,
                                      const float* __restrict__ v, int n) {
  float acc = 0.f;
#pragma unroll 4
  for (int j = 0; j < n; ++j) acc = fmaf(row[j], v[j], acc);
  return acc;
}

// One thread's view of its instance: the resident geometry, its rows of
// the panels, and the warp's staging slices.
struct PackedLane {
  const float *qdn, *qdp, *qd, *gp, *gpt, *qp, *qpi;  // shared memory
  float *ys, *ps, *ts, *us, *red;                     // this instance's slices
  int n, m, ldn, ldm, T, t, lane, red_base;
  bool seg;                 // lane belongs to one of the G instances
  int row[kPackedRows];     // matrix row of each register row (clamped)
  bool has[kPackedRows];    // register row is a real row (< n)
  float fd[kPackedRows], fdp[kPackedRows], fdn[kPackedRows],
      kps[kPackedRows];
  const float* fp;          // panel column of the lane's instance
  long long fp_row;
  float mp, md, eaj, erj, den_eps;
  bool strict, gap_comp;

  __device__ __forceinline__ float fp_at(int k) const {
    return fp[k * fp_row];
  }

  // write this thread's rows of v into the instance's slice dst
  __device__ __forceinline__ void stage(float* dst,
                                        const float (&v)[kPackedRows]) const {
    if (!seg) return;
#pragma unroll
    for (int r = 0; r < kPackedRows; ++r)
      if (has[r]) dst[row[r]] = v[r];
  }

  // Sum each of the Q values over the instance's T threads, in thread
  // order; every thread of the instance gets the same sums.
  template <int Q>
  __device__ __forceinline__ void seg_sums(float (&v)[Q]) const {
#pragma unroll
    for (int q = 0; q < Q; ++q) red[q * 32 + lane] = v[q];
    __syncwarp();
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float s = 0.f;
      for (int k = 0; k < T; ++k) s += red[q * 32 + red_base + k];
      v[q] = s;
    }
    __syncwarp();
  }

  // Y <- Y * (Qdn Y + Fdn) / guard(Qdp Y + Fdp), unless frozen
  __device__ __forceinline__ void update(float (&y)[kPackedRows],
                                         bool frozen) const {
    stage(ys, y);
    __syncwarp();
    float an[kPackedRows], ad[kPackedRows];
#pragma unroll
    for (int r = 0; r < kPackedRows; ++r) an[r] = ad[r] = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float yj = ys[j];
#pragma unroll
      for (int r = 0; r < kPackedRows; ++r) {
        an[r] = fmaf(qdn[row[r] * ldn + j], yj, an[r]);
        ad[r] = fmaf(qdp[row[r] * ldn + j], yj, ad[r]);
      }
    }
    __syncwarp();
    if (frozen) return;
#pragma unroll
    for (int r = 0; r < kPackedRows; ++r) {
      if (has[r]) {
        const float num = an[r] + fdn[r];
        const float den = guard_den(ad[r] + fdp[r], den_eps);
        y[r] = (num / den) * y[r];
      }
    }
  }

  // Projected steepest descent with exact line search on
  // f(Y) = 1/2 Y'Qd Y + Fd'Y, kept only when f does not increase and the
  // instance is not done (solver.accel_step, per segment).
  __device__ __forceinline__ void accel(float (&y)[kPackedRows],
                                        bool done) const {
    stage(ys, y);
    __syncwarp();
    float p[kPackedRows];
    float s[3] = {0.f, 0.f, 0.f};  // p'Qd p, p'p, Y'(grad + Fd)
#pragma unroll
    for (int r = 0; r < kPackedRows; ++r) {
      p[r] = 0.f;
      if (has[r]) {
        const float g = sdot(qd + row[r] * ldn, ys, n) + fd[r];
        p[r] = (y[r] > 0.f || g < 0.f) ? -g : 0.f;
        s[2] = fmaf(y[r], g + fd[r], s[2]);
      }
    }
    stage(ps, p);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kPackedRows; ++r) {
      if (has[r]) {
        s[0] = fmaf(p[r], sdot(qd + row[r] * ldn, ps, n), s[0]);
        s[1] = fmaf(p[r], p[r], s[1]);
      }
    }
    seg_sums<3>(s);
    const float pqp = s[0];
    const float alpha =
        (pqp > 0.f) ? s[1] / (pqp < 1e-30f ? 1e-30f : pqp) : 0.f;
    float yn[kPackedRows];
#pragma unroll
    for (int r = 0; r < kPackedRows; ++r) yn[r] = relu_nan(y[r] + alpha * p[r]);
    stage(ps, yn);
    __syncwarp();
    float f[2] = {0.f, 0.f};  // Yn'Qd Yn, Fd'Yn
#pragma unroll
    for (int r = 0; r < kPackedRows; ++r) {
      if (has[r]) {
        f[0] = fmaf(yn[r], sdot(qd + row[r] * ldn, ps, n), f[0]);
        f[1] = fmaf(fd[r], yn[r], f[1]);
      }
    }
    seg_sums<2>(f);
    if (!done && 0.5f * f[0] + f[1] <= 0.5f * s[2]) {
#pragma unroll
      for (int r = 0; r < kPackedRows; ++r) y[r] = yn[r];
    }
  }

  // The four-part test of terminate (PQP_CPU.c:673-687) per segment:
  // U = -Qp^-1 (Gp'Y + Fp) into the instance's U slice, feasibility
  // Gp U <= Kp_slack, explicit or complementarity gap.  Returns
  // "certified" (the same for every thread of the instance).
  __device__ __forceinline__ bool check(const float (&y)[kPackedRows]) const {
    stage(ys, y);
    __syncwarp();
    if (seg)
      for (int k = t; k < m; k += T)
        ts[k] = sdot(gpt + k * ldn, ys, n) + fp_at(k);
    __syncwarp();
    if (seg)
      for (int k = t; k < m; k += T) us[k] = -sdot(qpi + k * ldm, ts, m);
    __syncwarp();
    // viol count, Y'Qd Y, Fd'Y, U'Qp U, Fp'U
    float s[kRedSlots] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kPackedRows; ++r) {
      if (has[r]) {
        if (sdot(gp + row[r] * ldm, us, m) > kps[r]) s[0] += 1.f;
        s[1] = fmaf(y[r], sdot(qd + row[r] * ldn, ys, n), s[1]);
        s[2] = fmaf(fd[r], y[r], s[2]);
      }
    }
    if (seg) {
      for (int k = t; k < m; k += T) {
        const float uk = us[k];
        s[3] = fmaf(uk, sdot(qp + k * ldm, us, m), s[3]);
        s[4] = fmaf(fp_at(k), uk, s[4]);
      }
    }
    seg_sums<kRedSlots>(s);
    const float jd = 0.5f * s[1] + s[2] + 0.5f * md;
    const float jp = 0.5f * s[3] + s[4] + 0.5f * mp;
    float gap;
    bool weak_fail;
    if (gap_comp) {  // Jp(U(Y)) + Jd(Y) = Y'(Qd Y + Fd)
      gap = s[1] + s[2];
      weak_fail = gap > 0.f;
    } else {
      gap = jp + jd;
      weak_fail = jp > -jd;
    }
    bool fail = (s[0] != 0.f) || (gap > eaj) || (gap / fabsf(jd) > erj);
    if (strict) fail = fail || weak_fail;
    return !fail;
  }
};

__global__ void __launch_bounds__(kPackedWarps * 32)
full_solve_packed_kernel(const PackedArgs a) {
  extern __shared__ float4 smem4[];
  const int n = a.n, m = a.m;
  const PackedLayout L = packed_layout(n, m);
  const int ldn = L.ldn, ldm = L.ldm;
  float* s_qdn = reinterpret_cast<float*>(smem4);
  float* s_qdp = s_qdn + n * ldn;
  float* s_qd = s_qdp + n * ldn;
  float* s_gp = s_qd + n * ldn;
  float* s_gpt = s_gp + n * ldm;
  float* s_qp = s_gpt + m * ldn;
  float* s_qpi = s_qp + m * ldm;
  stage_matrix(s_qdn, a.qdn, n, n, ldn, false);
  stage_matrix(s_qdp, a.qdp, n, n, ldn, false);
  stage_matrix(s_qd, a.qd, n, n, ldn, false);
  stage_matrix(s_gp, a.gp, n, m, ldm, false);
  stage_matrix(s_gpt, a.gp, n, m, ldn, true);
  stage_matrix(s_qp, a.qp, m, m, ldm, false);
  stage_matrix(s_qpi, a.qpi, m, m, ldm, false);
  __syncthreads();

  const int G = L.G, T = L.T;
  const int Bc = (a.B + G - 1) / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kPackedWarps + warp;  // packed column
  if (c >= Bc) return;                             // warp-uniform

  float* w = reinterpret_cast<float*>(smem4) + L.mat_floats +
             warp * L.warp_floats;
  const int g = lane / T, t = lane % T;
  PackedLane S;
  S.seg = g < G;
  const int gs = S.seg ? g : 0;  // threads past the G instances: no slice
  S.ys = w + gs * ldn;
  S.ps = w + G * ldn + gs * ldn;
  S.ts = w + 2 * G * ldn + gs * ldm;
  S.us = w + 2 * G * ldn + G * ldm + gs * ldm;
  S.red = w + 2 * G * ldn + 2 * G * ldm;
  S.red_base = gs * T;
  S.qdn = s_qdn; S.qdp = s_qdp; S.qd = s_qd; S.gp = s_gp; S.gpt = s_gpt;
  S.qp = s_qp; S.qpi = s_qpi;
  S.n = n; S.m = m; S.ldn = ldn; S.ldm = ldm; S.T = T; S.t = t;
  S.lane = lane;
  S.eaj = a.eaj; S.erj = a.erj; S.den_eps = a.den_eps;
  S.strict = a.strict != 0; S.gap_comp = a.gap_comp != 0;

  // instance g of packed column c is batch lane g * Bc + c; a lane past B
  // (or a thread past the G instances) reads lane B - 1 and writes nothing
  const int b = g * Bc + c;
  const bool valid = S.seg && b < a.B;
  const int br = b < a.B ? b : a.B - 1;
  const LanePanel fd = lane_panel(a.fd, a.fd_lane, a.B, br);
  const LanePanel fdp = lane_panel(a.fdp, a.fdp_lane, a.B, br);
  const LanePanel fdn = lane_panel(a.fdn, a.fdn_lane, a.B, br);
  const LanePanel kps = lane_panel(a.kps, a.kps_lane, a.B, br);
  const LanePanel Y0 = lane_panel(a.y0, a.y0_lane, a.B, br);
  S.fp = a.fp + (a.fp_lane ? br : 0);
  S.fp_row = a.fp_lane ? (long long)a.B : 1LL;
  S.mp = a.mp[a.mp_lane ? br : 0];
  S.md = a.md[a.md_lane ? br : 0];
  float y[kPackedRows];
#pragma unroll
  for (int r = 0; r < kPackedRows; ++r) {
    const int i = t + T * r;
    S.has[r] = S.seg && i < n;
    const int ic = i < n ? i : n - 1;
    S.row[r] = ic;
    S.fd[r] = fd[ic]; S.fdp[r] = fdp[ic]; S.fdn[r] = fdn[ic];
    S.kps[r] = kps[ic];
    y[r] = S.has[r] ? Y0[ic] : 0.f;
  }

  const int inner = a.accel_every ? a.accel_every : a.check_every;
  const int n_chunks =
      a.accel_every ? max(1, a.check_every / a.accel_every) : 1;
  int state = valid ? kActive : kPadding, iters = 0, h = 1;
  while (__any_sync(kFullMask, state == kActive) && h <= a.max_iters) {
    const bool ok = S.check(y);
    if (ok && state == kActive) {
      iters = h;
      state = kCertified;
    }
    const bool done = state != kActive;
    float y_prev[kPackedRows];
#pragma unroll
    for (int r = 0; r < kPackedRows; ++r) y_prev[r] = y[r];
    for (int ch = 0; ch < n_chunks; ++ch) {
      for (int s = 0; s < inner; ++s) S.update(y, done);
      if (a.accel_every) S.accel(y, done);
    }
    // Stall freeze: an iterate bit-identical after a whole block is at a
    // fixed point; its check just failed and would fail forever.
    float diff[1] = {0.f};
#pragma unroll
    for (int r = 0; r < kPackedRows; ++r)
      if (S.has[r]) diff[0] += fabsf(y[r] - y_prev[r]);
    S.seg_sums<1>(diff);
    if (diff[0] == 0.f && state == kActive) {
      iters = h + a.check_every;
      state = kStalled;
    }
    h += a.check_every;
  }
  // the final check: the verdict of a lane still active, and U
  const bool ok = S.check(y);
  if (ok && state == kActive) {
    iters = h;
    state = kCertified;
  }
  if (state == kActive) iters = h;
  if (!valid) return;
#pragma unroll
  for (int r = 0; r < kPackedRows; ++r)
    if (S.has[r]) a.y_out[(long long)S.row[r] * a.B + b] = y[r];
  for (int k = t; k < m; k += T) a.u_out[(long long)k * a.B + b] = S.us[k];
  if (t == 0) {
    a.iters_out[b] = iters;
    a.state_out[b] = state;
  }
}

}  // namespace pqp

extern "C" int full_solve_packed_f32(
    const float* qdn, const float* qdp, const float* qd, const float* gp,
    const float* qp, const float* qpi, const float* fp, int fp_lane,
    const float* fd, int fd_lane, const float* fdp, int fdp_lane,
    const float* fdn, int fdn_lane, const float* kps, int kps_lane,
    const float* mp, int mp_lane, const float* md, int md_lane,
    const float* y0, int y0_lane, float* y_out, float* u_out, int* iters_out,
    int* state_out, int n, int m, int B, int max_iters, int check_every,
    int accel_every, float eaj, float erj, int strict, float den_eps,
    int gap_comp, void* stream) {
  pqp::PackedArgs a;
  a.qdn = qdn; a.qdp = qdp; a.qd = qd; a.gp = gp; a.qp = qp; a.qpi = qpi;
  a.fp = fp; a.fd = fd; a.fdp = fdp; a.fdn = fdn; a.kps = kps; a.mp = mp;
  a.md = md; a.y0 = y0;
  a.fp_lane = fp_lane; a.fd_lane = fd_lane; a.fdp_lane = fdp_lane;
  a.fdn_lane = fdn_lane; a.kps_lane = kps_lane; a.mp_lane = mp_lane;
  a.md_lane = md_lane; a.y0_lane = y0_lane;
  a.y_out = y_out; a.u_out = u_out; a.iters_out = iters_out;
  a.state_out = state_out;
  a.n = n; a.m = m; a.B = B; a.max_iters = max_iters;
  a.check_every = check_every; a.accel_every = accel_every;
  a.eaj = eaj; a.erj = erj; a.strict = strict; a.den_eps = den_eps;
  a.gap_comp = gap_comp;

  if (n < 1 || m < 1 || B < 1 || check_every < 1 || accel_every < 0)
    return (int)cudaErrorInvalidValue;
  const pqp::PackedLayout L = pqp::packed_layout(n, m);
  const size_t smem = pqp::packed_smem_bytes(n, m);
  if (L.G < 2 || smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pqp::full_solve_packed_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long Bc = ((long long)B + L.G - 1) / L.G;
  const dim3 grid((unsigned)((Bc + pqp::kPackedWarps - 1) / pqp::kPackedWarps));
  pqp::full_solve_packed_kernel<<<grid, pqp::kPackedWarps * 32, smem,
                                  static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
