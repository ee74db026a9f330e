// K1: the whole batched PQP solve in one launch.
//
// Replaces the TPU kernel pqp_for_mpc_tpu/ops/solve_kernel.py:
// fused_full_solve (its Pallas body _kernel): multiplicative updates, the
// periodic four-part termination check with the recovered U, optional
// safeguarded acceleration, the stall freeze and the early exit, with the
// problem geometry resident in fast memory for the whole solve.
//
// Design.  One thread per batch lane runs its own loop: check; unless
// certified, check_every updates (or check_every/accel_every chunks of
// accel_every updates, each closed by one accel step), then the stall
// test; until its state leaves 0 or h > max_iters; then the final check,
// which also gives U.  The TPU grid instead loops a whole batch block until
// every lane of the block is done, freezing done lanes.  Lanes never read
// each other and a done lane is frozen, so for every lane the iterates,
// iters and state code here are those of the TPU kernel; only the time a
// finished lane waits differs.
//
// A block of 128 lanes stages the geometry in shared memory: Qd^-+th,
// Qd^++th, Qd (N x N), Gp (N x M) and its transpose, Qp and Qp^-1 (M x M),
// rows padded to 4 floats — 3N^2 + 2NM + 2M^2 floats, 11.3 KB at N = 28,
// M = 7.  Above 48 KB the launch raises the dynamic shared-memory limit
// (cudaFuncSetAttribute); the wrapper refuses shapes past 227 KB or
// max(N, M) > 128.  The lane's y and the work vectors live in register
// arrays of NMAX (32, 64, 128) entries; at NMAX = 32 every loop unrolls
// and they stay in registers, above it the row loops stay rolled and the
// arrays spill to local memory (correct, not tuned).  No batch padding:
// threads with b >= B return, so state 3 (padding) never arises here.
//
// What bounds it on an H100.  The geometry is read once per block; each
// update costs a lane 2 N^2 FMAs and 2 N panel loads (Fd^-, Fd^+), a check
// (every check_every updates) about 2NM + 2M^2 + N^2 FMAs and 3 N + M
// loads.  Measured on an H100 SXM (700 W) at N = 28, B = 2^22: 0.61 s per
// batch, 8.5% of the float32 FMA peak — latency-bound: at NMAX = 32 the
// kernel takes 234 registers (8 warps per SM), and a warp runs until its
// slowest lane is done.  Capping registers at 128 for 16 warps per SM made
// it 1.3x slower (spills); staging the Fd panels in shared memory made it
// 1.15x faster — left for the kernel's tuning.
//
// Semantics match pqp_for_mpc_tpu_torch/ops/solve_kernel.py:
// fused_full_solve_reference up to float32 summation order.  Every clamp
// and test keeps NaN as the reference does (guard_den, relu_nan; the
// verdict in the reference's "fail if x > tol" form).

#include <cuda_runtime.h>

#include "pqp_common.cuh"

namespace pqp {

enum LaneState : int {
  kActive = 0,     // still iterating; at exit: hit max_iters
  kCertified = 1,  // the in-kernel termination test passed
  kStalled = 2,    // bit-identical iterate over a whole check block
  kPadding = 3,    // batch padding (TPU layout only; never produced here)
};

struct FullSolveArgs {
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

__host__ __device__ inline size_t full_solve_smem_floats(int n, int m) {
  const size_t ldn = round4(n), ldm = round4(m);
  return 3 * n * ldn + n * ldm + m * ldn + 2 * m * ldm;
}

// One lane's view of the resident geometry and its panels.
template <int NMAX>
struct LaneSolver {
  const float *qdn, *qdp, *qd, *gp, *gpt, *qp, *qpi;  // shared memory
  int n, m, ldn, ldm;
  LanePanel fp, fd, fdp, fdn, kps;
  float mp, md, eaj, erj, den_eps;
  bool strict, gap_comp;

  // Y <- Y * (Qdn Y + Fdn) / guard(Qdp Y + Fdp)
  __device__ __forceinline__ void update(float (&y)[NMAX]) const {
    update_lane<NMAX>(qdn, qdp, ldn, fdn, fdp, y, n, den_eps);
  }

  // Projected steepest descent with exact line search on
  // f(Y) = 1/2 Y'Qd Y + Fd'Y, kept only when f does not increase
  // (solver.accel_step).
  __device__ __forceinline__ void accel(float (&y)[NMAX]) const {
    float p[NMAX];
    float fy = 0.f;
#pragma unroll(NMAX <= 32 ? NMAX : 1)
    for (int i = 0; i < NMAX; ++i) {
      float pi = 0.f;
      if (i < n) {
        const float fdi = fd[i];
        const float g = row_dot<NMAX>(qd + i * ldn, y, n) + fdi;
        pi = (y[i] > 0.f || g < 0.f) ? -g : 0.f;
        fy = fmaf(y[i], g + fdi, fy);
      }
      p[i] = pi;
    }
    float pqp = 0.f, pp = 0.f;
#pragma unroll(NMAX <= 32 ? NMAX : 1)
    for (int i = 0; i < NMAX; ++i) {
      if (i < n) {
        pqp = fmaf(p[i], row_dot<NMAX>(qd + i * ldn, p, n), pqp);
        pp = fmaf(p[i], p[i], pp);
      }
    }
    const float alpha =
        (pqp > 0.f) ? pp / (pqp < 1e-30f ? 1e-30f : pqp) : 0.f;
    float yn[NMAX];
#pragma unroll
    for (int i = 0; i < NMAX; ++i)
      yn[i] = (i < n) ? relu_nan(y[i] + alpha * p[i]) : 0.f;
    float q = 0.f, l = 0.f;
#pragma unroll(NMAX <= 32 ? NMAX : 1)
    for (int i = 0; i < NMAX; ++i) {
      if (i < n) {
        q = fmaf(yn[i], row_dot<NMAX>(qd + i * ldn, yn, n), q);
        l = fmaf(fd[i], yn[i], l);
      }
    }
    if (0.5f * q + l <= 0.5f * fy) {
#pragma unroll
      for (int i = 0; i < NMAX; ++i) y[i] = yn[i];
    }
  }

  // The four-part test of terminate (PQP_CPU.c:673-687) as the TPU
  // kernel's check: U = -Qp^-1 (Gp'Y + Fp), feasibility Gp U <= Kp_slack,
  // explicit or complementarity gap.  Writes U; returns "certified".
  __device__ __forceinline__ bool check(const float (&y)[NMAX],
                                        float (&u)[NMAX]) const {
    float t[NMAX];
#pragma unroll(NMAX <= 32 ? NMAX : 1)
    for (int k = 0; k < NMAX; ++k)
      t[k] = (k < m) ? row_dot<NMAX>(gpt + k * ldn, y, n) + fp[k] : 0.f;
#pragma unroll(NMAX <= 32 ? NMAX : 1)
    for (int r = 0; r < NMAX; ++r)
      u[r] = (r < m) ? -row_dot<NMAX>(qpi + r * ldm, t, m) : 0.f;
    bool feas = true;
    float s1 = 0.f, s2 = 0.f;  // Y'Qd Y and Fd'Y
#pragma unroll(NMAX <= 32 ? NMAX : 1)
    for (int i = 0; i < NMAX; ++i) {
      if (i < n) {
        if (row_dot<NMAX>(gp + i * ldm, u, m) > kps[i]) feas = false;
        s1 = fmaf(y[i], row_dot<NMAX>(qd + i * ldn, y, n), s1);
        s2 = fmaf(fd[i], y[i], s2);
      }
    }
    const float jd = 0.5f * s1 + s2 + 0.5f * md;
    float uqu = 0.f, fu = 0.f;
#pragma unroll(NMAX <= 32 ? NMAX : 1)
    for (int r = 0; r < NMAX; ++r) {
      if (r < m) {
        uqu = fmaf(u[r], row_dot<NMAX>(qp + r * ldm, u, m), uqu);
        fu = fmaf(fp[r], u[r], fu);
      }
    }
    const float jp = 0.5f * uqu + fu + 0.5f * mp;
    float gap;
    bool weak_fail;
    if (gap_comp) {  // Jp(U(Y)) + Jd(Y) = Y'(Qd Y + Fd)
      gap = s1 + s2;
      weak_fail = gap > 0.f;
    } else {
      gap = jp + jd;
      weak_fail = jp > -jd;
    }
    bool fail = !feas || (gap > eaj) || (gap / fabsf(jd) > erj);
    if (strict) fail = fail || weak_fail;
    return !fail;
  }
};

template <int NMAX>
__global__ void __launch_bounds__(kLanesPerBlock)
full_solve_kernel(const FullSolveArgs a) {
  extern __shared__ float4 smem4[];
  const int n = a.n, m = a.m, ldn = round4(n), ldm = round4(m);
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

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;

  LaneSolver<NMAX> S;
  S.qdn = s_qdn; S.qdp = s_qdp; S.qd = s_qd; S.gp = s_gp; S.gpt = s_gpt;
  S.qp = s_qp; S.qpi = s_qpi;
  S.n = n; S.m = m; S.ldn = ldn; S.ldm = ldm;
  S.fp = lane_panel(a.fp, a.fp_lane, a.B, b);
  S.fd = lane_panel(a.fd, a.fd_lane, a.B, b);
  S.fdp = lane_panel(a.fdp, a.fdp_lane, a.B, b);
  S.fdn = lane_panel(a.fdn, a.fdn_lane, a.B, b);
  S.kps = lane_panel(a.kps, a.kps_lane, a.B, b);
  S.mp = a.mp[a.mp_lane ? b : 0];
  S.md = a.md[a.md_lane ? b : 0];
  S.eaj = a.eaj; S.erj = a.erj; S.den_eps = a.den_eps;
  S.strict = a.strict != 0; S.gap_comp = a.gap_comp != 0;

  const LanePanel Y0 = lane_panel(a.y0, a.y0_lane, a.B, b);
  float y[NMAX];
#pragma unroll
  for (int i = 0; i < NMAX; ++i) y[i] = (i < n) ? Y0[i] : 0.f;

  // One check, one update and one accel site in the loop body keeps the
  // unrolled code (and ptxas's time) small.  A lane passes the check once
  // more after it stops iterating: that is the final check, which also
  // gives U; for a certified or stalled lane it sees the same iterate.
  const int inner = a.accel_every ? a.accel_every : a.check_every;
  const int n_chunks =
      a.accel_every ? max(1, a.check_every / a.accel_every) : 1;
  int state = kActive, iters = 0, h = 1;
  for (;;) {
    float u[NMAX];
    const bool ok = S.check(y, u);
    if (state != kActive || h > a.max_iters) {
      if (state == kActive) {  // out of iterations: the final verdict
        iters = h;
        if (ok) state = kCertified;
      }
#pragma unroll
      for (int i = 0; i < NMAX; ++i)
        if (i < n) a.y_out[(long long)i * a.B + b] = y[i];
#pragma unroll
      for (int r = 0; r < NMAX; ++r)
        if (r < m) a.u_out[(long long)r * a.B + b] = u[r];
      a.iters_out[b] = iters;
      a.state_out[b] = state;
      return;
    }
    if (ok) {
      iters = h;
      state = kCertified;
    } else {
      float y_prev[NMAX];
#pragma unroll
      for (int i = 0; i < NMAX; ++i) y_prev[i] = y[i];
      for (int c = 0; c < n_chunks; ++c) {
        for (int t = 0; t < inner; ++t) S.update(y);
        if (a.accel_every) S.accel(y);
      }
      // Stall freeze: an iterate bit-identical after a whole block is at
      // a fixed point (e.g. underflowed to the absorbing zero); its check
      // just failed and would fail forever.
      float diff = 0.f;
#pragma unroll
      for (int i = 0; i < NMAX; ++i) diff += fabsf(y[i] - y_prev[i]);
      if (diff == 0.f) {
        iters = h + a.check_every;
        state = kStalled;
      }
    }
    h += a.check_every;
  }
}

template <int NMAX>
static cudaError_t launch_full_solve(const FullSolveArgs& a,
                                     cudaStream_t stream) {
  const size_t smem = full_solve_smem_floats(a.n, a.m) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        full_solve_kernel<NMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.B + kLanesPerBlock - 1) / kLanesPerBlock);
  full_solve_kernel<NMAX><<<grid, kLanesPerBlock, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace pqp

extern "C" int full_solve_f32(
    const float* qdn, const float* qdp, const float* qd, const float* gp,
    const float* qp, const float* qpi, const float* fp, int fp_lane,
    const float* fd, int fd_lane, const float* fdp, int fdp_lane,
    const float* fdn, int fdn_lane, const float* kps, int kps_lane,
    const float* mp, int mp_lane, const float* md, int md_lane,
    const float* y0, int y0_lane, float* y_out, float* u_out, int* iters_out,
    int* state_out, int n, int m, int B, int max_iters, int check_every,
    int accel_every, float eaj, float erj, int strict, float den_eps,
    int gap_comp, void* stream) {
  pqp::FullSolveArgs a;
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

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || m < 1 || B < 1 || check_every < 1 || accel_every < 0 ||
      pqp::full_solve_smem_floats(n, m) * sizeof(float) > 232448)
    return (int)cudaErrorInvalidValue;
  const int nmax = n > m ? n : m;
  if (nmax <= 32) return (int)pqp::launch_full_solve<32>(a, s);
  if (nmax <= 64) return (int)pqp::launch_full_solve<64>(a, s);
  if (nmax <= 128) return (int)pqp::launch_full_solve<128>(a, s);
  return (int)cudaErrorInvalidValue;
}
