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
// 1, whichever the card can hold with the fewest waves), the cluster body
// of cluster_solve.cuh that K5 shares: block rank r owns a contiguous range
// of n / C rows of Qd_hat and Gp (and of the m rows of Qp, Qp^-1), streamed
// from global memory, and keeps a full copy of the instance's y in shared
// memory; cluster.sync() is the Jacobi barrier.  The product Gp'Y runs one
// thread per column over the block's rows, its M partials summed in rank
// order.  Chosen over a cooperative grid with
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

#include <cuda_runtime.h>

#include "cluster_solve.cuh"

namespace pqp {

constexpr int kTiledThreads = 512;
// blocks per SM the registers must allow: 2 caps them at 64 (a few hundred
// bytes spill); uncapped the body takes 124 and ran 14% slower at B = 8,
// n = 2048 on an H100 (tools/probe_k6.py builds both with -D).
#ifndef PQP_K6_MIN_BLOCKS
#define PQP_K6_MIN_BLOCKS 2
#endif

__global__ void __launch_bounds__(kTiledThreads, PQP_K6_MIN_BLOCKS)
full_solve_distinct_tiled_kernel(const ClusterSolveArgs a) {
  cluster_solve<false>(a);
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
  pqp::ClusterSolveArgs a = {};
  a.q = qh; a.theta = theta; a.gp = gp; a.qp = qp; a.qpi = qpi;
  a.gp_stride = gp_stride; a.qp_stride = qp_stride;
  a.fp = fp; a.fd = fd; a.fdp = fdp; a.fdn = fdn; a.kps = kps;
  a.mp = mp; a.md = md; a.y0 = y0;
  a.y_out = y_out; a.u_out = u_out;
  a.iters_out = iters_out; a.state_out = state_out;
  a.n = n; a.m = m; a.max_iters = max_iters; a.check_every = check_every;
  a.accel_every = accel ? check_every : 0; a.eaj = eaj; a.erj = erj;
  a.strict = strict; a.den_eps = den_eps; a.gap_comp = gap_comp;
  a.resident = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      pqp::full_solve_distinct_tiled_kernel,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  const int sizes[] = {16, 8, 4, 2, 1};
  int C = 0, clusters = 0;
  size_t smem = 0;
  err = pqp::pick_cluster(pqp::full_solve_distinct_tiled_kernel,
                          pqp::kTiledThreads, sizes, 5, n, m, B, false,
                          false, s, C, smem, clusters);
  if (err != cudaSuccess) return (int)err;
  return (int)pqp::launch_clusters(pqp::full_solve_distinct_tiled_kernel,
                                   pqp::kTiledThreads, C, smem, a, B, s);
}
