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
// Design.  One instance per thread-block CLUSTER of C blocks, its owned Qd
// rows resident in the cluster's shared memory: the cluster body of
// cluster_solve.cuh.  Block rank r owns a contiguous
// range of rows; at the start it copies its rows of Qd into its shared
// memory once (cp.async), and every update, check and accel pass reads them
// from there; Gp, Qp and Qp^-1 are read from L2 at the check cadence (every
// 8 updates on the resident path), which leaves room for more clusters than
// keeping them resident too (that layout lost: PERF.md, PR 5).  Only the
// iterate travels: each rank publishes its new rows, the others read them
// through distributed shared memory, and cluster.sync() is the Jacobi
// barrier.  The splits are never read as matrices: off the diagonal
// relu(+-Qd_ij) is bit for bit what dualize_distinct materializes, and the
// splits' two diagonals come in as (B, n) vectors, read once per instance,
// so the products are the materialized splits' products summed in another
// order.  The plan (ops/distinct_kernel.py: k5_plan) says whether one
// instance's Qd rows fit C <= 16 blocks (resident); else the same body
// reads its rows of one Qd from global memory, half the bytes of streaming
// both splits.  This launcher picks C with cudaOccupancyMaxActiveClusters
// (fewest waves x rows per block), sizes above 8 allowed as non-portable:
// at n = 400, m = 100 16 blocks, four blocks per SM, 28 clusters in flight
// (tools/probe_k5.py).  A certified cluster returns and frees its SMs for
// the clusters still waiting (the per-instance early exit).
// Every per-instance scalar is a fixed-order sum (block, then ranks in rank
// order), so a relaunch repeats every bit.
//
// What bounds it on an H100.  Read once, the inputs of a whole solve are
// small beside its thousands of updates, so the least time for the function
// is its float32 operations.  With the rows resident an update reads n^2
// floats of shared memory and no device memory (1,024 x 6,534 lane-updates
// at n = 400: ~4.3 TB, ~0.15 s at ~34 TB/s of aggregate shared-memory
// bandwidth), plus one cluster barrier and a gather of n floats through
// distributed shared memory per update.  The sweep of a block's n / C rows
// is short, so what holds the design above that floor is latency and
// instruction issue: warp-per-row dots with two butterflies per row, the
// barrier, and how many clusters share the SMs to hide both.  Hence the
// relu of each entry in one max.NaN instruction, the update inlined (a
// call spilled registers to local memory, which the shared-memory
// carve-out leaves little L1 for), rank loops unrolled so that their
// distributed-shared-memory loads overlap, and registers capped for four
// blocks per SM.
//
// Semantics match pqp_for_mpc_tpu_torch/ops/distinct_kernel.py:
// fused_full_solve_distinct_reference up to float32 summation order.  Lane
// codes as K1's (0 max_iters, 1 certified, 2 stalled).

#include <cuda_runtime.h>

#include "cluster_solve.cuh"

namespace pqp {

constexpr int kDistinctThreads = 256;
// blocks per SM the registers must allow: 4 caps them at 64 (a few bytes
// spill), which lets four 48 KB resident blocks share an SM; 2 and 3 were
// slower at n = 400.  tools/probe_k5.py builds its variants with -D: other
// caps, and one cluster size in place of the launcher's choice.
#ifndef PQP_K5_MIN_BLOCKS
#define PQP_K5_MIN_BLOCKS 4
#endif
#ifndef PQP_K5_SIZES
#define PQP_K5_SIZES 16, 8, 4, 2, 1
#endif

__global__ void __launch_bounds__(kDistinctThreads, PQP_K5_MIN_BLOCKS)
full_solve_distinct_kernel(const ClusterSolveArgs a) {
  cluster_solve(a);
}

// The cluster size for B instances, with the Qd rows resident or not.
static cudaError_t k5_pick(int n, int m, int B, bool resident,
                           cudaStream_t s, int& C, size_t& smem,
                           int& clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      full_solve_distinct_kernel,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  const int sizes[] = {PQP_K5_SIZES};
  return pick_cluster(full_solve_distinct_kernel, kDistinctThreads, sizes,
                      (int)(sizeof(sizes) / sizeof(sizes[0])), n, m, B,
                      resident, s, C, smem, clusters);
}

}  // namespace pqp

// dn, dp (B, n): the diagonals of the splits Qdn_theta, Qdp_theta, whose
// off-diagonal entries must be relu(-Qd), relu(Qd); qd (B, n, n); gp
// (B, n, m) with instance stride gp_stride (0 = shared); qp, qpi (B, m, m)
// with stride qp_stride.  Panels instance-major: fp (B, m); fd, fdp, fdn,
// kps, y0 (B, n); mp, md (B).  Outputs: y_out (B, n), u_out (B, m),
// iters_out, state_out (B).  resident: the Qd rows in shared memory (the
// plan says whether they fit).
extern "C" int full_solve_distinct_f32(
    const float* dn, const float* dp, const float* qd, const float* gp,
    long long gp_stride, const float* qp, const float* qpi,
    long long qp_stride, const float* fp, const float* fd, const float* fdp,
    const float* fdn, const float* kps, const float* mp, const float* md,
    const float* y0, float* y_out, float* u_out, int* iters_out,
    int* state_out, int n, int m, int B, int max_iters, int check_every,
    int accel_every, float eaj, float erj, int strict, float den_eps,
    int resident, void* stream) {
  if (n < 1 || m < 1 || B < 1 || check_every < 1 || accel_every < 0)
    return (int)cudaErrorInvalidValue;
  pqp::ClusterSolveArgs a = {};
  a.q = qd; a.dn = dn; a.dp = dp; a.gp = gp; a.qp = qp; a.qpi = qpi;
  a.gp_stride = gp_stride; a.qp_stride = qp_stride;
  a.fp = fp; a.fd = fd; a.fdp = fdp; a.fdn = fdn; a.kps = kps;
  a.mp = mp; a.md = md; a.y0 = y0;
  a.y_out = y_out; a.u_out = u_out;
  a.iters_out = iters_out; a.state_out = state_out;
  a.n = n; a.m = m; a.max_iters = max_iters; a.check_every = check_every;
  a.accel_every = accel_every; a.eaj = eaj; a.erj = erj;
  a.strict = strict; a.den_eps = den_eps;
  a.resident = resident != 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int C = 0, clusters = 0;
  size_t smem = 0;
  cudaError_t err =
      pqp::k5_pick(n, m, B, a.resident, s, C, smem, clusters);
  if (err != cudaSuccess) return (int)err;
  return (int)pqp::launch_clusters(pqp::full_solve_distinct_kernel,
                                   pqp::kDistinctThreads, C, smem, a, B, s);
}

// What full_solve_distinct_f32 would launch for (n, m, B, resident) on
// this card: out[0] blocks per instance, out[1] clusters the card holds at
// once, out[2] shared memory per block in bytes.
extern "C" int full_solve_distinct_cluster(int n, int m, int B, int resident,
                                           int* out) {
  int C = 0, clusters = 0;
  size_t smem = 0;
  cudaError_t err = pqp::k5_pick(n, m, B, resident != 0, 0, C, smem,
                                 clusters);
  if (err != cudaSuccess) return (int)err;
  out[0] = C;
  out[1] = clusters;
  out[2] = (int)smem;
  return 0;
}
