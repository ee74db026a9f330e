// K2: num_iters multiplicative PQP updates in one launch.
//
// Replaces the TPU kernel pqp_for_mpc_tpu/ops/kernels.py:
// fused_pqp_iterations (its Pallas body _iterate_kernel), which keeps both
// split matrices and a (N, Bblk) panel of Y in VMEM for all num_iters
// updates
//     Y <- Y * ((Qd^- + th) Y + Fd^-) / max((Qd^+ + th) Y + Fd^+, den_eps).
//
// Design: register blocking.  A block owns a tile of lanes and every row:
// both splits staged once in shared memory, transposed (q[k][r], rows
// padded to a multiple of R with zeros), and the block's (N x LB) tile of
// Y in shared memory, ping-ponging between two buffers with one
// __syncthreads per update.  A thread owns R = 4 rows x L = 4 lanes: for
// each depth k it loads R entries of each split (one float4, the same for
// every thread of its row group) and L entries of the iterate (one
// float4), and does 2 R L = 32 fused multiply-adds into 32 independent
// accumulators.  Its R x L entries of Fd^- and Fd^+ stay in registers for
// the launch, so Y and the forcing panels are read once and Y written once
// per launch, each thread's entries in one batch of vector loads (the
// wrapper hands 16-byte aligned panels).  The block is (N_pad / R) row
// groups x LG lane groups, LG the largest power of two with at most 256
// threads, at most 32 (ops/kernels.py: k2_plan): at N = 28, 7 x 32
// threads over 128 lanes.  Each entry's sum runs in ascending k from 0
// with fused multiply-adds, then adds Fd (tile4::update in pqp_common.cuh,
// the lane-tile engine's update too), so a relaunch repeats every bit.  N
// above 128 is refused.  R = L = 4 is the fastest thread tile measured on an H100
// (PERF.md): 4 x 2, 2 x 4 and smaller tiles, and this tile with its
// registers capped for 3 or 4 blocks per SM, ran slower.
//
// What bounds it on an H100.  Per update a lane does 2 N^2 FMAs (1,568 at
// N = 28) against its 2 N forcing entries, which are read once per launch
// here: the function is bound by its float32 operations (8 updates at
// B = 2^22: 105 GFLOP).  The previous design (one thread per lane, y in
// registers, the split rows read as broadcast float4 loads: one load per 4
// FMAs, Fd re-read from global memory on every update) ran at 20% of the
// FMA peak.  Here a load feeds 10.7 FMAs on average and each thread has 32
// independent chains, so the FMA pipe is the design's ceiling; measured on
// an H100 SXM (700 W) it runs 8 updates at B = 2^22 in 3.9 ms, 41% of the
// FMA peak.  The likely limit: 128 registers leave 2 blocks of 7 warps
// per SM, so a block's load and store phases hide behind only one other
// block's updates.
//
// Semantics match pqp_for_mpc_tpu_torch/ops/kernels.py:
// fused_pqp_iterations_reference up to float32 summation order.

#include <cuda_runtime.h>

#include "pqp_common.cuh"

namespace pqp {
namespace k2 {

using tile4::R;
using tile4::L;
using tile4::load;
using tile4::store;
constexpr int kMaxThreads = 256;
constexpr int kMaxLaneGroups = 32;

// This thread's L lanes of row r of a batch-last (n x B) panel: one
// vector load when the lanes are whole and aligned (B % L == 0), else one
// load per lane; lanes past B read 0.  A shared panel (lane = 0) repeats
// its entry r.
__device__ __forceinline__ void panel_lanes(const float* p, int lane,
                                            long long r, long long b, int B,
                                            float (&v)[L]) {
  if (!lane) {
#pragma unroll
    for (int j = 0; j < L; ++j) v[j] = p[r];
  } else if (B % L == 0 && b + L <= B) {
    load(p + r * B + b, v);
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) v[j] = (b + j < B) ? p[r * B + b + j] : 0.f;
  }
}

struct Plan {
  int np, row_groups, lane_groups, lanes, threads;
  size_t smem;
};

__host__ __device__ inline Plan plan(int n) {
  Plan p;
  p.np = (n + R - 1) / R * R;
  p.row_groups = p.np / R;
  int lg = 1;
  while (2 * lg <= kMaxLaneGroups && 2 * lg * p.row_groups <= kMaxThreads)
    lg *= 2;
  p.lane_groups = lg;
  p.lanes = L * lg;
  p.threads = p.row_groups * lg;
  // both splits (n x np) and two (n x lanes) iterate tiles
  p.smem = (2 * (size_t)n * p.np + 2 * (size_t)n * p.lanes) * sizeof(float);
  return p;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
pqp_iterations_kernel(const float* __restrict__ qdn,
                      const float* __restrict__ qdp,
                      const float* __restrict__ fdn,
                      const float* __restrict__ fdp, int fd_lane,
                      const float* __restrict__ y_in,
                      float* __restrict__ y_out, int n, int B,
                      int num_iters, float den_eps) {
  const Plan pl = plan(n);
  const int np = pl.np, lb = pl.lanes;
  extern __shared__ float4 smem4[];
  float* s_qn = reinterpret_cast<float*>(smem4);  // s_qn[k * np + r]
  float* s_qp = s_qn + n * np;
  float* ys = s_qp + n * np;                      // 2 x (n x lb)
#pragma unroll 4
  for (int e = threadIdx.x; e < n * np; e += blockDim.x) {
    const int k = e / np, r = e % np;
    s_qn[e] = r < n ? qdn[r * n + k] : 0.f;
    s_qp[e] = r < n ? qdp[r * n + k] : 0.f;
  }
  const long long b0 = (long long)blockIdx.x * lb;
  const int rg = threadIdx.x / pl.lane_groups;
  const int lg = threadIdx.x % pl.lane_groups;
  const int r0 = R * rg, c0 = L * lg;
  // this thread's R x L entries of Y and of both forcing panels, all loads
  // issued together
  float fn[R][L], fp[R][L], y0[R][L];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i < n ? r0 + i : n - 1;  // rows past n: unused
    panel_lanes(y_in, 1, r, b0 + c0, B, y0[i]);
    panel_lanes(fdn, fd_lane, r, b0 + c0, B, fn[i]);
    panel_lanes(fdp, fd_lane, r, b0 + c0, B, fp[i]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (r0 + i < n) store(ys + (r0 + i) * lb + c0, y0[i]);
  __syncthreads();

  int cur = 0;
  for (int it = 0; it < num_iters; ++it) {
    tile4::update(s_qn, s_qp, np, ys + cur * n * lb, ys + (cur ^ 1) * n * lb,
                  lb, n, r0, c0, fn, fp, den_eps);
    __syncthreads();
    cur ^= 1;
  }

  // this thread's entries of the result, from the tile
  const float* yc = ys + cur * n * lb;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i;
    if (r >= n) continue;
    float y[L];
    load(yc + r * lb + c0, y);
    const long long b = b0 + c0;
    if (B % L == 0 && b + L <= B) {
      store(y_out + r * (long long)B + b, y);
    } else {
#pragma unroll
      for (int j = 0; j < L; ++j)
        if (b + j < B) y_out[r * (long long)B + b + j] = y[j];
    }
  }
}

}  // namespace k2
}  // namespace pqp

extern "C" int pqp_iterations_f32(const float* qdn, const float* qdp,
                                  const float* fdn, const float* fdp,
                                  int fd_lane, const float* y, float* y_out,
                                  int n, int B, int num_iters, float den_eps,
                                  void* stream) {
  if (n < 1 || n > 128 || B < 1) return (int)cudaErrorInvalidValue;
  const pqp::k2::Plan pl = pqp::k2::plan(n);
  if (pl.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pqp::k2::pqp_iterations_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((B + pl.lanes - 1) / pl.lanes);
  pqp::k2::pqp_iterations_kernel<<<grid, pl.threads, pl.smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      qdn, qdp, fdn, fdp, fd_lane, y, y_out, n, B, num_iters, den_eps);
  return (int)cudaGetLastError();
}

extern "C" const char* pqp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
