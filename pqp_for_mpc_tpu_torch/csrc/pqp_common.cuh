// Helpers shared by the kernels (pqp_iterations.cu, lane_tile_solve.cuh
// and, through fma_tile.cuh and distinct_common.cuh, the streamed and the
// distinct-geometry kernels).
//
// Layout conventions, as the Python wrappers pass them:
//  * matrices are row-major float32 in device memory; a kernel stages them
//    in shared memory in the layout its products read;
//  * panels are batch-last, element (i, b) at p[i * B + b]: neighbouring
//    threads (lanes) read neighbouring addresses.  A panel shared by every
//    lane is passed as a column with lane flag 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pqp {

// Per-lane exit codes of the whole-solve kernels (the TPU kernels' codes).
enum LaneState : int {
  kActive = 0,     // still iterating; at exit: hit max_iters
  kCertified = 1,  // the in-kernel termination test passed
  kStalled = 2,    // bit-identical iterate over a whole check block
  kPadding = 3,    // batch padding (TPU layout only; never produced here)
};

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Round to bf16 (nearest even, as torch's .bfloat16()) and back: the operand
// the TPU's bf16 matvec sees.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The guarded denominator of the update.  Written as a comparison, not
// fmaxf: fmaxf(NaN, x) returns x, while the reference (jnp.maximum,
// torch.clamp) propagates NaN, and a diverging lane must stay NaN so that
// the divergence test sees it.  den_eps == 0 means no guard.
__device__ __forceinline__ float guard_den(float den, float den_eps) {
  return (den_eps != 0.f && den < den_eps) ? den_eps : den;
}

// max(v, 0) that keeps NaN (see guard_den).
__device__ __forceinline__ float relu_nan(float v) { return v < 0.f ? 0.f : v; }

// max(v, 0) in one instruction that keeps NaN (max.NaN, sm_80+), as
// relu_nan does; a -0 entry may come out +0, a zero all the same.
__device__ __forceinline__ float relu_max(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(v));
  return r;
}

// The register tile of the resident kernels (K2, pqp_iterations.cu, and
// the lane-tile engine of K1 and K8, lane_tile_solve.cuh).  A block owns a
// tile of lanes and every row of them; a thread owns R rows x L lanes of
// it.  Operands live in shared memory: a matrix depth-major (q[k * ld + r],
// rows padded with zeros to a multiple of R, so R rows of one depth are one
// 16-byte load, the same for every thread of a row group), an iterate tile
// row-major with stride lanes (y[k * lanes + c], L lanes one 16-byte load).
namespace tile4 {

constexpr int R = 4;  // rows of a thread
constexpr int L = 4;  // lanes of a thread

// 4 consecutive floats at a 16-byte aligned address in one access.
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// One multiplicative update of the thread's entries,
//     y <- y * (Qdn y + Fdn) / guard(Qdp y + Fdp),
// from the tile yc into the tile yn (rows r0.. < n, lanes c0..c0+L): qn,
// qp the two splits depth-major with row stride np, fn / fq the thread's
// entries of Fdn / Fdp.  Each entry's sum runs in ascending k from 0 with
// fused multiply-adds, then adds the forcing term: the order of the
// previous one-lane-per-thread kernels, so their bits.
__device__ __forceinline__ void update(const float* __restrict__ qn,
                                       const float* __restrict__ qp, int np,
                                       const float* yc, float* yn, int lanes,
                                       int n, int r0, int c0,
                                       const float (&fn)[R][L],
                                       const float (&fq)[R][L],
                                       float den_eps) {
  float num[R][L], den[R][L];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < L; ++j) num[i][j] = den[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    float qa[R], qb[R], yv[L];
    load(qn + k * np + r0, qa);
    load(qp + k * np + r0, qb);
    load(yc + k * lanes + c0, yv);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < L; ++j) {
        num[i][j] = fmaf(qa[i], yv[j], num[i][j]);
        den[i][j] = fmaf(qb[i], yv[j], den[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i;
    if (r >= n) continue;
    float y[L];
    load(yc + r * lanes + c0, y);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const float nu = num[i][j] + fn[i][j];
      const float de = guard_den(den[i][j] + fq[i][j], den_eps);
      y[j] = (nu / de) * y[j];
    }
    store(yn + r * lanes + c0, y);
  }
}

}  // namespace tile4

}  // namespace pqp
