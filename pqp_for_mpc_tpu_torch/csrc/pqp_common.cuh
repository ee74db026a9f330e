// Helpers shared by the kernels (pqp_iterations.cu, full_solve.cu and,
// through tile_gemm.cuh, fma_tile.cuh and distinct_common.cuh, the
// streamed and the distinct-geometry kernels).
//
// Layout conventions, as the Python wrappers pass them:
//  * matrices are row-major float32; in shared memory each row is padded to
//    a multiple of 4 floats with zeros, so a row starts 16-byte aligned and
//    is read four entries per load (a broadcast: every thread of a warp
//    reads the same address);
//  * per-lane vectors live in fixed-size register arrays of NMAX entries,
//    zero beyond the runtime length, so a padded row entry meets a zero;
//  * panels are batch-last, element (i, b) at p[i * B + b]: neighbouring
//    threads (lanes) read neighbouring addresses.  A panel shared by every
//    lane is passed as a column with lane flag 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pqp {

constexpr int kLanesPerBlock = 128;

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

// One panel as seen by one lane: element i is p[i * row + col].
struct LanePanel {
  const float* p;
  long long row;
  long long col;
  __device__ __forceinline__ float operator[](int i) const {
    return p[i * row + col];
  }
};

__device__ __forceinline__ LanePanel lane_panel(const float* p, int lane,
                                                int B, int b) {
  return LanePanel{p, lane ? (long long)B : 1LL, lane ? (long long)b : 0LL};
}

// Copy a (rows, cols) row-major matrix into shared memory with row stride
// ld >= cols, zero-filling the padding columns.  transpose=true stores the
// transpose (cols rows of stride ld).
__device__ __forceinline__ void stage_matrix(float* dst, const float* src,
                                             int rows, int cols, int ld,
                                             bool transpose) {
  const int out_rows = transpose ? cols : rows;
  const int out_cols = transpose ? rows : cols;
  for (int k = threadIdx.x; k < out_rows * ld; k += blockDim.x) {
    const int r = k / ld, c = k % ld;
    float v = 0.f;
    if (c < out_cols) v = transpose ? src[c * cols + r] : src[r * cols + c];
    dst[k] = v;
  }
}

// dot(row[0:n], v[0:n]) with row 16-byte aligned and zero-padded to a
// multiple of 4; summed in index order with fused multiply-adds.
template <int NMAX>
__device__ __forceinline__ float row_dot(const float* __restrict__ row,
                                         const float (&v)[NMAX], int n) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < NMAX / 4; ++q) {
    if (4 * q < n) {
      const float4 a = r4[q];
      acc = fmaf(a.x, v[4 * q + 0], acc);
      acc = fmaf(a.y, v[4 * q + 1], acc);
      acc = fmaf(a.z, v[4 * q + 2], acc);
      acc = fmaf(a.w, v[4 * q + 3], acc);
    }
  }
  return acc;
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

// One multiplicative update of a lane's iterate,
//     y <- y * (Qdn y + Fdn) / guard(Qdp y + Fdp),
// with both splits in shared memory (row stride ld): K1's update.  K2 sums
// each entry in the same order, 4 rows x 4 lanes per thread
// (pqp_iterations.cu).
template <int NMAX>
__device__ __forceinline__ void update_lane(const float* qdn, const float* qdp,
                                            int ld, const LanePanel& fdn,
                                            const LanePanel& fdp,
                                            float (&y)[NMAX], int n,
                                            float den_eps) {
  float yn[NMAX];
#pragma unroll(NMAX <= 32 ? NMAX : 1)
  for (int i = 0; i < NMAX; ++i) {
    float v = 0.f;
    if (i < n) {
      const float num = row_dot<NMAX>(qdn + i * ld, y, n) + fdn[i];
      const float den =
          guard_den(row_dot<NMAX>(qdp + i * ld, y, n) + fdp[i], den_eps);
      v = (num / den) * y[i];
    }
    yn[i] = v;
  }
#pragma unroll
  for (int i = 0; i < NMAX; ++i) y[i] = yn[i];
}

}  // namespace pqp
