// Tiled products shared by the two streamed kernels (pqp_iterations_tiled.cu,
// full_solve_tiled.cu).
//
// One block of 128 threads computes a BM x BL = 32 x 64 tile of an output
// C = A X: 32 rows of a row-major matrix A (rows x depth) against 64 lanes
// of a batch-last panel X (depth x B, element (k, b) at x[k * B + b]).  The
// depth is walked in slabs of BK = 32: the block stages A's 32 x 32 slab
// and X's 32 x 64 slab in shared memory, then every thread accumulates a
// 4 x 4 sub-tile (4 consecutive rows, 4 consecutive lanes) with
// fused multiply-adds, reading both operands as float4.  Each thread sums
// its entries in ascending k, so a result is the same from run to run.
//
// SPLIT mode accumulates the two relu parts of A at once,
//     acc0 += relu(A) X,   acc1 += relu(-A) X,
// the on-the-fly splits of Qd_hat that the update needs (relu_nan keeps a
// NaN entry NaN, as jnp.maximum does).  The loaders convert a bf16 matrix
// entry to float (exact) and can round a panel entry to bf16 and back, so a
// bf16 x bf16 product is formed exactly in float32 and summed in float32 —
// the TPU's preferred_element_type=f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pqp_common.cuh"

namespace pqp {
namespace tile {

constexpr int BM = 32;        // output rows of a tile
constexpr int BL = 64;        // output lanes of a tile
constexpr int BK = 32;        // depth of one staged slab
constexpr int kThreads = 128; // 8 row groups x 16 lane groups, 4 x 4 each
constexpr int kPadA = 4;      // A slab rows padded to 36 floats (float4
                              // aligned; 4-way bank conflicts on the store)

struct Smem {
  float a[2][BK][BM + kPadA];  // A slab stored k-major: a[k][row]
  float x[BK][BL];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round to bf16 (nearest even) and back: the operand the TPU's bf16 matvec
// sees.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A(r, k) = p[r * ld + k]: a row-major matrix.
template <typename T>
struct RowMajor {
  const T* p;
  int ld;
  static constexpr bool kTrans = false;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return to_float(p[(long long)r * ld + k]);
  }
};

// A(r, k) = p[k * ld + r]: the transpose of a row-major matrix (Gp').
struct Transposed {
  const float* p;
  int ld;
  static constexpr bool kTrans = true;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return p[(long long)k * ld + r];
  }
};

// X(k, b) = p[k * B + b], optionally rounded through bf16.
template <bool ROUND_BF16>
struct Panel {
  const float* p;
  int B;
  __device__ __forceinline__ float operator()(int k, int b) const {
    const float v = p[(long long)k * B + b];
    return ROUND_BF16 ? round_bf16(v) : v;
  }
};

// X(k, b) = p[k * B + b] + q[k * B + b] (v + Fp of the check).
struct PanelSum {
  const float* p;
  const float* q;
  int B;
  __device__ __forceinline__ float operator()(int k, int b) const {
    const long long e = (long long)k * B + b;
    return p[e] + q[e];
  }
};

// This thread's sub-tile: rows r0 + 4 * row_group() + i, lanes
// b0 + 4 * lane_group() + j, i, j < 4.
__device__ __forceinline__ int row_group() { return threadIdx.x / 16; }
__device__ __forceinline__ int lane_group() { return threadIdx.x % 16; }

// Accumulate one tile of A (rows x depth) times X (depth x B) at
// (r0, b0).  Entries past rows/depth/B are staged as zeros.  Every thread
// of the block must call it (it synchronises the block).
template <bool SPLIT, class ALoad, class XLoad>
__device__ __forceinline__ void products(Smem& sm, int r0, int b0, int rows,
                                         int depth, int B, const ALoad& A,
                                         const XLoad& X,
                                         float (&acc0)[4][4],
                                         float (&acc1)[4][4]) {
  const int t = threadIdx.x;
  const int tr = row_group(), tl = lane_group();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc0[i][j] = acc1[i][j] = 0.f;

  for (int k0 = 0; k0 < depth; k0 += BK) {
    // stage A: neighbouring threads read neighbouring addresses
#pragma unroll
    for (int s = 0; s < (BM * BK) / kThreads; ++s) {
      int rr, kk;
      if (ALoad::kTrans) {
        rr = t % BM;
        kk = t / BM + (kThreads / BM) * s;
      } else {
        kk = t % BK;
        rr = t / BK + (kThreads / BK) * s;
      }
      const int r = r0 + rr, k = k0 + kk;
      const float v = (r < rows && k < depth) ? A(r, k) : 0.f;
      if (SPLIT) {
        sm.a[0][kk][rr] = relu_nan(v);
        sm.a[1][kk][rr] = relu_nan(-v);
      } else {
        sm.a[0][kk][rr] = v;
      }
    }
    // stage X
#pragma unroll
    for (int s = 0; s < (BK * BL) / kThreads; ++s) {
      const int bb = t % BL, kk = t / BL + (kThreads / BL) * s;
      const int k = k0 + kk, b = b0 + bb;
      sm.x[kk][bb] = (k < depth && b < B) ? X(k, b) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 x4 = *reinterpret_cast<const float4*>(&sm.x[kk][4 * tl]);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
      const float4 a4 =
          *reinterpret_cast<const float4*>(&sm.a[0][kk][4 * tr]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc0[i][j] = fmaf(av[i], xv[j], acc0[i][j]);
      if (SPLIT) {
        const float4 n4 =
            *reinterpret_cast<const float4*>(&sm.a[1][kk][4 * tr]);
        const float nv[4] = {n4.x, n4.y, n4.z, n4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc1[i][j] = fmaf(nv[i], xv[j], acc1[i][j]);
      }
    }
    __syncthreads();
  }
}

// The multiplicative update of one tile's entries from its split products:
//     num = relu(-Q) y + th_i y_i + fdn,  den = relu(Q) y [+ th_i y_i] + fdp,
//     y_new = (num / guard(den)) * y_i,
// with the theta term on the denominator too when sym_theta (the bf16
// stream keeps theta out of the matrix).  With a lane_state array, lanes
// whose state is not 0 (certified or stalled) keep y_i.
// fd_lane selects per-lane (n x B) or shared (n) forcing panels.
__device__ __forceinline__ void update_epilogue(
    const float (&den_acc)[4][4], const float (&num_acc)[4][4], int r0,
    int b0, int n, int B, const float* theta, bool sym_theta,
    const float* fdn, const float* fdp, int fd_lane, const float* y_in,
    float* y_out, float den_eps, const int* lane_state) {
  const int tr = row_group(), tl = lane_group();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * tr + i;
    if (r >= n) continue;
    const float th = theta[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + 4 * tl + j;
      if (b >= B) continue;
      const long long e = (long long)r * B + b;
      const float y = y_in[e];
      const long long f = fd_lane ? e : (long long)r;
      float out = y;
      if (lane_state == nullptr || lane_state[b] == 0) {
        const float ty = th * y;
        const float num = (num_acc[i][j] + ty) + fdn[f];
        const float den = sym_theta ? (den_acc[i][j] + ty) + fdp[f]
                                    : den_acc[i][j] + fdp[f];
        out = (num / guard_den(den, den_eps)) * y;
      }
      y_out[e] = out;
    }
  }
}

}  // namespace tile
}  // namespace pqp
