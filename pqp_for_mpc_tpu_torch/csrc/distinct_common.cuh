// Helpers shared by the distinct-geometry kernels: K5 (full_solve_distinct.cu
// through cluster_solve.cuh), K6 (full_solve_distinct_tiled.cu) and K7
// (pqp_iterations_distinct_tiled.cu).
//
// Layout: every matrix is row-major with a leading instance axis; every
// per-instance vector is instance-major, element (b, i) at v[b * len + i]
// (the wrappers transpose the batch-last panels).  The matrices the kernels
// multiply by are symmetric (Qd, its splits and Qd_hat; Qp and Qp^-1), so
// row i is also column i: one warp reads row i contiguously for output i.
// Only Gp is not symmetric; its transposed product sums over columns.
//
// Every sum runs in a fixed order — lanes over ascending entries, a warp
// butterfly, then warps (and ranks) in index order — so a second launch
// repeats every bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pqp_common.cuh"

namespace pqp {

// Rows [off, off + cnt) of `total` split over `parts` ranks as evenly as
// possible, the first total % parts ranks one row more.
__host__ __device__ inline void split_rows(int total, int parts, int rank,
                                           int& off, int& cnt) {
  const int base = total / parts, rem = total % parts;
  cnt = base + (rank < rem ? 1 : 0);
  off = rank * base + (rank < rem ? rank : rem);
}

// Asynchronous copies from global to shared memory (cp.async, sm_80+): 16
// bytes through L2 only, or 4 bytes; the caller commits and waits.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

namespace dist {

// Sum over a warp by an xor butterfly: every lane ends with the same value.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The float32 value of a bfloat16 given by its bits (exact).
__device__ __forceinline__ float bf16_bits(unsigned int bits) {
  return __uint_as_float(bits << 16);
}

// dot(row[0:n], x[0:n]) for one warp: lane l takes the entries (or the
// float4 groups, when vec) l, l + 32, ... in ascending order, then the
// butterfly.  Every lane returns the sum.  x may be shared or global.
__device__ __forceinline__ float warp_row_dot(const float* __restrict__ row,
                                              const float* __restrict__ x,
                                              int n, bool vec) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
    for (int q = lane; q < (n >> 2); q += 32) {
      const float4 a = r4[q], v = x4[q];
      acc = fmaf(a.x, v.x, acc);
      acc = fmaf(a.y, v.y, acc);
      acc = fmaf(a.z, v.z, acc);
      acc = fmaf(a.w, v.w, acc);
    }
  } else {
#pragma unroll 4
    for (int j = lane; j < n; j += 32) acc = fmaf(row[j], x[j], acc);
  }
  return warp_sum(acc);
}

// Both relu parts of one streamed entry: neg += max(-q, 0) x,
// pos += max(q, 0) x (NaN kept, as the plain version's clamps), each relu
// one max.NaN instruction.  relu_max may give +0 where relu_nan gave -0;
// a sum that starts at +0 never tells them apart, so the sums keep their
// bits.
__device__ __forceinline__ void relu_fma(float q, float x, float& neg,
                                         float& pos) {
  neg = fmaf(relu_max(-q), x, neg);
  pos = fmaf(relu_max(q), x, pos);
}

// The relu-split dots of one float32 streamed row with x, for one warp.
__device__ __forceinline__ void warp_row_relu_dots(
    const float* __restrict__ row, const float* __restrict__ x, int n,
    bool vec, float& neg, float& pos) {
  const int lane = threadIdx.x & 31;
  float an = 0.f, ap = 0.f;
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
    for (int q = lane; q < (n >> 2); q += 32) {
      const float4 a = r4[q], v = x4[q];
      relu_fma(a.x, v.x, an, ap);
      relu_fma(a.y, v.y, an, ap);
      relu_fma(a.z, v.z, an, ap);
      relu_fma(a.w, v.w, an, ap);
    }
  } else {
#pragma unroll 4
    for (int j = lane; j < n; j += 32) relu_fma(row[j], x[j], an, ap);
  }
  neg = warp_sum(an);
  pos = warp_sum(ap);
}

// The relu-split dots of row `diag` of Qd with x, its diagonal entry left
// out (K5: the splits' own diagonals are added by the caller).  Off the
// diagonal relu(+-q) equals the materialized splits' entry.  Two max and
// two FMA instructions per entry: the loop is bound by instruction issue.
__device__ __forceinline__ void warp_row_split_dots(
    const float* __restrict__ row, const float* __restrict__ x, int n,
    bool vec, int diag, float& neg, float& pos) {
  const int lane = threadIdx.x & 31;
  float an = 0.f, ap = 0.f;
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int dq = diag >> 2, dc = diag & 3;
#pragma unroll 4
    for (int q = lane; q < (n >> 2); q += 32) {
      float4 a = r4[q];
      const float4 v = x4[q];
      if (q == dq) {
        if (dc == 0) a.x = 0.f;
        else if (dc == 1) a.y = 0.f;
        else if (dc == 2) a.z = 0.f;
        else a.w = 0.f;
      }
      an = fmaf(relu_max(-a.x), v.x, an);
      ap = fmaf(relu_max(a.x), v.x, ap);
      an = fmaf(relu_max(-a.y), v.y, an);
      ap = fmaf(relu_max(a.y), v.y, ap);
      an = fmaf(relu_max(-a.z), v.z, an);
      ap = fmaf(relu_max(a.z), v.z, ap);
      an = fmaf(relu_max(-a.w), v.w, an);
      ap = fmaf(relu_max(a.w), v.w, ap);
    }
  } else {
#pragma unroll 4
    for (int j = lane; j < n; j += 32) {
      const float a = j == diag ? 0.f : row[j];
      an = fmaf(relu_max(-a), x[j], an);
      ap = fmaf(relu_max(a), x[j], ap);
    }
  }
  neg = warp_sum(an);
  pos = warp_sum(ap);
}

// Totals of K per-thread values over the block in a fixed order: warp
// butterflies, then the warps in index order, summed by every thread alike.
// red holds K * 32 floats.
template <int K>
__device__ __forceinline__ void block_sums(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  __syncthreads();  // the previous use of red is over
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * 32 + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = 0.f;
    for (int w = 0; w < warps; ++w) t += red[k * 32 + w];
    v[k] = t;
  }
}

// out(r) = A[r, :] . x over rows [0, rows) of a row-major (rows, cols)
// matrix, one warp per row; f(r, s) runs on lane 0.
template <class F>
__device__ __forceinline__ void rows_times(const float* A, int rows, int cols,
                                           const float* x, bool vec, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps) {
    const float s = warp_row_dot(A + (long long)r * cols, x, cols, vec);
    if (lane == 0) f(r, s);
  }
}

}  // namespace dist
}  // namespace pqp
