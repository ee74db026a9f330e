// K7: num_iters multiplicative PQP updates for DISTINCT instances, each
// instance's Hessian streamed and its splits rebuilt on the fly.
//
// Replaces the TPU kernel pqp_for_mpc_tpu/ops/distinct_tiled_kernel.py:
// fused_pqp_iterations_distinct_tiled (its Pallas body _upd_kernel), the
// bulk engine of solve_mixed on 3-D Qd.  Per instance b it streams ONE
// matrix Q_b per update:
//     float32:  Q_b = Qd_hat_b (diagonal max(diag, 0) + theta_b), theta in
//               the matrix: num = relu(-Q) y + theta y + Fd^-,
//               den = relu(Q) y + Fd^+;
//     bfloat16: Q_b = Qd_b with its diagonal clamped at 0, rounded ONCE;
//               theta (raised to the rounded negative rowsums) applied as
//               the same f32 term on both sides; y rounded to bf16 for the
//               product only, each bf16 x bf16 product exact in f32 and
//               summed in f32; the iterate stays f32.
// The wrapper (ops/distinct_tiled_kernel.py) builds Q and theta once per
// solve.
//
// Design.  One launch per update over a grid of (row tiles x instances), as
// K3: launches on one stream run in order, so the iterate ping-pongs
// between two global buffers and every update sees the whole previous one.
// A block stages its instance's y (rounded to bf16 in that mode) in shared
// memory, then each of its 8 warps takes rows of the tile: lane l reads the
// row's 16-byte vectors l, l + 32, ... (rows are contiguous: Q is
// symmetric, so row i serves output i), accumulates both relu parts, and a
// butterfly closes the row — a fixed order, so a second launch repeats every
// bit.  The TPU's slab heights and padding are not needed: the tile is 32
// rows and the last one is masked.
//
// What bounds it on an H100.  Memory.  It is a batched matrix-vector
// product, one lane per instance: each update reads B n^2 entries once for
// 4 B n^2 flop, one flop per byte in f32.  At n = 2048, B = 8 an update
// streams 134 MB in f32 and 67 MB in bf16, neither of which fits the 50 MB
// L2, so the floor is about 40 us (f32) and 20 us (bf16) per update at
// 3.35 TB/s, and the bf16 mode halves the binding bytes.  The design keeps
// every SM streaming (512 blocks at that size) with 16-byte loads when the
// row length allows (n % 4 == 0 in f32, n % 8 == 0 in bf16).
//
// Semantics match pqp_for_mpc_tpu_torch/ops/distinct_tiled_kernel.py:
// distinct_streamed_iterations_reference up to float32 summation order.

#include <cuda_runtime.h>

#include <type_traits>

#include "distinct_common.cuh"
#include "pqp_common.cuh"

namespace pqp {

constexpr int kUpdThreads = 256;
constexpr int kUpdRows = 32;  // rows of one block's tile

template <typename T>
__global__ void __launch_bounds__(kUpdThreads)
distinct_update_kernel(const T* q, const float* theta, const float* fdn,
                       const float* fdp, const float* y_in, float* y_out,
                       int n, float den_eps, int vec) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  float* x = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const long long base = (long long)b * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float v = y_in[base + j];
    x[j] = kBf16 ? round_bf16(v) : v;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kUpdRows;
  for (int r = r0 + warp; r < min(n, r0 + kUpdRows);
       r += kUpdThreads / 32) {
    float neg, pos;
    dist::warp_row_relu_dots(q + (base + r) * n, x, n, vec != 0, neg, pos);
    if (lane == 0) {
      const long long e = base + r;
      const float y = y_in[e];
      const float ty = theta[e] * y;
      const float num = neg + ty + fdn[e];
      const float den = kBf16 ? (pos + ty) + fdp[e] : pos + fdp[e];
      y_out[e] = (num / guard_den(den, den_eps)) * y;
    }
  }
}

template <typename T>
static cudaError_t launch_distinct_iterations(const T* q, const float* theta,
                                              const float* fdn,
                                              const float* fdp,
                                              const float* y, float* y_out,
                                              float* y_tmp, int n, int B,
                                              int num_iters, float den_eps,
                                              cudaStream_t stream) {
  constexpr int kVecElems = std::is_same<T, float>::value ? 4 : 8;
  const int vec = (n % kVecElems) == 0;
  const size_t smem = (size_t)n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      distinct_update_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kUpdRows - 1) / kUpdRows, B);
  const float* src = y;
  for (int t = 0; t < num_iters; ++t) {
    // the buffer of update t is chosen so that the last one is y_out
    float* dst = ((num_iters - 1 - t) % 2 == 0) ? y_out : y_tmp;
    distinct_update_kernel<T><<<grid, kUpdThreads, smem, stream>>>(
        q, theta, fdn, fdp, src, dst, n, den_eps, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace pqp

// q: (B, n, n) float32 (q_bf16 = 0) or bfloat16 (q_bf16 = 1), 16-byte
// aligned; theta, fdn, fdp, y, y_out, y_tmp: (B, n) instance-major.
// num_iters >= 1.
extern "C" int pqp_iterations_distinct_tiled(const void* q, int q_bf16,
                                             const float* theta,
                                             const float* fdn,
                                             const float* fdp, const float* y,
                                             float* y_out, float* y_tmp,
                                             int n, int B, int num_iters,
                                             float den_eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || B < 1 || B > 65535 || num_iters < 1 ||
      (size_t)n * sizeof(float) > 232448)
    return (int)cudaErrorInvalidValue;
  if (q_bf16)
    return (int)pqp::launch_distinct_iterations(
        static_cast<const unsigned short*>(q), theta, fdn, fdp, y, y_out,
        y_tmp, n, B, num_iters, den_eps, s);
  return (int)pqp::launch_distinct_iterations(
      static_cast<const float*>(q), theta, fdn, fdp, y, y_out, y_tmp, n, B,
      num_iters, den_eps, s);
}
