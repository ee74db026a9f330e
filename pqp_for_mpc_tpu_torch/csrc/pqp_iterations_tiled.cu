// K3: num_iters multiplicative PQP updates with the Hessian streamed and the
// splits rebuilt on the fly.
//
// Replaces the TPU kernel pqp_for_mpc_tpu/ops/tiled_kernel.py:
// fused_pqp_iterations_tiled (its Pallas body _kernel).  For N past the
// resident kernels it streams ONE matrix per update instead of the two
// materialized splits, and rebuilds both splits by relu as it goes:
//     float32:  Q = Qd_hat = Qd with diagonal max(diag, 0) + theta,
//               num = relu(-Q) y + theta_i y_i + Fd^-,  den = relu(Q) y + Fd^+
//     bfloat16: Q = Qd with its diagonal clamped at 0, rounded ONCE to bf16;
//               theta (raised to the rounded negative rowsums) applied as the
//               same f32 term on both sides; y rounded to bf16 for the
//               product only, each bf16 x bf16 product exact in f32 and summed
//               in f32; the iterate stays f32 (solve_mixed's bulk phase).
// The wrapper (ops/tiled_kernel.py) builds Q and theta once per solve.
//
// Design.  The Jacobi trap: every update needs the whole previous iterate,
// which the TPU gets from a sequential grid.  Here each update is one launch
// of a tiled product over (row tiles x lane tiles); launches on one stream
// run in order, so the iterate ping-pongs between two global buffers (2 MB
// at N = 4096, B = 128, L2-resident).  Chosen over a cooperative grid sync
// because a launch costs a few microseconds against the ~0.5 ms of one
// update at that size, and the kernel stays an ordinary grid of
// independent blocks.  A block computes a 32-row x 64-lane tile of num and
// den together (tile_gemm.cuh): each staged Q entry feeds both relu parts,
// each staged y entry 32 rows.  The wrapper never writes its input; the
// last update lands in y_out.
//
// What bounds it on an H100.  One update is 4 N^2 B flop (two products of
// the split matrix) against N^2 x 4 bytes (f32) or x 2 bytes (bf16) of
// matrix: at N = 4096, B = 128, 8.6 GFLOP against 67 MB or 34 MB.  On the
// CUDA cores that is compute-bound — at least 0.13 ms at the 67 TFLOP/s
// f32 peak against 0.02 ms of HBM — so the TPU's reason for the bf16 stream
// (half the bytes) buys little in this kernel: bf16 only saves the slab
// loads.  Tensor cores (wgmma on bf16, 3xTF32 on f32) are later work.
//
// Semantics match pqp_for_mpc_tpu_torch/ops/tiled_kernel.py:
// streamed_pqp_iterations_reference up to float32 summation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "pqp_common.cuh"
#include "tile_gemm.cuh"

namespace pqp {

template <typename T>
__global__ void __launch_bounds__(tile::kThreads)
tiled_update_kernel(const T* q, const float* theta, const float* fdn,
                    const float* fdp, int fd_lane, const float* y_in,
                    float* y_out, int n, int B, float den_eps) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  __shared__ __align__(16) tile::Smem sm;
  const int r0 = blockIdx.y * tile::BM, b0 = blockIdx.x * tile::BL;
  float den_acc[4][4], num_acc[4][4];
  tile::products<true>(sm, r0, b0, n, n, B, tile::RowMajor<T>{q, n},
                       tile::Panel<kBf16>{y_in, B}, den_acc, num_acc);
  tile::update_epilogue(den_acc, num_acc, r0, b0, n, B, theta, kBf16, fdn,
                        fdp, fd_lane, y_in, y_out, den_eps, nullptr);
}

template <typename T>
static cudaError_t launch_tiled_iterations(const T* q, const float* theta,
                                           const float* fdn, const float* fdp,
                                           int fd_lane, const float* y,
                                           float* y_out, float* y_tmp, int n,
                                           int B, int num_iters,
                                           float den_eps,
                                           cudaStream_t stream) {
  const dim3 grid((B + tile::BL - 1) / tile::BL, (n + tile::BM - 1) / tile::BM);
  const float* src = y;
  for (int t = 0; t < num_iters; ++t) {
    // the buffer of update t is chosen so that the last one is y_out
    float* dst = ((num_iters - 1 - t) % 2 == 0) ? y_out : y_tmp;
    tiled_update_kernel<T><<<grid, tile::kThreads, 0, stream>>>(
        q, theta, fdn, fdp, fd_lane, src, dst, n, B, den_eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace pqp

// q: (n, n) float32 (q_bf16 = 0) or bfloat16 (q_bf16 = 1); theta (n);
// fdn/fdp (n, B) per lane (fd_lane = 1) or (n) shared; y, y_out, y_tmp
// (n, B).  num_iters >= 1.
extern "C" int pqp_iterations_tiled(const void* q, int q_bf16,
                                    const float* theta, const float* fdn,
                                    const float* fdp, int fd_lane,
                                    const float* y, float* y_out,
                                    float* y_tmp, int n, int B,
                                    int num_iters, float den_eps,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || B < 1 || num_iters < 1 || (long long)n > 65535LL * 32)
    return (int)cudaErrorInvalidValue;
  if (q_bf16)
    return (int)pqp::launch_tiled_iterations(
        static_cast<const __nv_bfloat16*>(q), theta, fdn, fdp, fd_lane, y,
        y_out, y_tmp, n, B, num_iters, den_eps, s);
  return (int)pqp::launch_tiled_iterations(static_cast<const float*>(q),
                                           theta, fdn, fdp, fd_lane, y, y_out,
                                           y_tmp, n, B, num_iters, den_eps,
                                           s);
}
