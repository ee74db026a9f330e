// K2: num_iters multiplicative PQP updates in one launch.
//
// Replaces the TPU kernel pqp_for_mpc_tpu/ops/kernels.py:
// fused_pqp_iterations (its Pallas body _iterate_kernel), which keeps both
// split matrices and a (N, Bblk) panel of Y in VMEM for all num_iters
// updates
//     Y <- Y * ((Qd^- + th) Y + Fd^-) / max((Qd^+ + th) Y + Fd^+, den_eps).
//
// Design.  One thread per batch lane; a block of 128 lanes stages both
// splits in shared memory (2 N^2 floats, rows padded to 4: 6.3 KB at
// N = 28).  The lane's y[N] lives in registers for all num_iters updates,
// so Y is read and written once per launch.  The panels are batch-last,
// Y[i * B + b], so for every row i the 32 lanes of a warp read 32
// neighbouring floats.  Templated on NMAX (32, 64, 128): every loop over a
// row's entries unrolls, so y stays in registers; at NMAX = 32 the loop
// over rows unrolls too, above it the row loop stays rolled (a fully
// unrolled 128 x 128 body takes ptxas many minutes) and the new iterate
// goes through local memory.  N above 128 is refused by the wrapper.
//
// What bounds it on an H100.  Per update a lane does 2 N^2 FMAs and reads
// Fd^- and Fd^+ (2 N * 4 bytes): at N = 28, 1,568 FMAs against 224 bytes,
// 14 flop/byte, under the card's float32 ridge of about 20 (67 TFLOP/s
// over 3.35 TB/s) when the Fd panels stream from HBM, far over it when
// they sit in L1/L2.  Each float4 broadcast load from shared memory feeds
// 4 FMAs, so shared-memory issue is not the limit.  Measured on an H100
// SXM (700 W) at B = 2^22, 8 updates: 7.85 ms, 20% of the FMA peak and at
// most 1.1 TB/s — neither bound; the lane's dependent FMA chains with 16
// warps per SM (128 registers) leave the loop latency-bound.
//
// Semantics match pqp_for_mpc_tpu_torch/ops/kernels.py:
// fused_pqp_iterations_reference up to float32 summation order.

#include <cuda_runtime.h>

#include "pqp_common.cuh"

namespace pqp {

template <int NMAX>
__global__ void __launch_bounds__(kLanesPerBlock)
pqp_iterations_kernel(const float* __restrict__ qdn,
                      const float* __restrict__ qdp,
                      const float* __restrict__ fdn,
                      const float* __restrict__ fdp, int fd_lane,
                      const float* __restrict__ y_in,
                      float* __restrict__ y_out, int n, int B,
                      int num_iters, float den_eps) {
  extern __shared__ float4 smem4[];
  float* s_qdn = reinterpret_cast<float*>(smem4);
  const int ld = round4(n);
  float* s_qdp = s_qdn + n * ld;
  stage_matrix(s_qdn, qdn, n, n, ld, false);
  stage_matrix(s_qdp, qdp, n, n, ld, false);
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const LanePanel Fn = lane_panel(fdn, fd_lane, B, b);
  const LanePanel Fp = lane_panel(fdp, fd_lane, B, b);
  const LanePanel Yin = lane_panel(y_in, 1, B, b);

  float y[NMAX];
#pragma unroll
  for (int i = 0; i < NMAX; ++i) y[i] = (i < n) ? Yin[i] : 0.f;

  for (int it = 0; it < num_iters; ++it)
    update_lane<NMAX>(s_qdn, s_qdp, ld, Fn, Fp, y, n, den_eps);

  float* out = y_out + b;
#pragma unroll
  for (int i = 0; i < NMAX; ++i)
    if (i < n) out[(long long)i * B] = y[i];
}

template <int NMAX>
static cudaError_t launch_iterations(const float* qdn, const float* qdp,
                                     const float* fdn, const float* fdp,
                                     int fd_lane, const float* y,
                                     float* y_out, int n, int B,
                                     int num_iters, float den_eps,
                                     cudaStream_t stream) {
  const size_t smem = 2 * (size_t)n * round4(n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pqp_iterations_kernel<NMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + kLanesPerBlock - 1) / kLanesPerBlock);
  pqp_iterations_kernel<NMAX><<<grid, kLanesPerBlock, smem, stream>>>(
      qdn, qdp, fdn, fdp, fd_lane, y, y_out, n, B, num_iters, den_eps);
  return cudaGetLastError();
}

}  // namespace pqp

extern "C" int pqp_iterations_f32(const float* qdn, const float* qdp,
                                  const float* fdn, const float* fdp,
                                  int fd_lane, const float* y, float* y_out,
                                  int n, int B, int num_iters, float den_eps,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || B < 1) return (int)cudaErrorInvalidValue;
  if (n <= 32)
    return (int)pqp::launch_iterations<32>(qdn, qdp, fdn, fdp, fd_lane, y,
                                           y_out, n, B, num_iters, den_eps, s);
  if (n <= 64)
    return (int)pqp::launch_iterations<64>(qdn, qdp, fdn, fdp, fd_lane, y,
                                           y_out, n, B, num_iters, den_eps, s);
  if (n <= 128)
    return (int)pqp::launch_iterations<128>(qdn, qdp, fdn, fdp, fd_lane, y,
                                            y_out, n, B, num_iters, den_eps,
                                            s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pqp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
