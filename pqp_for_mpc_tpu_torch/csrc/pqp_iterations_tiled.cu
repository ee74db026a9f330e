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
// because a launch costs a few microseconds against one update, and the
// kernel stays an ordinary grid of independent blocks.  The wrapper never
// writes its input; the last update lands in y_out.
//   float32 mode: a block of 256 threads computes a 32-row tile of num and
//   den together on the CUDA cores, on K4's tile (fma_tile.cuh: a 3-stage
//   cp.async ring of 64-deep slabs, the relu split of Q in registers) and
//   K4's update epilogue (fma::update_epilogue).  Its lanes BN (32, 64 or
//   128, as K4's: the narrowest that holds B) are the wrapper's
//   (ops/tiled_kernel.py: k3_f32_plan); a thread owns 4 rows x BN/32
//   lanes, K4's layout (123 KB of shared memory at 128 lanes, one block
//   per SM).
//   bfloat16 mode: the two products on the tensor cores.  Its arithmetic is
//   exactly a bf16 MMA with float32 accumulation, mma.sync.m16n8k16: A is a
//   16 x 16 tile of Q read from shared memory and split in registers into
//   relu(Q) and relu(-Q) (__hmax2_nan, so a NaN entry stays NaN, as
//   relu_nan); B is the bf16 iterate (ldmatrix.trans); two MMAs per A
//   fragment feed the den and num accumulators.  Each warp owns 16 rows x
//   16 lanes; a block of (tile_rows / 16) x (tile_lanes / 16) warps streams
//   its Q rows and the bf16 iterate through a 4-stage cp.async ring of
//   32-deep slabs.  The
//   epilogue is the float32 mode's arithmetic (theta y in f32 on both sides,
//   Fd+-, guard_den, NaN kept) and writes the new iterate in f32 and its bf16
//   rounding, into a second ping-pong pair that the next update reads; the
//   first update of a call reads the input rounded by a small rounding
//   launch.  The tile plan (tile rows, tile lanes) is the wrapper's
//   (ops/tiled_kernel.py: k3_bf16_plan): the widest lane tile the batch
//   fills, then the tallest row tile that still gives 132 blocks (one per
//   SM), 32 x 64 at N = 4096, B = 128 (256 blocks).  Ragged N or B (not a
//   multiple of 8) stage element by element instead of by cp.async.
//
// What bounds it on an H100.  One update is 4 N^2 B flop (two products of
// the split matrix) against N^2 x 4 bytes (f32) or x 2 bytes (bf16) of
// matrix: at N = 4096, B = 128, 8.6 GFLOP against 67 MB or 34 MB.  On the
// CUDA cores (f32 mode) that is compute-bound — at least 0.13 ms at the
// 67 TFLOP/s f32 peak; the FMA tile issues ~42 instructions per 32 FMAs
// with 8 warps per SM (each output entry one chain in k, so no depth
// split) and runs an update in about 0.265 ms (tools/probe_k3.py, as K4's
// update pass).  On the tensor cores (bf16 mode) the product's own
// bound is 8.7 us at 989 TFLOP/s; the bf16 Q (33.5 MB) stays in the L2
// across a call's updates, and with 32-row tiles every block also reads its
// lane tile of the iterate over the whole depth, so the L2 -> shared-memory
// traffic (~190 MB per update at N = 4096, B = 128) is the design's floor.
//
// Semantics match pqp_for_mpc_tpu_torch/ops/tiled_kernel.py:
// streamed_pqp_iterations_reference up to float32 summation order (the
// tensor cores' accumulation order in bf16 mode).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "pqp_common.cuh"
#include "fma_tile.cuh"

namespace pqp {

// One float32-mode update of a 32 x BN tile: y_in (16-byte aligned, as q)
// to y_out.
template <int BN>
__global__ void __launch_bounds__(fma::kThreads, 1)
f32_update_kernel(const float* q, const float* theta, const float* fdn,
                  const float* fdp, int fd_lane, const float* y_in,
                  float* y_out, int n, int B, float den_eps) {
  using Acc = fma::AccShape<BN>;
  extern __shared__ float4 smem4[];
  fma::Smem<BN>& sm = *reinterpret_cast<fma::Smem<BN>*>(smem4);
  const int r0 = blockIdx.y * fma::BM, b0 = blockIdx.x * BN;
  float den_acc[Acc::d0][Acc::d1], num_acc[Acc::d0][Acc::d1];
  fma::products<BN, false, true>(sm, r0, b0, n, n, B, q, n, y_in, den_acc,
                                  num_acc);
  fma::update_epilogue<BN>(den_acc, num_acc, r0, b0, n, B, theta, fdn, fdp,
                           fd_lane != 0, y_in, y_out, den_eps,
                           [](int) { return false; });
}

namespace tc {

constexpr int BK = 32;      // depth of one staged slab (two k16 steps)
constexpr int kStages = 4;  // cp.async ring
constexpr int kPad = 8;     // bf16 of row padding: conflict-free fragments

template <int BM, int BN>
struct Smem {
  __nv_bfloat16 a[kStages][BM][BK + kPad];  // Q slab, k contiguous
  __nv_bfloat16 x[kStages][BK][BN + kPad];  // iterate slab, lanes contiguous
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ uint32_t relu2(uint32_t v, bool neg) {
  __nv_bfloat162 q = *reinterpret_cast<__nv_bfloat162*>(&v);
  if (neg) q = __hneg2(q);
  q = __hmax2_nan(q, __float2bfloat162_rn(0.f));
  return *reinterpret_cast<uint32_t*>(&q);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage slab k0 of Q rows [r0, r0 + BM) and of the iterate's lanes
// [b0, b0 + BN) into ring slot st; entries past n or B are zeros.
template <int BM, int BN>
__device__ __forceinline__ void stage(Smem<BM, BN>& sm, int st,
                                      const __nv_bfloat16* q,
                                      const __nv_bfloat16* yb, int r0, int b0,
                                      int k0, int n, int B, bool vec) {
  const int t = threadIdx.x, nt = blockDim.x;
  if (vec) {  // n % 8 == 0 and B % 8 == 0: 16-byte chunks, in or out whole
    for (int c = t; c < BM * (BK / 8); c += nt) {
      const int rr = c / (BK / 8), kk = 8 * (c % (BK / 8));
      const int r = r0 + rr, k = k0 + kk;
      const bool in = r < n && k < n;
      cp_async16(&sm.a[st][rr][kk], in ? q + (long long)r * n + k : q, in);
    }
    for (int c = t; c < BK * (BN / 8); c += nt) {
      const int kk = c / (BN / 8), bb = 8 * (c % (BN / 8));
      const int k = k0 + kk, b = b0 + bb;
      const bool in = k < n && b < B;
      cp_async16(&sm.x[st][kk][bb], in ? yb + (long long)k * B + b : yb, in);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int e = t; e < BM * BK; e += nt) {
      const int rr = e / BK, kk = e % BK;
      const int r = r0 + rr, k = k0 + kk;
      sm.a[st][rr][kk] = (r < n && k < n) ? q[(long long)r * n + k] : zero;
    }
    for (int e = t; e < BK * BN; e += nt) {
      const int kk = e / BN, bb = e % BN;
      const int k = k0 + kk, b = b0 + bb;
      sm.x[st][kk][bb] = (k < n && b < B) ? yb[(long long)k * B + b] : zero;
    }
  }
}

// One bf16-mode update of a BM x BN tile by (BM / 16) x (BN / 16) warps:
// warp (wr, wl) takes rows r0 + 16 wr + [0, 16) and lanes b0 + 16 wl +
// [0, 16).
template <int BM, int BN>
__global__ void __launch_bounds__(BM * BN / 8)
tc_update_kernel(const __nv_bfloat16* q, const float* theta,
                 const float* fdn, const float* fdp, int fd_lane,
                 const float* y_in, const __nv_bfloat16* yb_in, float* y_out,
                 __nv_bfloat16* yb_out, int n, int B, float den_eps) {
  constexpr int WL = BN / 16;  // warps across the lanes
  constexpr int WN = 16;       // lanes per warp
  constexpr int NT = WN / 8;   // n8 tiles per warp
  __shared__ __align__(16) Smem<BM, BN> sm;
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) / WL, wl = (threadIdx.x >> 5) % WL;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.y * BM, b0 = blockIdx.x * BN;
  const bool vec = (n % 8) == 0 && (B % 8) == 0;
  float den[NT][4], num[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) den[j][e] = num[j][e] = 0.f;

  const int slabs = (n + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs) stage(sm, s, q, yb_in, r0, b0, s * BK, n, B, vec);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int i = 0; i < slabs; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // slab i landed; slot (i - 1) % kStages is free
    const int nxt = i + kStages - 1;
    if (nxt < slabs)
      stage(sm, nxt % kStages, q, yb_in, r0, b0, nxt * BK, n, B, vec);
    asm volatile("cp.async.commit_group;\n" ::);
    const int st = i % kStages;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      // A fragment (rows g, g + 8; k pairs 2 tq, 2 tq + 8), split
      const __nv_bfloat16* ar = &sm.a[st][16 * wr + g][ks + 2 * tq];
      const uint32_t raw[4] = {
          *reinterpret_cast<const uint32_t*>(ar),
          *reinterpret_cast<const uint32_t*>(ar + 8 * (BK + kPad)),
          *reinterpret_cast<const uint32_t*>(ar + 8),
          *reinterpret_cast<const uint32_t*>(ar + 8 * (BK + kPad) + 8)};
      uint32_t apos[4], aneg[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        apos[e] = relu2(raw[e], false);
        aneg[e] = relu2(raw[e], true);
      }
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        // B fragments of n8 tiles 2p and 2p + 1: four 8 x 8 matrices
        const int mi = lane >> 3, row = lane & 7;
        const __nv_bfloat16* xr =
            &sm.x[st][ks + (mi & 1) * 8 + row]
                 [WN * wl + 16 * p + (mi >> 1) * 8];
        const unsigned addr = (unsigned)__cvta_generic_to_shared(xr);
        uint32_t b[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
            : "r"(addr));
        mma(den[2 * p], apos, b[0], b[1]);
        mma(num[2 * p], aneg, b[0], b[1]);
        mma(den[2 * p + 1], apos, b[2], b[3]);
        mma(num[2 * p + 1], aneg, b[2], b[3]);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  // epilogue: the float32 mode's arithmetic (fma::update_epilogue with
  // theta on both sides), then the f32 iterate and its bf16 rounding
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 16 * wr + g + (e >> 1) * 8;
      const int b = b0 + WN * wl + 8 * j + 2 * tq + (e & 1);
      if (r >= n || b >= B) continue;
      const long long idx = (long long)r * B + b;
      const long long f = fd_lane ? idx : (long long)r;
      const float y = y_in[idx];
      const float ty = theta[r] * y;
      const float nu = (num[j][e] + ty) + fdn[f];
      const float de = (den[j][e] + ty) + fdp[f];
      const float out = (nu / guard_den(de, den_eps)) * y;
      y_out[idx] = out;
      yb_out[idx] = __float2bfloat16_rn(out);
    }
  }
}

__global__ void round_kernel(const float* y, __nv_bfloat16* yb,
                             long long count) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x)
    yb[i] = __float2bfloat16_rn(y[i]);
}

template <int BM, int BN>
static cudaError_t launch(const __nv_bfloat16* q, const float* theta,
                          const float* fdn, const float* fdp, int fd_lane,
                          const float* y, float* y_out, float* y_tmp,
                          __nv_bfloat16* yb0, __nv_bfloat16* yb1, int n,
                          int B, int num_iters, float den_eps,
                          cudaStream_t stream) {
  const long long count = (long long)n * B;
  round_kernel<<<(int)((count + 255) / 256 < 1024 ? (count + 255) / 256
                                                   : 1024),
                 256, 0, stream>>>(y, yb0, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BN - 1) / BN, (n + BM - 1) / BM);
  const float* src = y;
  __nv_bfloat16* yb[2] = {yb0, yb1};
  for (int t = 0; t < num_iters; ++t) {
    // the buffer of update t is chosen so that the last one is y_out
    float* dst = ((num_iters - 1 - t) % 2 == 0) ? y_out : y_tmp;
    tc_update_kernel<BM, BN><<<grid, BM * BN / 8, 0, stream>>>(
        q, theta, fdn, fdp, fd_lane, src, yb[t % 2], dst, yb[(t + 1) % 2],
        n, B, den_eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

template <int BM>
static cudaError_t launch_rows(int BN, const __nv_bfloat16* q,
                               const float* theta, const float* fdn,
                               const float* fdp, int fd_lane, const float* y,
                               float* y_out, float* y_tmp, __nv_bfloat16* yb0,
                               __nv_bfloat16* yb1, int n, int B,
                               int num_iters, float den_eps,
                               cudaStream_t s) {
#define PQP_TC_TILE(bn)                                                     \
  if (BN == bn)                                                             \
    return launch<BM, bn>(q, theta, fdn, fdp, fd_lane, y, y_out, y_tmp,     \
                          yb0, yb1, n, B, num_iters, den_eps, s);
  PQP_TC_TILE(16)
  PQP_TC_TILE(32)
  PQP_TC_TILE(64)
#undef PQP_TC_TILE
  return cudaErrorInvalidValue;
}

}  // namespace tc

template <int BN>
static cudaError_t launch_f32(const float* q, const float* theta,
                              const float* fdn, const float* fdp, int fd_lane,
                              const float* y, float* y_out, float* y_tmp,
                              int n, int B, int num_iters, float den_eps,
                              cudaStream_t stream) {
  const auto kernel = f32_update_kernel<BN>;
  const int smem = (int)sizeof(fma::Smem<BN>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BN - 1) / BN, (n + fma::BM - 1) / fma::BM);
  const float* src = y;
  for (int t = 0; t < num_iters; ++t) {
    // the buffer of update t is chosen so that the last one is y_out
    float* dst = ((num_iters - 1 - t) % 2 == 0) ? y_out : y_tmp;
    kernel<<<grid, fma::kThreads, smem, stream>>>(q, theta, fdn, fdp,
                                                  fd_lane, src, dst, n, B,
                                                  den_eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace pqp

// q: (n, n) float32 (q_bf16 = 0) or bfloat16 (q_bf16 = 1); theta (n);
// fdn/fdp (n, B) per lane (fd_lane = 1) or (n) shared; y, y_out, y_tmp
// (n, B) float32; yb0, yb1 (n, B) bfloat16 scratch of the bf16 mode (the
// iterate's rounding, ping-pong).  The tile plan: float32 mode, tile_lanes
// in {32, 64, 128} (tile_rows is 32); bf16 mode, tile_rows and tile_lanes
// in {16, 32, 64}.  A float32 q and y start 16-byte aligned.
// num_iters >= 1.
extern "C" int pqp_iterations_tiled(const void* q, int q_bf16,
                                    const float* theta, const float* fdn,
                                    const float* fdp, int fd_lane,
                                    const float* y, float* y_out,
                                    float* y_tmp, void* yb0, void* yb1,
                                    int n, int B, int num_iters,
                                    float den_eps, int tile_rows,
                                    int tile_lanes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || B < 1 || num_iters < 1 || (long long)n > 65535LL * 16)
    return (int)cudaErrorInvalidValue;
  if (!q_bf16) {
    const auto* qf = static_cast<const float*>(q);
#define PQP_F32_TILE(bn)                                                    \
  if (tile_lanes == bn)                                                     \
    return (int)pqp::launch_f32<bn>(qf, theta, fdn, fdp, fd_lane, y, y_out, \
                                    y_tmp, n, B, num_iters, den_eps, s);
    PQP_F32_TILE(32)
    PQP_F32_TILE(64)
    PQP_F32_TILE(128)
#undef PQP_F32_TILE
    return (int)cudaErrorInvalidValue;
  }
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  auto* b0 = static_cast<__nv_bfloat16*>(yb0);
  auto* b1 = static_cast<__nv_bfloat16*>(yb1);
#define PQP_TC_ROWS(bm)                                                     \
  if (tile_rows == bm)                                                      \
    return (int)pqp::tc::launch_rows<bm>(tile_lanes, qb, theta, fdn, fdp,    \
                                         fd_lane, y, y_out, y_tmp, b0, b1, n, \
                                         B, num_iters, den_eps, s);
  PQP_TC_ROWS(16)
  PQP_TC_ROWS(32)
  PQP_TC_ROWS(64)
#undef PQP_TC_ROWS
  return (int)cudaErrorInvalidValue;
}
