// K7: num_iters multiplicative PQP updates for DISTINCT instances, each
// instance's Hessian read from device memory once per launch and kept on
// the chip for the other updates.
//
// Replaces the TPU kernel pqp_for_mpc_tpu/ops/distinct_tiled_kernel.py:
// fused_pqp_iterations_distinct_tiled (its Pallas body _upd_kernel), the
// bulk engine of solve_mixed on 3-D Qd.  Per instance b it multiplies by
// ONE matrix Q_b per update:
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
// What bounds it on an H100.  An update is a batched matrix-vector product,
// B n^2 entries for 4 B n^2 flop: at n = 2048, B = 8 the matrices hold
// 134 MB in f32 and 67 MB in bf16, past the 50 MB L2, so a design that
// reads them from device memory on every update is held to 40 us (f32) and
// 20 us (bf16) per update at 3.35 TB/s.
//
// Design.  One cooperative persistent launch per call: one block of 512
// threads per SM (the wrapper's plan, ops/distinct_tiled_kernel.py:
// k7_plan), grid.sync() between updates (each update needs the whole
// previous iterate of its instance; the iterate ping-pongs between two
// global buffers, read through L2).  The B n rows of all instances are
// split evenly over the blocks in instance-major order; a block's LAST
// `resident` rows are copied into its shared memory with cp.async while it
// streams its other rows for the first update, and every later update
// reads them from there: the card's 30 MB of shared memory hold 44% of the
// bf16 matrices at that size.  The rest of a block's rows are read from
// global memory on every update.  In bf16 those 37 MB would fit L2, but on
// an H100 they did not stay there across updates (an L2 evict_last policy
// on them changed nothing), so a later update is held to their time at the
// HBM rate, plus the relu split's instructions (two max.NaN and two FMA per
// entry) and one grid barrier; in f32 the 105 MB remainder comes from
// device memory again, as before.  For each instance its rows meet, a block
// stages that instance's y in shared memory (in the stream's type: bf16
// values are the rounded operand), then each warp takes groups of four rows
// and reads each 16-byte vector of y once for all four; after the first
// update the groups of rows from global and from shared memory alternate
// across the warps, so that memory waits overlap the other warps' issue.
// Lane l reads each row's vectors l, l + 32, ... in ascending order and a
// butterfly closes the row — the order of the previous
// one-launch-per-update design, so y_out repeats its bits on every entry.
// Only where a row's data comes from changed.  A launch the card refuses
// (cooperative residency, shared memory) raises in the wrapper.
//
// Semantics match pqp_for_mpc_tpu_torch/ops/distinct_tiled_kernel.py:
// distinct_streamed_iterations_reference up to float32 summation order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "distinct_common.cuh"
#include "pqp_common.cuh"

namespace cg = cooperative_groups;

namespace pqp {
namespace k7 {

constexpr int kK7Threads = 512;
constexpr int kK7Group = 4;  // rows a warp dots at once, sharing y's loads

struct K7Args {
  const void* q;  // (B, n, n) float32 or bf16 bits
  const float *theta, *fdn, *fdp, *y;
  float *y_out, *y_tmp;
  int n, B, num_iters, resident, vec;
  float den_eps;
};

// The relu-split dots of kK7Group rows with the staged x, for one warp, each
// row in the previous design's order: lane l takes the row's 16-byte
// vectors (or, rows not made of them, its entries) l, l + 32, ... in
// ascending order, then the butterfly.  x holds y in the stream's type
// (bf16 bits in that mode: the rounded operand, exact).
template <typename T>
__device__ __forceinline__ void group_dots(const T* const (&rows)[kK7Group],
                                           const T* __restrict__ x, int n,
                                           bool vec, float (&neg)[kK7Group],
                                           float (&pos)[kK7Group]) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kK7Group; ++r) neg[r] = pos[r] = 0.f;
  if (vec) {
    if constexpr (kBf16) {
      const uint4* x8 = reinterpret_cast<const uint4*>(x);
#pragma unroll 4
      for (int q = lane; q < (n >> 3); q += 32) {
        const uint4 v = x8[q];
        const float v0 = dist::bf16_bits(v.x & 0xffffu);
        const float v1 = dist::bf16_bits(v.x >> 16);
        const float v2 = dist::bf16_bits(v.y & 0xffffu);
        const float v3 = dist::bf16_bits(v.y >> 16);
        const float v4 = dist::bf16_bits(v.z & 0xffffu);
        const float v5 = dist::bf16_bits(v.z >> 16);
        const float v6 = dist::bf16_bits(v.w & 0xffffu);
        const float v7 = dist::bf16_bits(v.w >> 16);
#pragma unroll
        for (int r = 0; r < kK7Group; ++r) {
          const uint4 w = reinterpret_cast<const uint4*>(rows[r])[q];
          dist::relu_fma(dist::bf16_bits(w.x & 0xffffu), v0, neg[r], pos[r]);
          dist::relu_fma(dist::bf16_bits(w.x >> 16), v1, neg[r], pos[r]);
          dist::relu_fma(dist::bf16_bits(w.y & 0xffffu), v2, neg[r], pos[r]);
          dist::relu_fma(dist::bf16_bits(w.y >> 16), v3, neg[r], pos[r]);
          dist::relu_fma(dist::bf16_bits(w.z & 0xffffu), v4, neg[r], pos[r]);
          dist::relu_fma(dist::bf16_bits(w.z >> 16), v5, neg[r], pos[r]);
          dist::relu_fma(dist::bf16_bits(w.w & 0xffffu), v6, neg[r], pos[r]);
          dist::relu_fma(dist::bf16_bits(w.w >> 16), v7, neg[r], pos[r]);
        }
      }
    } else {
      const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
      for (int q = lane; q < (n >> 2); q += 32) {
        const float4 v = x4[q];
#pragma unroll
        for (int r = 0; r < kK7Group; ++r) {
          const float4 a = reinterpret_cast<const float4*>(rows[r])[q];
          dist::relu_fma(a.x, v.x, neg[r], pos[r]);
          dist::relu_fma(a.y, v.y, neg[r], pos[r]);
          dist::relu_fma(a.z, v.z, neg[r], pos[r]);
          dist::relu_fma(a.w, v.w, neg[r], pos[r]);
        }
      }
    }
  } else {
#pragma unroll 4
    for (int j = lane; j < n; j += 32) {
      float xv;
      if constexpr (kBf16) xv = dist::bf16_bits(x[j]);
      else xv = x[j];
#pragma unroll
      for (int r = 0; r < kK7Group; ++r) {
        float a;
        if constexpr (kBf16) a = dist::bf16_bits(rows[r][j]);
        else a = rows[r][j];
        dist::relu_fma(a, xv, neg[r], pos[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kK7Group; ++r) {
    neg[r] = dist::warp_sum(neg[r]);
    pos[r] = dist::warp_sum(pos[r]);
  }
}

// The update of the kK7Group rows from g (flattened instance-major index)
// below hi from src into dst, x staged; row g's entries at row_of(g).
// Lane r of the warp closes row r.
template <typename T, class RowOf>
__device__ __forceinline__ void update_group(const K7Args& a, const T* x,
                                             const float* src, float* dst,
                                             long long g, long long hi,
                                             RowOf row_of) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  const int lane = threadIdx.x & 31;
  const T* rows[kK7Group];
#pragma unroll
  for (int r = 0; r < kK7Group; ++r)
    rows[r] = row_of(g + r < hi ? g + r : hi - 1);
  // lane r's row operands, loaded before the dots hide their latency
  const long long e = g + lane;
  float y = 0.f, th = 0.f, fn = 0.f, fp = 0.f;
  if (lane < kK7Group && e < hi) {
    y = __ldcg(src + e);
    th = a.theta[e];
    fn = a.fdn[e];
    fp = a.fdp[e];
  }
  float neg[kK7Group], pos[kK7Group];
  group_dots<T>(rows, x, a.n, a.vec != 0, neg, pos);
  // lane r's sums picked first, so that the expression below is the
  // previous design's, contracted alike
  float ng = 0.f, ps = 0.f;
#pragma unroll
  for (int r = 0; r < kK7Group; ++r) {
    if (lane == r) {
      ng = neg[r];
      ps = pos[r];
    }
  }
  if (lane < kK7Group && e < hi) {
    const float ty = th * y;
    const float num = ng + ty + fn;
    const float den = kBf16 ? (ps + ty) + fp : ps + fp;
    dst[e] = (num / guard_den(den, a.den_eps)) * y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kK7Threads, 1)
distinct_updates_kernel(const K7Args a) {
  extern __shared__ float4 smem4[];
  const int n = a.n;
  const T* q = static_cast<const T*>(a.q);
  // y in the stream's type, then this block's resident rows
  T* x = reinterpret_cast<T*>(smem4);
  T* res = x + ((n * sizeof(T) + 15) / 16) * (16 / sizeof(T));
  const long long total = (long long)a.B * n;
  const long long k = blockIdx.x;
  const long long base = total / gridDim.x, rem = total % gridDim.x;
  const long long g0 = k * base + (k < rem ? k : rem);
  const long long g1 = g0 + base + (k < rem ? 1 : 0);
  const long long gs = g1 - min((long long)a.resident, g1 - g0);
  // the resident rows, contiguous in q: cp.async when rows are whole
  // 16-byte vectors (waited for before their first use), else copied now
  {
    const T* from = q + gs * n;
    const long long count = (g1 - gs) * n;
    if (a.vec) {
      const long long chunks = count * (long long)sizeof(T) / 16;
      for (long long c = threadIdx.x; c < chunks; c += blockDim.x)
        cp_async16(reinterpret_cast<char*>(res) + 16 * c,
                   reinterpret_cast<const char*>(from) + 16 * c);
      asm volatile("cp.async.commit_group;\n" ::);
    } else {
      for (long long j = threadIdx.x; j < count; j += blockDim.x)
        res[j] = from[j];
      __syncthreads();
    }
  }
  cg::grid_group grid = cg::this_grid();
  const float* src = a.y;
  for (int t = 0; t < a.num_iters; ++t) {
    // the buffer of update t is chosen so that the last one is y_out
    float* dst = ((a.num_iters - 1 - t) % 2 == 0) ? a.y_out : a.y_tmp;
    if (g0 < g1) {
      for (long long b = g0 / n; b <= (g1 - 1) / n; ++b) {
        const long long s0 = max(g0, b * n), s1 = min(g1, (b + 1) * n);
        for (int j = threadIdx.x; j < n; j += blockDim.x) {
          const float v = __ldcg(src + b * n + j);
          if constexpr (std::is_same<T, float>::value) x[j] = v;
          else x[j] = (T)__bfloat16_as_ushort(__float2bfloat16_rn(v));
        }
        __syncthreads();
        const auto row_of = [&](long long g) {
          return g < gs ? q + g * n : res + (g - gs) * n;
        };
        constexpr int kWarps = kK7Threads / 32;
        const int warp = threadIdx.x >> 5;
        if (t == 0) {
          // the streamed rows, then (once they have landed) the resident
          for (long long g = s0 + (long long)warp * kK7Group;
               g < min(s1, gs); g += (long long)kWarps * kK7Group)
            update_group<T>(a, x, src, dst, g, min(s1, gs),
                            [&](long long r) { return q + r * n; });
          if (s1 > gs) {
            asm volatile("cp.async.wait_all;\n" ::);
            __syncthreads();
            for (long long g = max(s0, gs) + (long long)warp * kK7Group;
                 g < s1; g += (long long)kWarps * kK7Group)
              update_group<T>(a, x, src, dst, g, s1, row_of);
          }
        } else {
          // groups of four rows taken alternately from the front (rows
          // streamed from L2) and the back (resident rows), and by each
          // warp in alternating order, so that while some warps wait for
          // memory others keep the issue slots busy
          const long long groups = (s1 - s0 + kK7Group - 1) / kK7Group;
          for (long long j0 = 2 * warp; j0 < groups; j0 += 2 * kWarps) {
            for (int h = 0; h < 2; ++h) {
              const long long j = j0 + (h ^ (warp & 1));
              if (j >= groups) continue;
              const long long p = (j % 2 == 0) ? j / 2 : groups - 1 - j / 2;
              update_group<T>(a, x, src, dst, s0 + p * kK7Group, s1,
                              row_of);
            }
          }
        }
        __syncthreads();  // x is staged again for the next instance
      }
    }
    grid.sync();
    src = dst;
  }
}

template <typename T>
static cudaError_t launch_updates(const K7Args& a, int blocks,
                                  cudaStream_t stream) {
  const auto kernel = distinct_updates_kernel<T>;
  const size_t xbytes = ((size_t)a.n * sizeof(T) + 15) / 16 * 16;
  const size_t smem = xbytes + (size_t)a.resident * a.n * sizeof(T);
  if (smem > 232448) return cudaErrorInvalidValue;
  // the solve calls this launcher once per check: set the shared-memory
  // cap only when it grows; the cooperative launch itself refuses a grid
  // whose blocks cannot all be resident
  static size_t smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  K7Args args = a;
  void* params[] = {&args};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(blocks), dim3(kK7Threads), params, smem,
      stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace k7
}  // namespace pqp

// q: (B, n, n) float32 (q_bf16 = 0) or bfloat16 (q_bf16 = 1), 16-byte
// aligned; theta, fdn, fdp, y, y_out, y_tmp: (B, n) instance-major.
// num_iters >= 1.  blocks and resident (rows each block keeps in shared
// memory) come from the wrapper's plan, k7_plan.
extern "C" int pqp_iterations_distinct_tiled(const void* q, int q_bf16,
                                             const float* theta,
                                             const float* fdn,
                                             const float* fdp, const float* y,
                                             float* y_out, float* y_tmp,
                                             int n, int B, int num_iters,
                                             float den_eps, int blocks,
                                             int resident, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || B < 1 || B > 65535 || num_iters < 1 || blocks < 1 ||
      resident < 0 || (size_t)n * sizeof(float) > 232448)
    return (int)cudaErrorInvalidValue;
  pqp::k7::K7Args a = {};
  a.q = q; a.theta = theta; a.fdn = fdn; a.fdp = fdp; a.y = y;
  a.y_out = y_out; a.y_tmp = y_tmp;
  a.n = n; a.B = B; a.num_iters = num_iters; a.resident = resident;
  a.den_eps = den_eps;
  a.vec = (n % (q_bf16 ? 8 : 4)) == 0;
  if (q_bf16)
    return (int)pqp::k7::launch_updates<unsigned short>(a, blocks, s);
  return (int)pqp::k7::launch_updates<float>(a, blocks, s);
}
