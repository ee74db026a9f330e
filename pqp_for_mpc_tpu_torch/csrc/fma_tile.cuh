// The float32 tile of K4 (full_solve_tiled.cu) and of K3's float32 mode
// (pqp_iterations_tiled.cu): one block of 256 threads computes a
// BM x BN = 32 x (32, 64 or 128) tile of C = A X on the CUDA cores, A a
// (rows x depth) row-major matrix or the transpose of one (Gp'), X a
// batch-last panel (depth x B, element (k, b) at x[k * B + b]).
//
// Arithmetic.  Each entry is one chain of float32 fused multiply-adds in
// ascending k from 0 — the order of the previous K4's tile, so every sum
// repeats its bits.  SPLIT mode splits A into relu(A) and relu(-A) in
// registers (relu_max: max.NaN keeps a NaN entry NaN, as the plain version
// does) and feeds two accumulators.
//
// Data path.  A 3-stage cp.async ring of BK = 64-deep slabs: A's BM rows
// (k contiguous, rows padded by 4 floats; a transposed A is staged
// k-major, rows padded to 36) and X's BN lanes.  Rows, depth or lanes that
// are not multiples of 4 stage entry by entry (4-byte cp.async); entries
// past the edge are zero-filled.  The 16-byte copies need A and X to start
// 16-byte aligned (the wrappers copy an operand that does not).
//
// Thread t owns rows 4 (t / 32) + [0, 4) and lanes (t % 32) BN/32 +
// [0, BN/32): a warp reads one float4 of A per row and k-quad (the same
// address for the whole warp) and BN floats of X per k, contiguous;
// 2 x 4 x BN/32 FMAs per k in SPLIT mode.
//
// The sizes are the fastest measured on an H100 (PERF.md): 32-deep
// slabs, 16-row tiles and 8 lanes per thread ran slower, 2- or 4-stage
// rings within 0.5%; the k-quad loop unrolled 4 beat 2 by 1-3% (K3, K4).
#pragma once

#include <cuda_runtime.h>

#include "pqp_common.cuh"

namespace pqp {
namespace fma {

constexpr int BM = 32;            // output rows of a tile
constexpr int RT = BM / 8;        // rows of a thread
constexpr int LG = 32;            // lane groups of a block
constexpr int BK = 64;            // depth of one staged slab
constexpr int kStages = 3;        // cp.async ring
constexpr int kThreads = 8 * LG;  // 8 row groups x LG lane groups
constexpr int kLdA = BK + 4;      // row-major A slab rows: a[row][k]
constexpr int kLdT = BM + 4;      // transposed A slab rows: a[k][row]

template <int BN>
struct Smem {
  float a[kStages][BM * kLdA > BK * kLdT ? BM * kLdA : BK * kLdT];
  float x[kStages][BK][BN];
};

// A thread's accumulators: acc[i][j] holds row RT (t / LG) + i, lane
// (t % LG) BN / LG + j of the tile.
template <int BN>
struct AccShape {
  static constexpr int d0 = RT, d1 = BN / LG;
};

// The lanes of a tile for a batch of B: the narrowest of 32, 64, 128 that
// holds B, else 128 (K4's; ops/tiled_kernel.py: fma_tile_lanes).
__host__ __device__ inline int tile_lanes(int B) {
  return B <= 32 ? 32 : B <= 64 ? 64 : 128;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0));
}

// Stage slab k0 into ring slot st.  TRANS: A(r, k) = a[k * lda + r].
template <int BN, bool TRANS>
__device__ __forceinline__ void stage(Smem<BN>& sm, int st, const float* a,
                                      int lda, const float* x, int r0,
                                      int b0, int k0, int rows, int depth,
                                      int B, bool vec) {
  const int t = threadIdx.x;
  float* sa = sm.a[st];
  if (vec) {  // lda and B multiples of 4: 16-byte chunks, in or out whole
    // A: BM x BK entries in chunks of 4
#pragma unroll
    for (int c = t; c < BM * BK / 4; c += kThreads) {
      if (TRANS) {
        const int kk = c / (BM / 4), rr = 4 * (c % (BM / 4));
        const int k = k0 + kk, r = r0 + rr;
        const bool in = k < depth && r < rows;
        cp_async16(sa + kk * kLdT + rr, in ? a + (long long)k * lda + r : a,
                   in);
      } else {
        const int rr = c / (BK / 4), kk = 4 * (c % (BK / 4));
        const int r = r0 + rr, k = k0 + kk;
        const bool in = r < rows && k < depth;
        cp_async16(sa + rr * kLdA + kk, in ? a + (long long)r * lda + k : a,
                   in);
      }
    }
#pragma unroll
    for (int c = t; c < BK * (BN / 4); c += kThreads) {
      const int kk = c / (BN / 4), bb = 4 * (c % (BN / 4));
      const int k = k0 + kk, b = b0 + bb;
      const bool in = k < depth && b < B;
      cp_async16(&sm.x[st][kk][bb], in ? x + (long long)k * B + b : x, in);
    }
  } else {
#pragma unroll
    for (int e = t; e < BM * BK; e += kThreads) {
      if (TRANS) {
        const int kk = e / BM, rr = e % BM;
        const int k = k0 + kk, r = r0 + rr;
        const bool in = k < depth && r < rows;
        cp_async4(sa + kk * kLdT + rr, in ? a + (long long)k * lda + r : a,
                  in);
      } else {
        const int rr = e / BK, kk = e % BK;
        const int r = r0 + rr, k = k0 + kk;
        const bool in = r < rows && k < depth;
        cp_async4(sa + rr * kLdA + kk, in ? a + (long long)r * lda + k : a,
                  in);
      }
    }
#pragma unroll
    for (int e = t; e < BK * BN; e += kThreads) {
      const int kk = e / BN, bb = e % BN;
      const int k = k0 + kk, b = b0 + bb;
      const bool in = k < depth && b < B;
      cp_async4(&sm.x[st][kk][bb], in ? x + (long long)k * B + b : x, in);
    }
  }
}

// TL consecutive floats of shared memory, 4 TL-byte aligned.
template <int TL>
__device__ __forceinline__ void load_lanes(const float* p, float (&v)[TL]) {
  if constexpr (TL == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (TL == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// Accumulate one tile of A (rows x depth) times X (depth x B) at (r0, b0)
// into acc0 (and, SPLIT, relu(A) X into acc0 and relu(-A) X into acc1).
// Every thread of the block must call it: it synchronises the block, and
// leaves the ring free for the next call.
template <int BN, bool TRANS, bool SPLIT>
__device__ __forceinline__ void products(Smem<BN>& sm, int r0, int b0,
                                         int rows, int depth, int B,
                                         const float* a, int lda,
                                         const float* x,
                                         float (&acc0)[RT][BN / LG],
                                         float (&acc1)[RT][BN / LG]) {
  constexpr int TL = BN / LG;  // lanes of a thread
  const int tr = threadIdx.x / LG, tl = threadIdx.x % LG;
  const bool vec = (lda % 4) == 0 && (B % 4) == 0;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < TL; ++j) acc0[i][j] = acc1[i][j] = 0.f;

  const int slabs = (depth + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs)
      stage<BN, TRANS>(sm, s, a, lda, x, r0, b0, s * BK, rows, depth, B,
                       vec);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int i = 0; i < slabs; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // slab i landed; slot (i - 1) % kStages is free
    const int nxt = i + kStages - 1;
    if (nxt < slabs)
      stage<BN, TRANS>(sm, nxt % kStages, a, lda, x, r0, b0, nxt * BK, rows,
                       depth, B, vec);
    asm volatile("cp.async.commit_group;\n" ::);
    const int st = i % kStages;
    const float* sa = sm.a[st];
#pragma unroll 4
    for (int kq = 0; kq < BK; kq += 4) {
      // av[r][kk]: A(RT tr + r, kq + kk)
      float av[RT][4];
      if (TRANS) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float w[RT];
          load_lanes<RT>(sa + (kq + u) * kLdT + RT * tr, w);
#pragma unroll
          for (int c = 0; c < RT; ++c) av[c][u] = w[c];
        }
      } else {
#pragma unroll
        for (int u = 0; u < RT; ++u)
          load_lanes<4>(sa + (RT * tr + u) * kLdA + kq, av[u]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float xv[TL];
        load_lanes<TL>(&sm.x[st][kq + kk][tl * TL], xv);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float pos = SPLIT ? relu_max(av[r][kk]) : av[r][kk];
#pragma unroll
          for (int j = 0; j < TL; ++j) acc0[r][j] = fmaf(pos, xv[j], acc0[r][j]);
          if (SPLIT) {
            const float neg = relu_max(-av[r][kk]);
#pragma unroll
            for (int j = 0; j < TL; ++j)
              acc1[r][j] = fmaf(neg, xv[j], acc1[r][j]);
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// f(r, b, i, j) for each entry of this thread's acc[i][j] inside (rows, B).
template <int BN, class F>
__device__ __forceinline__ void for_entries(int r0, int b0, int rows, int B,
                                            F f) {
  const int tr = threadIdx.x / LG, tl = threadIdx.x % LG;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < BN / LG; ++j) {
      const int r = r0 + RT * tr + i, b = b0 + tl * (BN / LG) + j;
      if (r < rows && b < B) f(r, b, i, j);
    }
}

// The multiplicative update of a tile's entries from its split products,
// den_acc = relu(Q) y and num_acc = relu(-Q) y (SPLIT mode on Qd_hat), the
// epilogue of K3's float32 mode and of K4's update pass:
//     num = (num_acc + theta_r y) + fdn,  den = den_acc + fdp,
//     dst = (num / guard(den)) * y
// for each entry inside (n, B).  fd_lane selects per-lane (n x B) or
// shared (n) forcing panels; a lane for which frozen(b) holds keeps y.
// theta_r y contracts into one FMA with num_acc, as in the previous
// epilogues of both kernels, so each keeps its bits (PERF.md).
template <int BN, class Frozen>
__device__ __forceinline__ void update_epilogue(
    const float (&den_acc)[RT][BN / LG], const float (&num_acc)[RT][BN / LG],
    int r0, int b0, int n, int B, const float* theta, const float* fdn,
    const float* fdp, bool fd_lane, const float* src, float* dst,
    float den_eps, Frozen frozen) {
  for_entries<BN>(r0, b0, n, B, [&](int r, int b, int i, int j) {
    const long long e = (long long)r * B + b;
    const long long f = fd_lane ? e : (long long)r;
    const float y = src[e];
    float out = y;
    if (!frozen(b)) {
      const float num = (num_acc[i][j] + theta[r] * y) + fdn[f];
      const float den = den_acc[i][j] + fdp[f];
      out = (num / guard_den(den, den_eps)) * y;
    }
    dst[e] = out;
  });
}

}  // namespace fma
}  // namespace pqp
