// K4: the whole batched PQP solve in one launch with the Hessian streamed.
//
// Replaces the TPU kernel pqp_for_mpc_tpu/ops/tiled_solve_kernel.py:
// fused_full_solve_tiled (its Pallas body _kernel): for N past the resident
// kernels, rounds of one check pass and check_every Jacobi update passes,
// the safeguarded projected-gradient step at the check cadence (three more
// passes over the matrix), the stall freeze and the early exit — the matrix
// Qd_hat = Qd + diag(max(diag, 0) - diag + theta) streamed on every pass,
// its splits rebuilt by relu (tile_gemm.cuh).
//
// Design.  A cooperative persistent kernel: cudaLaunchCooperativeKernel
// with a grid no larger than the blocks that fit on the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and
// cooperative_groups::this_grid().sync() between dependent phases, which
// replaces the TPU's sequential grid.  Each phase spreads its work over the
// blocks: a matrix phase hands out 32-row x 64-lane output tiles, a lane
// phase hands out (row chunk x 32 lanes) units, an elementwise phase
// entries.  Every output row belongs to one block, and every per-lane sum is
// taken in a fixed order: partial sums over 256-row chunks (four row groups
// added in fixed order), then the chunks in ascending order — no atomics,
// so iteration counts repeat from run to run.  The loop condition is read
// by every block from the lane states after a grid sync, so all blocks
// leave together.  Per round without acceleration: check (5 syncs),
// check_every updates (one each), stall test (2); the accel step adds 9.
// The iterates, Qd y, Gp u and the check's panels live in global memory
// (2 MB each at N = 4096, B = 128: L2-resident); Qp and Qp^-1 (4 MB each
// at M = 1024) are read from global memory / L2, not staged.
//
// What bounds it on an H100.  As K3 (pqp_iterations_tiled.cu): an update
// is 4 N^2 B flop on the CUDA cores, compute-bound (>= 0.13 ms at N = 4096,
// B = 128); a check adds 2 N^2 B + 4 N M B + 4 M^2 B flop, an accel step
// 6 N^2 B.  A grid sync costs microseconds, against ~0.35 ms per update.
// The update tile is a separate (noinline) function: see update_tile.
//
// Semantics match pqp_for_mpc_tpu_torch/ops/tiled_solve_kernel.py:
// fused_full_solve_tiled_reference up to float32 summation order.  Lane
// codes as K1's (0 max_iters, 1 certified, 2 stalled); no batch padding.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pqp_common.cuh"
#include "tile_gemm.cuh"

namespace cg = cooperative_groups;

namespace pqp {

constexpr int kChunk = 256;  // rows of one partial per-lane sum
constexpr int kMaxSums = 5;  // sums one lane phase carries

struct TiledSolveArgs {
  const float *qh, *theta, *gp, *qp, *qpi;        // geometry (read only)
  const float *fp, *fd, *fdp, *fdn, *kps;         // (m|n, B) panels
  const float *mp, *md, *y0;                      // (B), (B), (n, B)
  float *ya, *yb, *qdy, *w, *g, *p;               // (n, B) scratch; ya = Y
  float *v, *u;                                   // (m, B); u = U
  float *lane;                                    // (4, B): alpha, fY,
                                                  // diff, keep
  float* part;                                    // lane partials
  int *iters, *state;                             // (B)
  int n, m, B, max_iters, check_every, accel;
  float eaj, erj;
  int strict;
  float den_eps;
  int gap_comp;
};

union SolveSmem {
  tile::Smem gemm;
  float red[4][kMaxSums][32];
};

__host__ __device__ inline int n_chunks(int rows) {
  return (rows + kChunk - 1) / kChunk;
}

// Grid-stride over the BM x BL tiles of a (rows x B) output:
// fn(r0, b0) for each tile this block owns.
template <class Fn>
__device__ __forceinline__ void for_tiles(int rows, int B, Fn fn) {
  const int lt = (B + tile::BL - 1) / tile::BL;
  const int tiles = ((rows + tile::BM - 1) / tile::BM) * lt;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    fn((t / lt) * tile::BM, (t % lt) * tile::BL);
}

// Two outputs in one phase: the tiles of (rows1 x B) then of (rows2 x B).
template <class Fn1, class Fn2>
__device__ __forceinline__ void for_tiles2(int rows1, int rows2, int B,
                                           Fn1 fn1, Fn2 fn2) {
  const int lt = (B + tile::BL - 1) / tile::BL;
  const int t1 = ((rows1 + tile::BM - 1) / tile::BM) * lt;
  const int t2 = ((rows2 + tile::BM - 1) / tile::BM) * lt;
  for (int t = blockIdx.x; t < t1 + t2; t += gridDim.x) {
    if (t < t1)
      fn1((t / lt) * tile::BM, (t % lt) * tile::BL);
    else
      fn2(((t - t1) / lt) * tile::BM, ((t - t1) % lt) * tile::BL);
  }
}

// Store one tile: out(r, b) = f(r, b, acc) for the entries inside.
template <class F>
__device__ __forceinline__ void store_tile(int r0, int b0, int rows, int B,
                                           const float (&acc)[4][4], F f) {
  const int tr = tile::row_group(), tl = tile::lane_group();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * tr + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + 4 * tl + j;
      if (b < B) f(r, b, (long long)r * B + b, acc[i][j]);
    }
  }
}

// Per-lane partial sums over chunks of kChunk rows: unit (chunk c, 32
// lanes); thread (row group rg, lane ln) adds rows c*kChunk + rg, +4, ...
// in ascending order through f(i, b, acc), then the four row groups are
// added in fixed order into part[(c * K + k) * B + b].
template <int K, class F>
__device__ void lane_partials(SolveSmem& sm, int rows, int B, float* part,
                              F f) {
  const int ln = threadIdx.x % 32, rg = threadIdx.x / 32;
  const int groups = (B + 31) / 32, chunks = n_chunks(rows);
  for (int unit = blockIdx.x; unit < groups * chunks; unit += gridDim.x) {
    const int c = unit / groups, b = (unit % groups) * 32 + ln;
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
    if (b < B) {
      const int end = min(rows, (c + 1) * kChunk);
      for (int i = c * kChunk + rg; i < end; i += 4) f(i, b, acc);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) sm.red[rg][k][ln] = acc[k];
    __syncthreads();
    if (rg == 0 && b < B) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        part[((long long)c * K + k) * B + b] =
            ((sm.red[0][k][ln] + sm.red[1][k][ln]) + sm.red[2][k][ln]) +
            sm.red[3][k][ln];
    }
    __syncthreads();
  }
}

// Per-lane totals of lane_partials' chunks, in ascending chunk order, handed
// to g(b, tot) by one thread per lane.
template <int K, class G>
__device__ void lane_totals(int rows, int B, const float* part, G g) {
  const int chunks = n_chunks(rows);
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    float tot[K];
#pragma unroll
    for (int k = 0; k < K; ++k) tot[k] = 0.f;
    for (int c = 0; c < chunks; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) tot[k] += part[((long long)c * K + k) * B + b];
    g(b, tot);
  }
}

// out = Qd_hat x - theta x over every tile of an (n x B) output: the TPU's
// qd_col (Qd with its diagonal clamped, times x).
__device__ void qd_times(const TiledSolveArgs& a, SolveSmem& sm,
                         const float* x, float* out) {
  for_tiles(a.n, a.B, [&](int r0, int b0) {
    float acc[4][4], unused[4][4];
    tile::products<false>(sm.gemm, r0, b0, a.n, a.n, a.B,
                          tile::RowMajor<float>{a.qh, a.n},
                          tile::Panel<false>{x, a.B}, acc, unused);
    store_tile(r0, b0, a.n, a.B, acc,
               [&](int r, int b, long long e, float s) {
                 out[e] = s - a.theta[r] * x[e];
               });
  });
}

// The four-part verdict at the iterate in ya (PQP_CPU.c:673-687, as the
// TPU kernel's check_pass): U = -Qp^-1 (Gp'Y + Fp), feasibility
// Gp U <= Kp_slack, explicit or complementarity gap.  A lane still active
// that passes is certified at h.  The final check also stamps iters = h on
// every lane still active.
__device__ void check_pass(const TiledSolveArgs& a, SolveSmem& sm,
                           cg::grid_group& grid, int h, bool final_check) {
  const int n = a.n, m = a.m, B = a.B;
  // qdy = Qd_hat y - theta y;  v = Gp' y
  for_tiles2(
      n, m, B,
      [&](int r0, int b0) {
        float acc[4][4], unused[4][4];
        tile::products<false>(sm.gemm, r0, b0, n, n, B,
                              tile::RowMajor<float>{a.qh, n},
                              tile::Panel<false>{a.ya, B}, acc, unused);
        store_tile(r0, b0, n, B, acc,
                   [&](int r, int b, long long e, float s) {
                     a.qdy[e] = s - a.theta[r] * a.ya[e];
                   });
      },
      [&](int r0, int b0) {
        float acc[4][4], unused[4][4];
        tile::products<false>(sm.gemm, r0, b0, m, n, B,
                              tile::Transposed{a.gp, m},
                              tile::Panel<false>{a.ya, B}, acc, unused);
        store_tile(r0, b0, m, B, acc,
                   [&](int, int, long long e, float s) { a.v[e] = s; });
      });
  grid.sync();
  // u = -Qp^-1 (v + Fp)
  for_tiles(m, B, [&](int r0, int b0) {
    float acc[4][4], unused[4][4];
    tile::products<false>(sm.gemm, r0, b0, m, m, B,
                          tile::RowMajor<float>{a.qpi, m},
                          tile::PanelSum{a.v, a.fp, B}, acc, unused);
    store_tile(r0, b0, m, B, acc,
               [&](int, int, long long e, float s) { a.u[e] = -s; });
  });
  grid.sync();
  // w = Gp u;  v = Qp u (v is free again)
  for_tiles2(
      n, m, B,
      [&](int r0, int b0) {
        float acc[4][4], unused[4][4];
        tile::products<false>(sm.gemm, r0, b0, n, m, B,
                              tile::RowMajor<float>{a.gp, m},
                              tile::Panel<false>{a.u, B}, acc, unused);
        store_tile(r0, b0, n, B, acc,
                   [&](int, int, long long e, float s) { a.w[e] = s; });
      },
      [&](int r0, int b0) {
        float acc[4][4], unused[4][4];
        tile::products<false>(sm.gemm, r0, b0, m, m, B,
                              tile::RowMajor<float>{a.qp, m},
                              tile::Panel<false>{a.u, B}, acc, unused);
        store_tile(r0, b0, m, B, acc,
                   [&](int, int, long long e, float s) { a.v[e] = s; });
      });
  grid.sync();
  // rows [0, n): Y'Qd Y, Fd'Y, violations; rows [n, n + m): U'Qp U, Fp'U
  lane_partials<5>(sm, n + m, B, a.part, [&](int i, int b, float* acc) {
    if (i < n) {
      const long long e = (long long)i * B + b;
      const float y = a.ya[e];
      acc[0] = fmaf(y, a.qdy[e], acc[0]);
      acc[1] = fmaf(a.fd[e], y, acc[1]);
      acc[2] += (a.w[e] > a.kps[e]) ? 1.f : 0.f;
    } else {
      const long long e = (long long)(i - n) * B + b;
      const float uu = a.u[e];
      acc[3] = fmaf(uu, a.v[e], acc[3]);
      acc[4] = fmaf(a.fp[e], uu, acc[4]);
    }
  });
  grid.sync();
  lane_totals<5>(n + m, B, a.part, [&](int b, const float* t) {
    const float s1 = t[0], s2 = t[1];
    const bool feas = t[2] == 0.f;
    const float jd = 0.5f * s1 + s2 + 0.5f * a.md[b];
    const float jp = 0.5f * t[3] + t[4] + 0.5f * a.mp[b];
    float gap;
    bool weak_fail;
    if (a.gap_comp) {  // Jp(U(Y)) + Jd(Y) = Y'(Qd Y + Fd)
      gap = s1 + s2;
      weak_fail = gap > 0.f;
    } else {
      gap = jp + jd;
      weak_fail = jp > -jd;
    }
    bool fail = !feas || (gap > a.eaj) || (gap / fabsf(jd) > a.erj);
    if (a.strict) fail = fail || weak_fail;
    if (a.state[b] == kActive) {
      if (!fail) {
        a.state[b] = kCertified;
        a.iters[b] = h;
      } else if (final_check) {
        a.iters[b] = h;
      }
    }
  });
  grid.sync();
}

// The stall test of a lane still active after its round: no movement in
// the last update sweep plus the accel step.
__device__ __forceinline__ void stall_test(const TiledSolveArgs& a, int b,
                                           float diff, int h) {
  if (diff == 0.f && a.state[b] == kActive) {
    a.state[b] = kStalled;
    a.iters[b] = h + a.check_every;
  }
}

// The corrected projected-gradient step with exact line search on
// f(Y) = 1/2 Y'Qd Y + Fd'Y, kept per lane when f does not increase
// (solver.accel_step; the TPU kernel's accel_step).  diff_sweep: the
// per-lane movement of the last update sweep, computed here before yb is
// reused.  Ends with the stall test.
__device__ void accel_pass(const TiledSolveArgs& a, SolveSmem& sm,
                           cg::grid_group& grid, int h) {
  const int n = a.n, B = a.B;
  float* alpha = a.lane;
  float* fy = a.lane + B;
  float* diff = a.lane + 2 * B;
  float* keep = a.lane + 3 * B;
  // g = Qd y + Fd (the gradient); p = -g where y > 0 or g < 0
  for_tiles(n, B, [&](int r0, int b0) {
    float acc[4][4], unused[4][4];
    tile::products<false>(sm.gemm, r0, b0, n, n, B,
                          tile::RowMajor<float>{a.qh, n},
                          tile::Panel<false>{a.ya, B}, acc, unused);
    store_tile(r0, b0, n, B, acc, [&](int r, int b, long long e, float s) {
      const float y = a.ya[e];
      const float gr = (s - a.theta[r] * y) + a.fd[e];
      a.g[e] = gr;
      a.p[e] = (y > 0.f || gr < 0.f) ? -gr : 0.f;
    });
  });
  grid.sync();
  qd_times(a, sm, a.p, a.w);
  grid.sync();
  lane_partials<4>(sm, n, B, a.part, [&](int i, int b, float* acc) {
    const long long e = (long long)i * B + b;
    const float pe = a.p[e], y = a.ya[e];
    acc[0] = fmaf(pe, a.w[e], acc[0]);               // p'Qd p
    acc[1] = fmaf(pe, pe, acc[1]);                   // p'p
    acc[2] = fmaf(y, a.g[e] + a.fd[e], acc[2]);      // 2 f(Y) - ...
    acc[3] += fabsf(y - a.yb[e]);                    // last sweep's move
  });
  grid.sync();
  lane_totals<4>(n, B, a.part, [&](int b, const float* t) {
    alpha[b] = (t[0] > 0.f) ? t[1] / fmaxf(t[0], 1e-30f) : 0.f;
    fy[b] = 0.5f * t[2];
    diff[b] = t[3];
  });
  grid.sync();
  // the candidate yn = max(y + alpha p, 0) into yb
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < (long long)n * B; e += (long long)gridDim.x * blockDim.x)
    a.yb[e] = relu_nan(a.ya[e] + alpha[e % B] * a.p[e]);
  grid.sync();
  qd_times(a, sm, a.yb, a.w);
  grid.sync();
  lane_partials<3>(sm, n, B, a.part, [&](int i, int b, float* acc) {
    const long long e = (long long)i * B + b;
    const float yn = a.yb[e];
    acc[0] = fmaf(yn, a.w[e], acc[0]);
    acc[1] = fmaf(a.fd[e], yn, acc[1]);
    acc[2] += fabsf(yn - a.ya[e]);
  });
  grid.sync();
  lane_totals<3>(n, B, a.part, [&](int b, const float* t) {
    const float fyn = 0.5f * t[0] + t[1];
    const bool kept = (fyn <= fy[b]) && a.state[b] == kActive;
    keep[b] = kept ? 1.f : 0.f;
    stall_test(a, b, diff[b] + (kept ? t[2] : 0.f), h);
  });
  grid.sync();
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < (long long)n * B; e += (long long)gridDim.x * blockDim.x)
    if (keep[e % B] != 0.f) a.ya[e] = a.yb[e];
  grid.sync();
}

// One update tile, compiled as a function of its own: inlined into this
// kernel, the same loop ran at half the speed it reaches alone (measured
// on an H100 at N = 4096, B = 128: 0.71 against 0.35 ms per update, with
// bit-identical iterates).  It owns its accumulators: passed in by
// reference they would live in memory.
__device__ __noinline__ void update_tile(tile::Smem& sm, int r0, int b0,
                                         const float* qh, const float* theta,
                                         const float* fdn, const float* fdp,
                                         const float* src, float* dst,
                                         const int* state, int n, int B,
                                         float den_eps) {
  float den_acc[4][4], num_acc[4][4];
  tile::products<true>(sm, r0, b0, n, n, B, tile::RowMajor<float>{qh, n},
                       tile::Panel<false>{src, B}, den_acc, num_acc);
  tile::update_epilogue(den_acc, num_acc, r0, b0, n, B, theta, false, fdn,
                        fdp, 1, src, dst, den_eps, state);
}

__global__ void __launch_bounds__(tile::kThreads)
tiled_full_solve_kernel(const TiledSolveArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ __align__(16) SolveSmem sm;
  const int n = a.n, B = a.B;
  const long long nB = (long long)n * B;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;

  for (long long e = gtid; e < nB; e += gstride) a.ya[e] = a.y0[e];
  for (long long b = gtid; b < B; b += gstride) {
    a.state[b] = kActive;
    a.iters[b] = 0;
  }
  grid.sync();

  for (int h = 1;; h += a.check_every) {
    // every block reads the same lane states after a grid sync, so every
    // block takes the same branch
    int active = 0;
    for (int b = threadIdx.x; b < B; b += blockDim.x)
      active |= (a.state[b] == kActive);
    active = __syncthreads_or(active);
    if (!active || h > a.max_iters) {
      check_pass(a, sm, grid, h, /*final_check=*/true);
      return;
    }
    check_pass(a, sm, grid, h, /*final_check=*/false);
    // check_every (even) Jacobi sweeps ya -> yb -> ya ...; frozen lanes
    // (state != 0) keep their iterate
    for (int j = 0; j < a.check_every; ++j) {
      const float* src = (j % 2 == 0) ? a.ya : a.yb;
      float* dst = (j % 2 == 0) ? a.yb : a.ya;
      for_tiles(n, B, [&](int r0, int b0) {
        update_tile(sm.gemm, r0, b0, a.qh, a.theta, a.fdn, a.fdp, src, dst,
                    a.state, n, B, a.den_eps);
      });
      grid.sync();
    }
    if (a.accel) {
      accel_pass(a, sm, grid, h);
    } else {
      lane_partials<1>(sm, n, B, a.part, [&](int i, int b, float* acc) {
        const long long e = (long long)i * B + b;
        acc[0] += fabsf(a.ya[e] - a.yb[e]);
      });
      grid.sync();
      lane_totals<1>(n, B, a.part,
                     [&](int b, const float* t) { stall_test(a, b, t[0], h); });
      grid.sync();
    }
  }
}

}  // namespace pqp

// Geometry: qh = Qd_hat (n, n), theta (n), gp (n, m), qp/qpi (m, m).
// Panels, all per lane: fp (m, B); fd, fdp, fdn, kps, y0 (n, B); mp, md (B).
// Scratch: yb, qdy, w, g, p (n, B); v (m, B); lane (4 B); part
// (n_chunks(n + m) * 5 * B).  Outputs: y_out (n, B), u_out (m, B), iters,
// state (B).  check_every even; accel 0 or 1 (at the check cadence).
extern "C" int full_solve_tiled_f32(
    const float* qh, const float* theta, const float* gp, const float* qp,
    const float* qpi, const float* fp, const float* fd, const float* fdp,
    const float* fdn, const float* kps, const float* mp, const float* md,
    const float* y0, float* y_out, float* u_out, int* iters_out,
    int* state_out, float* yb, float* qdy, float* w, float* g, float* p,
    float* v, float* lane, float* part, int n, int m, int B, int max_iters,
    int check_every, int accel, float eaj, float erj, int strict,
    float den_eps, int gap_comp, void* stream) {
  if (n < 1 || m < 1 || B < 1 || check_every < 2 || check_every % 2)
    return (int)cudaErrorInvalidValue;
  pqp::TiledSolveArgs a;
  a.qh = qh; a.theta = theta; a.gp = gp; a.qp = qp; a.qpi = qpi;
  a.fp = fp; a.fd = fd; a.fdp = fdp; a.fdn = fdn; a.kps = kps;
  a.mp = mp; a.md = md; a.y0 = y0;
  a.ya = y_out; a.yb = yb; a.qdy = qdy; a.w = w; a.g = g; a.p = p;
  a.v = v; a.u = u_out; a.lane = lane; a.part = part;
  a.iters = iters_out; a.state = state_out;
  a.n = n; a.m = m; a.B = B; a.max_iters = max_iters;
  a.check_every = check_every; a.accel = accel;
  a.eaj = eaj; a.erj = erj; a.strict = strict; a.den_eps = den_eps;
  a.gap_comp = gap_comp;

  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pqp::tiled_full_solve_kernel, pqp::tile::kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // one block per tile of the update pass, capped at what fits on the card
  // at once (a cooperative launch needs every block resident).  Measured on
  // an H100 at N = 4096, M = 1024, B = 128: 4.5% faster than one block per
  // tile of the widest check phase (256 against 320 blocks), 1.8x faster
  // than one block per SM
  const int lt = (B + pqp::tile::BL - 1) / pqp::tile::BL;
  const int tiles = ((n + pqp::tile::BM - 1) / pqp::tile::BM) * lt;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)pqp::tiled_full_solve_kernel,
                                    dim3(grid), dim3(pqp::tile::kThreads),
                                    params, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
