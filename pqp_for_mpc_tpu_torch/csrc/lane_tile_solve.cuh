// The lane-tile engine: the whole batched PQP solve, written for Hopper.
// K1 (full_solve.cu) and K8 (full_solve_packed.cu) both launch it.
//
// The function is the TPU kernels' pqp_for_mpc_tpu/ops/solve_kernel.py:
// fused_full_solve and pqp_for_mpc_tpu/ops/packed_kernel.py:
// fused_full_solve_packed: per lane, multiplicative updates, the periodic
// four-part termination check with the recovered U, optional safeguarded
// acceleration, the stall freeze and the early exit, over a batch that
// shares one geometry.
//
// Design.
//  * Block tile.  A block owns LB lane slots and every row of them.  The
//    geometry is staged once per block in shared memory, each matrix
//    depth-major as its product reads it (the wrapper lays them out in one
//    buffer, ops/solve_kernel.py: engine_geometry): the splits Qd^-+th and
//    Qd^++th, Qd, Gp (for Gp'Y), Gp' (for Gp U), Qp^-1 and Qp.  The slots'
//    iterate is a shared-memory tile that ping-pongs between two buffers,
//    with one __syncthreads per update.  Every product (the update's two
//    split products, the accel step's three Qd products, the check's Gp'Y,
//    Qp^-1 t, Gp U, Qd Y and Qp U) runs on the same register tile: a
//    thread owns 4 rows x 4 lanes (tile4 in pqp_common.cuh, K2's tile),
//    one 16-byte load of each operand feeding 16 FMAs.  A slot's Fd^- and
//    Fd^+ entries stay in the registers of the threads that own them, and
//    its Fd, Kp_slack and Fp in shared memory, for the lane's whole life.
//  * Feasibility.  The engine is a template on the certificate
//    (Args::feas_dual picks the instantiation at launch).  Off, the
//    reference's forcing-scale test Gp U > Kp_slack.  On, the dual-gradient
//    test of solver.check_terminate (config.feas_from_dual_gradient):
//    Gp U - Kp = -(Qd Y + Fd) for the recovered U, so a row violates where
//    !(Qd Y + Fd >= -slack), NaN included, with the panel kps holding the
//    slack max(erc Kp, eac) in place of Kp_slack; the check reads it off
//    the Qd Y it forms for the gap and skips the Gp U product.
//  * Per-lane sums.  Y'Qd Y, Fd'Y, U'Qp U, Fp'U, p'Qd p, p'p, f(Y) and
//    f(Y_new) are each one FMA chain in ascending index from 0, run by one
//    thread per slot over columns staged in shared memory; every product
//    entry is an ascending-k FMA chain from 0 plus its forcing term.  That
//    is the order of the earlier one-thread-per-lane kernel, so the engine
//    gives its bits on every lane: Y, U, iters and state.  The violation
//    test and the stall test are "any" tests, order-free.
//  * Lane refill.  The grid is the co-resident blocks, capped at
//    ceil(B / LB); lanes are handed out from a global counter (a zeroed
//    int32 the wrapper allocates), so no slot waits for another lane.  At
//    each check a slot retires when its lane is certified, was stalled at
//    the previous check, or has h > max_iters: it writes Y, U, iters and
//    state (the U of that check: the final check of the one-thread design
//    repeats it on the same iterate).  The block then takes as many lanes
//    as it has empty slots with one atomicAdd and loads their panels with
//    coalesced reads.  A refilled lane gets its h = 1 check on y0 before
//    its first update: when an eighth of the slots or more were refilled,
//    in a further check pass over them (a thread tile with none of them
//    skips its products); else at the next round's check, its iterate set
//    back to y0 after the round ran on it, so a few fresh slots wait one
//    round instead of costing the block a check pass (on an H100 at
//    M=7/N=28, B = 2^22, that took K1 from 209 to 190 ms; PERF.md).
//    Slots left without a lane go idle; the block exits when the counter
//    has passed B and no slot holds a lane.  A lane's result depends only
//    on its own data, so which slot or block runs it changes no bit.
//  * Plan (plan(); ops/solve_kernel.py: k1_plan mirrors it).  LB is K2's:
//    the largest power-of-two count of 4-lane groups, at most 32, with at
//    most 256 threads (N = 28: 7 row groups x 32 lane groups, 224 threads,
//    128 slots).  It is halved while the block's shared memory passes
//    227 KB; at the fewest lanes the trailing matrices of the layout stay
//    in device memory, read through the cache, so every N, M <= 128 whose
//    geometry fits the earlier design is taken.
//
// What bounds it on an H100.  Per lane an update is 2 N^2 FMAs and a check
// about 2NM + 2M^2 + N^2; the lanes' iteration counts fix the work, which
// is bound by the float32 FMA rate (M=7/N=28 at B=2^22: 57.40 ms).  The
// one-thread-per-lane design ran at ~9% of that rate: its warp waited for
// its slowest of 32 lanes, and a lane read one broadcast float4 of a split
// row per 4 FMAs with Fd re-read from device memory on every update.  Here
// no slot waits for another lane, and the update is K2's tile (41% of the
// FMA peak at the same shape).  What it adds to K2's cost: the check and
// its per-slot chains (one check per check_every updates), the refills,
// and the drain at the end of the queue.  Measured on an H100 SXM (700 W)
// at that shape: 190 ms, 30% of the FMA peak, against 602 ms; an update
// of every lane 0.48 ms (67% of the time), a check 1.24 ms (22%;
// tools/probe_k1.py).  Uncapped registers (231, one block per SM) ran
// slower than this cap of 128 for two blocks per SM.
//
// Every clamp and test keeps NaN as the plain version does (guard_den,
// relu_nan; verdicts in the "fail if x > tol" form); a NaN lane stays in
// its column.

#pragma once

#include <cuda_runtime.h>

#include "pqp_common.cuh"

namespace pqp {
namespace lts {

using tile4::L;
using tile4::R;
using tile4::load;
using tile4::store;

constexpr int kMaxThreads = 256;
constexpr int kMaxLaneGroups = 32;
constexpr int kMatrices = 7;    // qn, qp, qd, gp, gpt, qpi, qpt
constexpr int kSlotWords = 12;  // per-slot scalars in shared memory
constexpr int kCtlWords = 4;    // the block's queue words
constexpr size_t kSmemLimit = 232448;
constexpr int kMaxBatch = 1 << 30;
enum Ctl : int { kAsk = 0, kBase = 1, kGot = 2, kDone = 3 };

struct Args {
  const float* geo;  // the seven matrices, engine_geometry's layout
  const float *fp, *fd, *fdp, *fdn, *kps, *mp, *md, *y0;
  int fp_lane, fd_lane, fdp_lane, fdn_lane, kps_lane, mp_lane, md_lane,
      y0_lane;
  float *y_out, *u_out;
  int *iters_out, *state_out;
  int* queue;  // the next lane to hand out; 0 at launch
  int n, m, B, max_iters, check_every, accel_every;
  float eaj, erj;
  int strict;
  float den_eps;
  int gap_comp;
  int feas_dual;  // the dual-gradient feasibility test (kps = the slack)
};

struct Plan {
  int ldn, ldm;                 // rows padded to R
  int row_groups, lane_groups;  // threads = row_groups x lane_groups
  int lanes, threads;           // LB slots, threads of a block
  int lane_words;               // shared words per slot
  int staged;                   // matrices staged in shared memory
  long long off[kMatrices + 1];  // their offsets in the layout (floats)
  size_t smem;                  // dynamic shared memory of a block
};

__host__ __device__ inline size_t block_bytes(long long staged_floats,
                                              int lanes, int lane_words) {
  return 4 * ((size_t)staged_floats + (size_t)lanes * lane_words +
              kCtlWords);
}

__host__ __device__ inline Plan plan(int n, int m) {
  Plan p;
  p.ldn = round4(n);
  p.ldm = round4(m);
  p.row_groups = p.ldn / R;
  const long long nn = (long long)n * p.ldn, nm = (long long)n * p.ldm,
                  mn = (long long)m * p.ldn, mm = (long long)m * p.ldm;
  const long long seg[kMatrices] = {nn, nn, nn, nm, mn, mm, mm};
  p.off[0] = 0;
  for (int s = 0; s < kMatrices; ++s) p.off[s + 1] = p.off[s] + seg[s];
  // Y ping-pong, a work column and a scratch of max(n, 3m) rows, Fd,
  // Kp_slack and Fp, and the slot's scalars
  p.lane_words = 5 * n + (n > 3 * m ? n : 3 * m) + m + kSlotWords;
  int lg = 1;
  while (2 * lg <= kMaxLaneGroups && 2 * lg * p.row_groups <= kMaxThreads)
    lg *= 2;
  while (lg > 1 && block_bytes(p.off[kMatrices], L * lg, p.lane_words) >
                       kSmemLimit)
    lg /= 2;
  int staged = kMatrices;
  while (staged > 2 && block_bytes(p.off[staged], L * lg, p.lane_words) >
                           kSmemLimit)
    --staged;
  p.lane_groups = lg;
  p.lanes = L * lg;
  p.threads = p.row_groups * lg;
  p.staged = staged;
  p.smem = block_bytes(p.off[staged], p.lanes, p.lane_words);
  return p;
}

// A block's view of its shared memory: the geometry, the slot columns
// (x[i * lanes + s]) and the slot scalars, and this thread's tile.
struct Block {
  const float *qn, *qp;                       // shared memory
  const float *qd, *gp, *gpt, *qpi, *qpt;     // shared or device memory
  float *ys, *A, *S, *fd, *kps, *fp;
  int *lane, *h, *state, *iters, *need, *fresh, *changed, *viol, *list;
  float *mps, *mds, *fy;
  int* ctl;
  int n, m, ldn, ldm, lanes, row_groups, rg, r0, c0;

  __device__ __forceinline__ float* y(int cur) const {
    return ys + cur * n * lanes;
  }
};

__device__ __forceinline__ float panel(const float* p, int lane, int i,
                                       long long b, int B) {
  return lane ? p[(long long)i * B + b] : p[i];
}

// acc = this thread's R x L entries of A X: A depth-major
// (a[k * lda + r]), X a slot tile (x[k * lanes + c]); each entry one FMA
// chain in ascending k from 0.
__device__ __forceinline__ void product(const float* a, int lda,
                                        const float* x, int lanes, int depth,
                                        int r0, int c0, float (&acc)[R][L]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < L; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < depth; ++k) {
    float av[R], xv[L];
    load(a + k * lda + r0, av);
    load(x + k * lanes + c0, xv);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < L; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
  }
}

// The products of the check for the slots with need set:
// A = Qd Y, t = Gp'Y + Fp, u = -Qp^-1 t, the violation flag (of
// Gp u > Kp_slack, or with FeasDual of !(A + Fd >= -slack)), and Qp u
// (t, u, Qp u in the scratch S).
template <bool FeasDual>
__device__ __forceinline__ void check_products(const Block& k,
                                               const float* yc) {
  const int n = k.n, m = k.m, lanes = k.lanes, r0 = k.r0, c0 = k.c0;
  const int4 nd4 = *reinterpret_cast<const int4*>(k.need + c0);
  const int nd[L] = {nd4.x, nd4.y, nd4.z, nd4.w};
  const bool mine = (nd4.x | nd4.y | nd4.z | nd4.w) != 0;
  float* t = k.S;
  float* u = k.S + m * lanes;
  float* qu = k.S + 2 * m * lanes;
  float acc[R][L];
  if (mine) {
    product(k.qd, k.ldn, yc, lanes, n, r0, c0, acc);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (r0 + i >= n) continue;
      store(k.A + (r0 + i) * lanes + c0, acc[i]);
      if constexpr (FeasDual) {
        float f[L], sl[L];
        load(k.fd + (r0 + i) * lanes + c0, f);
        load(k.kps + (r0 + i) * lanes + c0, sl);
#pragma unroll
        for (int j = 0; j < L; ++j)
          if (nd[j] && !(acc[i][j] + f[j] >= -sl[j])) k.viol[c0 + j] = 1;
      }
    }
    for (int g = k.rg; R * g < m; g += k.row_groups) {
      product(k.gp, k.ldm, yc, lanes, n, R * g, c0, acc);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = R * g + i;
        if (r >= m) continue;
        float f[L];
        load(k.fp + r * lanes + c0, f);
#pragma unroll
        for (int j = 0; j < L; ++j) acc[i][j] += f[j];
        store(t + r * lanes + c0, acc[i]);
      }
    }
  }
  __syncthreads();
  if (mine) {
    for (int g = k.rg; R * g < m; g += k.row_groups) {
      product(k.qpi, k.ldm, t, lanes, m, R * g, c0, acc);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = R * g + i;
        if (r >= m) continue;
#pragma unroll
        for (int j = 0; j < L; ++j) acc[i][j] = -acc[i][j];
        store(u + r * lanes + c0, acc[i]);
      }
    }
  }
  __syncthreads();
  if (mine) {
    if constexpr (!FeasDual) {
      product(k.gpt, k.ldn, u, lanes, m, r0, c0, acc);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (r0 + i >= n) continue;
        float kp[L];
        load(k.kps + (r0 + i) * lanes + c0, kp);
#pragma unroll
        for (int j = 0; j < L; ++j)
          if (nd[j] && acc[i][j] > kp[j]) k.viol[c0 + j] = 1;
      }
    }
    for (int g = k.rg; R * g < m; g += k.row_groups) {
      product(k.qpt, k.ldm, u, lanes, m, R * g, c0, acc);
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (R * g + i < m) store(qu + (R * g + i) * lanes + c0, acc[i]);
    }
  }
  __syncthreads();
}

// The four-part test of terminate (PQP_CPU.c:673-687) for each slot with
// need set, from check_products' columns: feasibility, explicit or
// complementarity gap.  A slot that retires writes its lane's Y, U, iters
// and state and lets its lane go.
__device__ __forceinline__ void decide(const Block& k, const float* yc,
                                       const Args& a) {
  const int n = k.n, m = k.m, lanes = k.lanes;
  const float* u = k.S + m * lanes;
  const float* qu = k.S + 2 * m * lanes;
  for (int s = threadIdx.x; s < lanes; s += blockDim.x) {
    if (!k.need[s]) continue;
    float s1 = 0.f, s2 = 0.f;  // Y'Qd Y and Fd'Y
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float y = yc[i * lanes + s];
      s1 = fmaf(y, k.A[i * lanes + s], s1);
      s2 = fmaf(k.fd[i * lanes + s], y, s2);
    }
    float uqu = 0.f, fu = 0.f;  // U'Qp U and Fp'U
#pragma unroll 4
    for (int r = 0; r < m; ++r) {
      const float ur = u[r * lanes + s];
      uqu = fmaf(ur, qu[r * lanes + s], uqu);
      fu = fmaf(k.fp[r * lanes + s], ur, fu);
    }
    const float jd = 0.5f * s1 + s2 + 0.5f * k.mds[s];
    const float jp = 0.5f * uqu + fu + 0.5f * k.mps[s];
    float gap;
    bool weak_fail;
    if (a.gap_comp) {  // Jp(U(Y)) + Jd(Y) = Y'(Qd Y + Fd)
      gap = s1 + s2;
      weak_fail = gap > 0.f;
    } else {
      gap = jp + jd;
      weak_fail = jp > -jd;
    }
    bool fail = (k.viol[s] != 0) || (gap > a.eaj) ||
                (gap / fabsf(jd) > a.erj);
    if (a.strict) fail = fail || weak_fail;
    const bool ok = !fail;
    int state = k.state[s];
    const int h = k.h[s];
    if (state == kStalled || h > a.max_iters || ok) {
      if (state == kActive) {
        state = ok ? kCertified : kActive;
        k.iters[s] = h;
      }
      const long long b = k.lane[s];
      for (int i = 0; i < n; ++i)
        a.y_out[(long long)i * a.B + b] = yc[i * lanes + s];
      for (int r = 0; r < m; ++r)
        a.u_out[(long long)r * a.B + b] = u[r * lanes + s];
      a.iters_out[b] = k.iters[s];
      a.state_out[b] = state;
      k.lane[s] = -1;
    }
    k.need[s] = 0;
    k.viol[s] = 0;
  }
}

// Each empty slot asks for a lane (unless the queue is empty); the last
// refill's fresh marks, read by then, are cleared.
__device__ __forceinline__ void request(const Block& k) {
  for (int s = threadIdx.x; s < k.lanes; s += blockDim.x) {
    k.fresh[s] = 0;
    if (k.lane[s] < 0 && !k.ctl[kDone])
      k.list[atomicAdd(&k.ctl[kAsk], 1)] = s;
  }
}

// Hand the asking slots the next lanes of the queue: one atomicAdd for the
// block, the lanes' panels loaded with reads coalesced over the lanes, each
// lane at h = 1 with its check pending, and the fresh lanes' Fd^- / Fd^+
// entries into their owners' registers (staged through the work column
// and the other iterate buffer).  Returns how many slots got a lane
// (block-uniform).
__device__ __forceinline__ int refill(const Block& k, int cur,
                                       const Args& a, float (&fn)[R][L],
                                       float (&fq)[R][L]) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const int ask = k.ctl[kAsk];
    int base = 0, got = 0;
    if (ask > 0) {
      base = atomicAdd(a.queue, ask);
      got = base < a.B ? min(ask, a.B - base) : 0;
      if (got < ask) k.ctl[kDone] = 1;
    }
    k.ctl[kAsk] = 0;
    k.ctl[kBase] = base;
    k.ctl[kGot] = got;
  }
  __syncthreads();
  const int got = k.ctl[kGot];
  if (got == 0) return 0;
  const long long base = k.ctl[kBase];
  const int n = k.n, m = k.m, lanes = k.lanes, B = a.B;
  float* yc = k.y(cur);
  float* yo = k.y(cur ^ 1);
  for (int e = threadIdx.x; e < got * n; e += blockDim.x) {
    const int i = e / got, j = e - i * got;
    const long long b = base + j;
    const int o = i * lanes + k.list[j];
    yc[o] = panel(a.y0, a.y0_lane, i, b, B);
    k.fd[o] = panel(a.fd, a.fd_lane, i, b, B);
    k.kps[o] = panel(a.kps, a.kps_lane, i, b, B);
    k.A[o] = panel(a.fdn, a.fdn_lane, i, b, B);
    yo[o] = panel(a.fdp, a.fdp_lane, i, b, B);
  }
  for (int e = threadIdx.x; e < got * m; e += blockDim.x) {
    const int r = e / got, j = e - r * got;
    k.fp[r * lanes + k.list[j]] = panel(a.fp, a.fp_lane, r, base + j, B);
  }
  for (int j = threadIdx.x; j < got; j += blockDim.x) {
    const int s = k.list[j];
    const long long b = base + j;
    k.lane[s] = (int)b;
    k.h[s] = 1;
    k.state[s] = kActive;
    k.iters[s] = 0;
    k.need[s] = 1;
    k.fresh[s] = 1;
    k.mps[s] = a.mp[a.mp_lane ? b : 0];
    k.mds[s] = a.md[a.md_lane ? b : 0];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (!k.fresh[k.c0 + j]) continue;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int o = (k.r0 + i) * lanes + k.c0 + j;
      if (k.r0 + i < n) {
        fn[i][j] = k.A[o];
        fq[i][j] = yo[o];
      }
    }
  }
  return got;
}

// Projected steepest descent with exact line search on
// f(Y) = 1/2 Y'Qd Y + Fd'Y, kept only when f does not increase
// (solver.accel_step), for every slot; p lives in the other iterate
// buffer.
__device__ __forceinline__ void accel(const Block& k, float* yc, float* p) {
  const int n = k.n, lanes = k.lanes, r0 = k.r0, c0 = k.c0;
  float acc[R][L];
  product(k.qd, k.ldn, yc, lanes, n, r0, c0, acc);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (r0 + i >= n) continue;
    const int o = (r0 + i) * lanes + c0;
    float y[L], f[L], gf[L], pv[L];
    load(yc + o, y);
    load(k.fd + o, f);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const float g = acc[i][j] + f[j];
      pv[j] = (y[j] > 0.f || g < 0.f) ? -g : 0.f;
      gf[j] = g + f[j];
    }
    store(k.A + o, gf);
    store(p + o, pv);
  }
  __syncthreads();
  product(k.qd, k.ldn, p, lanes, n, r0, c0, acc);
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (r0 + i < n) store(k.S + (r0 + i) * lanes + c0, acc[i]);
  for (int s = threadIdx.x; s < lanes; s += blockDim.x) {
    float fy = 0.f;  // Y'(grad + Fd) = 2 f(Y)
#pragma unroll 4
    for (int i = 0; i < n; ++i)
      fy = fmaf(yc[i * lanes + s], k.A[i * lanes + s], fy);
    k.fy[s] = fy;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < lanes; s += blockDim.x) {
    float pqp = 0.f, pp = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float pi = p[i * lanes + s];
      pqp = fmaf(pi, k.S[i * lanes + s], pqp);
      pp = fmaf(pi, pi, pp);
    }
    const float alpha =
        (pqp > 0.f) ? pp / (pqp < 1e-30f ? 1e-30f : pqp) : 0.f;
    for (int i = 0; i < n; ++i) {
      const int o = i * lanes + s;
      k.A[o] = relu_nan(yc[o] + alpha * p[o]);
    }
  }
  __syncthreads();
  product(k.qd, k.ldn, k.A, lanes, n, r0, c0, acc);
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (r0 + i < n) store(k.S + (r0 + i) * lanes + c0, acc[i]);
  __syncthreads();
  for (int s = threadIdx.x; s < lanes; s += blockDim.x) {
    float q = 0.f, l = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float yn = k.A[i * lanes + s];
      q = fmaf(yn, k.S[i * lanes + s], q);
      l = fmaf(k.fd[i * lanes + s], yn, l);
    }
    if (0.5f * q + l <= 0.5f * k.fy[s])
      for (int i = 0; i < n; ++i) yc[i * lanes + s] = k.A[i * lanes + s];
  }
  __syncthreads();
}

// One round of every slot that holds a lane: check_every updates (or
// chunks of accel_every updates, each closed by an accel step), then the
// stall test against the iterate the round started from.  A slot whose
// first check is still pending keeps h = 1 and gets y0 back.
__device__ __forceinline__ void iterate(const Block& k, int& cur,
                                        const Args& a,
                                        const float (&fn)[R][L],
                                        const float (&fq)[R][L]) {
  const int n = k.n, lanes = k.lanes, r0 = k.r0, c0 = k.c0;
  float yp[R][L];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (r0 + i < n) {
      load(k.y(cur) + (r0 + i) * lanes + c0, yp[i]);
    } else {
#pragma unroll
      for (int j = 0; j < L; ++j) yp[i][j] = 0.f;
    }
  }
  const int inner = a.accel_every ? a.accel_every : a.check_every;
  const int chunks =
      a.accel_every ? max(1, a.check_every / a.accel_every) : 1;
  for (int c = 0; c < chunks; ++c) {
    for (int t = 0; t < inner; ++t) {
      tile4::update(k.qn, k.qp, k.ldn, k.y(cur), k.y(cur ^ 1), lanes, n, r0,
                    c0, fn, fq, a.den_eps);
      __syncthreads();
      cur ^= 1;
    }
    if (a.accel_every) accel(k, k.y(cur), k.y(cur ^ 1));
  }
  // Stall freeze: an iterate bit-identical after a whole round is at a
  // fixed point; its check just failed and would fail forever.
  bool moved[L] = {false, false, false, false};
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (r0 + i >= n) continue;
    float y[L];
    load(k.y(cur) + (r0 + i) * lanes + c0, y);
#pragma unroll
    for (int j = 0; j < L; ++j)
      if (!(y[j] - yp[i][j] == 0.f)) moved[j] = true;
  }
#pragma unroll
  for (int j = 0; j < L; ++j)
    if (moved[j]) k.changed[c0 + j] = 1;
  __syncthreads();
  float* yc = k.y(cur);
  for (int s = threadIdx.x; s < lanes; s += blockDim.x) {
    const int b = k.lane[s];
    if (b >= 0 && k.need[s]) {
      // refilled after the last check, its first check still to come: the
      // round ran on it, so its iterate goes back to y0
      for (int i = 0; i < n; ++i)
        yc[i * lanes + s] = panel(a.y0, a.y0_lane, i, b, a.B);
    } else if (b >= 0) {
      if (!k.changed[s]) {
        k.iters[s] = k.h[s] + a.check_every;
        k.state[s] = kStalled;
      }
      k.h[s] += a.check_every;
      k.need[s] = 1;
    }
    k.changed[s] = 0;
  }
  __syncthreads();
}

template <bool FeasDual>
__global__ void __launch_bounds__(kMaxThreads, 2)
lane_tile_solve(const Args a) {
  extern __shared__ float4 smem4[];
  const Plan pl = plan(a.n, a.m);
  const int n = a.n, m = a.m, lanes = pl.lanes;
  float* sm = reinterpret_cast<float*>(smem4);
  const long long staged = pl.off[pl.staged];
  const float4* geo4 = reinterpret_cast<const float4*>(a.geo);
  for (long long e = threadIdx.x; e < staged / 4; e += blockDim.x)
    smem4[e] = geo4[e];

  // the splits are always staged (plan); a matrix past pl.staged is read
  // from the layout in device memory
  Block k;
  const auto at = [&](int s) -> const float* {
    return (s < pl.staged ? sm : a.geo) + pl.off[s];
  };
  k.qn = sm;
  k.qp = sm + pl.off[1];
  k.qd = at(2); k.gp = at(3); k.gpt = at(4); k.qpi = at(5); k.qpt = at(6);
  float* w = sm + staged;
  k.ys = w;              w += 2 * n * lanes;
  k.A = w;               w += n * lanes;
  k.S = w;               w += (n > 3 * m ? n : 3 * m) * lanes;
  k.fd = w;              w += n * lanes;
  k.kps = w;             w += n * lanes;
  k.fp = w;              w += m * lanes;
  int* iw = reinterpret_cast<int*>(w);
  k.lane = iw;
  k.h = iw + lanes;
  k.state = iw + 2 * lanes;
  k.iters = iw + 3 * lanes;
  k.need = iw + 4 * lanes;
  k.fresh = iw + 5 * lanes;
  k.changed = iw + 6 * lanes;
  k.viol = iw + 7 * lanes;
  k.list = iw + 8 * lanes;
  float* fw = reinterpret_cast<float*>(iw + 9 * lanes);
  k.mps = fw;
  k.mds = fw + lanes;
  k.fy = fw + 2 * lanes;
  k.ctl = reinterpret_cast<int*>(fw + 3 * lanes);
  k.n = n; k.m = m; k.ldn = pl.ldn; k.ldm = pl.ldm; k.lanes = lanes;
  k.row_groups = pl.row_groups;
  k.rg = threadIdx.x / pl.lane_groups;
  k.r0 = R * k.rg;
  k.c0 = L * (threadIdx.x % pl.lane_groups);
  for (int s = threadIdx.x; s < lanes; s += blockDim.x) {
    k.lane[s] = -1;
    k.need[s] = k.fresh[s] = k.changed[s] = k.viol[s] = 0;
  }
  if (threadIdx.x < kCtlWords) k.ctl[threadIdx.x] = 0;
  __syncthreads();

  float fn[R][L], fq[R][L];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < L; ++j) fn[i][j] = fq[i][j] = 0.f;
  int cur = 0;
  request(k);
  bool pending = refill(k, cur, a, fn, fq) > 0;
  for (;;) {
    while (pending) {
      check_products<FeasDual>(k, k.y(cur));
      decide(k, k.y(cur), a);
      request(k);
      // a few refilled slots wait for the next round's check (with their
      // y0 restored), many get a check pass of their own now
      pending = refill(k, cur, a, fn, fq) * 8 >= lanes;
    }
    int live = 0;
    for (int s = threadIdx.x; s < lanes; s += blockDim.x)
      live |= k.lane[s] >= 0;
    if (!__syncthreads_or(live)) break;
    iterate(k, cur, a, fn, fq);
    pending = true;
  }
}

// The grid of the FeasDual instantiation: the blocks the card holds at
// once, capped at ceil(B / lanes).
template <bool FeasDual>
inline cudaError_t card_grid(const Plan& p, int B, int* per_sm, int* sms,
                             int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      lane_tile_solve<FeasDual>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, lane_tile_solve<FeasDual>, p.threads, p.smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long need = ((long long)B + p.lanes - 1) / p.lanes;
  const long long held = (long long)(*per_sm) * (*sms);
  *grid = (int)(need < held ? need : held);
  return *grid > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <bool FeasDual>
inline cudaError_t launch_as(const Args& a, const Plan& p,
                             cudaStream_t stream) {
  int per_sm = 0, sms = 0, grid = 0;
  const cudaError_t err = card_grid<FeasDual>(p, a.B, &per_sm, &sms, &grid);
  if (err != cudaSuccess) return err;
  lane_tile_solve<FeasDual><<<grid, p.threads, p.smem, stream>>>(a);
  return cudaGetLastError();
}

// Refuses what the engine does not take (cudaErrorInvalidValue); else
// launches the instantiation of a.feas_dual on the stream and returns
// cudaGetLastError().
inline cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.n < 1 || a.m < 1 || a.n > 128 || a.m > 128 || a.B < 1 ||
      a.B > kMaxBatch || a.check_every < 1 || a.accel_every < 0)
    return cudaErrorInvalidValue;
  const Plan p = plan(a.n, a.m);
  if (p.smem > kSmemLimit) return cudaErrorInvalidValue;
  return a.feas_dual ? launch_as<true>(a, p, stream)
                     : launch_as<false>(a, p, stream);
}

}  // namespace lts
}  // namespace pqp
